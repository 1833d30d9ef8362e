"""Build and load the port's CUDA kernels (nvcc -> shared libraries -> ctypes).

Each source ``torchseg_tpu_torch/csrc/<name>.cu`` is one library, compiled
at first use into ``torchseg_tpu_torch/_build/`` (git-ignored) and named by
a hash of its source and the flags, so an edited source rebuilds and an
unchanged one loads the cached file.  The first ``load`` starts one nvcc per
missing library, all at once, and waits for them together, under a file
lock in the build directory (concurrent processes build once).  The C entry
points take raw device pointers and the CUDA stream as ``void*`` and return
``cudaGetLastError()``; ``ready(device, name)`` also runs the library's
one-time set-up (``tsg_init``, where it has one) on that device.

``host_library(source)`` builds a C++ host library (the data pipeline's
``native/augment.cpp``) the same way with g++: hash-named by its source
and flags, into the same directory, under the same lock.
"""

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from ctypes import c_double, c_float, c_int, c_longlong, c_void_p

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: nvcc must not contract a multiply and an add that the JAX
# reference rounds twice; the kernels write every fused multiply-add that
# the reference does perform explicitly (__fmaf_rn).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# the host libraries' flags: the JAX package's native build's
# (torchseg_tpu/native/__init__.py), so that the arithmetic compiles alike
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

# library (= source stem) -> {entry point: argtypes}
LIBRARIES = {
    "int8_serve_kernels": {
        "tsg_init": [],
        "tsg_smem_optin": [],
        # cout, n_sp
        "tsg_stem_smem_bytes": [c_int] * 2,
        # mode, k, stride, dilation
        "tsg_conv_mma_smem_bytes": [c_int] * 4,
        # cin, k (0: the separable window), mode, out_f32, stride, dilation
        "tsg_conv_mma_res_smem_bytes": [c_int] * 6,
        # xs, wf, m, c, sp, pooled, h2, w2, cin, cout, n_sp, stream
        "tsg_stem_pool_i8": [c_void_p] * 6 + [c_int] * 5 + [c_void_p],
        # x, batch, h, w, cin, s_in, x_bf16, wt, k, stride, dilation, cout,
        # m, c, mode, res, rr, xd, wd, cdin, sd, wdt, md, cd, out, out_f32,
        # ho, wo, split, stream
        "tsg_conv_i8_mma": ([c_void_p] + [c_int] * 4 + [c_float, c_int, c_void_p]
                            + [c_int] * 4 + [c_void_p] * 2 + [c_int]
                            + [c_void_p, c_float, c_void_p] + [c_int] * 3
                            + [c_void_p] * 4 + [c_int] * 4 + [c_void_p]),
        # x, batch, h, w, cin, s_in, x_bf16, wt, k, stride, dilation, cout,
        # m, c, mode, res, rr, out, out_f32, stream
        "tsg_conv_i8_mma_res": ([c_void_p] + [c_int] * 4 + [c_float, c_int, c_void_p]
                                + [c_int] * 4 + [c_void_p] * 2 + [c_int]
                                + [c_void_p, c_float, c_void_p, c_int]
                                + [c_void_p]),
        # x, h, w, cin, dw, dm, stride, wt, cout, m, c, mode, res, rr, out,
        # out_f32, stream
        "tsg_sep_i8_mma_res": ([c_void_p] + [c_int] * 3 + [c_void_p] * 2
                               + [c_int, c_void_p, c_int] + [c_void_p] * 2
                               + [c_int] + [c_void_p, c_float, c_void_p, c_int]
                               + [c_void_p]),
        # x, h, w, c, out, ho, wo, route (bytes a load: 16 or 4), stream
        "tsg_maxpool_i8": ([c_void_p] + [c_int] * 3 + [c_void_p]
                           + [c_int] * 3 + [c_void_p]),
        # x, h, w, c, wt, dm, stride, out, ho, wo, stream
        "tsg_dwconv3x3_i8": ([c_void_p] + [c_int] * 3 + [c_void_p] * 2
                             + [c_int, c_void_p] + [c_int] * 2
                             + [c_void_p]),
    },
    "bn_kernels": {
        # x, n, c, hw, bf16, out, weight, bias, running_mean,
        # running_var, num_batches_tracked, eps, momentum, stream
        "tsg_channel_sums": ([c_void_p] + [c_int] * 2 + [c_longlong, c_int]
                             + [c_void_p] * 6 + [c_double] * 2
                             + [c_void_p]),
        # x, a, b, n, c, hw, flags (bf16 | relu << 1), y, stream
        "tsg_scale_bias_act": ([c_void_p] * 3 + [c_int] * 2
                               + [c_longlong, c_int] + [c_void_p] * 2),
    },
    "upsample_argmax": {
        "tsg_upsample_max_cols": [],
        # x, batch, h, w, nc, rtab, ctab, out, oh, ow, cols, cc, smem_bytes,
        # stream
        "tsg_upsample_argmax": ([c_void_p] + [c_int] * 4 + [c_void_p] * 3
                                + [c_int] * 5 + [c_void_p]),
    },
    "stem_conv": {
        "tsg_init": [],
        # n_pack
        "tsg_stem_tc_smem_bytes": [c_int],
        # batch, h, w, n_pack
        "tsg_stem_tc_fix_ints": [c_int] * 4,
        # x, batch, h, w, cx, s2d, wt, a, b, cout, n_sp, out1, out2,
        # out_bf16, stream
        "tsg_stem_conv_f32": ([c_void_p] + [c_int] * 5 + [c_void_p] * 3
                              + [c_int] * 2 + [c_void_p] * 2 + [c_int]
                              + [c_void_p]),
        # x, batch, h, w, cx, s2d, pack, n_pack, wt, a, b, cout, n_sp, out1,
        # out2, out_bf16, fix_list, n_rechecked, stream
        "tsg_stem_conv_bf16": ([c_void_p] + [c_int] * 5 + [c_void_p, c_int]
                               + [c_void_p] * 3 + [c_int] * 2
                               + [c_void_p] * 2 + [c_int] + [c_void_p] * 3),
    },
    "focal_loss": {
        # x, x_bf16, t, t_i64, n, c, gamma, square, alpha, 1 - alpha, out,
        # stream
        "tsg_focal_fwd": ([c_void_p, c_int, c_void_p] + [c_int] * 3
                          + [c_float, c_int, c_float, c_float]
                          + [c_void_p] * 2),
        # x, x_bf16, t, t_i64, g, g_scalar, n, c, gamma, square, alpha,
        # 1 - alpha, dx, stream
        "tsg_focal_bwd": ([c_void_p, c_int, c_void_p, c_int, c_void_p]
                          + [c_int] * 3 + [c_float, c_int, c_float, c_float]
                          + [c_void_p] * 2),
    },
}
# entry points that return something other than int
_RESTYPES = {"tsg_stem_smem_bytes": c_longlong,
             "tsg_stem_tc_smem_bytes": c_longlong,
             "tsg_stem_tc_fix_ints": c_longlong,
             "tsg_conv_mma_smem_bytes": c_longlong,
             "tsg_conv_mma_res_smem_bytes": c_longlong}


class BuildInfo:
    """What the build did: per library its path and nvcc's ptxas report
    (empty when the cached library was loaded), and the wall seconds of
    the parallel nvcc run (0.0 when every library was cached)."""

    paths = {}
    logs = {}
    seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):  # shared headers count too
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """One build at a time: processes that start together (the ranks of a
    multi-process run, the tests' workers) wait for the first one's
    compiler and load its files."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile every library that is not cached, one nvcc each, in
    parallel; returns {name: library path}.  Raises if any nvcc fails."""
    paths = {name: _lib_path(name) for name in LIBRARIES}
    with _build_lock():
        return _build_locked(paths)


@functools.lru_cache(maxsize=None)
def host_library(source: str) -> str:
    """Compile the C++ file ``source`` with g++ (``GXX_FLAGS``) into a
    shared library in ``BUILD_DIR`` unless it is cached; returns its path.
    Raises RuntimeError with the compiler's message if g++ fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    with _build_lock():
        if os.path.exists(path):
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *GXX_FLAGS, source, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def _build_locked(paths: dict) -> dict:
    jobs = {}
    t0 = time.perf_counter()
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        jobs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        BuildInfo.logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    if jobs:
        BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.paths = paths
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; one per process."""
    lib = ctypes.CDLL(build()[name])
    for fn_name, argtypes in LIBRARIES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(fn_name, c_int)
    return lib


@functools.lru_cache(maxsize=None)
def ready(device_index: int, name: str = "int8_serve_kernels") -> ctypes.CDLL:
    """The loaded library, with its one-time per-device set-up (the
    kernels' dynamic shared-memory limit) done on ``cuda:device_index``."""
    import torch

    lib = load(name)
    if "tsg_init" in LIBRARIES[name]:
        with torch.cuda.device(device_index):
            rc = lib.tsg_init()
        if rc != 0:
            raise RuntimeError(
                f"{name} tsg_init on cuda:{device_index}: CUDA error {rc}")
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The number of SMs of that device."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on that device."""
    import torch

    with torch.cuda.device(device_index):
        n = ready(device_index).tsg_smem_optin()
    if n < 0:
        raise RuntimeError(f"cuda:{device_index}: cannot read the shared "
                           "memory limit")
    return n
