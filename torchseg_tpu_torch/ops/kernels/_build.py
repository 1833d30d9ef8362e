"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The library is compiled at first use from ``torchseg_tpu_torch/csrc/*.cu``
into ``torchseg_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached file.  The C entry points take raw device pointers and the CUDA
stream as ``void*`` and return ``cudaGetLastError()``; ``ready(device)``
also runs the library's one-time set-up on that device.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from ctypes import c_float, c_int, c_void_p

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("int8_serve_kernels.cu",)
# -fmad=false: nvcc must not contract a multiply and an add that the JAX
# reference rounds twice; the kernels write every fused multiply-add that
# the reference does perform explicitly (__fmaf_rn).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_SIGNATURES = {
    # xs, wf, m, c, sp, pooled, h2, w2, cin, cout, n_sp, stream
    "tsg_stem_pool_i8": [c_void_p] * 6 + [c_int] * 5 + [c_void_p],
    # x, h, w, cin, wt, k, stride, pad, cout, m, c, mode, res, rr,
    # xd, hd, wd, cdin, sd, wdt, md, cd, out, ho, wo, stream
    "tsg_conv_i8": ([c_void_p] + [c_int] * 3 + [c_void_p] + [c_int] * 4
                    + [c_void_p] * 2 + [c_int] + [c_void_p, c_float]
                    + [c_void_p] + [c_int] * 4 + [c_void_p] * 4
                    + [c_int] * 2 + [c_void_p]),
}


class BuildInfo:
    """What the last ``load()`` did: library path, seconds spent compiling
    (0.0 when the cached library was loaded) and nvcc's ptxas report."""

    path = None
    seconds = 0.0
    log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; one per process."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"int8_serve_kernels_{_source_hash()}.so")
    if not os.path.exists(lib_path):
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
    BuildInfo.path = lib_path
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    lib.tsg_init.argtypes = []
    lib.tsg_init.restype = c_int
    return lib


@functools.lru_cache(maxsize=None)
def ready(device_index: int) -> ctypes.CDLL:
    """The loaded library, with its one-time per-device set-up (the
    kernels' dynamic shared-memory limit) done on ``cuda:device_index``."""
    import torch

    lib = load()
    with torch.cuda.device(device_index):
        rc = lib.tsg_init()
    if rc != 0:
        raise RuntimeError(f"tsg_init on cuda:{device_index}: CUDA error {rc}")
    return lib
