#!/usr/bin/env python3
"""K1 (``stem_pool_i8``), K2 (``conv3x3s2_i8``), K3 (``l1_stage_i8``), K4
(``down_stage_i8``), K5 (``down_block_i8``) and K6 (``res_block_i8``) on a
CUDA card at the main path's shapes: this tree's tensor-core kernels against
another checkout's (``--root``, e.g. the parent commit unpacked under
``_archive/``) in turns in one process, and this tree's source built with
other values of its tuning constants (``--variant``).

    python scripts/torch_int8_kernel_variants.py --root _archive/parent
    python scripts/torch_int8_kernel_variants.py \\
        --variant st3:kMmaStages=3 --variant st2:kMmaStages=2

A variant is ``name:NAME=value,...``: each NAME is a ``constexpr int`` of
``csrc/int8_serve_kernels.cu`` (``kMmaStages``, ...), replaced in a copy
that nvcc builds with the repo's flags into ``torchseg_tpu_torch/_build/
variants`` (all at once).  For each build (this tree, each variant, the
other tree) it prints ptxas's registers and spills of every kernel of the
library, the dynamic shared memory of a K1 and a K4 launch, and the count
of HMMA (bf16/f16 tensor-core) and IMMA (int8 tensor-core) instructions of
each kernel in ``cuobjdump -sass`` of the built library, and exits non-zero
unless every tensor-core conv kernel (those K2-K6 launch, K5's split
projection launch among them) has IMMA.  Then, on seeded random codes and
weights at the main path's shapes (K1: xs (1, 515, 1027, 12) -> 64 sp + 64
pooled channels; K2: (1, 512, 1024, 64) -> 64 and on to (1, 128, 256, 64);
K3: (1, 256, 512, 64); K4 stage 2: (1, 256, 512, 64) -> 128, stage 3: (1,
128, 256, 128) -> 256; K5: (1, 64, 128, 256) -> 512; K6: (1, 32, 64,
512)), the CUDA-event ms per call of K1, of each K4 link (conv1 3x3/2;
conv2 with the 1x1/2 projection; the stride-1 block's conv1; its conv2 with
the residual), of each K3 and K6 link (conv1; conv2 with the residual; K3
twice), of each K2 launch (sp1, sp2) and K5 link (conv1 3x3/2; conv2 with
the projection) and of each whole stage or block, measured in turns: other
tree, this tree, variants and alternatives, this tree, other tree
(``--reps`` calls each after a warm-up); the other tree's links run as its
wrappers launch them (``parent_link``).  The alternatives are this tree's
other launches of the same link: K3's and K2's links on the streaming
kernel (K4's launch as it is, ``stream``), K6's and K5's without the K
split (``split1``).  Each row has its bound (int8 or bf16 operations over
the dense peak, or bytes over 3.35 TB/s) and the outputs are checked: K4's
links bit-exact against this tree's codes, K2's, K3's, K5's and K6's links
and every whole stage against the plain versions, K1 within one code on at
most 1e-3 of the codes.  Prints the card's name and power limit, and
one JSON line (also to ``--out``).  With ``--forward N`` it also times the
main path itself in both trees (``entry()``: BiSeNet-R18.speed int8-through
at 1024x2048, seeded weights; four seeded uint8 images, N rounds of four
forwards, CUDA events per forward) in turns: other tree, this tree, this
tree, other tree, each with its median and p90; ``--psp-forward N`` does
the same for PSPNet-R50 at 480x480 (``serve_entry``).

cbr_i8's and bottleneck_i8's launches (``CBR_LINKS``: the R18.speed main
path's sp3 and six decoder convs at 1024x2048, and every distinct conv of
PSPNet-R50's deep stem and Bottleneck body at 480x480) are timed the same
way on each route the kernels offer (the resident-weight kernel where cin
<= 64, the streaming one by the host's split rule, unsplit and split over
two blocks; "change" is the route the wrappers pick) against the other
tree's CUDA-core ``conv_i8_kernel`` (its ``_launch_conv``, where it has
one), each checked against its plain version, and summed over a
forward's launches per path.  Needs a card and nvcc.

K10 (``maxpool2d_3x3s2_i8``) comes first, at PSPNet-R50's pool input (1,
240, 240, 128), over eight distinct seeded inputs and outputs (74 MB,
more than the 50 MB L2, so each call reads its input from device memory):
each build's library called directly, in turns (other tree, this tree,
variants, this tree, other tree), torch.profiler's device time per call
and the CUDA-event time of back-to-back calls; the two trees' wrappers
(CUDA events, so the wrapper's host time included, and the profiler);
the share of the bytes bound (9.2 MB over 3.35 TB/s); the library
yardstick ``F.max_pool2d`` on float16 copies (the NHWC copy viewed as
NCHW, as chip_smoke times it, and an NCHW-contiguous one) and the cast,
by the profiler; the route each launch takes; registers, SASS
instructions and global loads of the pool kernels.  Every build is held
bit for bit to ``maxpool_i8`` on those inputs and on ragged shapes (odd
sizes, C on the 4-byte route, an input 4 bytes off a 16-byte boundary).
A variant sets K10's ``kPool*`` constants.  ``--k10-only`` runs K10 and
the forward timings and nothing else:

    python scripts/torch_int8_kernel_variants.py --root _archive/parent \\
        --k10-only --psp-forward 10 --variant r4:kPoolRows=4
"""

import argparse
import ctypes
import itertools
import statistics
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_stem_upsample_probe import device_ms  # noqa: E402

from torchseg_tpu_torch.ops.kernels import _build  # noqa: E402
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K  # noqa: E402

HBM = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12}
H2, W2 = 512, 1024          # the main path's stem output at 1024x2048
STAGES = {"stage2": (256, 512, 64), "stage3": (128, 256, 128)}
IDENTITY = {"K3": (256, 512, 64), "K6": (32, 64, 512)}  # (h, w, c)
SPATIAL = (512, 1024, 64)    # K2: sp1's input (h, w, c); sp2 takes sp1's codes
DOWN_BLOCK = (64, 128, 256)  # K5: stage 4's input (h, w, cin), cout 2 cin
# the tensor-core instantiations K2 and K5 launch (mangled-name parts)
K2_K5_KERNELS = ("conv_i8_mma_res_kernelILi0E", "conv_i8_mma_kernelILi0ELi2E",
                 "conv_i8_mma_kernelILi2ELi2E")


def import_tree(root, alias):
    """The int8 serving kernels module of the checkout at ``root``,
    imported as the package ``alias`` (its kernels build into that
    checkout's ``_build``)."""
    pkg = os.path.join(os.path.abspath(root), "torchseg_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.kernels.int8_serve_kernels")


def variant_source(text, assignments):
    for name, value in assignments.items():
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"no single constexpr {name} in the source")
    return text


def build_variants(variants):
    """{name: (library path, ptxas log)}, one nvcc per variant, at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "int8_serve_kernels.cu")) as f:
        text = f.read()
    jobs = {}
    for name, assignments in variants.items():
        src = os.path.join(out_dir, f"i8_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, assignments))
        so = os.path.join(out_dir, f"i8_{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        built[name] = (so, log)
    return built


def load_lib(so):
    lib = ctypes.CDLL(so)
    for fn_name, argtypes in _build.LIBRARIES["int8_serve_kernels"].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _build._RESTYPES.get(fn_name, ctypes.c_int)
    if lib.tsg_init():
        raise SystemExit(f"{so}: tsg_init failed")
    return lib


def report_build(tag, so, log):
    """ptxas registers / spills per kernel and the SASS tensor-core
    instruction counts per kernel."""
    fn = None
    regs = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
        if "spill" in line and fn and not line.strip().startswith("0 bytes"):
            print(f"  [{tag}] {fn}: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HMMA": 0, "IMMA": 0, "instructions": 0,
                          "LDG": 0, "LDG.128": 0}
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[fn]["instructions"] += 1
            for op in ("HMMA", "IMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
            if re.search(r"\bLDG\b", line):
                counts[fn]["LDG"] += 1
                counts[fn]["LDG.128"] += ".128" in line
    rows = {}
    for name in sorted(set(regs) | set(counts)):
        short = re.sub(r"^_ZN\w*?_tsg_init\d+", "", name)
        rows[short] = {"registers": regs.get(name), **counts.get(
            name, {"HMMA": 0, "IMMA": 0})}
        if "maxpool" in short:
            continue  # printed with K10
        print(f"  [{tag}] {short[:60]:60s} registers {regs.get(name)} "
              f"HMMA {rows[short]['HMMA']} IMMA {rows[short]['IMMA']}")
    return rows


def dump_pool_sass(so, path):
    """Write the ``cuobjdump -sass`` listing of the library's K10 kernels
    to ``path``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    keep, out = False, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            keep = "maxpool" in m.group(1)
        if keep:
            out.append(line)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def check_imma(tag, rows):
    """Every tensor-core conv kernel (conv_i8_mma_kernel's and
    conv_i8_mma_res_kernel's instantiations: all that K2-K6 launch) has
    IMMA instructions, and those K2 and K5 launch are among them."""
    mma = {k: v["IMMA"] for k, v in rows.items() if "conv_i8_mma" in k}
    if not mma or min(mma.values()) == 0:
        raise SystemExit(f"[{tag}] a tensor-core conv kernel has no IMMA: "
                         f"{mma}")
    missing = [n for n in K2_K5_KERNELS if not any(n in k for k in mma)]
    if missing:
        raise SystemExit(f"[{tag}] no tensor-core kernel {missing} in the "
                         f"library")
    print(f"  [{tag}] IMMA in all {len(mma)} tensor-core conv kernels: "
          f"{sorted(mma.values())}", flush=True)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def operands(dev):
    g = torch.Generator().manual_seed(0)

    def cbr(k, cin, cout):
        scale = 40.0 / (127 * 64 * (9 * cin) ** 0.5)
        return {"w": torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                                   dtype=torch.int8).to(dev),
                "m": ((torch.rand(cout, generator=g) + 0.5) * scale).to(dev),
                "c": (torch.randn(cout, generator=g) * 8).to(dev)}

    stem = {"xs": torch.randint(-128, 128, (1, H2 + 3, W2 + 3, 12),
                                generator=g, dtype=torch.int8).to(dev),
            "wf": (torch.randn(4, 4, 12, 128, generator=g) * 0.05).to(
                torch.bfloat16).to(dev),
            "m": (torch.rand(128, generator=g) * 0.016 + 0.004).to(dev),
            "c": (torch.randn(128, generator=g) * 2).to(dev)}
    stages = {}
    for name, (h, w, cin) in STAGES.items():
        cout = 2 * cin
        x = torch.randint(0, 128, (1, h, w, cin), generator=g,
                          dtype=torch.int8).to(dev)
        e0 = {"conv1": cbr(3, cin, cout), "conv2": cbr(3, cout, cout),
              "down": cbr(1, cin, cout), "stride": 2,
              "res_ratio": float(torch.rand((), generator=g)) + 0.3}
        e1 = {"conv1": cbr(3, cout, cout), "conv2": cbr(3, cout, cout),
              "stride": 1,
              "res_ratio": float(torch.rand((), generator=g)) + 0.3}
        stages[name] = (x, e0, e1)
    identity = {}
    for name, (h, w, c) in IDENTITY.items():
        x = torch.randint(0, 128, (1, h, w, c), generator=g,
                          dtype=torch.int8).to(dev)
        blocks = [{"conv1": cbr(3, c, c), "conv2": cbr(3, c, c), "stride": 1,
                   "res_ratio": float(torch.rand((), generator=g)) + 0.3}
                  for _ in range(2 if name == "K3" else 1)]
        identity[name] = (x, blocks)
    h, w, c = SPATIAL
    spatial = (torch.randint(0, 128, (1, h, w, c), generator=g,
                             dtype=torch.int8).to(dev),
               cbr(3, c, c), cbr(3, c, c))
    h, w, cin = DOWN_BLOCK
    x = torch.randint(0, 128, (1, h, w, cin), generator=g,
                      dtype=torch.int8).to(dev)
    k5 = (x, {"conv1": cbr(3, cin, 2 * cin), "conv2": cbr(3, 2 * cin, 2 * cin),
              "down": cbr(1, cin, 2 * cin), "stride": 2,
              "res_ratio": float(torch.rand((), generator=g)) + 0.3})
    return stem, stages, identity, spatial, k5


# libraries whose tsg_conv_i8_mma has the older argument list (no kernel
# size, dilation or float32 output: the 3x3 pad-1 kernel with codes out)
OLD_ABI = set()


def mma_call(lib, x, e, stride, out, mode=0, res=None, rr=0.0, xd=None,
             down=None, split=1, dilation=1, sd=2):
    """One tsg_conv_i8_mma call into ``out`` (``split`` as the entry
    point takes it: 0 for its host rule, 1 or 2; float32 out where ``out``
    is float32)."""
    _, h, w, cin = x.shape
    _, ho, wo, cout = out.shape
    res_args = (res.data_ptr() if res is not None else None, float(rr),
                xd.data_ptr() if xd is not None else None,
                xd.shape[2] if xd is not None else 0,
                xd.shape[3] if xd is not None else 0, sd,
                down["w"].data_ptr() if down is not None else None,
                down["m"].data_ptr() if down is not None else None,
                down["c"].data_ptr() if down is not None else None,
                out.data_ptr())
    if id(lib) in OLD_ABI:
        rc = lib.tsg_conv_i8_mma(
            x.data_ptr(), h, w, cin, e["w"].data_ptr(), stride, cout,
            e["m"].data_ptr(), e["c"].data_ptr(), mode, *res_args, ho, wo,
            split, K._stream(x))
    else:
        rc = lib.tsg_conv_i8_mma(
            x.data_ptr(), h, w, cin, e["w"].data_ptr(), e["w"].shape[0],
            stride, dilation, cout, e["m"].data_ptr(), e["c"].data_ptr(),
            mode, *res_args, int(out.dtype == torch.float32), ho, wo, split,
            K._stream(x))
    if rc:
        raise RuntimeError(f"tsg_conv_i8_mma: CUDA error {rc}")
    return out


def res_call(lib, x, e, out, mode=0, res=None, rr=0.0, stride=1,
             dilation=1):
    _, h, w, cin = x.shape
    rc = lib.tsg_conv_i8_mma_res(
        x.data_ptr(), h, w, cin, e["w"].data_ptr(), e["w"].shape[0], stride,
        dilation, out.shape[3], e["m"].data_ptr(), e["c"].data_ptr(), mode,
        res.data_ptr() if res is not None else None, float(rr),
        out.data_ptr(), int(out.dtype == torch.float32), K._stream(x))
    if rc:
        raise RuntimeError(f"tsg_conv_i8_mma_res: CUDA error {rc}")
    return out


# cbr_i8's and bottleneck_i8's launches: (item, input (h, w, cin), k, cout,
# stride, dilation, mode, float32 out, projection (cdin, sd) or None).  The
# R18.speed main path's sp3 and decoder convs at 1024x2048, and every
# distinct conv of PSPNet-R50's stem and Bottleneck body at 480x480
# (layer3 at dilation 2 and layer4 at 4 after each stage's first block, at
# 1 and 2; the body's last conv3 in float32)
CBR_LINKS = [
    ("dec:sp3", (128, 256, 64), 1, 128, 1, 1, 0, False, None),
    ("dec:arm0", (32, 64, 512), 3, 128, 1, 1, 0, True, None),
    ("dec:refine0", (64, 128, 128), 3, 128, 1, 1, 0, True, None),
    ("dec:arm1", (64, 128, 256), 3, 128, 1, 1, 0, True, None),
    ("dec:refine1", (128, 256, 128), 3, 128, 1, 1, 0, False, None),
    ("dec:ffm", (128, 256, 256), 1, 256, 1, 1, 0, True, None),
    ("dec:head", (128, 256, 256), 3, 64, 1, 1, 0, True, None),
    ("psp:stem2", (240, 240, 64), 3, 64, 1, 1, 0, False, None),
    ("psp:stem3", (240, 240, 64), 3, 128, 1, 1, 0, False, None),
    ("psp:l1_0.conv1", (120, 120, 64), 1, 64, 1, 1, 0, False, None),
    ("psp:l1.conv2", (120, 120, 64), 3, 64, 1, 1, 0, False, None),
    ("psp:l1_0.conv3", (120, 120, 64), 1, 256, 1, 1, 2, False, (64, 1)),
    ("psp:l1.conv1", (120, 120, 256), 1, 64, 1, 1, 0, False, None),
    ("psp:l1.conv3", (120, 120, 64), 1, 256, 1, 1, 1, False, None),
    ("psp:l2_0.conv1", (120, 120, 256), 1, 128, 1, 1, 0, False, None),
    ("psp:l2_0.conv2", (120, 120, 128), 3, 128, 2, 1, 0, False, None),
    ("psp:l2_0.conv3", (60, 60, 128), 1, 512, 1, 1, 2, False, (256, 2)),
    ("psp:l2.conv1", (60, 60, 512), 1, 128, 1, 1, 0, False, None),
    ("psp:l2.conv2", (60, 60, 128), 3, 128, 1, 1, 0, False, None),
    ("psp:l2.conv3", (60, 60, 128), 1, 512, 1, 1, 1, False, None),
    ("psp:l3_0.conv1", (60, 60, 512), 1, 256, 1, 1, 0, False, None),
    ("psp:l3_0.conv2", (60, 60, 256), 3, 256, 1, 1, 0, False, None),
    ("psp:l3.conv2", (60, 60, 256), 3, 256, 1, 2, 0, False, None),
    ("psp:l3_0.conv3", (60, 60, 256), 1, 1024, 1, 1, 2, False, (512, 1)),
    ("psp:l3.conv1", (60, 60, 1024), 1, 256, 1, 1, 0, False, None),
    ("psp:l3.conv3", (60, 60, 256), 1, 1024, 1, 1, 1, False, None),
    ("psp:l4_0.conv1", (60, 60, 1024), 1, 512, 1, 1, 0, False, None),
    ("psp:l4_0.conv2", (60, 60, 512), 3, 512, 1, 2, 0, False, None),
    ("psp:l4.conv2", (60, 60, 512), 3, 512, 1, 4, 0, False, None),
    ("psp:l4_0.conv3", (60, 60, 512), 1, 2048, 1, 1, 2, False, (1024, 1)),
    ("psp:l4.conv1", (60, 60, 2048), 1, 512, 1, 1, 0, False, None),
    ("psp:l4.conv3", (60, 60, 512), 1, 2048, 1, 1, 1, False, None),
    ("psp:l4_2.conv3", (60, 60, 512), 1, 2048, 1, 1, 1, True, None),
]
# how many times a forward launches each: PSPNet-R50's blocks per stage
# are 3, 4, 6, 3 (the first of each with the projection)
CBR_LAUNCHES = {"psp:l1.conv2": 3, "psp:l1.conv1": 2, "psp:l1.conv3": 2,
                "psp:l2.conv1": 3, "psp:l2.conv2": 3, "psp:l2.conv3": 3,
                "psp:l3.conv2": 5, "psp:l3.conv1": 5, "psp:l3.conv3": 5,
                "psp:l4.conv2": 2, "psp:l4.conv1": 2, "psp:l4.conv3": 1}


def cbr_operands(g, dev, link):
    """Seeded codes and weights of one CBR_LINKS launch: (x, e, extra)."""
    _, (h, w, cin), k, cout, stride, _, mode, _, proj = link
    scale = 40.0 / (127 * 64 * (k * k * cin) ** 0.5)

    def entry(kk, ci, co):
        return {"w": torch.randint(-127, 128, (kk, kk, ci, co), generator=g,
                                   dtype=torch.int8).to(dev),
                "m": ((torch.rand(co, generator=g) + 0.5) * scale).to(dev),
                "c": (torch.randn(co, generator=g) * 8).to(dev)}

    x = torch.randint(0, 128, (1, h, w, cin), generator=g,
                      dtype=torch.int8).to(dev)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    extra = {}
    if mode == 1:
        extra = {"res": torch.randint(0, 128, (1, ho, wo, cout), generator=g,
                                      dtype=torch.int8).to(dev), "rr": 0.75}
    elif mode == 2:
        cdin, sd = proj
        extra = {"xd": torch.randint(0, 128, (1, ho * sd, wo * sd, cdin),
                                     generator=g, dtype=torch.int8).to(dev),
                 "down": entry(1, cdin, cout), "sd": sd}
    return x, entry(k, cin, cout), extra


def plain_cbr(x, e, stride, dilation, mode, out_f32, extra):
    """The plain version of one CBR_LINKS launch."""
    k = e["w"].shape[0]
    z = K.fma(K.qconv(x, e["w"], stride, dilation if k == 3 else 0,
                      dilation).float(), e["m"], e["c"])
    if mode == 1:
        z = K.fma(extra["res"].float(), extra["rr"], z)
    elif mode == 2:
        d = extra["down"]
        z = K.fma(K.qconv(extra["xd"], d["w"], extra["sd"], 0).float(),
                  d["m"], z) + d["c"]
    z = torch.relu(z)
    return z if out_f32 else K.requant(z)


def identity_links(x, blocks):
    """(name, input, entry, mode, residual, res_ratio) of each identity
    block's two links, with the plain version's codes as their inputs
    (made contiguous: the plain convs return NHWC views of NCHW memory,
    and the kernels read NHWC memory)."""
    out = []
    for i, e in enumerate(blocks):
        tag = "b" if i else ""
        t = K.apply_cbr(x, e["conv1"], 1, 1).contiguous()
        out.append((f"conv1{tag}", x, e["conv1"], 0, None, 0.0))
        out.append((f"conv2{tag}_res", t, e["conv2"], 1, x, e["res_ratio"]))
        x = K.apply_block(x, e, 1).contiguous()
    return out


MISMATCHES = []


def same_codes(what, have, want):
    """Record (and print) a mismatch instead of stopping at the first."""
    if torch.equal(have, want):
        return True
    d = (have.int() - want.int()).abs()
    msg = (f"{what}: {int((d > 0).sum())} of {d.numel()} codes differ, max "
           f"{int(d.max())}")
    print("  MISMATCH " + msg, flush=True)
    MISMATCHES.append(msg)
    return False


def plain_link(x, e, mode, res, rr):
    z = K.fma(K.qconv(x, e["w"], 1, 1).float(), e["m"], e["c"])
    if mode == 1:
        z = K.fma(res.float(), float(torch.tensor(rr, dtype=torch.float32)), z)
    return K.requant(torch.relu(z))


def parent_link(parent, kname, x, e, stride, mode, res=None, rr=0.0,
                xd=None, down=None):
    """One link of K2, K3, K5 or K6 launched as the other tree's wrapper
    launches it: on its tensor-core route where that tree has one (K3 and
    K6 from the resident-weight kernel's tree on, K2 and K5 from their
    shape checks' tree on), else on its CUDA-core conv."""
    tensor_cores = hasattr(parent, {"K2": "conv3x3s2_i8_shape_error",
                                    "K5": "down_block_i8_shape_error"}.get(
                                        kname, "RESIDENT_MAX_CIN"))
    if not tensor_cores:
        return parent._launch_conv(x, e, stride, 1, mode=mode, res=res,
                                   rr=rr, xd=xd, down=down, sd=2)
    if kname == "K2":
        return parent._launch_conv_mma_res(x, e, stride=2)
    if kname == "K3" or (kname == "K6"
                         and x.shape[3] <= parent.RESIDENT_MAX_CIN):
        return parent._launch_conv_mma_res(x, e, mode=mode, res=res, rr=rr)
    return parent._launch_conv_mma(x, e, stride, mode=mode, res=res, rr=rr,
                                   xd=xd, down=down, sd=2)


def links(x, e0, e1):
    """(name, input, entry, stride, mode, extra) of the four links, with
    this tree's intermediate codes as their inputs."""
    t = K._launch_conv_mma(x, e0["conv1"], 2)
    y = K._launch_conv_mma(t, e0["conv2"], 1, mode=2, xd=x, down=e0["down"],
                           sd=2)
    t2 = K._launch_conv_mma(y, e1["conv1"], 1)
    return [("conv1_s2", x, e0["conv1"], 2, 0, {}),
            ("conv2_proj", t, e0["conv2"], 1, 2,
             {"xd": x, "down": e0["down"]}),
            ("conv1b", y, e1["conv1"], 1, 0, {}),
            ("conv2b_res", t2, e1["conv2"], 1, 1,
             {"res": y, "rr": e1["res_ratio"]})]


def link_work(x, e, stride, mode, extra):
    _, h, w, cin = x.shape
    cout = e["w"].shape[3]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    ops = 2 * ho * wo * cout * 9 * cin
    n_bytes = x.numel() + e["w"].numel() + ho * wo * cout
    if mode == 2:
        ops += 2 * ho * wo * cout * extra["xd"].shape[3]
        n_bytes += extra["xd"].numel() + extra["down"]["w"].numel()
    if mode == 1:
        n_bytes += extra["res"].numel()
    return ops, n_bytes, (ho, wo, cout)


def bound_ms(ops, n_bytes, kind):
    return max(ops / PEAK[kind], n_bytes / HBM) * 1e3


# K10 at PSPNet-R50's pool input (480x480: the deep stem's 240x240x128), on
# K10_INPUTS distinct inputs and outputs (8 x 9.2 MB, more than the L2)
K10_SHAPE = (1, 240, 240, 128)
K10_INPUTS = 8
# ragged shapes every build is held to bit for bit: (shape, byte offset of
# the input from a 16-byte boundary)
K10_CHECKS = [((1, 239, 237, 64), 0), ((1, 15, 17, 16), 0),
              ((1, 1, 1, 16), 0), ((1, 2, 3, 16), 0), ((1, 9, 11, 20), 0),
              ((1, 31, 29, 4), 0), ((1, 17, 19, 32), 4)]


def k10_route(nargs, x, out):
    """The route argument of a tsg_maxpool_i8 whose entry point takes
    ``nargs`` arguments: none for the one-route kernel (8), else the bytes a
    load that ``maxpool_i8_route`` picks."""
    if nargs == 8:
        return ()
    return (K.maxpool_i8_route(x.shape[3], x.data_ptr(), out.data_ptr()),)


def k10_call(lib, nargs, x, out, route=None):
    """A closure of one direct tsg_maxpool_i8 call of ``lib`` into ``out``
    (on ``route`` where given, else the one ``k10_route`` picks)."""
    _, h, w, c = x.shape
    _, ho, wo, _ = out.shape
    args = (x.data_ptr(), h, w, c, out.data_ptr(), ho, wo,
            *((route,) if route else k10_route(nargs, x, out)), K._stream(x))

    def run():
        rc = lib.tsg_maxpool_i8(*args)
        if rc:
            raise RuntimeError(f"tsg_maxpool_i8: CUDA error {rc}")
    return run


def cycle(fns):
    """One closure that calls ``fns`` in turn, one a call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def k10_section(dev, libs, nargs, wrappers, builds, reps):
    """K10 in turns (see the module docstring); libs / nargs: {build:
    library / its entry point's argument count}; wrappers: {tree: its
    maxpool2d_3x3s2_i8}.  A two-route library of this tree is also run on
    its 4-byte route ("route4").  Returns the section's results."""
    g = torch.Generator(device=dev).manual_seed(10)
    forced = {}
    if nargs["change"] == 9:
        libs, nargs = {**libs, "route4": libs["change"]}, {**nargs,
                                                           "route4": 9}
        forced["route4"] = 4

    def codes(shape, offset=0):
        n = int(np.prod(shape))
        buf = torch.randint(-128, 128, (n + 16,), generator=g, device=dev,
                            dtype=torch.int8)
        x = buf[(-buf.data_ptr() + offset) % 16:][:n].view(shape)
        x.view(-1)[::97] = -128  # the pad identity among the codes
        return x

    xs = [codes(K10_SHAPE) for _ in range(K10_INPUTS)]
    want = [K.maxpool_i8(x) for x in xs]
    for b, lib in libs.items():
        outs = [torch.empty_like(w) for w in want]
        for x, o in zip(xs, outs):
            k10_call(lib, nargs[b], x, o, forced.get(b))()
        for shape, offset in K10_CHECKS:
            x = codes(shape, offset)
            ref = K.maxpool_i8(x)
            o = torch.empty_like(ref)
            k10_call(lib, nargs[b], x, o, forced.get(b))()
            torch.cuda.synchronize()
            same_codes(f"K10 {shape} (input {offset} bytes off 16) [{b}] "
                       f"vs plain", o, ref)
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            same_codes(f"K10 {K10_SHAPE} [{b}] vs plain", o, w)
    route = {b: (forced[b],) if b in forced else k10_route(
        nargs[b], xs[0], want[0]) for b in libs}
    print("K10 route at " + str(K10_SHAPE) + ": " + ", ".join(
        f"{b} {f'{r[0]}-byte' if r else 'one route (4-byte)'}"
        for b, r in route.items()), flush=True)
    for b in libs:
        for fn, row in builds.get(b, {}).items():
            if "maxpool" in fn:
                print(f"  [{b}] {fn}: registers {row['registers']}, SASS "
                      f"instructions {row.get('instructions')}, global loads "
                      f"{row.get('LDG')} ({row.get('LDG.128')} of 16 bytes)",
                      flush=True)

    outs = {b: [torch.empty_like(w) for w in want] for b in libs}
    calls = {b: cycle([k10_call(libs[b], nargs[b], x, o, forced.get(b))
                       for x, o in zip(xs, outs[b])]) for b in libs}
    ends = ["parent"] if "parent" in libs else []
    order = ends + ["change"] + [b for b in libs if b not in (
        "parent", "change")] + ["change"] + ends
    n_calls = 6 * K10_INPUTS
    dev_ms, ev_ms = {}, {}
    for b in order:
        dev_ms.setdefault(b, []).append(device_ms(calls[b], calls=n_calls))
        ev_ms.setdefault(b, []).append(cuda_ms(calls[b], reps))
    wrap = {t: cycle([lambda x=x, fn=fn: fn(x) for x in xs])
            for t, fn in wrappers.items()}
    wrap_ev, wrap_dev = {}, {}
    for t in ends + ["change", "change"] + ends:
        wrap_ev.setdefault(t, []).append(cuda_ms(wrap[t], reps))
        wrap_dev.setdefault(t, []).append(device_ms(wrap[t], calls=n_calls))

    # what the card does with the same bytes and with almost none: PyTorch's
    # copy moving 9.2 MB (half of K10's input bytes read, as many written)
    # over the same eight buffers, and a one-element fill (the least device
    # time the profiler gives a kernel)
    half_n = (xs[0].numel() + want[0].numel()) // 2
    dsts = [torch.empty(half_n, dtype=torch.int8, device=dev) for _ in xs]
    one = torch.empty(1, device=dev)
    floor = {
        "copy_same_bytes": device_ms(cycle(
            [lambda x=x, d=d: d.copy_(x.view(-1)[:half_n])
             for x, d in zip(xs, dsts)]), calls=n_calls),
        "fill_one_element": device_ms(lambda: one.fill_(0.0), calls=n_calls)}
    del dsts
    halves = [x.half() for x in xs]
    nchw = [h.permute(0, 3, 1, 2).contiguous() for h in halves]
    for h, w in zip(halves, want):
        lib_out = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1)
        same_codes("F.max_pool2d on the float16 copy vs plain",
                   lib_out.permute(0, 2, 3, 1).to(torch.int8), w)
    lib_parts = {}
    library = {
        "max_pool2d_nhwc_view": device_ms(cycle(
            [lambda h=h: F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1)
             for h in halves]), calls=n_calls, parts=lib_parts),
        "max_pool2d_nchw": device_ms(cycle(
            [lambda h=h: F.max_pool2d(h, 3, 2, 1) for h in nchw]),
            calls=n_calls),
        "cast_to_float16": device_ms(cycle(
            [lambda x=x: x.half() for x in xs]), calls=n_calls)}

    n_bytes = xs[0].numel() + want[0].numel()
    bnd = n_bytes / HBM * 1e3
    best = {b: min(v) for b, v in dev_ms.items()}
    print(f"K10 maxpool2d_3x3s2_i8 {K10_SHAPE} -> {tuple(want[0].shape)}, "
          f"{K10_INPUTS} inputs in turn; bound {bnd:.5f} ms (bytes: "
          f"{n_bytes / 1e6:.2f} MB at 3.35 TB/s)", flush=True)
    for b in dev_ms:
        print(f"  [{b}] device (profiler) {dev_ms[b]} ms = "
              f"{100 * bnd / best[b]:.1f} % of the bound, "
              f"{n_bytes / best[b] / 1e9:.3f} TB/s; CUDA events "
              f"(back-to-back direct calls) {ev_ms[b]} ms", flush=True)
    for t in wrap_ev:
        print(f"  [{t} wrapper] CUDA events {wrap_ev[t]} ms (the wrapper's "
              f"host time included); device (profiler) {wrap_dev[t]} ms",
              flush=True)
    print("  the card with the same bytes, device (profiler): " + ", ".join(
        f"{k} {v:.5f} ms" for k, v in floor.items()), flush=True)
    print("  library yardstick, device (profiler): " + ", ".join(
        f"{k} {v:.5f} ms" for k, v in library.items())
        + f"; kernels {lib_parts}", flush=True)
    if "parent" in best:
        print(f"  this tree / other tree, device: "
              f"{best['change'] / best['parent']:.3f}", flush=True)
    return {"shape": K10_SHAPE, "bytes": n_bytes, "bound_ms": bnd,
            "route": {b: (r[0] if r else 4) for b, r in route.items()},
            "device_ms": dev_ms, "event_ms": ev_ms,
            "wrapper_event_ms": wrap_ev, "wrapper_device_ms": wrap_dev,
            "library_device_ms": library, "floor_device_ms": floor,
            "registers": {b: {fn: row["registers"] for fn, row in
                              builds.get(b, {}).items() if "maxpool" in fn}
                          for b in libs}}


def forward_ms(entry_mod, dev, rounds, psp=False):
    """(median, p90) CUDA-event ms of one main-path forward (or, with
    ``psp``, one PSPNet-R50 forward at 480x480) of the tree whose ``entry``
    module this is, over four seeded images."""
    i8 = importlib.import_module(entry_mod.__name__.rsplit(".", 1)[0]
                                 + ".deploy.int8_serve")
    rng = np.random.default_rng(1)
    if psp:
        infer, (pkg, _) = entry_mod.serve_entry(device=dev)
        cfg = entry_mod.get_experiment(entry_mod.PSP_EXPERIMENT)
        xss = [i8.prepare_u8_input(
            rng.integers(0, 256, (1, 480, 480, 3), dtype=np.uint8),
            image_mean=cfg.image_mean, device=dev) for _ in range(4)]
    else:
        infer, (pkg, _) = entry_mod.entry(device=dev)
        cfg = entry_mod.get_experiment(entry_mod.EXPERIMENT)
        xss = [i8.prepare_s2d_input_u8(
            rng.integers(0, 256, (1, 1024, 2048, 3), dtype=np.uint8),
            image_mean=cfg.image_mean, device=dev) for _ in range(4)]

    def run():
        for x in xss:
            infer(pkg, x)
        marks = []
        for _ in range(rounds):
            for x in xss:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                infer(pkg, x)
                ev[1].record()
                marks.append(ev)
        torch.cuda.synchronize()
        t = sorted(a.elapsed_time(b) for a, b in marks)
        return statistics.median(t), t[int(0.9 * (len(t) - 1))]
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="another checkout to time against (the parent)")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--forward", type=int, default=0,
                    help="rounds of the main-path forward timing (0: none)")
    ap.add_argument("--psp-forward", type=int, default=0,
                    help="rounds of the PSPNet-R50 forward timing (0: none)")
    ap.add_argument("--k10-only", action="store_true",
                    help="K10 and the forward timings only")
    ap.add_argument("--sass", default=None,
                    help="write this tree's SASS of the K10 kernels here")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    variants = {}
    for v in args.variant:
        name, _, spec = v.partition(":")
        variants[name] = dict(kv.split("=") for kv in spec.split(",") if kv)
    lib = _build.ready(dev.index)
    log = _build.BuildInfo.logs.get("int8_serve_kernels")
    so = _build.BuildInfo.paths["int8_serve_kernels"]
    if not log:  # a cached library: build the same source once more
        so, log = build_variants({"this_tree": {}})["this_tree"]
    builds = {"change": report_build("change", so, log)}
    if args.sass:
        dump_pool_sass(so, args.sass)
    check_imma("change", builds["change"])
    print(f"  [change] dynamic shared memory: K1 "
          f"{lib.tsg_stem_smem_bytes(128, 64)} B, K4 "
          f"{lib.tsg_conv_mma_smem_bytes()} B a block", flush=True)
    libs = {"change": lib}
    for name, (so, log) in build_variants(variants).items():
        builds[name] = report_build(name, so, log)
        check_imma(name, builds[name])
        libs[name] = load_lib(so)
    parent = parent_lib = None
    if args.root:
        parent = import_tree(args.root, "tsg_parent")
        parent_build = importlib.import_module("tsg_parent.ops.kernels._build")
        parent_lib = parent_build.ready(dev.index)
        if len(parent_build.LIBRARIES["int8_serve_kernels"][
                "tsg_conv_i8_mma"]) == 24:
            OLD_ABI.add(id(parent_lib))
        builds["parent"] = report_build(
            "parent", parent_build.BuildInfo.paths["int8_serve_kernels"],
            parent_build.BuildInfo.logs.get("int8_serve_kernels", ""))

    k10_libs = dict(libs)
    nargs = dict.fromkeys(libs, len(
        _build.LIBRARIES["int8_serve_kernels"]["tsg_maxpool_i8"]))
    wrappers = {"change": K.maxpool2d_3x3s2_i8}
    if parent:
        k10_libs["parent"] = parent_lib
        nargs["parent"] = len(
            parent_build.LIBRARIES["int8_serve_kernels"]["tsg_maxpool_i8"])
        wrappers["parent"] = parent.maxpool2d_3x3s2_i8
    results = {"maxpool2d_3x3s2_i8": k10_section(dev, k10_libs, nargs,
                                                  wrappers, builds,
                                                  args.reps)}
    if args.k10_only:
        forward_section(args, dev, parent, results)
        return finish(args, smi, variants, builds, results)

    stem, stages, identity, spatial, k5 = operands(dev)

    def turns(item, calls, check):
        """calls: {build: fn}; order parent, change, variants, change,
        parent; returns {build: [ms, ...]}."""
        ends = ["parent"] if "parent" in calls else []
        order = ends + ["change"] + [
            v for v in calls if v not in ("parent", "change")] + ["change"] + ends
        times = {}
        for b in order:
            times.setdefault(b, []).append(cuda_ms(calls[b], args.reps))
        for b in calls:
            check(b)
        results[item] = times
        return times

    # K1 at the main path's shape
    sp = torch.empty((1, H2, W2, 64), dtype=torch.int8, device=dev)
    pooled = torch.empty((1, H2 // 2, W2 // 2, 64), dtype=torch.int8,
                         device=dev)
    stem_out = {}

    def stem_call(b):
        def run():
            if b == "parent":
                stem_out[b] = parent.stem_pool_i8(stem["xs"], stem["wf"],
                                                  stem["m"], stem["c"], 64)
                return
            rc = libs[b].tsg_stem_pool_i8(
                stem["xs"].data_ptr(), stem["wf"].data_ptr(),
                stem["m"].data_ptr(), stem["c"].data_ptr(), sp.data_ptr(),
                pooled.data_ptr(), H2, W2, 12, 128, 64, K._stream(sp))
            if rc:
                raise RuntimeError(f"tsg_stem_pool_i8: CUDA error {rc}")
            stem_out[b] = (sp, pooled)  # checked before the next call
        return run

    ref = K.stem_pool_i8_plain(stem["xs"], stem["wf"], stem["m"], stem["c"],
                               64)

    def stem_check(b):
        stem_call(b)()
        torch.cuda.synchronize()
        n_diff = worst = 0
        for a, r in zip(stem_out[b], ref):
            d = (a.int() - r.int()).abs()
            worst = max(worst, int(d.max()))
            n_diff += int((d > 0).sum())
        share = n_diff / sum(r.numel() for r in ref)
        print(f"  K1 [{b}] vs plain: max {worst} code(s), share {share:.3e}")
        if worst > 1 or share > 1e-3:
            raise SystemExit(f"K1 [{b}] misses its bar")

    calls = {b: stem_call(b) for b in libs}
    if parent:
        calls["parent"] = stem_call("parent")
    t = turns("stem_pool_i8", calls, stem_check)
    ops, n_bytes = 2 * H2 * W2 * 128 * 147, stem["xs"].numel() + H2 * W2 * 80
    print(f"stem_pool_i8 (1, {H2 + 3}, {W2 + 3}, 12): " + ", ".join(
        f"{b} {ms}" for b, ms in t.items()) + f" ms; bound "
        f"{bound_ms(ops, n_bytes, 'bf16'):.5f} ms (bf16, 7x7x3 MACs as "
        f"chip_smoke counts them)", flush=True)

    for sname, (x, e0, e1) in stages.items():
        for name, xin, e, stride, mode, extra in links(x, e0, e1):
            ops, n_bytes, (ho, wo, cout) = link_work(xin, e, stride, mode,
                                                     extra)
            outs = {b: torch.empty((1, ho, wo, cout), dtype=torch.int8,
                                   device=dev) for b in libs}

            outs["parent"] = torch.empty_like(outs["change"])

            def link_call(b):
                if b == "parent":  # its library, without its wrapper
                    return lambda: mma_call(parent_lib, xin, e, stride,
                                            outs[b], mode, extra.get("res"),
                                            extra.get("rr", 0.0),
                                            extra.get("xd"),
                                            extra.get("down"), split=0)
                return lambda: mma_call(libs[b], xin, e, stride, outs[b],
                                        mode, extra.get("res"),
                                        extra.get("rr", 0.0),
                                        extra.get("xd"), extra.get("down"))

            want = K._launch_conv_mma(xin, e, stride, mode=mode, sd=2,
                                      **{k: v for k, v in extra.items()})

            def link_check(b):
                link_call(b)()
                torch.cuda.synchronize()
                same_codes(f"{sname} {name} [{b}] vs this tree's codes",
                           outs[b], want)

            calls = {b: link_call(b) for b in libs}
            if parent:
                calls["parent"] = link_call("parent")
            item = f"{sname}:{name}"
            t = turns(item, calls, link_check)
            bnd = bound_ms(ops, n_bytes, "int8")
            best = min(min(v) for b, v in t.items() if b != "parent")
            print(f"{item} {tuple(xin.shape)} -> {cout} (stride {stride}, "
                  f"mode {mode}): " + ", ".join(
                      f"{b} {ms}" for b, ms in t.items())
                  + f" ms; bound {bnd:.5f} ms ({ops / 1e9:.2f} G int8 ops); "
                  f"this tree {ops / best / 1e9:.1f} TOP/s", flush=True)
        calls = {"change": lambda: K.down_stage_i8(x, e0, e1)}
        if parent:
            calls["parent"] = lambda: parent.down_stage_i8(x, e0, e1)
        want = K.down_stage_i8_plain(x, e0, e1)

        def stage_check(b):
            same_codes(f"{sname} down stage [{b}] vs plain", calls[b](),
                       want)

        t = turns(f"{sname}:down_stage_i8", calls, stage_check)
        print(f"{sname} down_stage_i8 (four launches, wrapper included): "
              + ", ".join(f"{b} {ms}" for b, ms in t.items()) + " ms",
              flush=True)

    for kname, (x, blocks) in identity.items():
        c = x.shape[3]
        route = "resident" if c <= K.RESIDENT_MAX_CIN else "split"
        alt = "stream" if route == "resident" else "split1"
        for name, xin, e, mode, res, rr in identity_links(x, blocks):
            out_shape = (1, *xin.shape[1:3], c)
            outs = {b: torch.empty(out_shape, dtype=torch.int8, device=dev)
                    for b in [*libs, alt]}
            got = {}

            def link_call(b):
                if b == "parent":
                    def run():
                        got[b] = parent_link(parent, kname, xin, e, 1, mode,
                                             res=res, rr=rr)
                    return run
                if b == alt:
                    return lambda: mma_call(libs["change"], xin, e, 1,
                                            outs[b], mode, res, rr,
                                            split=1)
                if route == "resident":
                    return lambda: res_call(libs[b], xin, e, outs[b], mode,
                                            res, rr)
                return lambda: mma_call(libs[b], xin, e, 1, outs[b], mode,
                                        res, rr, split=0)

            want = plain_link(xin, e, mode, res, rr)

            def link_check(b):
                link_call(b)()
                torch.cuda.synchronize()
                same_codes(f"{kname} {name} [{b}] vs plain",
                           got.get(b, outs.get(b)), want)

            calls = {b: link_call(b) for b in [*libs, alt]}
            if parent:
                calls["parent"] = link_call("parent")
            item = f"{kname}:{name}"
            t = turns(item, calls, link_check)
            ops, n_bytes, _ = link_work(
                xin, e, 1, mode, {"res": res} if mode == 1 else {})
            bnd = bound_ms(ops, n_bytes, "int8")
            best = min(min(v) for b, v in t.items() if b not in ("parent",
                                                                  alt))
            print(f"{item} {tuple(xin.shape)} -> {c} (mode {mode}, {route}): "
                  + ", ".join(f"{b} {ms}" for b, ms in t.items())
                  + f" ms; bound {bnd:.5f} ms ({ops / 1e9:.2f} G int8 ops); "
                  f"this tree {ops / best / 1e9:.1f} TOP/s", flush=True)
        wrapper = "l1_stage_i8" if kname == "K3" else "res_block_i8"
        calls = {"change": lambda: getattr(K, wrapper)(x, *blocks)}
        if parent:
            calls["parent"] = lambda: getattr(parent, wrapper)(x, *blocks)
        want = getattr(K, wrapper + "_plain")(x, *blocks)

        def whole_check(b):
            same_codes(f"{kname} {wrapper} [{b}] vs plain", calls[b](), want)

        t = turns(f"{kname}:{wrapper}", calls, whole_check)
        ops = 2 * x.shape[1] * x.shape[2] * c * 9 * c * 2 * len(blocks)
        n_bytes = 2 * x.numel() + sum(e[k]["w"].numel() for e in blocks
                                      for k in ("conv1", "conv2"))
        print(f"{kname} {wrapper} ({2 * len(blocks)} launches, wrapper "
              f"included): " + ", ".join(f"{b} {ms}" for b, ms in t.items())
              + f" ms; bound {bound_ms(ops, n_bytes, 'int8'):.5f} ms "
              f"({ops / 1e9:.2f} G int8 ops)", flush=True)

    # K2's two launches and K5's two links: (item, input, entry, stride,
    # mode, extra, the plain codes), the plain version's codes as inputs
    x, p1, p2 = spatial
    s1 = K.conv3x3s2_i8_plain(x, p1["w"], p1["m"], p1["c"]).contiguous()
    x5, e5 = k5
    t5 = K.apply_cbr(x5, e5["conv1"], 2, 1).contiguous()
    new_links = [
        ("K2:sp1", x, p1, 2, 0, {}, s1),
        ("K2:sp2", s1, p2, 2, 0, {},
         K.conv3x3s2_i8_plain(s1, p2["w"], p2["m"], p2["c"])),
        ("K5:conv1_s2", x5, e5["conv1"], 2, 0, {}, t5),
        ("K5:conv2_proj", t5, e5["conv2"], 1, 2,
         {"xd": x5, "down": e5["down"]}, K.apply_block(x5, e5, 2))]
    for item, xin, e, stride, mode, extra, want in new_links:
        ops, n_bytes, (ho, wo, cout) = link_work(xin, e, stride, mode, extra)
        alt = "stream" if item.startswith("K2") else "split1"
        outs = {b: torch.empty((1, ho, wo, cout), dtype=torch.int8,
                               device=dev) for b in [*libs, alt]}
        got = {}

        def link_call(b):
            if b == "parent":
                def run():
                    got[b] = parent_link(parent, item[:2], xin, e, stride,
                                         mode, xd=extra.get("xd"),
                                         down=extra.get("down"))
                return run
            if item.startswith("K2") and b != alt:
                return lambda: res_call(libs[b], xin, e, outs[b], stride=2)
            return lambda: mma_call(
                libs["change"] if b == alt else libs[b], xin, e, stride,
                outs[b], mode, xd=extra.get("xd"), down=extra.get("down"),
                split=1 if b == "split1" else 0)

        def link_check(b):
            link_call(b)()
            torch.cuda.synchronize()
            same_codes(f"{item} [{b}] vs plain", got.get(b, outs.get(b)),
                       want)

        calls = {b: link_call(b) for b in [*libs, alt]}
        if parent:
            calls["parent"] = link_call("parent")
        t = turns(item, calls, link_check)
        bnd = bound_ms(ops, n_bytes, "int8")
        best = min(min(v) for b, v in t.items() if b not in ("parent", alt))
        print(f"{item} {tuple(xin.shape)} -> {cout} (stride {stride}, mode "
              f"{mode}): " + ", ".join(f"{b} {ms}" for b, ms in t.items())
              + f" ms; bound {bnd:.5f} ms ({ops / 1e9:.2f} G int8 ops, "
              f"{n_bytes / 1e6:.1f} MB); this tree {ops / best / 1e9:.1f} "
              f"TOP/s", flush=True)
    for item, fn, fargs, want in (
            ("K2:spatial_path_i8", "spatial_path_i8", (x, p1, p2),
             K.conv3x3s2_i8_plain(s1, p2["w"], p2["m"], p2["c"])),
            ("K5:down_block_i8", "down_block_i8", (x5, e5),
             K.apply_block(x5, e5, 2))):
        calls = {"change": lambda: getattr(K, fn)(*fargs)}
        if parent:
            calls["parent"] = lambda: getattr(parent, fn)(*fargs)

        def whole_check(b):
            same_codes(f"{item} [{b}] vs plain", calls[b](), want)

        t = turns(item, calls, whole_check)
        print(f"{item} (two launches, wrapper included): " + ", ".join(
            f"{b} {ms}" for b, ms in t.items()) + " ms", flush=True)

    # cbr_i8's and bottleneck_i8's launches on each route: the resident
    # kernel (up to 64 input channels, modes 0 and 1), the streaming one by
    # the host's split rule (split0), unsplit (split1) and split over two
    # blocks (split2); "change" is the route the wrappers pick (conv_route;
    # a projection streams whole); the other tree's CUDA-core
    # conv_i8_kernel (its _launch_conv) where it has one
    g = torch.Generator().manual_seed(1)
    cbr_total = {}
    for link in CBR_LINKS:
        item, (h, w, cin), k, cout, stride, dil, mode, f32, _ = link
        x, e, extra = cbr_operands(g, dev, link)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        resident_ok = cin <= K.RESIDENT_MAX_CIN and mode <= 1 and stride <= 2
        rule = "split1" if mode == 2 else K.conv_route(
            cin, cout, ho, wo, k, stride, mode, _build.sm_count(dev.index))
        routes = (["resident"] if resident_ok else []) + [
            "split0", "split1", "split2"]
        outs = {r: torch.empty((1, ho, wo, cout), device=dev,
                               dtype=torch.float32 if f32 else torch.int8)
                for r in routes}
        got = {}

        def route_call(r):
            if r == "parent":
                def run():
                    got[r] = parent._launch_conv(
                        x, e, stride, dil if k == 3 else 0, mode=mode,
                        res=extra.get("res"), rr=extra.get("rr", 0.0),
                        xd=extra.get("xd"), down=extra.get("down"),
                        sd=extra.get("sd", 1), dil=dil, out_f32=f32)
                return run
            if r == "resident":
                return lambda: res_call(lib, x, e, outs[r], mode,
                                        extra.get("res"),
                                        extra.get("rr", 0.0), stride, dil)
            return lambda: mma_call(lib, x, e, stride, outs[r], mode,
                                    extra.get("res"), extra.get("rr", 0.0),
                                    extra.get("xd"), extra.get("down"),
                                    split=int(r[-1]), dilation=dil,
                                    sd=extra.get("sd", 1))

        want = plain_cbr(x, e, stride, dil, mode, f32, extra)

        def route_check(r):
            r = rule if r == "change" else r
            route_call(r)()
            torch.cuda.synchronize()
            have = got.get(r, outs.get(r))
            if not torch.equal(have, want):
                msg = (f"{item} [{r}] vs plain: "
                       f"{int((have != want).sum())} of {want.numel()} differ")
                print("  MISMATCH " + msg, flush=True)
                MISMATCHES.append(msg)

        calls = {"change": route_call(rule)}
        calls.update({r: route_call(r) for r in routes if r != rule})
        if parent and hasattr(parent, "_launch_conv"):
            calls["parent"] = route_call("parent")
        t = turns(item, calls, route_check)
        ops = 2 * ho * wo * cout * k * k * cin
        n_bytes = x.numel() + e["w"].numel() + outs[routes[0]].nbytes
        if mode == 1:
            n_bytes += extra["res"].numel()
        elif mode == 2:
            ops += 2 * ho * wo * cout * extra["xd"].shape[3]
            n_bytes += extra["xd"].numel() + extra["down"]["w"].numel()
        best = min(t["change"])
        n = CBR_LAUNCHES.get(item, 1)
        for b, v in t.items():
            cbr_total.setdefault(item[:3], {}).setdefault(b, 0.0)
            cbr_total[item[:3]][b] += n * min(v)
        print(f"{item} {(1, h, w, cin)} -> {cout} (k {k}, stride {stride}, "
              f"dilation {dil}, mode {mode}, {'float32' if f32 else 'codes'};"
              f" change = {rule}; x{n} a forward): " + ", ".join(
                  f"{b} {ms}" for b, ms in t.items())
              + f" ms; bound {bound_ms(ops, n_bytes, 'int8'):.5f} ms "
              f"({ops / 1e9:.3f} G int8 ops, {n_bytes / 1e6:.1f} MB); this "
              f"tree {ops / best / 1e9:.1f} TOP/s", flush=True)
    for path, v in cbr_total.items():
        print(f"{path} convs, a forward's launches (sum of each route's best "
              f"time x launches): " + ", ".join(
                  f"{b} {ms:.4f}" for b, ms in v.items()) + " ms", flush=True)

    forward_section(args, dev, parent, results)
    finish(args, smi, variants, builds, results)


def forward_section(args, dev, parent, results):
    """The main-path and PSPNet forwards of both trees in turns (other,
    this, this, other), ``--forward`` / ``--psp-forward`` rounds each."""
    trees = {"change": importlib.import_module("torchseg_tpu_torch.entry")}
    if parent:
        trees["parent"] = importlib.import_module("tsg_parent.entry")
    for key, rounds, psp in (("main_path", args.forward, False),
                             ("pspnet", args.psp_forward, True)):
        if not rounds:
            continue
        runs = {b: forward_ms(mod, dev, rounds, psp)
                for b, mod in trees.items()}
        order = (["parent"] if parent else []) + ["change", "change"] + (
            ["parent"] if parent else [])
        fwd = {}
        for b in order:
            fwd.setdefault(b, []).append(runs[b]())
        results[f"{key}_forward_median_p90"] = fwd
        print(f"{key} forward (median, p90) ms: " + ", ".join(
            f"{b} {v}" for b, v in fwd.items()), flush=True)


def finish(args, smi, variants, builds, results):
    """Print (and write to ``--out``) the JSON line; exit non-zero on any
    mismatch."""
    line = json.dumps({"card": smi, "reps": args.reps, "variants": variants,
                       "builds": builds, "ms": results})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if MISMATCHES:
        raise SystemExit(f"{len(MISMATCHES)} mismatches: {MISMATCHES}")


if __name__ == "__main__":
    main()
