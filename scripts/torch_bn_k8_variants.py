#!/usr/bin/env python3
"""K8 (``csrc/bn_kernels.cu``, one launch with its fold) built with other
values of its tuning constants, timed at every distinct BN input shape of
the DFN-R101 and BiSeNet-R18 training steps, on a CUDA card.

    python scripts/torch_bn_k8_variants.py \
        --variant repo: \
        --variant g32:kGroupElems=32 \
        --variant occ8:kMinBlocks=8,kMinSlice=8192

A variant is ``name:NAME=value,...``: each NAME is a ``constexpr`` of the
source (``kGroupElems``, ``kMinBlocks``, ``kMinSlice``, ``kMaxCluster``,
``kTinyRun``, ...), replaced in a copy that nvcc builds with the repo's
flags (all variants at once) into ``torchseg_tpu_torch/_build/variants``.
Each variant's ``tsg_channel_sums`` is called on the same seeded float32
inputs and BN operands ``--reps`` times a shape under ``torch.profiler``
(device time of the ``channel_sums`` kernels a call), its (mean, inv, a, b,
d) checked against the repo build's to float32 rounding, and the step sums
counted as in ``torch_bn_kernel_shapes.py``.  Prints the card's name and
power limit, a table and one JSON line (also to ``--out``).  Needs a card
and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bn_kernel_shapes as shapes  # noqa: E402

from torchseg_tpu_torch.ops.kernels import _build  # noqa: E402


def variant_source(text, assignments):
    for name, value in assignments.items():
        text, n = re.subn(rf"(constexpr (?:int|long long) {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"no single constexpr {name} in the source")
    return text


def build(variants):
    """{name: loaded library}, one nvcc per variant, all at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "bn_kernels.cu")) as f:
        text = f.read()
    jobs = {}
    for name, assignments in variants.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, assignments))
        so = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  log)})
        print(f"variant {name}: {variants[name]}; registers per kernel "
              f"{regs}", flush=True)
        lib = ctypes.CDLL(so)
        fn = lib.tsg_channel_sums
        fn.argtypes = _build.LIBRARIES["bn_kernels"]["tsg_channel_sums"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    variants = {}
    for v in args.variant:
        name, _, spec = v.partition(":")
        variants[name] = dict(kv.split("=") for kv in spec.split(",") if kv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build(variants)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for shape in sorted({s for s, _ in shapes.DFN + shapes.BISENET}):
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        n, c, h, w = shape
        bn = (torch.ones(c, device=dev), torch.zeros(c, device=dev),
              torch.zeros(c, device=dev), torch.ones(c, device=dev))
        ref = B.channel_sum_sumsq(x, (*[t.clone() for t in bn], None, 1e-5,
                                      0.1))
        rows[str(shape)] = {}
        for name, fn in libs.items():
            out = torch.empty((5, c), device=dev)
            operands = [t.clone() for t in bn]  # alive while timed
            ptrs = [t.data_ptr() for t in operands]

            def call(fn=fn, out=out, ptrs=ptrs, operands=operands):
                rc = fn(x.data_ptr(), n, c, h * w, 0, out.data_ptr(), *ptrs,
                        None, 1e-5, 0.1, stream)
                if rc:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")

            us = shapes.kernel_us(call, (), "channel_sums", args.reps)
            torch.cuda.synchronize()
            if not torch.allclose(out[0], ref[0], rtol=1e-5, atol=1e-6):
                raise SystemExit(f"variant {name} {shape}: mean differs")
            rows[str(shape)][name] = us
        print(f"{str(shape):20s}" + "".join(
            f" {name} {us:7.2f}" for name, us in rows[str(shape)].items()),
            flush=True)
    steps = {step: {name: sum(rows[str(s)][name] * k for s, k in sh) / 1e3
                    for name in libs}
             for step, sh in (("dfn_r101", shapes.DFN),
                              ("bisenet_r18", shapes.BISENET))}
    for step, t in steps.items():
        print(f"{step} per step, ms: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in t.items()), flush=True)
    line = json.dumps({"card": smi, "variants": variants, "shapes_us": rows,
                       "steps_ms": steps})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
