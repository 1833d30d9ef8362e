#!/usr/bin/env python3
"""K12 (``focal_fwd_kernel``) and K13 (``focal_bwd_kernel``), the
multi-class sigmoid focal loss, on a CUDA card at DFN-R101's smooth-head
shape: this tree's kernels against another checkout's (``--root``, e.g.
the parent commit unpacked with ``git archive`` under ``_archive/``) in
turns, in one process, on one card.

    python scripts/torch_focal_probe.py --root _archive/parent \\
        --out focal_probe.json [--variant t512:kThreads=512]

Shape: (1,280,000, 19) logits (2 x 800 x 800 pixels, 19 classes; N(0, 3^2)
values) with int32 targets in [-1, 19] (10 % ignored, 10 % background),
in float32 and in bf16.  Cases: K12; K13 with the stride-0 dloss of a
sum (one float, the training path's) and with a dense float32 dloss.

Both trees' ``focal_loss.cu`` are compiled here with the build's flags
(one nvcc each, at once, into ``_build/probe``), and so is each
``--variant name:NAME=value,...``: this tree's source with those
``constexpr int`` values (e.g. ``kThreads``).  For each library it prints ptxas's
registers and spills of each kernel and the static SASS instruction count
(``cuobjdump -sass``) of each loop body, per element: a loop is a backward
branch; the one with 128-bit global loads processes 16 elements a trip
(``kChunk``), any other one element.  Every library's output is held
against the plain version (1e-5 of max |value| + 1e-6; bf16 gradients
2^-7).  Times: each library's entry point is called directly (no Python
wrapper) ``--reps`` times back to back, CUDA events, in turns: other
tree, this tree, the variants, this tree, other tree; then
``torch.profiler``'s device time per call of each, the achieved TB/s (the
bytes of ``chip_smoke``'s bound: each input read once, each output
written once) and the share of the bytes bound at 3.35 TB/s.  The plain
versions (the eager formula) are timed once each.  Prints the card's
name and power limit and one JSON line (also to ``--out``).  Needs a card
and nvcc.
"""

import argparse
import importlib
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

from torch_stem_upsample_probe import (  # noqa: E402
    compile_libs,
    device_ms,
    event_ms,
    import_tree,
    load_lib,
    ptxas,
    variant_source,
)

from torchseg_tpu_torch.ops.kernels import _build  # noqa: E402
from torchseg_tpu_torch.ops.kernels import focal_loss as FL  # noqa: E402

N, C = 2 * 800 * 800, 19
HBM = 3.35e12  # bytes/s, H100 SXM
CHUNK = 16  # this tree's kChunk: elements a trip of the 16-byte loop
ARGS = _build.LIBRARIES["focal_loss"]


def loop_counts(so):
    """{kernel: [(instructions, 128-bit global loads), ...]} of each
    backward branch's loop body in ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if fn and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                wide = sum(1 for t in body if re.search(r"\bLDG\S*\.128\b",
                                                        t))
                loops.append((len(body), wide))
        out[fn] = loops
    return out


def per_element(loops):
    """Instructions an element of each loop: /CHUNK for a loop with 128-bit
    loads, /1 otherwise."""
    return [round(n / (CHUNK if wide else 1), 2) for n, wide in loops]


def short(fn):
    """'fwd f32 i32 g2', 'bwd bf16 i64 scalar-g pow', ... from a mangled
    name (g2: the gamma == 2 kernel, pow: any other gamma)."""
    m = re.search(r"focal_(fwd|bwd)_kernelI(f|13__nv_bfloat16)([il])", fn)
    if not m:
        return fn[:60]
    flags = re.findall(r"Lb([01])E", fn)
    g = ""
    if m.group(1) == "bwd" and len(flags) == 2:
        g = " scalar-g" if flags.pop(0) == "1" else " dense-g"
    sq = {"1": " g2", "0": " pow"}.get(flags[0], "") if flags else ""
    return (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'} "
            f"{'i32' if m.group(3) == 'i' else 'i64'}{g}{sq}")


def dump_sass(so, names, path):
    """Write the ``cuobjdump -sass`` listing of the kernels whose short
    name is in ``names`` to ``path``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    keep, out = False, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            keep = short(m.group(1)) in names
        if keep:
            out.append(line)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def operands(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(13)
    x = (torch.randn(N, C, generator=g, device=dev) * 3).to(dtype)
    u = torch.rand(N, generator=g, device=dev)
    lab = torch.randint(1, C + 1, (N,), generator=g, device=dev)
    t = torch.where(u < 0.1, -1, torch.where(u < 0.2, 0, lab)).to(
        torch.int32)
    dense = torch.randn(N, C, generator=g, device=dev)
    return x, t, dense


def call(lib, case, x, t, g, out):
    """A closure of one direct call of ``lib``'s entry point for ``case``
    ("fwd", "bwd_scalar", "bwd_dense")."""
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    consts = (N, C, 2.0, 1, 0.25, 0.75)
    if case == "fwd":
        def run():
            return lib.tsg_focal_fwd(x.data_ptr(), bf16, t.data_ptr(), 0,
                                     *consts, out.data_ptr(), stream)
    else:
        scalar = int(case == "bwd_scalar")

        def run():
            return lib.tsg_focal_bwd(x.data_ptr(), bf16, t.data_ptr(), 0,
                                     g.data_ptr(), scalar, *consts,
                                     out.data_ptr(), stream)

    def checked():
        rc = run()
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
    return checked


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout (e.g. the parent commit)")
    ap.add_argument("--variant", action="append", default=[],
                    help="name:NAME=value,... (constexpr ints of this "
                         "tree's focal_loss.cu)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None,
                    help="write this tree's SASS of the float32, int32, "
                         "gamma == 2 kernels to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import_tree(args.root, "other_tree")
    other_build = importlib.import_module("other_tree.ops.kernels._build")
    sources = {}
    for tag, csrc in (("other", other_build.CSRC_DIR),
                      ("this", _build.CSRC_DIR)):
        with open(os.path.join(csrc, "focal_loss.cu")) as f:
            sources[tag] = f.read()
    for spec in args.variant:
        vname, _, rest = spec.partition(":")
        assign = dict(kv.split("=") for kv in rest.split(","))
        text, held = variant_source(sources["this"], assign)
        if set(held) != set(assign):
            raise SystemExit(f"variant {vname}: no constexpr "
                             f"{set(assign) - set(held)}")
        sources[vname] = text
    built = compile_libs({f"focal_{t}": s for t, s in sources.items()})
    libs = {}
    result = {"card": smi, "shape": [N, C], "build": {}, "cases": {},
              "plain_ms": {}}
    if args.sass:
        dump_sass(built["focal_this"][0], {"fwd f32 i32 g2",
                                            "bwd f32 i32 scalar-g g2"},
                  args.sass)
    for tag in sources:
        so, log = built[f"focal_{tag}"]
        libs[tag] = load_lib(so, ARGS)
        regs, loops = ptxas(log), loop_counts(so)
        result["build"][tag] = {
            short(fn): {"ptxas": regs.get(fn, {}),
                        "loops": loops.get(fn, []),
                        "per_element": per_element(loops.get(fn, []))}
            for fn in sorted(set(regs) | set(loops))}
        for name, v in sorted(result["build"][tag].items()):
            if "i64" in name or "pow" in name:
                continue  # in the JSON only
            print(f"  [{tag}] {name:24s} {v['ptxas']} loop bodies "
                  f"(instructions, 128-bit loads) {v['loops']}: "
                  f"{v['per_element']} an element", flush=True)

    for dname in args.dtypes:
        dtype = getattr(torch, dname)
        x, t, dense = operands(dev, dtype)
        scalar = torch.full((1,), 1.0 / float((t > 0).sum()), device=dev)
        x_bytes = x.numel() * x.element_size()
        cases = {
            "fwd": (None, torch.float32,
                    FL.sigmoid_focal_loss_multiclass_plain(x, t),
                    x_bytes + 4 * N + 4 * N * C),
            "bwd_scalar": (scalar, dtype,
                           FL.sigmoid_focal_loss_multiclass_bwd_plain(
                               x, t, scalar.expand(N, C)),
                           2 * x_bytes + 4 * N + 4),
            "bwd_dense": (dense, dtype,
                          FL.sigmoid_focal_loss_multiclass_bwd_plain(
                              x, t, dense),
                          2 * x_bytes + 4 * N + 4 * N * C),
        }
        for case, (g, out_dtype, ref, nbytes) in cases.items():
            name = f"{case} {dname}"
            bar = (1e-5 if out_dtype == torch.float32 else 2 ** -7) * float(
                ref.float().abs().max()) + 1e-6
            calls, errs = {}, {}
            for tag, lib in libs.items():
                out = torch.empty(N, C, dtype=out_dtype, device=dev)
                calls[tag] = call(lib, case, x, t, g, out)
                calls[tag]()
                torch.cuda.synchronize()
                errs[tag] = float((out.float() - ref.float()).abs().max())
                if errs[tag] > bar:
                    raise SystemExit(f"{name} [{tag}]: max error "
                                     f"{errs[tag]:.3e} > {bar:.3e}")
            del ref
            order = (["other", "this"] + [t_ for t_ in calls if t_ not in
                                          ("other", "this")]
                     + ["this", "other"])
            times = {}
            for tag in order:
                times.setdefault(tag, []).append(event_ms(calls[tag],
                                                          args.reps))
            bound = nbytes / HBM * 1e3
            row = {"bytes": nbytes, "bound_ms": bound, "bar": bar}
            for tag in calls:
                ms = device_ms(calls[tag], calls=20)
                row[tag] = {"event_ms": times[tag], "device_ms": ms,
                            "tb_s": nbytes / ms / 1e9,
                            "share_of_bound": bound / ms,
                            "max_abs_err": errs[tag]}
            result["cases"][name] = row
            print(f"{name}: bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); "
                  + "; ".join(
                      f"{tag} {'/'.join(f'{v:.4f}' for v in row[tag]['event_ms'])}"
                      f" ms (events), {row[tag]['device_ms']:.4f} (profiler) ="
                      f" {row[tag]['tb_s']:.3f} TB/s, "
                      f"{100 * row[tag]['share_of_bound']:.1f} % of the bound"
                      for tag in calls), flush=True)
        gs = scalar.expand(N, C)
        for case, fn in (
                ("fwd", lambda: FL.sigmoid_focal_loss_multiclass_plain(x, t)),
                ("bwd_scalar",
                 lambda: FL.sigmoid_focal_loss_multiclass_bwd_plain(x, t,
                                                                    gs))):
            result["plain_ms"][f"{case} {dname}"] = event_ms(fn, 5)
        print(f"plain versions, {dname}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in result["plain_ms"].items()
            if k.endswith(dname)), flush=True)
        del x, t, dense
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "build"}))


if __name__ == "__main__":
    main()
