#!/usr/bin/env python3
"""K11 (``stem_conv7x7_s2``, the fused stem) and K7
(``fused_upsample_argmax``, the full-resolution epilogue) on a CUDA card
at the serving shapes: this tree's kernels against another checkout's
(``--root``, e.g. the parent commit unpacked with ``git archive`` under
``_archive/``) in turns, in one process, on one card.

    python scripts/torch_stem_upsample_probe.py --root _archive/parent \\
        --forward 10 --out stem_upsample_probe.json

Shapes: K11 on the s2d bf16 stem input of X39.speed at 768x1536 ((1, 384,
768, 12) -> 64 + 8 channels) and of the R18 full-resolution bf16 graph at
1024x2048 ((1, 512, 1024, 12) -> 64 + 64), bf16 out; K7 on (1, 128, 256,
19) float32 logits -> (1, 1024, 2048) labels.  Inputs are seeded random
tensors made on the card; the stem weights are (7, 7, 3, cout) of std
sqrt(2 / 147), this tree's packed once (``pack_stem_weights``).

Both trees' ``stem_conv.cu`` and ``upsample_argmax.cu`` are compiled here
with the build's flags (one nvcc each, at once, into ``_build/probe``),
and so is each ``--variant name:NAME=value,...``, this tree's sources with
those ``constexpr int`` or ``float`` values (``kWgs``, ``kKappa``,
``kRows``, ...).  For each
library it prints ptxas's registers, stack and spills and the count of
HGMMA (wgmma), HMMA (mma.sync) and FFMA instructions of each kernel in
``cuobjdump -sass``, and exits non-zero unless this tree's bf16 stem
kernels have HGMMA or HMMA.  Checks: this tree's K11 meets its bars
against its plain version (bf16 and float32 out, through the wrapper) at
both shapes, and every library's launch meets them (bf16); every K7
library's labels equal the other tree's kernel's bit for bit, and this
tree's meet K7's bar against the plain version.  Times: each library's
entry point is called directly (no Python wrapper; ``--reps`` back-to-back
calls, CUDA events) in turns: other tree, this tree, the variants, this
tree, other tree; then ``torch.profiler``'s device time per call of each,
and by kernel where a call launches two (this tree's bf16 K11: the
tensor-core kernel and ``stem_fix_kernel``); each K11 library's share of
outputs its rounding check recomputed is counted on one extra call.
With ``--forward N`` it also times the X39.speed forward (``deploy_entry``)
and the R18 full-resolution bf16 forward (``make_bisenet_fused_infer``,
argmax 'fused') in both trees, N rounds of four seeded images each, in
turns.  Prints the card's name and power limit and one JSON line (also to
``--out``).  Needs a card and nvcc.
"""

import argparse
import copy
import ctypes
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torchseg_tpu_torch.ops.kernels import _build  # noqa: E402
from torchseg_tpu_torch.ops.kernels import stem_conv as S  # noqa: E402
from torchseg_tpu_torch.ops.kernels import upsample_argmax as U  # noqa: E402

STEMS = {"x39": ((384, 768), 72), "r18": ((512, 1024), 128)}  # s2d hw, cout
K7_SHAPE, K7_OUT = (1, 128, 256, 19), (1024, 2048)


def import_tree(root, alias):
    """The port package of the checkout at ``root``, imported as
    ``alias`` (its kernels build into that checkout's ``_build``)."""
    pkg = os.path.join(os.path.abspath(root), "torchseg_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def variant_source(text, assignments):
    """The source with each ``constexpr int|float NAME = ...;`` it holds set to
    the assigned value; returns (text, the names it held)."""
    held = []
    for name, value in assignments.items():
        text, n = re.subn(rf"(constexpr (?:int|float) {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n:
            held.append(name)
    return text, held


def compile_libs(jobs):
    """{tag: (library path, ptxas log)} for jobs {tag: source text}, one
    nvcc each with the build's flags, all at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, text in jobs.items():
        src = os.path.join(out_dir, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{tag}.so")
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{log}")
        built[tag] = (so, log)
    return built


def load_lib(so, argtypes):
    lib = ctypes.CDLL(so)
    for fn_name, types in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = types
        fn.restype = _build._RESTYPES.get(fn_name, ctypes.c_int)
    if "tsg_init" in argtypes and lib.tsg_init():
        raise SystemExit(f"{so}: tsg_init failed")
    return lib


def sass_counts(so):
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif fn:
            for op in counts[fn]:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def ptxas(log):
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["stack_spill_st_ld"] = [int(v) for v in m.groups()]
        if "Potential Performance Loss" in line and fn:
            out[fn]["warning"] = line.strip()[:160]
    return out


def short(fn):
    return re.sub(r"^_ZN\w*?_tsg_init\d+", "", fn)[:60]


def event_ms(fn, reps):
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


def device_ms(fn, calls=10, parts=None):
    """torch.profiler's device time of one call (all its kernels); with a
    dict ``parts``, also each kernel's, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if parts is not None:
        for e in kern:
            parts[e.key[:60]] = e.self_device_time_total / 1000.0 / calls
    return sum(e.self_device_time_total for e in kern) / 1000.0 / calls


def stem_operands(dev, hw, cout, seed):
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(1, *hw, 12, generator=g).to(torch.bfloat16).to(dev)
    k = (torch.randn(7, 7, 3, cout, generator=g) * (2 / 147) ** 0.5).to(dev)
    a = (torch.rand(cout, generator=g) + 0.5).to(dev)
    b = (torch.randn(cout, generator=g) * 0.2).to(dev)
    return xs, k, a, b


def stem_call(lib, xs, k, a, b, n_sp, pack, out, other, counter=None):
    """One direct call of a stem library's entry point, bf16 out: this
    tree's tensor-core entry (or a variant's), or with ``other`` the other
    tree's ``tsg_stem_conv`` (its dtype flags)."""
    n, h2, w2, _ = xs.shape
    cout = k.shape[3]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (out[0].data_ptr(), out[1].data_ptr())
    if other:
        return lambda: lib.tsg_stem_conv(
            xs.data_ptr(), n, 2 * h2, 2 * w2, 3, 1, 1, k.data_ptr(),
            a.data_ptr(), b.data_ptr(), cout, n_sp, *ptrs, 1, stream)
    fix = torch.empty(lib.tsg_stem_tc_fix_ints(n, 2 * h2, 2 * w2,
                                               pack.shape[2] * 8),
                      dtype=torch.int32, device=xs.device)
    return lambda: lib.tsg_stem_conv_bf16(
        xs.data_ptr(), n, 2 * h2, 2 * w2, 3, 1, pack.data_ptr(),
        pack.shape[2] * 8, k.data_ptr(), a.data_ptr(), b.data_ptr(), cout,
        n_sp, *ptrs, 1, fix.data_ptr(), counter, stream)


def k7_call(lib, x, out, other):
    b, h, w, c = x.shape
    oh, ow = out.shape[1:]
    stream = torch.cuda.current_stream().cuda_stream
    if other:
        return lambda: lib.tsg_upsample_argmax(x.data_ptr(), b, h, w, c,
                                               out.data_ptr(), oh, ow, stream)
    cols, cc, smem = U.block_plan(w, c, ow, lib.tsg_upsample_max_cols())
    rtab = U._tap_table_on(h, oh, x.device.index)
    ctab = U._tap_table_on(w, ow, x.device.index)
    return lambda: lib.tsg_upsample_argmax(
        x.data_ptr(), b, h, w, c, rtab.data_ptr(), ctab.data_ptr(),
        out.data_ptr(), oh, ow, cols, cc, smem, stream)


def checked(fn):
    def run():
        rc = fn()
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
    return run


def in_turns(name, calls, reps, rows):
    """calls {tag: fn}, with "other" and "this": timed other, this, the
    variants, this, other (CUDA events), then the profiler's device time
    of each."""
    order = (["other", "this"] + [t for t in calls if t not in
                                  ("other", "this")] + ["this", "other"])
    times = {}
    for tag in order:
        times.setdefault(tag, []).append(event_ms(calls[tag], reps))
    row = {}
    for tag, fn in calls.items():
        parts = {}
        row[tag] = {"event_ms": times[tag],
                    "device_ms": device_ms(fn, parts=parts), "parts": parts}
    rows[name] = row
    print(f"{name}: " + "; ".join(
        f"{tag} {'/'.join(f'{t:.4f}' for t in v['event_ms'])} ms (events), "
        f"{v['device_ms']:.4f} (profiler)" for tag, v in row.items()),
        flush=True)
    for tag, v in row.items():
        if len(v["parts"]) > 1:
            print(f"  {name} [{tag}] by kernel: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in v["parts"].items()), flush=True)


def forward_fn(tree, dev, which):
    """A timing closure for X39.speed (``deploy_entry``) or the R18
    full-resolution bf16 graph of the package ``tree``."""
    entry = importlib.import_module(f"{tree}.entry")
    fs = importlib.import_module(f"{tree}.deploy.fused_stem")
    reg = importlib.import_module(f"{tree}.experiments.registry")
    models = importlib.import_module(f"{tree}.models")
    if which == "x39":
        infer, _ = entry.deploy_entry(device=dev)
        cfg, hw = reg.get_experiment(entry.DEPLOY_EXPERIMENT), (768, 1536)
    else:
        cfg, hw = reg.get_experiment("cityscapes.bisenet.R18"), (1024, 2048)
        model = models.init_weights(reg.build_model(cfg),
                                    torch.Generator().manual_seed(0))
        model = copy.deepcopy(model).to(dev).to(torch.bfloat16)
        infer = fs.make_bisenet_fused_infer(model, cfg.bn_eps,
                                            argmax="fused",
                                            input_format="s2d")
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    rng = np.random.default_rng(3)
    xss = [fs.prepare_s2d_input(
        (rng.integers(0, 256, (1, *hw, 3)).astype(np.float32) / 255.0 - mean)
        / std, torch.bfloat16, device=dev) for _ in range(4)]

    def run(rounds):
        for x in xss:
            infer(x)
        marks = []
        for _ in range(rounds):
            for x in xss:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                infer(x)
                ev[1].record()
                marks.append(ev)
        torch.cuda.synchronize()
        t = sorted(a.elapsed_time(b) for a, b in marks)
        return statistics.median(t), t[int(0.9 * (len(t) - 1))]
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout (e.g. the parent commit)")
    ap.add_argument("--variant", action="append", default=[],
                    help="name:NAME=value,... (constexpr ints or floats "
                         "of this tree's stem_conv.cu / upsample_argmax.cu)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--forward", type=int, default=0,
                    help="rounds of four forwards per tree and graph")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    other = import_tree(args.root, "other_tree")
    other_build = importlib.import_module("other_tree.ops.kernels._build")
    names = ("stem_conv", "upsample_argmax")
    sources = {}
    for name in names:
        for tag, csrc in (("this", _build.CSRC_DIR),
                          ("other", other_build.CSRC_DIR)):
            with open(os.path.join(csrc, f"{name}.cu")) as f:
                sources[(tag, name)] = f.read()
    variants = {}
    for spec in args.variant:
        vname, _, rest = spec.partition(":")
        assign = dict(kv.split("=") for kv in rest.split(","))
        for name in names:
            text, held = variant_source(sources[("this", name)], assign)
            if held:
                sources[(vname, name)] = text
                variants.setdefault(vname, set()).update(held)
        if variants.get(vname) != set(assign):
            raise SystemExit(f"variant {vname}: no constexpr "
                             f"{set(assign) - variants.get(vname, set())}")
    built = compile_libs({f"{t}_{n}": text for (t, n), text in
                          sources.items()})
    libs, result = {}, {"card": smi, "build": {}, "kernels": {},
                        "forward": {}}
    for (tag, name) in sources:
        so, log = built[f"{tag}_{name}"]
        table = (other_build if tag == "other" else _build).LIBRARIES[name]
        libs[(tag, name)] = load_lib(so, table)
        regs, counts = ptxas(log), sass_counts(so)
        result["build"][f"{tag}_{name}"] = {"ptxas": regs, "sass": counts}
        for fn in sorted(set(regs) | set(counts)):
            print(f"  [{tag} {name}] {short(fn):60s} {regs.get(fn, {})} "
                  f"{counts.get(fn, {})}", flush=True)
    tc = {fn: c for fn, c in result["build"]["this_stem_conv"]["sass"].items()
          if "wgmma" in fn}
    if not tc or min(c["HGMMA"] + c["HMMA"] for c in tc.values()) == 0:
        raise SystemExit(f"this tree's bf16 stem kernels have no tensor-core "
                         f"instruction: {tc}")
    stem_tags = [t for (t, n) in sources if n == "stem_conv"]
    k7_tags = [t for (t, n) in sources if n == "upsample_argmax"]

    for name, (hw, cout) in STEMS.items():
        xs, k, a, b = stem_operands(dev, hw, cout, seed=cout)
        pack = S.pack_stem_weights(k)
        ref = {od: S.stem_conv7x7_s2_plain(xs, k, a, b, 64, "s2d", od)
               for od in (torch.bfloat16, torch.float32)}
        for od in ref:
            err, share, beyond = S.agreement(
                S.stem_conv7x7_s2(xs, k, a, b, 64, "s2d", od, pack=pack),
                ref[od])
            print(f"K11 {name} {od}: max |kernel - plain| {err}, equal "
                  f"share {share:.6f}, beyond the bar {beyond}", flush=True)
            if beyond or (od == torch.bfloat16 and share < S.MIN_SHARE):
                raise SystemExit(f"K11 {name} {od} misses its bars")
        calls = {}
        for tag in stem_tags:
            out = [torch.empty((1, c, *hw), dtype=torch.bfloat16,
                               device=dev) for c in (64, cout - 64)]
            n_re = torch.zeros(1, dtype=torch.int32, device=dev)
            if tag != "other":  # count the rounding check's recomputes once
                checked(stem_call(libs[(tag, "stem_conv")], xs, k, a, b, 64,
                                  pack, out, False, n_re.data_ptr()))()
            calls[tag] = checked(stem_call(libs[(tag, "stem_conv")], xs, k,
                                           a, b, 64, pack, out,
                                           tag == "other"))
            calls[tag]()
            torch.cuda.synchronize()
            err, share, beyond = S.agreement(out, ref[torch.bfloat16])
            n_out = sum(t.numel() for t in out)
            print(f"K11 {name} [{tag}]: bf16 equal to the plain version's on "
                  f"{share:.7f}; {int(n_re)} of {n_out} outputs recomputed in "
                  f"the reference order ({int(n_re) / n_out:.5f})",
                  flush=True)
            result.setdefault("k11_checks", {})[f"{name} {tag}"] = {
                "equal_share": share, "rechecked": int(n_re),
                "outputs": n_out}
            if beyond or share < S.MIN_SHARE:
                raise SystemExit(f"K11 {name} [{tag}] misses its bars")
        in_turns(f"K11 {name}", calls, args.reps, result["kernels"])

    x = torch.randn(K7_SHAPE, generator=torch.Generator().manual_seed(7)
                    ).to(dev)
    outs = {t: torch.empty((1, *K7_OUT), dtype=torch.int32, device=dev)
            for t in k7_tags}
    calls = {t: checked(k7_call(libs[(t, "upsample_argmax")], x, outs[t],
                                t == "other")) for t in k7_tags}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    same = {t: bool(torch.equal(outs[t], outs["other"])) for t in k7_tags}
    ref = U.fused_upsample_argmax_plain(x, K7_OUT)
    from torchseg_tpu_torch.ops.resize import resize_bilinear_align_corners
    scores = resize_bilinear_align_corners(x.permute(0, 3, 1, 2), K7_OUT)
    share, n_clear = U.label_agreement(outs["this"], ref,
                                       scores.permute(0, 2, 3, 1))
    print(f"K7: labels equal the other tree's kernel's bit for bit: {same}; "
          f"vs plain equal on {share:.6f}, {n_clear} beyond the margin",
          flush=True)
    result["k7_labels_equal_other"] = same
    if not all(same.values()) or share < U.MIN_SHARE or n_clear:
        raise SystemExit("K7 labels differ")
    in_turns("K7", calls, args.reps, result["kernels"])

    if args.forward:
        for which in ("x39", "r18_fullres_bf16"):
            runs = {t: forward_fn(t, dev, which) for t in ("other_tree",
                                                           "torchseg_tpu_torch")}
            t = [runs["other_tree"](args.forward),
                 runs["torchseg_tpu_torch"](args.forward),
                 runs["torchseg_tpu_torch"](args.forward),
                 runs["other_tree"](args.forward)]
            result["forward"][which] = {"other": [t[0], t[3]],
                                        "this": [t[1], t[2]]}
            print(f"{which} forward (median, p90) ms in turns: other {t[0]}"
                  f" / this {t[1]} / this {t[2]} / other {t[3]}", flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "build"}))


if __name__ == "__main__":
    main()
