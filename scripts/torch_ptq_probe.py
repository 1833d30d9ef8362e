#!/usr/bin/env python3
"""The generic int8 graph (``deploy/quantize.py``) and the kernel custom
ops (``ops/kernels/custom_ops.py``) on a CUDA card.

    python scripts/torch_ptq_probe.py [--out chiprun_out/ptq_probe.json]

1. Host time a call.  Every kernel wrapper that one BiSeNet-R18.speed
   int8-through forward at 1024x2048 calls (``deploy/int8_serve.py``), on
   the arguments that forward gave it, and K11 in the X39.speed bf16
   fused-stem forward at 768x1536 (``deploy/fused_stem.py``): called
   directly, and through its ``torchseg_cuda`` op as an exported graph
   calls it (``deploy/export.SHIMS``, which flattens a package entry into
   the op's tensor list).  Host time: 50 calls back to back with no
   synchronize in between (the launch queue does not fill), the least of 5
   passes (the two routes in turns), per call.  The same for whole
   int8-through forwards (5 a pass), directly and under
   ``export.kernel_ops()``, with their CUDA-event time.
2. ``conv_i8_affine``'s device time in one ``--int8`` R18.speed forward
   at 1024x2048 (``chip_smoke.ptq_device_ms``: torch.profiler).
3. Card against CPU of the generic int8 graph at 128x256
   (``chip_smoke.ptq_card_vs_cpu``), float32, seeds 7-11: the convs
   whose card output on the CPU run's input differs from the CPU's; in the
   free runs, the label share and the first conv whose int8 codes differ,
   with the distance of its flipped values from a rounding midpoint.
   Controls on the same inputs: the float model's labels (float32, card vs
   CPU); two faults made on the card's copy of the int8 model: the middle
   conv (a 3x3) missing its first tap, and every conv's scale rounded to
   bf16.  Then, for seed 7, the first modules of any kind whose float32
   output differs between card and CPU, each with whether its inputs were
   equal and the difference in units of float32 epsilon (relative).

Prints the card's name and power limit and one JSON line (also to
``--out``).  Needs a card.
"""

import argparse
import copy
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from torchseg_tpu_torch.deploy import export as E  # noqa: E402
from torchseg_tpu_torch.deploy import fused_stem, int8_serve  # noqa: E402
from torchseg_tpu_torch.deploy import quantize as Q  # noqa: E402
from torchseg_tpu_torch.entry import _no_tf32  # noqa: E402
from torchseg_tpu_torch.experiments.registry import (  # noqa: E402
    build_model,
    get_experiment,
)
from torchseg_tpu_torch.models import init_weights  # noqa: E402
from torchseg_tpu_torch.ops.kernels import (  # noqa: E402
    int8_serve_kernels as K,
)
from torchseg_tpu_torch.tools import roofline, speed  # noqa: E402

R18S = "cityscapes.bisenet.R18.speed"
N_CALLS, PASSES, N_FORWARDS = 50, 5, 5
SEEDS = (7, 8, 9, 10, 11)


def host_us(routes, n):
    """{name: least host us a call over PASSES passes of n calls}, the
    routes ({name: (fn, args, kwargs)}) in turns."""
    best = dict.fromkeys(routes, float("inf"))
    for fn, args, kw in routes.values():
        fn(*args, **kw)
    torch.cuda.synchronize()
    for _ in range(PASSES):
        for name, (fn, args, kw) in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args, **kw)
            best[name] = min(best[name], time.perf_counter() - t0)
            torch.cuda.synchronize()
    return {k: v / n * 1e6 for k, v in best.items()}


def recorded_calls(mod, fn, args):
    """The first call's (args, kwargs) of each of ``mod``'s wrappers that
    ``export.SHIMS`` names, in one ``fn(*args)``."""
    calls, saved = {}, {}
    for name in E.SHIMS:
        if hasattr(mod, name):
            saved[name] = getattr(mod, name)

            def spy(*a, name=name, f=saved[name], **kw):
                calls.setdefault(name, (a, kw))
                return f(*a, **kw)

            setattr(mod, name, spy)
    try:
        fn(*args)
    finally:
        for name, f in saved.items():
            setattr(mod, name, f)
    torch.cuda.synchronize()
    return calls, saved


def op_host_times():
    out = {}
    info = {}
    speed.main(["-e", R18S, "--input-size", "1x1024x2048x3",
                "--int8-through", "--chain", "3", "--reps", "1",
                "--device", "cuda"], info=info)
    fn, args = info["fn"], info["args"]
    calls, wrappers = recorded_calls(int8_serve, fn, args)
    from torchseg_tpu_torch.entry import deploy_entry
    x39, xs = deploy_entry(device="cuda")
    k11, k11_wrappers = recorded_calls(fused_stem, x39, (xs,))
    calls.update(k11)
    wrappers.update(k11_wrappers)
    for name, (a, kw) in calls.items():
        t = host_us({"direct": (wrappers[name], a, kw),
                     "op": (E.SHIMS[name], a, kw)}, N_CALLS)
        out[name] = t
        print(f"{name}: host {t['direct']:.1f} us a call directly, "
              f"{t['op']:.1f} us through its op", flush=True)

    def under_ops(*a):
        with E.kernel_ops():
            return fn(*a)

    t = host_us({"direct": (fn, args, {}), "op": (under_ops, args, {})},
                N_FORWARDS)
    ev = {"direct": C.cuda_ms(fn, [args], reps=20),
          "op": C.cuda_ms(under_ops, [args], reps=20)}
    out["int8_through_forward"] = {**t, "events_ms": ev}
    print(f"int8-through R18.speed forward: host {t['direct']:.1f} us "
          f"directly, {t['op']:.1f} us through the ops; CUDA events "
          f"{ev['direct']:.4f} / {ev['op']:.4f} ms", flush=True)
    return out


def ptq_device():
    info = {}
    speed.main(["-e", R18S, "--input-size", "1x1024x2048x3", "--int8",
                "--chain", "3", "--reps", "1", "--device", "cuda"],
               info=info)
    fn, args = info["fn"], info["args"]
    with C.record_ptq_calls(Q) as fed:
        fn(*args)
    gemms = []
    for call in fed:
        out = K.conv_i8_affine(*call)
        w = call[1]
        gemms.append((max(out.shape[1] * out.shape[2], 17),
                      w.shape[0] ** 2 * w.shape[2], w.shape[3]))
    conv, mm, fwd, fwd_conv = C.ptq_device_ms(torch.device("cuda"), fed,
                                              gemms, fn, args, K)
    res = {"launches": len(fed), "conv_ms": conv, "int_mm_ms": mm,
           "forward_ms": fwd, "forward_conv_ms": fwd_conv}
    print(f"conv_i8_affine device time: {res}", flush=True)
    return res


def zero_tap(q):
    convs = [m for m in q.modules() if isinstance(m, Q.QuantConv2d)]
    convs[len(convs) // 2].wq[0, 0] = 0


def bf16_scales(q):
    for mod in q.modules():
        if isinstance(mod, Q.QuantConv2d):
            mod.m.copy_(mod.m.bfloat16().float())


def float_share(model, seed):
    rng = C.np.random.default_rng(seed)
    for _ in range(2):
        rng.normal(size=C.PTQ_SMALL)
    x = torch.from_numpy(rng.normal(size=C.PTQ_SMALL)).float()
    m = copy.deepcopy(model).float().eval()
    with torch.inference_mode():
        cpu = m(x).argmax(dim=1)
        card = m.cuda()(x.cuda()).argmax(dim=1).cpu()
    return float((cpu == card).float().mean())


def first_modules(model, seed, n=4):
    """The first ``n`` modules (completion order) whose float32 output
    differs between the card and the CPU, in the int8 graph."""
    rng = C.np.random.default_rng(seed)
    calib = [torch.from_numpy(rng.normal(size=C.PTQ_SMALL)).float()
             for _ in range(2)]
    x = torch.from_numpy(rng.normal(size=C.PTQ_SMALL)).float()
    _, _, qcpu, _ = Q.make_int8_infer(copy.deepcopy(model).float().eval(),
                                      calib)
    qcard = copy.deepcopy(qcpu).cuda()
    recs = []
    for q, xin in ((qcpu, x), (qcard, x.cuda())):
        rec, hooks = [], []
        for name, mod in q.named_modules():
            def hook(m, a, y, name=name, rec=rec):
                ins = [t.detach().cpu() for t in a if torch.is_tensor(t)]
                y = y[0] if isinstance(y, (tuple, list)) else y
                if torch.is_tensor(y) and y.is_floating_point():
                    rec.append((name, type(m).__name__, ins,
                                y.detach().cpu()))
            hooks.append(mod.register_forward_hook(hook))
        with torch.inference_mode():
            q(xin)
        for h in hooks:
            h.remove()
        recs.append(rec)
    found = []
    for (name, kind, ia, a), (_, _, ib, b) in zip(*recs):
        if not torch.equal(a, b):
            d = (a - b).abs()
            rel = d / a.abs().clamp_min(torch.finfo(torch.float32).tiny)
            found.append({
                "module": name, "type": kind,
                "inputs_equal": len(ia) == len(ib) and all(
                    torch.equal(u, v) for u, v in zip(ia, ib)),
                "n_differ": int((d > 0).sum()), "of": a.numel(),
                "max_abs": float(d.max()),
                "max_eps": float(rel.max() / torch.finfo(
                    torch.float32).eps)})
            print(f"first differing modules: {found[-1]}", flush=True)
            if len(found) == n:
                break
    return found


def card_vs_cpu():
    model = init_weights(build_model(get_experiment(R18S)),
                         torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    rows = []
    for seed in SEEDS:
        row = {"seed": seed, "float_share": float_share(model, seed),
               **C.ptq_card_vs_cpu(dev, model, seed, torch.float32)}
        for tag, tamper in (("tap", zero_tap), ("bf16", bf16_scales)):
            row[tag] = C.ptq_card_vs_cpu(dev, model, seed, torch.float32,
                                         tamper)
        print(f"card vs CPU, float32: {row}", flush=True)
        rows.append(row)
    return rows, first_modules(model, SEEDS[0])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _no_tf32()
    card = roofline.card()
    print(card, flush=True)
    res = {"card": card, "host_us": op_host_times(),
           "ptq_device": ptq_device()}
    res["card_vs_cpu"], res["first_modules"] = card_vs_cpu()
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
