#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the int8-through BiSeNet-R18.speed serving graph at
1024x2048 (``torchseg_tpu_torch.entry``): seeded random weights, four
distinct seeded uint8 images served, (1, 128, 256) int32 labels out.  The
script

  1. needs a CUDA card (exits non-zero without one, with no CPU fallback);
  2. prints the card's name and power limit as nvidia-smi reports them;
  3. builds the CUDA kernels from the checkout's sources (nvcc) and prints
     the build time and ptxas's register / shared-memory report;
  4. builds the serving graph and serves the images; counts each kernel
     wrapper's launches over exactly one served forward (each must be >= 1,
     conv3x3s2_i8 exactly 2);
  5. compares every kernel with its plain PyTorch version on the tensors
     the main path fed it (K2-K4 bit-exact, K1 within one code on at most
     a 1e-3 share of its codes), and the
     served graph with the plain graph run on the CPU on one small input;
  6. times the served forward over the distinct inputs, each kernel against
     its plain version, and the plain-PyTorch parts of the graph, with CUDA
     events after a warm-up.

Every failed phase raises, so the exit code is non-zero.  The line before
last is a JSON object with the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.  Only the port is imported (no JAX).
TF32 is off for cuDNN and matmuls, set here and by the entry: calibration
runs the float graph in float32 on the card.  The script uses one card:
it makes only the first visible one visible to itself.
"""

import json
import os
import subprocess
import sys
import time

os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

H, W = 1024, 2048
N_IMAGES = 4
FWD_ROUNDS = 25  # 100 timed forwards: p90 has ten samples beyond it
SRC = "torchseg_tpu_torch/csrc/int8_serve_kernels.cu"
TPU = "torchseg_tpu/ops/pallas/int8_serve_kernels.py"


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, inputs, reps=1):
    """Mean ms per call of fn(*args) over every args tuple in ``inputs``
    (each ``reps`` times), CUDA events, after one warm-up pass."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from torchseg_tpu_torch.deploy import int8_serve as i8
    from torchseg_tpu_torch.entry import entry
    from torchseg_tpu_torch.experiments.registry import get_experiment
    from torchseg_tpu_torch.ops.kernels import _build
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off (cudnn, matmul)")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.ready(dev.index)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BuildInfo.seconds:.2f} s) -> {_build.BuildInfo.path}")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    # -- main path --------------------------------------------------------
    t0 = time.perf_counter()
    infer, (pkg, xs0) = entry(device=dev, image_hw=(H, W))
    torch.cuda.synchronize()
    log(f"graph built (seeded weights, calibration, int8 package): "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = get_experiment("cityscapes.bisenet.R18.speed")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
              for _ in range(N_IMAGES)]
    xss = [i8.prepare_s2d_input_u8(u, image_mean=cfg.image_mean, device=dev)
           for u in images]
    infer(pkg, xss[0])  # warm-up: library load, cuDNN plans
    torch.cuda.synchronize()

    K.reset_launches()
    labels = infer(pkg, xss[0])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    log(f"launches in one served forward: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched by the main path")
    if launches["conv3x3s2_i8"] != 2:
        fail(f"conv3x3s2_i8 launched {launches['conv3x3s2_i8']} times, "
             "expected 2")
    outs = [labels] + [infer(pkg, x) for x in xss[1:]]
    for y in outs:
        if tuple(y.shape) != (1, H // 8, W // 8) or y.dtype != torch.int32:
            fail(f"labels {tuple(y.shape)} {y.dtype}, expected "
                 f"(1, {H // 8}, {W // 8}) int32")
        if int(y.min()) < 0 or int(y.max()) >= cfg.num_classes:
            fail(f"labels outside [0, {cfg.num_classes})")
    log(f"labels {tuple(labels.shape)} {labels.dtype}; distinct labels per "
        f"image: {[int(y.unique().numel()) for y in outs]}")
    with torch.inference_mode():
        spatial_out, feats = i8.int8_body(pkg, xss[0])
        logits = i8._apply_int8_decoder(pkg["dec"], spatial_out, feats[-2],
                                        feats[-1])
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")

    # -- kernels against their plain versions, on the main path's tensors -
    st = pkg["stem"]
    per_image = []
    for x in xss:
        sp, pooled = K.stem_pool_i8(x, st["wf"], st["mf"], st["cf"],
                                    st["n_sp"])
        s1 = K.conv3x3s2_i8(sp, pkg["sp1"]["w"], pkg["sp1"]["m"],
                            pkg["sp1"]["c"])
        c4 = K.l1_stage_i8(pooled, pkg["l1_0"], pkg["l1_1"])
        per_image.append({"xs": x, "sp": sp, "s1": s1, "pooled": pooled,
                          "c4": c4})
    cases = {
        "stem_pool_i8": (
            K.stem_pool_i8, K.stem_pool_i8_plain, 384,
            [(d["xs"], st["wf"], st["mf"], st["cf"], st["n_sp"])
             for d in per_image]),
        "conv3x3s2_i8": (
            K.conv3x3s2_i8, K.conv3x3s2_i8_plain, 515,
            [(d[k], *(pkg[p][f] for f in ("w", "m", "c")))
             for d in per_image for k, p in (("sp", "sp1"), ("s1", "sp2"))]),
        "l1_stage_i8": (
            K.l1_stage_i8, K.l1_stage_i8_plain, 763,
            [(d["pooled"], pkg["l1_0"], pkg["l1_1"]) for d in per_image]),
        "down_stage_i8": (
            K.down_stage_i8, K.down_stage_i8_plain, 986,
            [(d["c4"], pkg["l2_0"], pkg["l2_1"]) for d in per_image]),
    }
    rows = []
    for name, (kern, plain, line, inputs) in cases.items():
        worst, n_diff, n_all = 0, 0, 0
        for args in inputs:
            got, ref = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                if g.shape != r.shape or g.dtype != r.dtype:
                    fail(f"{name}: {tuple(g.shape)} {g.dtype} vs plain "
                         f"{tuple(r.shape)} {r.dtype}")
                d = (g.int() - r.int()).abs()
                worst = max(worst, int(d.max()))
                n_diff += int((d > 0).sum())
                n_all += d.numel()
        # the stem may flip a round-half tie (one code), but rarely: a
        # systematic rounding error moves a large share of codes by one
        tol, max_share = (1, 1e-3) if name == "stem_pool_i8" else (0, 0.0)
        log(f"{name}: max |kernel - plain| = {worst} code(s) (tolerance "
            f"{tol}); differing codes {n_diff}/{n_all} = "
            f"{n_diff / n_all:.3e} (tolerance {max_share:.0e})")
        if worst > tol:
            fail(f"{name} disagrees with its plain version: {worst} > {tol}")
        if n_diff > max_share * n_all:
            fail(f"{name}: {n_diff}/{n_all} codes differ from its plain "
                 f"version, more than a share of {max_share:.0e}")
        ms = cuda_ms(kern, inputs, reps=5)
        plain_ms = cuda_ms(plain, inputs, reps=1)
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call "
            f"({len(inputs)} distinct inputs)")
        rows.append({"name": name, "route": "cuda", "source": SRC,
                     "replaces": f"{TPU}:{line}",
                     "launches": launches[name], "max_abs_err": worst,
                     "ms": ms, "plain_ms": plain_ms})

    # -- the served graph against the plain graph on the CPU, small input -
    cpu_infer, (cpu_pkg, cpu_xs) = entry(device="cpu", image_hw=(256, 512),
                                         seed=3)
    card_labels = cpu_infer(to_device(cpu_pkg, dev), cpu_xs.to(dev)).cpu()
    agree = float((card_labels == cpu_infer(cpu_pkg, cpu_xs)).float().mean())
    log(f"small input 256x512: card labels agree with the CPU plain graph "
        f"on {agree:.6f} of pixels")
    if agree < 0.99:
        fail(f"card vs CPU plain graph label agreement {agree} < 0.99")

    # -- timings: served forward and the plain-PyTorch parts --------------
    marks = []
    for _ in range(FWD_ROUNDS):
        for x in xss:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            infer(pkg, x)
            ev[1].record()
            marks.append(ev)
    torch.cuda.synchronize()
    samples = np.array([a.elapsed_time(b) for a, b in marks])
    fwd_ms = float(samples.mean())
    log(f"served forward (device input, {N_IMAGES} distinct images, "
        f"{samples.size} forwards back to back): median "
        f"{np.median(samples):.4f} ms, p90 {np.percentile(samples, 90):.4f} "
        f"ms, mean {fwd_ms:.4f} ms = {1000.0 / fwd_ms:.2f} FPS")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xss:
        infer(pkg, x)
    enqueue_ms = (time.perf_counter() - t0) * 1000.0 / len(xss)
    torch.cuda.synchronize()
    log(f"host time to enqueue one forward (no sync): {enqueue_ms:.4f} ms "
        f"({'below' if enqueue_ms < fwd_ms else 'ABOVE'} the forward's "
        f"{fwd_ms:.4f} ms on the card)")
    t0 = time.perf_counter()
    for u in images:
        infer(pkg, i8.prepare_s2d_input_u8(u, image_mean=cfg.image_mean,
                                           device=dev))
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(images)
    log(f"served forward incl. host s2d prep + copy: {e2e_ms:.4f} ms")
    c4s = [d["c4"] for d in per_image]
    c8s = [K.down_stage_i8(c4, pkg["l2_0"], pkg["l2_1"]) for c4 in c4s]

    def stages34(x):
        for li in (3, 4):
            for bi in range(2):
                e = pkg[f"l{li}_{bi}"]
                x = i8._apply_block(x, e, e["stride"])
        return x

    sp3_in = [K.conv3x3s2_i8(s1, pkg["sp2"]["w"], pkg["sp2"]["m"],
                             pkg["sp2"]["c"]) for s1 in
              (d["s1"] for d in per_image)]
    l34_ms = cuda_ms(stages34, [(x,) for x in c8s])
    sp3_ms = cuda_ms(lambda x: i8._apply_cbr(x, pkg["sp3"], 1, 0),
                     [(x,) for x in sp3_in])
    with torch.inference_mode():
        body = [i8.int8_body(pkg, x) for x in xss]
    dec_ms = cuda_ms(
        lambda s, f: i8._apply_int8_decoder(pkg["dec"], s, f[-2], f[-1]),
        body)
    log(f"plain float64 route: stages 3+4 {l34_ms:.4f} ms, sp3 "
        f"{sp3_ms:.4f} ms, int8 decoder {dec_ms:.4f} ms")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
