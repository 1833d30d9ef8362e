"""Ahead-of-time serving artifacts with ``torch.export`` (counterpart of
torchseg_tpu/deploy/export.py, which writes ``jax.export`` StableHLO).

The contract is JAX's: uint8 image in, labels (or log-softmax scores) out,
the normalize inside the graph, the weights inside the artifact.  Layout
(a directory):
    graph.pt2     ``torch.export.save`` of the serving graph
    prepare.pt2   the int8-through input prep (s2d or pad), its own graph
    meta.json     experiment, shapes, output contract, provenance

What differs from JAX, on purpose:
  * the serving site needs torch and, for an artifact exported with
    ``--platforms cuda``, the port's kernel library: the int8-through
    graph calls the hand-written kernels as ``torchseg_cuda`` ops
    (``ops/kernels/custom_ops.py``), which ``import
    torchseg_tpu_torch.ops.kernels.custom_ops`` registers (the kernels are
    built from the package's sources at the first launch).  A ``cpu``
    artifact holds the plain graph (the kernels' plain versions traced into
    ATen ops), as JAX exports its plain stem unless the platform is TPU
    alone.  One platform an artifact: its tensors live on that device, and
    ``load_artifact`` refuses another;
  * ``--check`` is exact: ``torch.export`` does not constant-fold, so the
    artifact replays the live graph's ops and its labels (and the prepare
    graph's int8 codes, and any scores) must equal the live forward's bit
    for bit.  JAX accepts 99 % label agreement, XLA's constant folding
    rounding bf16 otherwise.

Usage:
    python -m torchseg_tpu_torch.deploy.export \\
        -e cityscapes.bisenet.R18.speed -o /tmp/r18.art --int8-through
    # at the serving site:
    from torchseg_tpu_torch.deploy.export import load_artifact
    infer, meta = load_artifact("/tmp/r18.art")       # device "cuda"
    labels = infer(u8_image)                          # (1, H, W) int32
"""

import argparse
import contextlib
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.kernels.custom_ops import flat_entry

GRAPH_FILE = "graph.pt2"
PREPARE_FILE = "prepare.pt2"
META_FILE = "meta.json"
FORMAT = "torchseg-tpu-torch-serving/1"
PLATFORMS = ("cuda", "cpu")


class ServingModule(nn.Module):
    """``img_u8`` (N, H, W, 3) uint8 -> (N, H, W) int32 labels, or the
    (N, H, W, C) log-softmax scores (JAX ``build_serving_fn``): the
    reference's normalize (img / 255 - mean) / std in ``dtype``, the eval
    forward, the argmax."""

    def __init__(self, model: nn.Module, image_mean, image_std,
                 output: str = "labels", dtype=torch.bfloat16):
        super().__init__()
        if output not in ("labels", "scores"):
            raise ValueError(
                f"output must be 'labels'|'scores', got {output!r}")
        dev = next(model.parameters()).device
        self.model = model.eval()
        self.output = output
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(image_mean, dtype=dtype,
                                                  device=dev))
        self.register_buffer("std", torch.tensor(image_std, dtype=dtype,
                                                 device=dev))
        self.register_buffer("scale", torch.tensor(255.0, dtype=dtype,
                                                   device=dev))

    def forward(self, img_u8):
        x = (img_u8.to(self.dtype) / self.scale - self.mean) / self.std
        scores = self.model(x.permute(0, 3, 1, 2))
        if self.output == "labels":
            return scores.argmax(dim=1).to(torch.int32)
        return scores.permute(0, 2, 3, 1)


def build_serving_fn(model, *, image_mean: Sequence[float],
                     image_std: Sequence[float], output: str = "labels",
                     dtype=torch.bfloat16) -> ServingModule:
    """The float serving graph of ``model`` (in ``dtype``, on its
    device) as a module."""
    return ServingModule(model.to(dtype), image_mean, image_std, output,
                         dtype)


class PrepareModule(nn.Module):
    """The int8-through input prep as a graph (JAX ``make_prepare_graph``),
    built from its description: ``{"format": "s2d", "pads": ((t, b), (l,
    r)), "image_mean"}`` (the 2x2 space-to-depth, codes value - 128, the
    pad the code of normalized zero) or ``{"format": "pad", "pad": p,
    "image_mean"}``."""

    def __init__(self, prep: Dict[str, Any]):
        super().__init__()
        if prep["format"] not in ("s2d", "pad"):
            raise ValueError(f"unknown prep format {prep['format']!r}")
        mean = np.asarray(prep["image_mean"], np.float64)
        padv = (np.round(mean * 255.0) - 128).astype(np.int16)
        self.format = prep["format"]
        if self.format == "s2d":
            self.pads = tuple(tuple(int(v) for v in p) for p in prep["pads"])
            padv = np.tile(padv, 4)
        else:
            self.pad = int(prep["pad"])
        self.register_buffer("padv", torch.from_numpy(padv))

    def forward(self, img_u8):
        b, h, w, c = img_u8.shape
        if self.format == "s2d":
            (pt, pb), (pl, pr) = self.pads
            xs = img_u8.reshape(b, h // 2, 2, w // 2, 2, c)
            xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2,
                                                      4 * c)
            hh, ww, top, left = h // 2 + pt + pb, w // 2 + pl + pr, pt, pl
        else:
            p = self.pad
            xs, hh, ww, top, left = img_u8, h + 2 * p, w + 2 * p, p, p
        out = self.padv.expand(b, hh, ww, xs.shape[3]).clone()
        out[:, top:top + xs.shape[1], left:left + xs.shape[2]] = (
            xs.to(torch.int16) - 128)
        return torch.clamp(out, -128, 127).to(torch.int8)


def make_prepare_graph(prep: Dict[str, Any]) -> PrepareModule:
    return PrepareModule(prep)


def prep_of(cfg) -> Dict[str, Any]:
    """The int8-through input prep of an experiment (the description JAX's
    ``build_int8_serving_for_experiment`` returns): the classic-stem
    BiSeNets read the pre-padded s2d image, BiSeNet-R101 the image padded
    by 3, the Bottleneck families by 1."""
    from .int8_serve import _BOTTLENECK_FAMILIES

    if cfg.model == "bisenet_r101":
        return {"format": "pad", "pad": 3, "image_mean": cfg.image_mean}
    if cfg.model.startswith(_BOTTLENECK_FAMILIES):
        return {"format": "pad", "pad": 1, "image_mean": cfg.image_mean}
    return {"format": "s2d", "pads": ((2, 1), (2, 1)),
            "image_mean": cfg.image_mean}


class PackageModule(nn.Module):
    """An int8 package as a module: every tensor a buffer (``torch.export``
    lifts buffers; a dict of tensors it would not), the structure and the
    Python statics (``kind``, strides, scales, ``n_sp``) kept beside them.
    ``tree()`` gives the package back, its tensors these buffers."""

    def __init__(self, pkg: dict):
        super().__init__()
        self._layout = self._register(pkg, ())

    def _register(self, tree, prefix):
        if torch.is_tensor(tree):
            name = "__".join(prefix)
            self.register_buffer(name, tree)
            return ("buffer", name)
        if isinstance(tree, dict):
            return {k: self._register(v, prefix + (str(k),))
                    for k, v in tree.items()}
        return ("static", tree)

    def _build(self, layout):
        if isinstance(layout, dict):
            return {k: self._build(v) for k, v in layout.items()}
        kind, value = layout
        return getattr(self, value) if kind == "buffer" else value

    def tree(self) -> dict:
        return self._build(self._layout)


class Int8ServingModule(nn.Module):
    """The int8-through serving graph: ``infer(pkg, xs)`` over the package
    held as buffers and, where the graph runs a float head, that head as a
    submodule."""

    def __init__(self, infer, pkg: dict):
        super().__init__()
        self.pkg = PackageModule(pkg)
        self.head = getattr(infer, "head", None)
        self._infer = infer

    def forward(self, xs):
        return self._infer(self.pkg.tree(), xs)


def _aval(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(map(str, t.shape))}]"


def _op(name):
    return getattr(torch.ops.torchseg_cuda, name)


def _cbr_i8(x, e, stride, pad, emit_int8=True, dilation=1):
    return _op("cbr_i8")(x, e["w"], e["m"], e["c"], stride, pad, emit_int8,
                         dilation)


def _bottleneck_i8(x, e, stride, dilation, emit_int8=True):
    return _op("bottleneck_i8")(x, flat_entry(e),
                                float(e.get("res_ratio", 0.0)), stride,
                                dilation, emit_int8)


def _stem_conv7x7_s2(x, w, a, b, n_sp, input_format="nhwc",
                     out_dtype=torch.bfloat16, pack=None):
    return _op("stem_conv7x7_s2")(x, w, a, b, n_sp, input_format, out_dtype,
                                  pack)


# the kernel wrappers the serving modules call, by name, as their ops
SHIMS = {
    "stem_pool_i8": lambda xs, wf, m, c, n_sp: _op("stem_pool_i8")(
        xs, wf, m, c, n_sp),
    "spatial_path_i8": lambda sp, p1, p2: _op("conv3x3s2_i8")(
        _op("conv3x3s2_i8")(sp, p1["w"], p1["m"], p1["c"]),
        p2["w"], p2["m"], p2["c"]),
    "l1_stage_i8": lambda x, e0, e1: _op("l1_stage_i8")(
        x, flat_entry(e0), float(e0["res_ratio"]), flat_entry(e1),
        float(e1["res_ratio"])),
    "down_stage_i8": lambda x, e0, e1: _op("down_stage_i8")(
        x, flat_entry(e0), flat_entry(e1), float(e1["res_ratio"])),
    "down_block_i8": lambda x, e: _op("down_block_i8")(x, flat_entry(e)),
    "res_block_i8": lambda x, e: _op("res_block_i8")(
        x, flat_entry(e), float(e["res_ratio"])),
    "maxpool2d_3x3s2_i8": lambda x: _op("maxpool2d_3x3s2_i8")(x),
    "cbr_i8": _cbr_i8,
    "bottleneck_i8": _bottleneck_i8,
    "fused_upsample_argmax": lambda x, out_hw: _op("fused_upsample_argmax")(
        x, [int(out_hw[0]), int(out_hw[1])]),
    "stem_conv7x7_s2": _stem_conv7x7_s2,
}


@contextlib.contextmanager
def kernel_ops():
    """Within, the serving modules (``deploy/int8_serve.py``,
    ``deploy/fused_stem.py``) call the kernels through the
    ``torchseg_cuda`` ops, which ``torch.export`` and the FLOP counter
    see; their direct wrapper calls come back on exit.  It rebinds module
    globals: one thread at a time."""
    from . import fused_stem, int8_serve

    saved = []
    try:
        for mod in (int8_serve, fused_stem):
            for name, shim in SHIMS.items():
                if hasattr(mod, name):
                    saved.append((mod, name, getattr(mod, name)))
                    setattr(mod, name, shim)
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def export_serving(module: nn.Module, example_args: Tuple,
                   platform: str = "cuda"):
    """``torch.export`` of ``module`` on ``example_args``: on ``cuda``
    with the kernels as ``torchseg_cuda`` ops, on ``cpu`` with the plain
    versions traced (the wrappers' CPU route)."""
    ctx = kernel_ops() if platform == "cuda" else contextlib.nullcontext()
    with ctx:
        return torch.export.export(module, tuple(example_args), strict=False)


def save_artifact(path: str, exported, meta: Optional[Dict[str, Any]] = None,
                  prepare=None, platforms: Sequence[str] = ("cuda",)) -> str:
    """Write the artifact directory (graph.pt2 [+ prepare.pt2] +
    meta.json)."""
    os.makedirs(path, exist_ok=True)
    graph = os.path.join(path, GRAPH_FILE)
    torch.export.save(exported, graph)
    if prepare is not None:
        torch.export.save(prepare, os.path.join(path, PREPARE_FILE))
    ins = [n.meta["val"] for n in exported.graph.nodes
           if n.op == "placeholder" and n.name in
           exported.graph_signature.user_inputs]
    outs = [n for n in exported.graph.nodes if n.op == "output"][0].args[0]
    full_meta = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "in_avals": [_aval(v) for v in ins],
        "out_avals": [_aval(o.meta["val"]) for o in outs],
        "graph_bytes": os.path.getsize(graph),
        "has_prepare": prepare is not None,
        **(meta or {}),
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(full_meta, f, indent=2, sort_keys=True)
    return path


def load_artifact(path: str, device="cuda"):
    """An artifact -> (callable, meta).  Raises ValueError on a device the
    artifact was not exported for.  With a prepare graph (int8-through
    exports) the callable runs it before the main graph, so the contract
    stays uint8 image in.  A ``cuda`` artifact's kernel ops are registered
    when this module is imported (``ops/kernels/custom_ops.py``)."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    kind = torch.device(device).type
    if kind not in meta["platforms"]:
        raise ValueError(
            f"artifact {path} was exported for {meta['platforms']}, not "
            f"{kind}")
    main = torch.export.load(os.path.join(path, GRAPH_FILE)).module()
    prep_path = os.path.join(path, PREPARE_FILE)
    prep = (torch.export.load(prep_path).module()
            if os.path.exists(prep_path) else None)

    @torch.inference_mode()
    def infer(img_u8):
        return main(img_u8 if prep is None else prep(img_u8))

    return infer, meta


def build_argparser():
    p = argparse.ArgumentParser(
        description="Export an AOT serving artifact (torch.export, weights "
                    "inside; uint8 image in, labels out).")
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("-o", "--out", required=True, help="artifact directory")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint to embed (default: random "
                        "init, smoke/testing only)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference .pth to graft and embed")
    p.add_argument("--input-size", default=None,
                   help="NxHxWxC; default is the experiment's deploy "
                        "resolution (eval_resize_to for .speed variants, "
                        "else the train crop); the artifact's input shape "
                        "is fixed")
    p.add_argument("--scores", action="store_true",
                   help="emit log-softmax scores instead of argmax labels")
    p.add_argument("--int8-through", action="store_true",
                   help="export the int8-through serving graph "
                        "(deploy/int8_serve.py) plus its uint8 prepare "
                        "graph: the contract stays uint8 in, labels out")
    p.add_argument("--int8-decoder", dest="int8_decoder",
                   action="store_true", default=None,
                   help="with --int8-through: force the int8 decoder "
                        "(classic-stem BiSeNet only; the default there)")
    p.add_argument("--bf16-decoder", dest="int8_decoder",
                   action="store_false",
                   help="with --int8-through: force the bf16 decoder")
    p.add_argument("--calib-size", default="1x256x512x3",
                   help="--int8-through random-calibration image size "
                        "(production: calibrate on val crops)")
    p.add_argument("--f32", action="store_true",
                   help="serve in float32 (default bfloat16)")
    p.add_argument("--platforms", default="cuda",
                   help="the device the artifact runs on: cuda (the "
                        "kernels as ops) or cpu (the plain graph)")
    p.add_argument("--check", action="store_true",
                   help="after export: reload and require the live "
                        "forward's outputs bit for bit")
    return p


def main(argv=None):
    """Export; returns the artifact directory."""
    args = build_argparser().parse_args(argv)
    from ..entry import _no_tf32
    from ..experiments.registry import build_model, get_experiment
    from ..models import init_weights

    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise SystemExit(f"--platforms takes one of {PLATFORMS} (an "
                         f"artifact's tensors live on one device), got "
                         f"{args.platforms!r}")
    if args.int8_through and args.scores:
        raise SystemExit("--int8-through emits argmax labels only")
    device = torch.device(platforms[0])
    _no_tf32()
    cfg = get_experiment(args.experiment)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        from ..utils.torch_convert import graft_full_checkpoint, model_family

        graft_full_checkpoint(args.torch_checkpoint, model,
                              model_family(cfg.model))
        source = args.torch_checkpoint
    elif args.checkpoint:
        from ..engine.checkpoint import restore_checkpoint
        from ..engine.trainer import TrainState

        restore_checkpoint(args.checkpoint, TrainState(model, None))
        source = args.checkpoint
    else:
        source = "random-init"
    model = model.to(device).eval()
    dtype = torch.float32 if args.f32 else torch.bfloat16
    if args.input_size:
        shape = tuple(int(s) for s in args.input_size.split("x"))
    elif cfg.eval_resize_to is not None:
        shape = (1, *cfg.eval_resize_to, 3)
    else:
        shape = (1, cfg.image_height, cfg.image_width, 3)
    output = "scores" if args.scores else "labels"
    n_params = sum(p.numel() for p in model.parameters())
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    prep_exported = None
    if args.int8_through:
        from .int8_serve import build_int8_serving_for_experiment

        calib_shape = tuple(int(s) for s in args.calib_size.split("x"))
        decoder = (None if args.int8_decoder is None else
                   "int8" if args.int8_decoder else "bf16")
        try:
            infer, pkg, prepare = build_int8_serving_for_experiment(
                cfg, model, decoder=decoder, calib_shape=calib_shape)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--int8-through: {e}")
        prep = prep_of(cfg)
        graph = Int8ServingModule(infer, pkg)
        prep_graph = make_prepare_graph(prep).to(device)
        xs = prepare(np.zeros(shape, np.uint8))
        exported = export_serving(graph, (xs,), platforms[0])
        prep_exported = torch.export.export(
            prep_graph, (torch.zeros(shape, dtype=torch.uint8,
                                     device=device),), strict=False)
        mode = ("int8-through+dec" if prep["format"] == "s2d"
                else "int8-through")

        def live(img):
            return infer(pkg, prepare(img))
    else:
        graph = build_serving_fn(model, image_mean=cfg.image_mean,
                                 image_std=cfg.image_std, output=output,
                                 dtype=dtype)
        exported = export_serving(graph, (torch.zeros(
            shape, dtype=torch.uint8, device=device),), platforms[0])

        def live(img):
            with torch.inference_mode():
                return graph(torch.from_numpy(img).to(device))
    save_artifact(args.out, exported, {
        "experiment": cfg.name,
        "model": cfg.model,
        "num_classes": cfg.num_classes,
        "input_shape": list(shape),
        "input_dtype": "uint8",
        "output": output,
        "serve_mode": mode,
        "serve_dtype": str(dtype).replace("torch.", ""),
        "weights_source": source,
        "n_params": n_params,
    }, prepare=prep_exported, platforms=platforms)
    print(f"exported {cfg.name} -> {args.out} "
          f"({os.path.getsize(os.path.join(args.out, GRAPH_FILE)) / 1e6:.1f}"
          f" MB, platforms={platforms}, {output} @ {shape})")

    if args.check:
        loaded, _ = load_artifact(args.out, device)
        img = np.random.default_rng(0).integers(0, 255, shape).astype(
            np.uint8)
        got = loaded(torch.from_numpy(img).to(device))
        want = live(img)
        msgs = []
        if args.int8_through:
            codes = prep_exported.module()(torch.from_numpy(img).to(device))
            if not torch.equal(codes, prepare(img)):
                msgs.append("the prepare graph's int8 codes differ")
        if got.dtype != want.dtype or not torch.equal(got, want):
            msgs.append(f"{output} differ from the live forward's "
                        f"({float((got == want).float().mean()):.6f} equal)")
        if msgs:
            raise SystemExit("artifact vs live forward: " + "; ".join(msgs))
        print(f"check: artifact vs live forward on {device}: exact")
    return args.out


if __name__ == "__main__":
    main()
