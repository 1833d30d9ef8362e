"""Carry JAX-side arrays into the port (counterpart of
torchseg_tpu/utils/torch_convert.py, in the other direction), and the
port's parameters back out in the flax layout (``to_jax_variables``, the
tree ``utils/torch_convert.py`` grafts reference checkpoints onto).

The functions take and give trees of numpy arrays (``jax.device_get``
output), so this module imports no JAX.  The port's submodules carry the flax module
names, so a flax path maps to a ``state_dict`` key mechanically:
``params/a/b/kernel`` -> ``a.b.weight`` (conv HWIO -> OIHW, dense (in,
out) -> (out, in)), ``scale`` ->
``weight``, ``bias`` -> ``bias``; ``batch_stats/a/b/mean`` and ``var`` ->
``running_mean`` and ``running_var``.
"""

from typing import Dict

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` numpy tree -> the port model's
    float32 ``state_dict`` (load it with ``strict=True``)."""
    sd = {}
    for coll, names in (("params", _PARAM_LEAVES),
                        ("batch_stats", _STAT_LEAVES)):
        for path, arr in _leaves(variables.get(coll, {})):
            *mods, leaf = path
            if leaf not in names:
                raise KeyError(f"unknown {coll} leaf {'/'.join(path)}")
            a = np.asarray(arr, np.float32)
            if leaf == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif leaf == "kernel" and a.ndim == 2:
                a = a.T  # flax Dense (in, out) -> nn.Linear (out, in)
            prefix = ".".join(mods)
            sd[f"{prefix}.{names[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(a))
            if leaf == "mean":
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_leaves(model: torch.nn.Module):
    """Every parameter and BN statistic of ``model`` as (collection, flax
    module path, flax leaf name, tensor in the port's layout, its
    module): ``weight`` -> ``kernel`` (a conv's, a linear's) or ``scale``
    (a norm's), ``running_mean``/``running_var`` -> ``batch_stats``
    ``mean``/``var``; ``num_batches_tracked`` left out."""
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        own = list(mod.named_parameters(recurse=False)) + [
            (k, v) for k, v in mod.named_buffers(recurse=False)
            if k in ("running_mean", "running_var")]
        for leaf, t in own:
            if leaf == "weight":
                kernel = t.dim() == 4 or isinstance(mod, torch.nn.Linear)
                yield ("params", path, "kernel" if kernel else "scale", t,
                       mod)
            elif leaf == "bias":
                yield "params", path, "bias", t, mod
            else:
                yield ("batch_stats", path, leaf[len("running_"):], t, mod)


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The model's ``{"params", "batch_stats"}`` tree in the flax layout
    as float32 numpy arrays: ``from_jax_variables``'s inverse (conv OIHW ->
    HWIO, linear (out, in) -> (in, out))."""
    out = {"params": {}, "batch_stats": {}}
    for coll, path, key, t, _ in flax_leaves(model):
        a = t.detach().float().cpu().numpy()
        if key == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = out[coll]
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(a)
    return out


def _tensor(a: np.ndarray, device):
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree, device):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _convert(v, device)
        elif isinstance(v, (int, str)) and not isinstance(v, bool):
            out[k] = v
        else:
            a = np.asarray(v)
            out[k] = float(a) if a.ndim == 0 else _tensor(a, device)
    return out


def _bottleneck_package(pkg, device, strides, dilations) -> dict:
    """A ``bottleneck{50,101}`` package (or its run package); the depth
    comes from stage 3's block count, each block's stride and dilation
    from its entry where it has them (a built package), else from these
    stage strides and dilations (a run package, its statics stripped)."""
    from ..deploy.int8_serve import RESNET_LAYERS, block_statics

    n3 = sum(1 for k in pkg if k.startswith("l3_"))
    depth = next((d for d, layers in RESNET_LAYERS.items()
                  if layers[2] == n3), None)
    if depth is None or pkg.get("kind", f"bottleneck{depth}") != \
            f"bottleneck{depth}":
        raise NotImplementedError(
            f"a Bottleneck package with {n3} stage-3 blocks is not ported "
            "(ROADMAP A4)")
    statics = block_statics(depth, strides, dilations)
    out = _convert({k: v for k, v in pkg.items()
                    if k not in ("kind", "layers")}, device)
    out["kind"] = f"bottleneck{depth}"
    out["layers"] = RESNET_LAYERS[depth]
    for name, (stride, dilation) in statics.items():
        out[name]["stride"] = int(pkg[name].get("stride", stride))
        out[name]["dilation"] = int(pkg[name].get("dilation", dilation))
    return out


def int8_package_from_numpy(pkg, device, strides=None,
                            dilations=None) -> dict:
    """A JAX int8-through package (``build_int8_package`` /
    ``build_int8_backbone_package`` / ``build_int8_bisenet_r101_package``
    output, or the ``run_pkg`` of ``make_int8_through_infer`` /
    ``make_int8_pspnet_infer`` / ``make_int8_bisenet_r101_infer`` with its
    statics stripped), as numpy arrays -> the port's package on
    ``device``.  Scalars become Python floats.

    BiSeNet-R18 with the int8 decoder: the stripped statics (``kind``,
    ``n_sp``, block strides) are restored from the shapes, and entries the
    port's graph does not read (the int8 stem variant, the bf16 decoder's
    ``s_c16``, TPU weight packings) are dropped.  The Bottleneck body
    (``bottleneck50``/``bottleneck101``, recognized by its ``stem1``):
    ``kind`` and ``layers`` are restored from ``RESNET_LAYERS``, and a
    block's ``stride`` and ``dilation`` from its entry, else from
    ``strides`` / ``dilations`` (a run package's are stripped; None:
    ``DILATED``, the PSPNet and PSANet layout; FCN's and DFN's run packages
    need ``STANDARD``).  BiSeNet-R101 (recognized by its ``bb``): the
    spatial path's entries and the body under ``bb``, at ``STANDARD``
    unless told otherwise."""
    from ..deploy.int8_serve import DILATED, STANDARD

    if "bb" in pkg:
        if pkg.get("kind", "bisenet_r101") != "bisenet_r101":
            raise NotImplementedError(
                f"package kind {pkg['kind']!r} is not ported (ROADMAP A4)")
        out = _convert({k: pkg[k] for k in ("sp_stem", "sp1", "sp2",
                                            "sp3")}, device)
        out["kind"] = "bisenet_r101"
        out["bb"] = _bottleneck_package(
            pkg["bb"], device, strides or STANDARD["strides"],
            dilations or STANDARD["dilations"])
        return out
    if "stem1" in pkg:
        return _bottleneck_package(pkg, device,
                                   strides or DILATED["strides"],
                                   dilations or DILATED["dilations"])
    if pkg.get("kind", "r18") != "r18" or "dec" not in pkg:
        raise NotImplementedError(
            "only R18 packages with the int8 decoder, the Bottleneck body "
            "and BiSeNet-R101 are ported (ROADMAP A4)")
    blocks = [f"l{li}_{bi}" for li in range(1, 5) for bi in range(2)]
    out = _convert({k: pkg[k] for k in ("sp1", "sp2", "sp3", "dec",
                                        *blocks)}, device)
    out["kind"] = "r18"
    stem = pkg["stem"]
    out["stem"] = _convert({k: stem[k] for k in ("wf", "mf", "cf")}, device)
    out["stem"]["n_sp"] = int(stem.get("n_sp", pkg["sp1"]["w"].shape[2]))
    for name in blocks:
        out[name]["stride"] = int(pkg[name].get(
            "stride", 2 if "down" in pkg[name] else 1))
    return out
