"""Carry JAX-side arrays into the port (counterpart of
torchseg_tpu/utils/torch_convert.py, in the other direction).

Both functions take trees of numpy arrays (``jax.device_get`` output), so
this module imports no JAX.  The port's submodules carry the flax module
names, so a flax path maps to a ``state_dict`` key mechanically:
``params/a/b/kernel`` -> ``a.b.weight`` (HWIO -> OIHW), ``scale`` ->
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
            prefix = ".".join(mods)
            sd[f"{prefix}.{names[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(a))
            if leaf == "mean":
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


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


def int8_package_from_numpy(pkg, device) -> dict:
    """A JAX int8-through package for BiSeNet-R18 with the int8 decoder
    (``build_int8_package`` output, or the ``run_pkg`` of
    ``make_int8_through_infer`` with its statics stripped), as numpy
    arrays -> the port's package on ``device``.  Scalars become Python
    floats; the stripped statics (``kind``, ``n_sp``, block strides) are
    restored from the shapes.  Entries the port's graph does not read (the
    int8 stem variant, the bf16 decoder's ``s_c16``, TPU weight packings)
    are dropped."""
    if pkg.get("kind", "r18") != "r18" or "dec" not in pkg:
        raise NotImplementedError(
            "only R18 packages with the int8 decoder are ported "
            "(ROADMAP A3)")
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
