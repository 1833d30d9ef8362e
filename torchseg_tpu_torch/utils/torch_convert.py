"""Reference ``.pth`` checkpoints into the port (counterpart of
torchseg_tpu/utils/torch_convert.py).

The reference's ``utils/pyt_utils.load_model`` (a non-strict state_dict
load that logs missing and unexpected keys, pyt_utils.py:42-79) for the
port's modules.  The key mapping is JAX's, copied as numpy: a reference
key maps to a flax path (``resnet_key_map``, ``xception_key_map``, the
per-family ``_MODEL_RULES``), the tensor to the JAX layout (conv OIHW ->
HWIO, depthwise (C, 1, k, k) -> (k, k, 1, C), linear (out, in) -> (in,
out), BN weight/bias -> scale/bias, running_mean/var -> batch_stats
mean/var).  The converted tree is grafted onto the model's own tree
(``utils.jax_params.to_jax_variables``) and loaded back through
``from_jax_variables``, so the port has one naming authority: the
transposes there and back are exact.

The file is read with ``torch.load(weights_only=True)``: a reference
checkpoint is dicts of tensors and numbers (JAX reads it unrestricted).
"""

import functools
import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..engine.logger import get_logger
from .jax_params import flax_leaves, from_jax_variables, to_jax_variables


def _to_numpy_state_dict(path_or_dict) -> Dict[str, np.ndarray]:
    """A state_dict (or a path to a file holding one, possibly under
    ``state_dict`` or ``model``) -> {key: numpy array}, ``module.``
    stripped (DataParallel's prefix)."""
    if isinstance(path_or_dict, dict):
        sd = path_or_dict
    else:
        sd = torch.load(path_or_dict, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if torch.is_tensor(v):
            out[k] = v.detach().cpu().numpy()
        elif isinstance(v, (np.ndarray, int, float)):
            out[k] = np.asarray(v)
    return out


def resnet_key_map(torch_key: str) -> Tuple[Tuple[str, ...], str]:
    """Map a torch ResNet state_dict key to (flax_path, kind).

    kind: 'conv' | 'bn_param' | 'bn_stat' | 'skip'.
    Handles classic and deep (v1c) stems, layers, and downsample shortcuts.
    """
    k = torch_key
    if k.startswith("fc."):
        return (), "skip"

    # deep stem Sequential: conv1.{0,3,6} convs; conv1.{1,4} bns
    m = re.fullmatch(r"conv1\.(\d)\.(.+)", k)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        conv_names = {0: "stem_conv1", 3: "stem_conv2", 6: "stem_conv3"}
        bn_names = {1: "stem_bn1", 4: "stem_bn2"}
        if idx in conv_names:
            return (conv_names[idx],), "conv"
        if idx in bn_names:
            return (bn_names[idx],), _bn_kind(rest)
        return (), "skip"

    if k.startswith("conv1."):
        return ("conv1",), "conv"
    if k.startswith("bn1."):
        return ("bn1",), _bn_kind(k.split(".", 1)[1])

    m = re.fullmatch(r"layer(\d)\.(\d+)\.(.+)", k)
    if m:
        layer, block, rest = m.group(1), m.group(2), m.group(3)
        prefix = f"layer{layer}_{block}"
        m2 = re.fullmatch(r"conv(\d)\.weight", rest)
        if m2:
            return (prefix, f"conv{m2.group(1)}"), "conv"
        m2 = re.fullmatch(r"bn(\d)\.(.+)", rest)
        if m2:
            return (prefix, f"bn{m2.group(1)}"), _bn_kind(m2.group(2))
        m2 = re.fullmatch(r"downsample\.0\.weight", rest)
        if m2:
            return (prefix, "downsample_conv"), "conv"
        m2 = re.fullmatch(r"downsample\.1\.(.+)", rest)
        if m2:
            return (prefix, "downsample_bn"), _bn_kind(m2.group(1))
    return (), "skip"


def _bn_kind(rest: str) -> str:
    if rest in ("weight", "bias"):
        return "bn_param"
    if rest in ("running_mean", "running_var"):
        return "bn_stat"
    return "skip"  # num_batches_tracked


def convert_resnet_state_dict(sd: Dict[str, np.ndarray]):
    """torch ResNet state_dict -> (params, batch_stats) nested dicts in the
    flax naming scheme."""
    params, stats = {}, {}
    for k, v in sd.items():
        path, kind = resnet_key_map(k)
        if kind == "skip":
            continue
        if kind == "conv":
            _set(params, path + ("kernel",), np.transpose(v, (2, 3, 1, 0)))
        elif kind == "bn_param":
            leaf = "scale" if k.endswith("weight") else "bias"
            _set(params, path + (leaf,), v)
        elif kind == "bn_stat":
            leaf = "mean" if k.endswith("running_mean") else "var"
            _set(stats, path + (leaf,), v)
    return params, stats


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def graft(target_tree, source_tree, log=True):
    """Non-strict copy of source leaves into target (same path + shape);
    logs missing/unexpected keys like pyt_utils.load_model:42-79."""
    logger = get_logger()
    tgt = _flatten(target_tree)
    src = _flatten(source_tree)
    grafted, mismatched = {}, []
    for path, v in src.items():
        if path in tgt:
            if tuple(tgt[path].shape) == tuple(v.shape):
                grafted[path] = v
            else:
                mismatched.append((path, v.shape, tgt[path].shape))
    missing = [p for p in tgt if p not in grafted]
    unexpected = [p for p in src if p not in tgt]
    if log:
        if missing:
            logger.info("graft: %d target leaves not in checkpoint "
                        "(first: %s)", len(missing), missing[:3])
        if unexpected:
            logger.info("graft: %d checkpoint leaves unused (first: %s)",
                        len(unexpected), unexpected[:3])
        if mismatched:
            logger.warning("graft: %d shape mismatches: %s", len(mismatched),
                           mismatched[:3])

    def rebuild(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = rebuild(v, prefix + (k,))
            else:
                out[k] = (
                    np.asarray(grafted[prefix + (k,)], dtype=v.dtype)
                    if prefix + (k,) in grafted
                    else v
                )
        return out

    return rebuild(target_tree)


def _load_tree(model: nn.Module, variables) -> nn.Module:
    """Load a flax-layout numpy tree covering the whole model into it, in
    place (the model keeps its device and dtype)."""
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def graft_backbone(model: nn.Module, src_params, src_stats,
                   subtree: str = "backbone") -> nn.Module:
    """Graft flax-layout backbone trees under ``model.<subtree>``, in
    place; every other leaf keeps its value."""
    variables = to_jax_variables(model)
    for coll, src in (("params", src_params), ("batch_stats", src_stats)):
        variables[coll][subtree] = graft(variables[coll][subtree], src)
    return _load_tree(model, variables)


def graft_torch_checkpoint(path: str, model: nn.Module,
                           subtree: str = "backbone") -> nn.Module:
    """Load a torch ResNet/Xception backbone .pth and graft it under
    ``model.<subtree>`` (parameters and BN statistics), in place; returns
    the model."""
    sd = _to_numpy_state_dict(path)
    src_params, src_stats = convert_resnet_state_dict(sd)
    return graft_backbone(model, src_params, src_stats, subtree)


# ---------------------------------------------------------------------
# Full-model key mapping: reference model/*/network.py module names ->
# the flax param paths (which the port's module names follow).
#
# Leaf kinds: conv (OIHW->HWIO), dwconv ((C,1,k,k)->(k,k,1,C)),
# linear (transpose), bias (copy), bn (split into params/batch_stats).
# ---------------------------------------------------------------------

_BN_LEAF = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("stats", "mean"),
    "running_var": ("stats", "var"),
}


def xception_key_map(torch_key):
    """furnace/base_model/xception.py keys -> models/xception.py paths."""
    k = torch_key
    m = re.fullmatch(r"conv1\.conv\.weight", k)
    if m:
        return ("conv1", "conv"), "conv"
    m = re.fullmatch(r"conv1\.bn\.(.+)", k)
    if m:
        return ("conv1", "bn", m.group(1)), "bn"
    m = re.fullmatch(r"layer(\d)\.(\d+)\.(.+)", k)
    if not m:
        return None
    prefix = (f"layer{m.group(1)}_{m.group(2)}",)
    rest = m.group(3)
    # branches: proj | residual_branch.{0,1,2} -> proj | sep1..sep3
    m2 = re.fullmatch(r"proj\.(.+)", rest)
    if m2:
        sub, rest2 = "proj", m2.group(1)
    else:
        m2 = re.fullmatch(r"residual_branch\.(\d)\.(.+)", rest)
        if not m2:
            return None
        sub, rest2 = f"sep{int(m2.group(1)) + 1}", m2.group(2)
    # SeparableConvBnRelu: conv1 (depthwise) + point_wise_cbr.{conv,bn}
    if rest2 == "conv1.weight":
        return prefix + (sub, "depthwise"), "dwconv"
    m3 = re.fullmatch(r"point_wise_cbr\.conv\.weight", rest2)
    if m3:
        return prefix + (sub, "pointwise", "conv"), "conv"
    m3 = re.fullmatch(r"point_wise_cbr\.bn\.(.+)", rest2)
    if m3:
        return prefix + (sub, "pointwise", "bn", m3.group(1)), "bn"
    return None


# Per-family regex rules.  Path templates use \N for regex groups; the
# special first components @resnet / @xception delegate the remainder.
# @bn marks the trailing torch-BN leaf (weight/bias/running_*).
_MODEL_RULES = {
    "bisenet": [
        (r"context_path\.(.+)", "@resnet \\1", None),
        (r"spatial_path\.(conv_7x7|conv_3x3_1|conv_3x3_2|conv_1x1)"
         r"\.conv\.weight", "spatial_path \\1 conv", "conv"),
        (r"spatial_path\.(conv_7x7|conv_3x3_1|conv_3x3_2|conv_1x1)"
         r"\.bn\.(.+)", "spatial_path \\1 bn @bn\\2", "bn"),
        (r"global_context\.1\.conv\.weight", "global_context conv", "conv"),
        (r"global_context\.1\.bn\.(.+)", "global_context bn @bn\\1", "bn"),
        (r"arms\.(\d)\.conv_3x3\.conv\.weight", "arm\\1 conv_3x3 conv", "conv"),
        (r"arms\.(\d)\.conv_3x3\.bn\.(.+)", "arm\\1 conv_3x3 bn @bn\\2", "bn"),
        (r"arms\.(\d)\.channel_attention\.1\.conv\.weight",
         "arm\\1 channel_attention conv", "conv"),
        (r"arms\.(\d)\.channel_attention\.1\.bn\.(.+)",
         "arm\\1 channel_attention bn @bn\\2", "bn"),
        (r"refines\.(\d)\.conv\.weight", "refine\\1 conv", "conv"),
        (r"refines\.(\d)\.bn\.(.+)", "refine\\1 bn @bn\\2", "bn"),
        (r"heads\.(\d)\.conv_3x3\.conv\.weight", "head\\1 conv_3x3 conv",
         "conv"),
        (r"heads\.(\d)\.conv_3x3\.bn\.(.+)", "head\\1 conv_3x3 bn @bn\\2",
         "bn"),
        (r"heads\.(\d)\.conv_1x1\.weight", "head\\1 conv_1x1", "conv"),
        (r"heads\.(\d)\.conv_1x1\.bias", "head\\1 conv_1x1", "bias"),
        (r"ffm\.conv_1x1\.conv\.weight", "ffm conv_1x1 conv", "conv"),
        (r"ffm\.conv_1x1\.bn\.(.+)", "ffm conv_1x1 bn @bn\\1", "bn"),
        (r"ffm\.channel_attention\.1\.conv\.weight", "ffm ca1 conv", "conv"),
        (r"ffm\.channel_attention\.2\.conv\.weight", "ffm ca2 conv", "conv"),
    ],
    "fcn": [
        (r"backbone\.(.+)", "@resnet \\1", None),
        (r"(head|aux_head)\.cbr\.conv\.weight", "\\1 cbr conv", "conv"),
        (r"(head|aux_head)\.cbr\.bn\.(.+)", "\\1 cbr bn @bn\\2", "bn"),
        (r"(head|aux_head)\.conv1x1\.weight", "\\1 conv1x1", "conv"),
        (r"(head|aux_head)\.conv1x1\.bias", "\\1 conv1x1", "bias"),
    ],
    "pspnet": [
        (r"backbone\.(.+)", "@resnet \\1", None),
        (r"psp_layer\.ppm\.(\d)\.[^.]*cbr\.conv\.weight",
         "psp_layer ppm\\1_cbr conv", "conv"),
        (r"psp_layer\.ppm\.(\d)\.[^.]*cbr\.bn\.(.+)",
         "psp_layer ppm\\1_cbr bn @bn\\2", "bn"),
        (r"psp_layer\.conv6\.0\.conv\.weight", "psp_layer conv6_cbr conv",
         "conv"),
        (r"psp_layer\.conv6\.0\.bn\.(.+)", "psp_layer conv6_cbr bn @bn\\1",
         "bn"),
        (r"psp_layer\.conv6\.2\.weight", "psp_layer conv6_out", "conv"),
        (r"psp_layer\.conv6\.2\.bias", "psp_layer conv6_out", "bias"),
        (r"aux_layer\.0\.conv\.weight", "aux_layer cbr conv", "conv"),
        (r"aux_layer\.0\.bn\.(.+)", "aux_layer cbr bn @bn\\1", "bn"),
        (r"aux_layer\.2\.weight", "aux_layer out", "conv"),
        (r"aux_layer\.2\.bias", "aux_layer out", "bias"),
    ],
    "psanet": [
        (r"backbone\.(.+)", "@resnet \\1", None),
        (r"psa_layer\.(collect|distribute)_reduction\.conv\.weight",
         "psa_layer \\1 reduction conv", "conv"),
        (r"psa_layer\.(collect|distribute)_reduction\.bn\.(.+)",
         "psa_layer \\1 reduction bn @bn\\2", "bn"),
        (r"psa_layer\.(collect|distribute)_attention\.0\.conv\.weight",
         "psa_layer \\1 att_cbr conv", "conv"),
        (r"psa_layer\.(collect|distribute)_attention\.0\.bn\.(.+)",
         "psa_layer \\1 att_cbr bn @bn\\2", "bn"),
        (r"psa_layer\.(collect|distribute)_attention\.1\.conv\.weight",
         "psa_layer \\1 att_out conv", "conv"),
        (r"psa_layer\.proj\.conv\.weight", "psa_layer proj conv", "conv"),
        (r"psa_layer\.proj\.bn\.(.+)", "psa_layer proj bn @bn\\1", "bn"),
        (r"psa_layer\.conv6\.0\.conv\.weight", "psa_layer conv6_cbr conv",
         "conv"),
        (r"psa_layer\.conv6\.0\.bn\.(.+)", "psa_layer conv6_cbr bn @bn\\1",
         "bn"),
        (r"psa_layer\.conv6\.2\.weight", "psa_layer conv6_out", "conv"),
        (r"psa_layer\.conv6\.2\.bias", "psa_layer conv6_out", "bias"),
        (r"aux_layer\.0\.conv\.weight", "aux_layer cbr conv", "conv"),
        (r"aux_layer\.0\.bn\.(.+)", "aux_layer cbr bn @bn\\1", "bn"),
        (r"aux_layer\.2\.weight", "aux_layer out", "conv"),
        (r"aux_layer\.2\.bias", "aux_layer out", "bias"),
    ],
    "dfn": [
        (r"backbone\.(.+)", "@resnet \\1", None),
        (r"global_context\.1\.conv\.weight", "global_context conv", "conv"),
        (r"global_context\.1\.bn\.(.+)", "global_context bn @bn\\1", "bn"),
        (r"(smooth_pre_rrb|smooth_aft_rrb|border_pre_rrb|border_aft_rrb)s"
         r"\.(\d)\.conv_1x1\.weight", "\\1\\2 conv_1x1", "conv"),
        (r"(smooth_pre_rrb|smooth_aft_rrb|border_pre_rrb|border_aft_rrb)s"
         r"\.(\d)\.cbr\.conv\.weight", "\\1\\2 cbr conv", "conv"),
        (r"(smooth_pre_rrb|smooth_aft_rrb|border_pre_rrb|border_aft_rrb)s"
         r"\.(\d)\.cbr\.bn\.(.+)", "\\1\\2 cbr bn @bn\\3", "bn"),
        (r"(smooth_pre_rrb|smooth_aft_rrb|border_pre_rrb|border_aft_rrb)s"
         r"\.(\d)\.conv_refine\.weight", "\\1\\2 conv_refine", "conv"),
        (r"cabs\.(\d)\.channel_attention\.fc\.0\.weight", "cab\\1 se fc1",
         "linear"),
        (r"cabs\.(\d)\.channel_attention\.fc\.0\.bias", "cab\\1 se fc1",
         "bias"),
        (r"cabs\.(\d)\.channel_attention\.fc\.2\.weight", "cab\\1 se fc2",
         "linear"),
        (r"cabs\.(\d)\.channel_attention\.fc\.2\.bias", "cab\\1 se fc2",
         "bias"),
        (r"(smooth_head|border_head)s\.(\d)\.rrb\.conv_1x1\.weight",
         "\\1\\2 rrb conv_1x1", "conv"),
        (r"(smooth_head|border_head)s\.(\d)\.rrb\.cbr\.conv\.weight",
         "\\1\\2 rrb cbr conv", "conv"),
        (r"(smooth_head|border_head)s\.(\d)\.rrb\.cbr\.bn\.(.+)",
         "\\1\\2 rrb cbr bn @bn\\3", "bn"),
        (r"(smooth_head|border_head)s\.(\d)\.rrb\.conv_refine\.weight",
         "\\1\\2 rrb conv_refine", "conv"),
        (r"(smooth_head|border_head)s\.(\d)\.conv\.weight", "\\1\\2 conv",
         "conv"),
        (r"(smooth_head|border_head)s\.(\d)\.conv\.bias", "\\1\\2 conv",
         "bias"),
    ],
}
# X39 BiSeNet: same head rules, xception backbone
_MODEL_RULES["bisenet_x39"] = [
    (r"context_path\.(.+)", "@xception \\1", None)
] + _MODEL_RULES["bisenet"][1:]


def model_family(model_name: str) -> str:
    """Registry model name (e.g. 'fcn32s_r101', 'bisenet_x39') -> the key
    into _MODEL_RULES."""
    if model_name == "bisenet_x39":
        return "bisenet_x39"
    prefix = model_name.split("_")[0]
    if prefix.startswith("fcn"):
        return "fcn"
    if prefix not in _MODEL_RULES:
        raise KeyError(
            f"no checkpoint mapping rules for model '{model_name}' "
            f"(known: {sorted(_MODEL_RULES)})"
        )
    return prefix


def map_model_key(torch_key: str, family: str):
    """-> (path_tuple, kind) into the flax variables tree, or None to skip.

    BN paths end with the torch leaf name; the caller resolves it via
    _BN_LEAF into params(scale/bias) or batch_stats(mean/var).
    """
    if torch_key.endswith("num_batches_tracked"):
        return None
    for pattern, template, kind in _MODEL_RULES[family]:
        m = re.fullmatch(pattern, torch_key)
        if not m:
            continue
        out = m.expand(template)
        parts = tuple(out.split(" "))
        if parts[0] == "@resnet":
            path, k2 = resnet_key_map(parts[1])
            if k2 == "skip":
                return None
            return ("backbone",) + path, k2
        if parts[0] == "@xception":
            sub = xception_key_map(parts[1])
            if sub is None:
                return None
            path, k2 = sub
            if k2 == "bn":
                leaf = path[-1]
                if leaf.endswith("num_batches_tracked"):
                    return None
                return ("backbone",) + path, "bn"
            return ("backbone",) + path, k2
        # strip the @bn marker: the trailing component is the torch BN leaf
        parts = tuple(p[3:] if p.startswith("@bn") else p for p in parts)
        return parts, kind
    return None


def convert_model_state_dict(sd: Dict[str, np.ndarray], family: str):
    """Full torch network state_dict -> (params, batch_stats) trees in the
    flax naming scheme.  Unknown keys are skipped (graft() reports them)."""
    params, stats = {}, {}
    for k, v in sd.items():
        mapped = map_model_key(k, family)
        if mapped is None:
            continue
        path, kind = mapped
        if kind in ("conv", "dwconv"):
            _set(params, path + ("kernel",), np.transpose(v, (2, 3, 1, 0)))
        elif kind == "linear":
            _set(params, path + ("kernel",), np.transpose(v, (1, 0)))
        elif kind == "bias":
            _set(params, path + ("bias",), v)
        elif kind in ("bn", "bn_param", "bn_stat"):
            leaf = path[-1]
            where, new_leaf = _BN_LEAF[leaf] if kind == "bn" else (
                ("params", "scale" if k.endswith("weight") else "bias")
                if kind == "bn_param"
                else ("stats", "mean" if k.endswith("running_mean") else "var")
            )
            base = path[:-1] if kind == "bn" else path
            tree = params if where == "params" else stats
            _set(tree, base + (new_leaf,), v)
    return params, stats


def graft_full_checkpoint(path_or_sd, model: nn.Module,
                          family: str) -> nn.Module:
    """Graft a full reference network checkpoint (a path or a state_dict)
    into ``model``, in place, non-strict with the missing and unused keys
    logged; returns the model."""
    sd = _to_numpy_state_dict(path_or_sd)
    src_params, src_stats = convert_model_state_dict(sd, family)
    variables = to_jax_variables(model)
    return _load_tree(model, {
        "params": graft(variables["params"], src_params),
        "batch_stats": graft(variables["batch_stats"], src_stats),
    })


# ---------------------------------------------------------------------
# The other direction: a flax path -> the reference key that maps to it
# (``map_model_key``'s inverse, checked against it), for writing a model
# out in the reference's layout.
# ---------------------------------------------------------------------

_TORCH_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


def _resnet_key(path):
    """(module names...) -> the reference ResNet module prefix."""
    stem = {"stem_conv1": "conv1.0", "stem_bn1": "conv1.1",
            "stem_conv2": "conv1.3", "stem_bn2": "conv1.4",
            "stem_conv3": "conv1.6", "conv1": "conv1", "bn1": "bn1"}
    if len(path) == 1:
        return stem[path[0]]
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    sub = {"downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}.get(path[1], path[1])
    return f"layer{m.group(1)}.{m.group(2)}.{sub}"


def _xception_key(path):
    if path[0] == "conv1":
        return "conv1." + path[1]
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    br = path[1] if path[1] == "proj" else \
        f"residual_branch.{int(path[1][3:]) - 1}"
    rest = ("conv1" if path[2] == "depthwise"
            else "point_wise_cbr." + path[3])
    return f"layer{m.group(1)}.{m.group(2)}.{br}.{rest}"


def _pattern_groups(pattern):
    """The sub-patterns of a rule's capture groups, in order."""
    groups, depth, start = [], 0, None
    for i, ch in enumerate(pattern):
        if ch == "(" and pattern[i - 1:i] != "\\":
            depth += 1
            if depth == 1:
                start = i + 1
        elif ch == ")" and pattern[i - 1:i] != "\\":
            depth -= 1
            if depth == 0:
                groups.append(pattern[start:i])
    return groups


def _fill(pattern, values):
    """The string a rule's pattern matches with these group values (the
    rules use only literals, ``\\.``, groups and ``[^.]*``, read empty)."""
    out, i, g = [], 0, 0
    pattern = pattern.replace("[^.]*", "")
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            out.append(pattern[i + 1])
            i += 2
        elif ch == "(":
            depth = 1
            i += 1
            while depth:
                depth += {"(": 1, ")": -1}.get(pattern[i], 0)
                i += 1
            out.append(values[g])
            g += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _inverse_rules(family):
    """Each rule of ``family`` with its template as a compiled regex over
    space-joined flax paths (None for the backbone delegations)."""
    out = []
    for pattern, template, kind in _MODEL_RULES[family]:
        groups = _pattern_groups(pattern)
        tpl = None
        if not template.startswith("@"):
            tpl = re.escape(template)
            for n, sp in enumerate(groups, 1):
                tpl = tpl.replace(re.escape(f"\\{n}"), f"({sp})", 1)
            tpl = re.compile(tpl)
        out.append((pattern, template, kind, tpl))
    return out


def reference_key(path: Tuple[str, ...], leaf: str, family: str,
                  is_bn: bool) -> str:
    """The reference state_dict key whose tensor lands on flax leaf
    ``path/leaf`` (``kernel``, ``bias``, ``scale``, ``mean``, ``var``; of a
    BN module where ``is_bn``) of ``family``; KeyError where no rule maps
    there."""
    tleaf = _TORCH_BN_LEAF[leaf] if is_bn else (
        "weight" if leaf == "kernel" else "bias")
    want = " ".join(path) + (f" @bn{tleaf}" if is_bn else "")
    for pattern, template, kind, tpl in _inverse_rules(family):
        if tpl is None:
            if path[0] != "backbone":
                continue
            sub = (_resnet_key(path[1:]) if template.startswith("@resnet")
                   else _xception_key(path[1:]))
            key = _fill(pattern, [f"{sub}.{tleaf}"])
        else:
            m = tpl.fullmatch(want)
            if not m or (kind == "bias") != (leaf == "bias" and not is_bn):
                continue
            key = _fill(pattern, list(m.groups()))
        mapped = map_model_key(key, family)
        if mapped is not None and mapped[0][:len(path)] == path:
            return key
    raise KeyError(f"no {family} rule maps to {'/'.join(path)}/{leaf}")


def reference_state_dict(model: nn.Module, family: str
                         ) -> Dict[str, torch.Tensor]:
    """``model`` written out in the reference's layout (the port keeps
    convs OIHW and linears (out, in), as the reference does; BN leaves with
    a ``num_batches_tracked``): every leaf the family's rules map, which
    ``graft_full_checkpoint`` reads back exactly.  Float32 CPU copies."""
    sd = {}
    for _, path, leaf, t, mod in flax_leaves(model):
        is_bn = isinstance(mod, nn.modules.batchnorm._NormBase)
        key = reference_key(path, leaf, family, is_bn)
        sd[key] = t.detach().float().cpu().clone()
        if key.endswith("running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd
