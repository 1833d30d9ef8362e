"""Post-training int8 quantization for serving, model-agnostic
(counterpart of torchseg_tpu/deploy/quantize.py).

Scheme (symmetric, no zero point), JAX's:
  * weights: per output channel, s_w = max(absmax_c, 1e-12) / 127;
  * activations: per tensor, s_in = max(absmax, 1e-8) / 127, calibrated by
    running representative batches through the float graph and recording
    each conv input's absmax;
  * a conv: codes clip(round(x / s_in), -127, 127), the exact int32 sum,
    then ``y * (s_in * s_w) + bias`` in float32 (one fused multiply-add, as
    XLA contracts it on the CPU), cast to the input's dtype.

JAX swaps ``nn.Conv`` applications with ``flax.linen.intercept_methods``;
here ``calibrate`` records with forward pre-hooks on every ``nn.Conv2d``
and ``quantize_model`` swaps each calibrated ``nn.Conv2d`` whose path does
not match ``skip`` for a ``QuantConv2d``.  Paths are ``named_modules()``
names with ``.`` -> ``/``, which are JAX's flax paths.  JAX runs the
tiny-channel strided stems (cin <= 8, stride 2, an odd kernel, pad k // 2,
even H and W) as ``S2DConv``, which its interceptor does not see: those
convs are not calibrated here either, so both quantize the same set.

Each ``QuantConv2d``'s route is fixed when the model is quantized, from
its shape alone, and never changes at run time:
  * "mma": the int8 tensor-core kernel (``conv_i8_affine``, mode 3 of
    ``conv_i8_mma_kernel``: float32 out, no ReLU) where
    ``conv_i8_mma_shape_error`` admits the conv (cin % 16 == 0, cout % 8
    == 0, groups 1, a 3x3 at pad = dilation or a 1x1 at pad 0).  The
    kernel takes NHWC codes at batch 1, so the conv quantizes in NHWC
    (one permute copy of its input) and loops over the batch; its output
    is permuted back to NCHW (another copy).
  * "f32": a float32 cuDNN conv of the codes (TF32 off), where taps x
    cin_per_group x 127^2 < 2^24 makes every partial sum an exact float32
    integer (the classic 7x7 stem at cin 3, X39's depthwise convs);
    JAX computes these in XLA as well, outside any Pallas kernel;
  * "int_mm": otherwise an im2col ``torch._int_mm`` (groups 1).
Every route gives the exact int32 sum, so all three are bit-identical to
the plain version (``conv_i8_affine_plain``); on the CPU the "mma" route
runs that plain version.

Accuracy note: real deployments calibrate on validation images and must
re-verify mIoU; the tests pin the mechanism (the arithmetic, argmax
agreement on random networks), not dataset accuracy.
"""

import copy
import re
from collections import Counter
from typing import Dict, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.int8_serve_kernels import (
    conv_i8_affine,
    conv_i8_mma_shape_error,
    fma,
)

# head class-logit convs across the model zoo: bisenet heads ("head0..2 /
# conv_1x1"), fcn/psp/psa/dfn output convs
DEFAULT_SKIP = (
    r"^head\d/conv_1x1$",
    r"conv1x1$",
    r"conv6_out$",
    r"^(smooth|border)_head\d/conv$",
)
ROUTES = ("mma", "f32", "int_mm")
_F32_EXACT = 2 ** 24


def conv_path(name: str) -> str:
    return name.replace(".", "/")


def _s2d_stem(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """True where JAX runs this conv as an ``S2DConv`` (ops/s2d.py
    ``use_s2d`` and its callers: cin <= 8, stride 2, an odd kernel at pad
    k // 2, no dilation, groups or bias, even H and W)."""
    k = conv.kernel_size[0]
    return (conv.in_channels <= 8 and conv.stride == (2, 2) and k % 2 == 1
            and conv.padding == (k // 2, k // 2)
            and conv.dilation == (1, 1) and conv.groups == 1
            and conv.bias is None
            and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable) -> Dict[str, float]:
    """Run the float graph (eval mode) over representative NCHW batches,
    recording the absmax of every conv input; returns {conv_path:
    absmax}."""
    rec: Dict[str, torch.Tensor] = {}

    def hook(path):
        def pre(mod, args):
            x = args[0]
            if _s2d_stem(mod, x):
                return
            a = x.float().abs().amax()
            rec[path] = torch.maximum(rec[path], a) if path in rec else a
        return pre

    handles = [mod.register_forward_pre_hook(hook(conv_path(name)))
               for name, mod in model.named_modules()
               if type(mod) is nn.Conv2d]
    model.eval()
    try:
        for x in batches:
            model(x)
    finally:
        for h in handles:
            h.remove()
    return {path: float(a) for path, a in rec.items()}


def conv_route(conv: nn.Conv2d) -> str:
    """The route of a ``QuantConv2d`` made from ``conv`` (see the module
    docstring)."""
    k, (sh, sw) = conv.kernel_size, conv.stride
    (ph, pw), (dh, dw) = conv.padding, conv.dilation
    square = k[0] == k[1] and sh == sw and ph == pw and dh == dw
    if square and conv.groups == 1 and conv_i8_mma_shape_error(
            conv.in_channels, conv.out_channels, k=k[0], dilation=dh,
            pad=ph) is None:
        return "mma"
    taps = k[0] * k[1] * conv.in_channels // conv.groups
    if taps * 127 * 127 < _F32_EXACT:
        return "f32"
    if conv.groups != 1:
        raise NotImplementedError(
            f"a grouped conv ({conv}) whose sums are not exact in float32 "
            f"has no int8 route")
    return "int_mm"


class QuantConv2d(nn.Module):
    """An ``nn.Conv2d`` run in int8 with a calibrated input scale
    (JAX quantize.py:100-146).  Buffers: ``wq`` the HWIO int8 weights,
    ``m`` = s_in * s_w and ``c`` = the bias (or 0), both float32 per
    output channel, ``s_in`` the float32 input scale."""

    def __init__(self, conv: nn.Conv2d, absmax: float):
        super().__init__()
        w = conv.weight.detach().float().cpu()
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
        wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127,
                         127).to(torch.int8)
        s_in = torch.tensor(max(absmax, 1e-8) / 127.0, dtype=torch.float32)
        dev = conv.weight.device
        self.register_buffer("wq", wq.permute(2, 3, 1, 0).contiguous()
                             .to(dev))
        self.register_buffer("m", (s_in * s_w).to(dev))
        self.register_buffer("c", (conv.bias.detach().float().cpu()
                                   if conv.bias is not None
                                   else torch.zeros_like(s_w)).to(dev))
        self.register_buffer("s_in", s_in.to(dev))
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.route = conv_route(conv)

    def extra_repr(self):
        return (f"{self.wq.shape[2] * self.groups}, {self.wq.shape[3]}, "
                f"kernel_size={tuple(self.wq.shape[:2])}, "
                f"stride={self.stride}, route={self.route}")

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float -> NHWC-contiguous int8 codes (a true division by
        the float32 scale, as XLA's)."""
        xq = torch.round(x.permute(0, 2, 3, 1).float() / self.s_in)
        return torch.clamp(xq, -127, 127).to(torch.int8).contiguous()

    def sums(self, xq: torch.Tensor) -> torch.Tensor:
        """The exact conv sums of NHWC codes as float32 NHWC values, on
        this conv's route ("mma" fuses the epilogue: see ``forward``)."""
        if self.route == "f32":
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                y = F.conv2d(xq.permute(0, 3, 1, 2).float(),
                             self.wq.permute(3, 2, 0, 1).float(),
                             stride=self.stride, padding=self.padding,
                             dilation=self.dilation, groups=self.groups)
            finally:
                torch.backends.cudnn.allow_tf32 = prev
            return torch.round(y).permute(0, 2, 3, 1)
        kh, kw, cin, cout = self.wq.shape
        b, h, w, _ = xq.shape
        cols = F.unfold(xq.permute(0, 3, 1, 2).float(), (kh, kw),
                        dilation=self.dilation, padding=self.padding,
                        stride=self.stride)  # (B, cin*kh*kw, L), exact
        a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
        wm = self.wq.permute(2, 0, 1, 3).reshape(-1, cout)  # (cin kh kw, N)
        y = _int_mm(a, wm).float()
        ho = (h + 2 * self.padding[0] - self.dilation[0] * (kh - 1) - 1) \
            // self.stride[0] + 1
        wo = (w + 2 * self.padding[1] - self.dilation[1] * (kw - 1) - 1) \
            // self.stride[1] + 1
        return y.reshape(b, ho, wo, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = self.quantize_input(x)
        if self.route == "mma":
            y = torch.cat([conv_i8_affine(
                xq[i:i + 1], self.wq, self.m, self.c, self.stride[0],
                self.padding[0], self.dilation[0])
                for i in range(xq.shape[0])])
        else:
            y = fma(self.sums(xq), self.m, self.c)
        return y.permute(0, 3, 1, 2).to(x.dtype)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact: ``torch._int_mm``
    on the card with its operands zero-padded to its tile rules (M > 16, K
    and N multiples of 8), a rounded float64 product on the CPU."""
    if a.device.type == "cpu":
        return torch.round(a.double() @ b.double()).to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) else a
    b = F.pad(b, (0, np_ - n, 0, kp - k)) if (kp, np_) != (k, n) else b
    return torch._int_mm(a, b.contiguous())[:m, :n]


def _modules_to_swap(model, scales, skip):
    skip_res = [re.compile(p) for p in skip]
    quantized, skipped = {}, []
    for name, mod in model.named_modules():
        path = conv_path(name)
        if type(mod) is not nn.Conv2d or path not in scales:
            continue
        if any(r.search(path) for r in skip_res):
            skipped.append(path)
        else:
            quantized[name] = mod
    return quantized, skipped


def quantize_model(model: nn.Module, scales: Dict[str, float],
                   skip: Iterable[str] = DEFAULT_SKIP):
    """A copy of ``model`` (eval mode) whose calibrated convs, except
    those whose path matches a ``skip`` pattern, are ``QuantConv2d``s;
    returns ``(qmodel, routes)``: {path: route} of every swapped conv."""
    qmodel = copy.deepcopy(model).eval()
    quantized, _ = _modules_to_swap(qmodel, scales, skip)
    routes = {}
    for name, conv in quantized.items():
        parent, _, leaf = name.rpartition(".")
        owner = qmodel.get_submodule(parent) if parent else qmodel
        q = QuantConv2d(conv, scales[conv_path(name)])
        setattr(owner, leaf, q)
        routes[conv_path(name)] = q.route
    return qmodel, routes


def route_counts(routes: Dict[str, str]) -> Dict[str, int]:
    counts = Counter(routes.values())
    return {r: counts.get(r, 0) for r in ROUTES}


def make_int8_infer(model: nn.Module, calib_batches,
                    skip: Iterable[str] = DEFAULT_SKIP, argmax: bool = True):
    """Calibrate, quantize, and build the serving function: ``infer(x)``
    on an NCHW float batch gives (B, H, W) int32 labels, or with
    ``argmax=False`` the model's (B, C, H, W) scores.  Returns
    ``(infer, scales, qmodel, routes)``."""
    scales = calibrate(model, calib_batches)
    qmodel, routes = quantize_model(model, scales, skip)

    @torch.inference_mode()
    def infer(x):
        scores = qmodel(x)
        if argmax:
            return scores.argmax(dim=1).to(torch.int32)
        return scores

    return infer, scales, qmodel, routes
