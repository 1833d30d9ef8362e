"""PyTorch port, K10 (the int8 3x3/2 pad-1 max pool) on the CPU: the order
of work of its two CUDA routes, emulated, and the host rules that pick a
route and refuse a shape.

The kernels run only on a card (test_torch_cuda_kernels.py); their order
of work runs here.  ``strip_walk`` does what one thread of the 16-byte
route (``maxpool_i8_vec16_kernel``) does, for every channel piece and
output column at once: for each strip of ``rows`` output rows, the
horizontal max of the three taps (columns 2ox-1, 2ox, 2ox+1) of input rows
2oy and 2oy+1, then the vertical max with the horizontal max of row 2oy-1
carried from the step before.  As in the kernels, a tap past an edge
(input row or column -1, and row or column h or w where that is odd)
reads the edge row or column, which lies in the same window, instead of
a -128 pad.  ``four_byte_walk`` maps each thread of the 4-byte route
(``maxpool_i8_kernel``) to its output word with the kernel's divides.
Both are held bit for bit against JAX's s8 reduce-window
(``_maxpool_i8(via="s8")``, what the serving graph runs) and against the
plain version ``maxpool_i8``, at odd sizes and on negative codes, the
strip walk for every strip height the kernel may be built with (the
source's ``kPoolRows`` among them).
"""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "torchseg_tpu_torch", "csrc", "int8_serve_kernels.cu")
ROWS = (1, 2, 4, 8)  # strip heights (kPoolRows) the kernel is built with
SHAPES = [(1, 15, 17, 16), (1, 13, 11, 32), (1, 16, 18, 16),
          (1, 30, 31, 48), (1, 1, 1, 16), (1, 2, 3, 16)]
NEG = -128


@functools.lru_cache(maxsize=None)
def _case(shape):
    """Seeded codes over the whole int8 range (every seventh -128) and
    JAX's pooled codes, as numpy arrays."""
    x = np.random.default_rng(sum(shape)).integers(
        -128, 128, shape).astype(np.int8)
    x.reshape(-1)[::7] = NEG
    ref = np.asarray(jax.jit(lambda v: ji8._maxpool_i8(v, via="s8"))(x))
    return x, ref


def _taps(o, n):
    """The window's three tap indices on an axis of n at outputs o, an
    edge tap clamped onto the edge element (the kernels' tap_lo, 2o,
    tap_hi)."""
    return (torch.where(o > 0, 2 * o - 1, 0), 2 * o,
            torch.where(2 * o + 1 < n, 2 * o + 1, 2 * o))


def _row_max(x, iy):
    """(wo, C): the horizontal max of input row iy (clamped to the image)
    under every output column."""
    _, h, w, _ = x.shape
    row = x[0, min(max(iy, 0), h - 1)]
    left, centre, right = (row[t] for t in _taps(
        torch.arange((w + 1) // 2), w))
    return torch.maximum(left, torch.maximum(centre, right))


def strip_walk(x, rows):
    """The 16-byte route's walk, ``rows`` output rows a strip."""
    _, h, w, c = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    out = torch.empty((1, ho, wo, c), dtype=torch.int8)
    for oy0 in range(0, ho, rows):
        carry = _row_max(x, 2 * oy0 - 1)
        for oy in range(oy0, oy0 + rows):
            a, b = _row_max(x, 2 * oy), _row_max(x, 2 * oy + 1)
            if oy < ho:
                out[0, oy] = torch.maximum(carry, torch.maximum(a, b))
            carry = b
    return out


def four_byte_walk(x):
    """The 4-byte route: thread i owns word ch = i % c4 of output pixel
    p = i / c4, (oy, ox) = (p / wo, p % wo), and takes the max of its nine
    window words (edge taps clamped)."""
    _, h, w, c = x.shape
    ho, wo, c4 = (h + 1) // 2, (w + 1) // 2, c // 4
    i = torch.arange(ho * wo * c4, dtype=torch.int32)
    p = torch.div(i, c4, rounding_mode="floor")
    ch = i - p * c4
    oy = torch.div(p, wo, rounding_mode="floor")
    ox = p - oy * wo
    xw = x[0].reshape(h, w, c4, 4)
    words = torch.full((i.numel(), 4), NEG, dtype=torch.int8)
    for iy in _taps(oy, h):
        for ix in _taps(ox, w):
            words = torch.maximum(words, xw[iy, ix, ch])
    out = torch.empty((ho * wo * c4, 4), dtype=torch.int8)
    out[i.long()] = words
    return out.reshape(1, ho, wo, c)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_strip_walk_bit_exact_vs_xla_s8_and_plain(shape, rows):
    x, ref = _case(shape)
    got = strip_walk(torch.from_numpy(x), rows)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, K.maxpool_i8(torch.from_numpy(x)))


@pytest.mark.parametrize("shape", [(1, 15, 17, 4), (1, 13, 11, 12),
                                   (1, 9, 13, 20), (1, 16, 18, 8)])
def test_four_byte_walk_bit_exact_vs_xla_s8_and_plain(shape):
    x, ref = _case(shape)
    got = four_byte_walk(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, K.maxpool_i8(torch.from_numpy(x)))


def _constant(name):
    with open(SRC) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"no constexpr int {name} in {SRC}"
    return int(m.group(1))


def test_kernel_constants_are_the_emulated_ones():
    """The strip height and block the source builds are among those the
    walk above is held at (and the block is whole warps)."""
    assert _constant("kPoolRows") in ROWS
    assert _constant("kPoolThreads") in (128, 256)
    assert _constant("kPool4Threads") % 32 == 0


@pytest.mark.parametrize("c", [4, 8, 12, 16, 20, 32, 128, 256])
def test_route_by_width_and_alignment(c):
    """16-byte loads only where C % 16 == 0 and both tensors start on a
    16-byte boundary, whatever the other's offset; else 4-byte loads."""
    base = 0x7F3A_0000_0000
    for x_off in (0, 4, 8, 12, 16, 48):
        for out_off in (0, 4, 8, 16, 512):
            want = 16 if (c % 16 == 0 and x_off % 16 == 0
                          and out_off % 16 == 0) else 4
            assert K.maxpool_i8_route(c, base + x_off,
                                      base + 2 ** 20 + out_off) == want


@pytest.mark.parametrize("h,w,c,ok", [
    (240, 240, 128, True),            # PSPNet's pool input
    (2 ** 15, 2 ** 14 - 1, 4, True),  # just below 2^31 codes
    (2 ** 15, 2 ** 14, 4, False),     # 2^31 codes
    (4096, 4096, 256, False)])
def test_shape_error_at_32_bit_index_math(h, w, c, ok):
    why = K.maxpool_i8_shape_error(h, w, c)
    assert (why is None) == ok
    if not ok:
        assert "2^31" in why
