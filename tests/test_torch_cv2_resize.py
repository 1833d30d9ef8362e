"""PyTorch port, cv2's INTER_LINEAR for uint8 (``native.resize_linear_cv``)
against ``cv2.resize`` bit for bit, and the transforms that use it against
the JAX package's (which call cv2) on the CPU.

Cases: seeded random and smooth images of 1, 2, 3 and 4 channels at odd
sizes; ``fx``/``fy`` at 0.5 (cv2's 2x area route, odd sizes rounded both
ways), 0.75, 1.25, 1.5, 1.75 and unequal pairs; ``dsize`` 1536x768 and
960x720 from 1024x2048 and back up, and odd sizes; one-channel images come
back (H, W) as cv2's do; ``resize_ensure_shortest_edge``, ``random_scale``
and ``random_scale_with_length`` equal JAX's bit for bit (images and
labels) on generators of one seed.
"""

import numpy as np
import pytest

from torchseg_tpu.data import transforms as jT
from torchseg_tpu_torch import native
from torchseg_tpu_torch.data import transforms as tT

cv2 = pytest.importorskip("cv2")

SCALES = (0.5, 0.75, 1.25, 1.5, 1.75)


def _smooth(rng, h, w, c):
    y, x = np.mgrid[:h, :w]
    img = [np.sin(x / rng.uniform(3, 9)) * 70 + np.cos(y / rng.uniform(3, 9))
           * 70 + 128 + rng.normal(0, 6, (h, w)) for _ in range(c)]
    return np.clip(np.stack(img, -1), 0, 255).astype(np.uint8)


def _images(seed, h, w, c):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    out = [noise, _smooth(rng, h, w, c)]
    return [a[..., 0] for a in out] + out if c == 1 else out


def _same(img, dsize=None, fx=0.0, fy=0.0):
    ref = cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    got = native.resize_linear_cv(img, dsize, fx, fy)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(97, 131), (64, 77), (101, 103), (6, 5)])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_fx_fy_equal_cv2(hw, c):
    for img in _images(hw[0] * c, *hw, c):
        for s in SCALES:
            _same(img, None, s, s)
        _same(img, None, 0.5, 0.75)
        _same(img, None, 1.75, 0.5)


@pytest.mark.parametrize("c", [1, 3])
def test_dsize_equal_cv2_at_full_size(c):
    rng = np.random.default_rng(c)
    img = rng.integers(0, 256, (1024, 2048, c), dtype=np.uint8)
    if c == 1:
        img = img[..., 0]
    for dsize in ((1536, 768), (960, 720)):
        small = native.resize_linear_cv(img, dsize)
        np.testing.assert_array_equal(small, cv2.resize(
            img, dsize, interpolation=cv2.INTER_LINEAR))
        _same(small, (2048, 1024))   # and back up


def test_full_size_msf_scales_equal_cv2():
    img = _smooth(np.random.default_rng(7), 1024, 2048, 3)
    for s in SCALES:
        _same(img, None, s, s)


@pytest.mark.parametrize("hw", [(45, 61), (37, 53)])
def test_odd_dsizes_equal_cv2(hw):
    for img in _images(sum(hw), *hw, 3):
        for dsize in ((61, 45), (17, 90), (122, 33), (30, 22), (1, 1),
                      (3, 200)):
            _same(img, dsize)


def test_refuses_other_inputs():
    with pytest.raises(TypeError, match="uint8"):
        native.resize_linear_cv(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="channels"):
        native.resize_linear_cv(np.zeros((4, 4, 5), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="dsize or fx"):
        native.resize_linear_cv(np.zeros((4, 4), np.uint8))


def _same_draws(fn_t, fn_j, seed):
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got, ref = fn_t(rt), fn_j(rj)
    assert rt.random() == rj.random()
    return got, ref


@pytest.mark.parametrize("seed", range(6))
def test_repaired_transforms_equal_jax(seed):
    rng = np.random.default_rng(50 + seed)
    img = _smooth(rng, 90, 123, 3)
    gt = rng.integers(0, 19, (90, 123)).astype(np.uint8)
    scales = (0.5, 0.75, 1, 1.25, 1.5, 1.75, 2.0)
    (ti, tg, ts), (ji, jg, js) = _same_draws(
        lambda r: tT.random_scale(r, img, gt, scales),
        lambda r: jT.random_scale(r, img, gt, scales), seed)
    assert ts == js
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tg, jg)
    (ti, tg, tn), (ji, jg, jn) = _same_draws(
        lambda r: tT.random_scale_with_length(r, img, gt, (48, 77, 130)),
        lambda r: jT.random_scale_with_length(r, img, gt, (48, 77, 130)),
        seed)
    assert tn == jn
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tg, jg)
    for edge in (31, 64, 100 + seed):
        np.testing.assert_array_equal(tT.resize_ensure_shortest_edge(
            img, edge), jT.resize_ensure_shortest_edge(img, edge))
        np.testing.assert_array_equal(tT.resize_ensure_shortest_edge(
            img.transpose(1, 0, 2), edge), jT.resize_ensure_shortest_edge(
            img.transpose(1, 0, 2), edge))
