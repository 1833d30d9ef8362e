"""PyTorch port, the last two host transforms: ``random_rotation``
(``rotation_matrix_2d`` = ``cv2.getRotationMatrix2D``; ``native.
warp_affine`` = ``cv2.warpAffine``, INTER_LINEAR for the image,
INTER_NEAREST for the labels, BORDER_CONSTANT 0) and
``random_gaussian_blur`` (``native.gaussian_blur`` = ``cv2.GaussianBlur((k,
k), 0)``, BORDER_REFLECT_101), bit for bit against JAX's functions
(``torchseg_tpu/data/transforms.py:103-117``, which call cv2) on the same
``np.random.Generator`` seeds, draws included: uint8 images of one and
three channels, odd sizes, images smaller than the kernel, every kernel
size and angles across the whole +-10 degree range (the warp's SIMD
blocks of 16 columns and its scalar tail).  Other dtypes raise TypeError.
"""

import cv2
import numpy as np
import pytest

from torchseg_tpu.data import transforms as jt
from torchseg_tpu_torch import native
from torchseg_tpu_torch.data import transforms as tt

SIZES = [(1, 1), (2, 3), (5, 4), (17, 23), (31, 16), (64, 47), (97, 130),
         (255, 333), (512, 683)]


def _pair(seed, hw, channels):
    rng = np.random.default_rng(1000 + seed)
    img = rng.integers(0, 256, (*hw, channels) if channels > 1 else hw,
                       dtype=np.uint8)
    gt = rng.integers(0, 151, hw, dtype=np.uint8)
    return img, gt


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", SIZES)
def test_random_rotation_equals_jax(hw, channels):
    img, gt = _pair(hw[0] * 7 + hw[1], hw, channels)
    for seed in range(4):
        a_rng, b_rng = (np.random.default_rng(seed) for _ in range(2))
        ti, tg = tt.random_rotation(a_rng, img, gt)
        ji, jg = jt.random_rotation(b_rng, img, gt)
        assert ti.shape == ji.shape and np.array_equal(ti, ji), seed
        assert np.array_equal(tg, jg), seed
        assert a_rng.random() == b_rng.random()  # the same draws


def test_rotation_matrix_and_warp_across_the_angle_range():
    img, gt = _pair(0, (61, 83), 3)
    for angle in np.linspace(-10, 10, 41):
        m = tt.rotation_matrix_2d((83 / 2, 61 / 2), angle, 1)
        ref = cv2.getRotationMatrix2D((83 / 2, 61 / 2), angle, 1)
        assert np.array_equal(m, ref), angle
        assert np.array_equal(native.warp_affine(img, m, (83, 61), False),
                              cv2.warpAffine(img, ref, (83, 61),
                                             flags=cv2.INTER_LINEAR))
        assert np.array_equal(native.warp_affine(gt, m, (83, 61), True),
                              cv2.warpAffine(gt, ref, (83, 61),
                                             flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", SIZES)
def test_random_gaussian_blur_equals_jax(hw, channels):
    img, _ = _pair(hw[0] + hw[1], hw, channels)
    seen = set()
    for seed in range(12):  # seed 11 draws k = 1
        a_rng, b_rng = (np.random.default_rng(seed) for _ in range(2))
        got = tt.random_gaussian_blur(a_rng, img)
        assert np.array_equal(got, jt.random_gaussian_blur(b_rng, img)), seed
        assert a_rng.random() == b_rng.random()
        seen.add(int(np.random.default_rng(seed).choice([1, 3, 5, 7])))
    for k in (3, 5, 7):  # every kernel, whatever the seeds drew
        assert np.array_equal(native.gaussian_blur(img, k),
                              cv2.GaussianBlur(img, (k, k), 0)), k
    assert seen == {1, 3, 5, 7}


def test_other_dtypes_raise():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(TypeError, match="uint8"):
        tt.random_rotation(np.random.default_rng(0), img.astype(np.float32),
                           np.zeros((8, 8), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        tt.random_rotation(np.random.default_rng(0), img,
                           np.zeros((8, 8), np.int32))
    with pytest.raises(TypeError, match="uint8"):
        tt.random_gaussian_blur(np.random.default_rng(0),
                                img.astype(np.uint16))
    with pytest.raises(ValueError, match="1 or 3 channels"):
        native.warp_affine(np.zeros((4, 4, 2), np.uint8), np.eye(2, 3),
                           (4, 4), False)
