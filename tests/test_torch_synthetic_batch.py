"""PyTorch port, ``entry.synthetic_batch``: the same bits on any host and
CPU thread count (a float32 ``F.interpolate`` of the smooth field gave
other bits with one thread than with eight), and its field the
align-corners bilinear upsample of the seeded grid computed in float64
and rounded once, checked against an independent reference
(``np.interp`` per axis)."""

import numpy as np
import pytest
import torch

from torchseg_tpu_torch.entry import smooth_field, synthetic_batch


@pytest.fixture
def threads():
    prev = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(prev)


def test_synthetic_batch_is_the_same_on_one_and_four_threads(threads):
    threads(1)
    one = synthetic_batch(2, (64, 64), device="cpu", border=True)
    threads(4)
    four = synthetic_batch(2, (64, 64), device="cpu", border=True)
    assert set(one) == set(four) == {"image", "label", "aux_label"}
    for key in one:
        assert one[key].dtype == four[key].dtype
        assert torch.equal(one[key], four[key]), key


def _interp_reference(grid, out_hw):
    """Align-corners linear interpolation along each axis with np.interp
    in float64, rows then columns (not rounded)."""
    g = np.asarray(grid, np.float64)
    (gh, gw), (h, w) = g.shape[-2:], out_hw
    ys, xs = np.linspace(0, gh - 1, h), np.linspace(0, gw - 1, w)
    rows = np.apply_along_axis(lambda v: np.interp(ys, np.arange(gh), v),
                               -2, g)
    return np.apply_along_axis(lambda v: np.interp(xs, np.arange(gw), v),
                               -1, rows)


def _rounded_once(got, ref):
    """Each float32 value within half an ulp of the float64 reference
    (plus 1e-12 relative: the two float64 computations differ in their
    last bits): a correct rounding, not a float32 computation's."""
    gap = np.abs(got.astype(np.float64) - ref)
    return gap <= np.spacing(np.abs(got)).astype(np.float64) / 2 \
        + 1e-12 * np.abs(ref)


@pytest.mark.parametrize("crop", [(64, 64), (96, 160)])
def test_synthetic_field_is_the_float64_align_corners_upsample(crop):
    """The image is field + noise in float32 with the rng's draws in order
    (the grid, then the noise), the label the field's channel 0 > 0; the
    field is the float64 reference rounded once, where a float32
    ``F.interpolate`` misses by an ulp on many pixels."""
    batch = synthetic_batch(2, crop, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(2, 3, max(crop[0] // 32, 2),
                            max(crop[1] // 32, 2))).astype(np.float32)
    noise = rng.normal(0, 0.1, size=(2, 3, *crop)).astype(np.float32)
    field = smooth_field(grid, crop)
    ref = _interp_reference(grid, crop)
    assert field.dtype == np.float32
    assert _rounded_once(field, ref).all()
    f32 = torch.nn.functional.interpolate(
        torch.from_numpy(grid), size=crop, mode="bilinear",
        align_corners=True).numpy()
    assert (~_rounded_once(f32, ref)).mean() > 0.01
    np.testing.assert_array_equal(batch["image"].numpy(), field + noise)
    np.testing.assert_array_equal(batch["label"].numpy(),
                                  (field[:, 0] > 0).astype(np.int64))
