"""PyTorch port, the CUDA kernels against their plain PyTorch versions, on a
card.  Every test here skips where ``torch.cuda.is_available()`` is False
(the kernels have no CPU mode; their arithmetic is checked against JAX on
the CPU through the plain versions in test_torch_int8_serve_kernels.py).

The shapes are ragged on purpose (widths that are not multiples of the
kernels' 32-column tiles, odd heights, stage 3's channel counts), so the
edge masking is exercised; chip_smoke.py covers the serving shapes.  This
file imports no JAX, so on a machine without it run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _codes(g, shape, lo=0):
    return torch.randint(lo, 128, shape, generator=g, dtype=torch.int8)


def _cbr(g, k, cin, cout, dev):
    scale = 40.0 / (127 * 64 * (9 * cin) ** 0.5)
    return {"w": torch.randint(-127, 128, (k, k, cin, cout), generator=g,
                               dtype=torch.int8).to(dev),
            "m": ((torch.rand(cout, generator=g) + 0.5) * scale).to(dev),
            "c": (torch.randn(cout, generator=g) * 8).to(dev)}


def _block(g, cin, cout, stride, dev):
    e = {"conv1": _cbr(g, 3, cin, cout, dev),
         "conv2": _cbr(g, 3, cout, cout, dev),
         "res_ratio": float(torch.rand((), generator=g)) + 0.3,
         "stride": stride}
    if stride != 1 or cin != cout:
        e["down"] = _cbr(g, 1, cin, cout, dev)
    return e


def _exact(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("h2,w2", [(36, 70), (8, 130), (512, 1024)])
def test_stem_pool_kernel_within_one_code(dev, h2, w2):
    g = _gen(0)
    xs = _codes(g, (1, h2 + 3, w2 + 3, 12), lo=-128).to(dev)
    wf = (torch.randn(4, 4, 12, 128, generator=g) * 0.05).to(
        torch.bfloat16).to(dev)
    m = (torch.rand(128, generator=g) * 0.016 + 0.004).to(dev)
    c = (torch.randn(128, generator=g) * 2).to(dev)
    before = K.stem_pool_i8.launches
    got = K.stem_pool_i8(xs, wf, m, c, 64)
    torch.cuda.synchronize()
    assert K.stem_pool_i8.launches == before + 1
    ref = K.stem_pool_i8_plain(xs, wf, m, c, 64)
    n_diff = 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        d = (a.int() - b.int()).abs()
        assert int(d.max()) <= 1
        n_diff += int((d > 0).sum())
    assert n_diff <= 1e-3 * sum(r.numel() for r in ref)


@pytest.mark.parametrize("h,w", [(37, 45), (64, 130), (1, 1)])
def test_conv3x3s2_kernel_bit_exact(dev, h, w):
    g = _gen(1)
    x = _codes(g, (1, h, w, 64)).to(dev)
    e = _cbr(g, 3, 64, 64, dev)
    _exact(K.conv3x3s2_i8(x, e["w"], e["m"], e["c"]),
           K.conv3x3s2_i8_plain(x, e["w"], e["m"], e["c"]))


@pytest.mark.parametrize("h,w", [(20, 44), (3, 33)])
def test_l1_stage_kernel_bit_exact(dev, h, w):
    g = _gen(2)
    x = _codes(g, (1, h, w, 64)).to(dev)
    e0, e1 = _block(g, 64, 64, 1, dev), _block(g, 64, 64, 1, dev)
    _exact(K.l1_stage_i8(x, e0, e1), K.l1_stage_i8_plain(x, e0, e1))


@pytest.mark.parametrize("cin,h,w", [(64, 19, 37), (128, 10, 18),
                                     (128, 64, 128)])
def test_down_stage_kernel_bit_exact(dev, cin, h, w):
    g = _gen(3)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e0 = _block(g, cin, 2 * cin, 2, dev)
    e1 = _block(g, 2 * cin, 2 * cin, 1, dev)
    _exact(K.down_stage_i8(x, e0, e1), K.down_stage_i8_plain(x, e0, e1))


def test_kernels_launch_on_the_current_stream(dev):
    g = _gen(4)
    x = _codes(g, (1, 16, 40, 64)).to(dev)
    e0, e1 = _block(g, 64, 64, 1, dev), _block(g, 64, 64, 1, dev)
    ref = K.l1_stage_i8_plain(x, e0, e1)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = K.l1_stage_i8(x, e0, e1)
    side.synchronize()
    _exact(got, ref)
