"""PyTorch port, the CUDA kernels against their plain PyTorch versions, on a
card.  Every test here skips where ``torch.cuda.is_available()`` is False
(the kernels have no CPU mode; their arithmetic is checked against JAX on
the CPU through the plain versions in test_torch_int8_serve_kernels.py).

The shapes are ragged on purpose (widths that are not multiples of the
kernels' 32-column tiles, of K1's 126-column strips or of K4's
128-pixel-by-64-channel tiles, odd heights, stage 3's and stage 4's channel
counts, output sizes that are not multiples of 32 or 128, BN inputs whose
H*W is odd or 1, misaligned BN inputs, stem outputs off K11's 64-column
tiles and 8-row strips (both its routes: the bf16 tensor-core kernel with
the packed weights, the float32 CUDA-core kernel), K7 at 150 classes in
column and class chunks and bit for bit against the per-pixel formula,
focal-loss element counts that are not multiples of the 16-byte vector,
logits off 16-byte alignment and C in {1, 2, 3, 19, 150} over logits
swept across [-100, 100], K10 on its 16-byte route at odd sizes and
output heights off its strips and on its 4-byte route at C % 16 != 0 and
inputs off 16-byte alignment, with -128 on every edge), so the edge
masking and the scalar paths are exercised; K3's and K2's
resident-weight kernel (K2 at stride 2), and K6's and K5's K split over a two-block cluster (K5's with
the projection's chunks on the first block), are held at the main path's
shapes and at ragged ones; the same two kernels' 1x1 and dilated 3x3
windows and float32 epilogue (cbr_i8, bottleneck_i8) on each route, in
each mode, at cout 8, 64 and 200 and at the served decoder's shapes;
chip_smoke.py covers the serving and training shapes, and K8/K9 are also held at every distinct BN input shape of the
DFN-R101 and BiSeNet-R18 training steps (K8 in its one-thread-per-channel,
one-block and cluster forms; K9 on its per-run and flat grids).  This file
imports no JAX, so on a machine without it run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from torchseg_tpu_torch.ops.kernels import bn_kernels as B
from torchseg_tpu_torch.ops.kernels import focal_loss as FL
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
from torchseg_tpu_torch.ops.kernels import stem_conv as S
from torchseg_tpu_torch.ops.kernels import upsample_argmax as U
from torchseg_tpu_torch.ops.norm import BatchNorm2d
from torchseg_tpu_torch.ops.resize import resize_bilinear_align_corners

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


def _k1_operands(g, h2, w2, cin, cout, dev):
    xs = _codes(g, (1, h2 + 3, w2 + 3, cin), lo=-128).to(dev)
    wf = (torch.randn(4, 4, cin, cout, generator=g) * 0.05).to(
        torch.bfloat16).to(dev)
    m = (torch.rand(cout, generator=g) * 0.016 + 0.004).to(dev)
    c = (torch.randn(cout, generator=g) * 2).to(dev)
    return xs, wf, m, c


def _check_stem(dev, xs, wf, m, c, n_sp):
    """One K1 launch within one code of its plain version on at most 1e-3
    of the codes."""
    before = K.stem_pool_i8.launches
    got = K.stem_pool_i8(xs, wf, m, c, n_sp)
    torch.cuda.synchronize()
    assert K.stem_pool_i8.launches == before + 1
    ref = K.stem_pool_i8_plain(xs, wf, m, c, n_sp)
    n_diff = 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = (a.int() - b.int()).abs()
        assert int(d.max()) <= 1
        n_diff += int((d > 0).sum())
    assert n_diff <= 1e-3 * sum(r.numel() for r in ref)


# K1's block computes 128 stem columns for 63 pooled ones (126 sp columns)
# and walks a band of pooled rows: widths around 126 and 252 cut its last
# strip short by one column or leave one column alone, heights of 2 and
# odd pooled-row counts cut its bands; (512, 1024) is the main path's.
@pytest.mark.parametrize("h2,w2", [(36, 70), (8, 130), (2, 2), (2, 254),
                                   (46, 252), (14, 256), (6, 1030),
                                   (512, 1024)])
def test_stem_pool_kernel_within_one_code(dev, h2, w2):
    g = _gen(0)
    _check_stem(dev, *_k1_operands(g, h2, w2, 12, 128, dev), 64)


@pytest.mark.parametrize("cin,cout,n_sp", [(4, 64, 32), (16, 128, 64),
                                           (8, 96, 48), (12, 32, 16)])
def test_stem_pool_kernel_other_widths(dev, cin, cout, n_sp):
    g = _gen(16)
    _check_stem(dev, *_k1_operands(g, 18, 140, cin, cout, dev), n_sp)


@pytest.mark.parametrize("cin,cout,n_sp", [(12, 128, 40), (12, 144, 64),
                                           (20, 128, 64), (6, 128, 64)])
def test_stem_pool_kernel_refuses_widths_before_launch(dev, cin, cout, n_sp):
    g = _gen(17)
    xs, wf, m, c = _k1_operands(g, 8, 16, cin, cout, dev)
    before = K.stem_pool_i8.launches
    with pytest.raises(ValueError, match="stem_pool_i8_mma_kernel"):
        K.stem_pool_i8(xs, wf, m, c, n_sp)
    assert K.stem_pool_i8.launches == before


# K2 runs the resident-weight kernel at stride 2: odd H and W leave a
# window on the bottom and right pad, 256-pixel tiles cross output rows
# (ragged at (37, 45)), (64, 130) gives a 65-wide output, (1, 1) one pixel;
# (512, 1024) is the main path's first launch (half an output row a tile).
# Off the serving width: part-filled K chunks (cin 16, 48), cout % 16 == 8
# (8-byte stores), cin = 128 (two chunks a tap), cout above one 64-channel
# block.
@pytest.mark.parametrize("cin,cout,h,w", [
    (64, 64, 37, 45), (64, 64, 64, 130), (64, 64, 1, 1), (64, 64, 512, 1024),
    (16, 72, 9, 14), (48, 24, 11, 23), (128, 40, 5, 6), (64, 136, 8, 70)])
def test_conv3x3s2_kernel_bit_exact(dev, cin, cout, h, w):
    g = _gen(1)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    before = K.conv3x3s2_i8.launches
    _exact(K.conv3x3s2_i8(x, e["w"], e["m"], e["c"]),
           K.conv3x3s2_i8_plain(x, e["w"], e["m"], e["c"]))
    assert K.conv3x3s2_i8.launches == before + 1


# K3 at C <= 64 runs the resident-weight kernel: persistent blocks walk
# 256-pixel M tiles flattened over rows, so odd H*W leaves a ragged last
# tile and 1 x 1 a single pixel; C of 16 and 48 leave part of each tap's
# 64-byte K chunk zero-filled; (64, 256, 512) is the main path's stage 1
# (512 tiles over the persistent grid); C = 128 takes the streaming route.
@pytest.mark.parametrize("c,h,w", [(64, 20, 44), (64, 3, 33), (64, 256, 512),
                                   (64, 1, 1), (16, 7, 9), (48, 13, 69),
                                   (128, 10, 18)])
def test_l1_stage_kernel_bit_exact(dev, c, h, w):
    g = _gen(2)
    x = _codes(g, (1, h, w, c)).to(dev)
    e0, e1 = _block(g, c, c, 1, dev), _block(g, c, c, 1, dev)
    before = K.l1_stage_i8.launches
    _exact(K.l1_stage_i8(x, e0, e1), K.l1_stage_i8_plain(x, e0, e1))
    assert K.l1_stage_i8.launches == before + 1


# K4's tile is 128 output pixels (flattened over rows) x 64 channels: wo of
# 19 or 35 leaves ragged tiles across rows, h of 1 or 2 gives ho = 1, cin
# 16 and 48 leave part of a 64-byte K chunk zero-filled; (64, 256, 512)
# and (128, 128, 256) are the main path's stage 2 and stage 3.
@pytest.mark.parametrize("cin,h,w", [(64, 19, 37), (128, 10, 18),
                                     (128, 64, 128), (64, 1, 37),
                                     (128, 2, 70), (16, 7, 9), (48, 13, 69),
                                     (64, 256, 512), (128, 128, 256)])
def test_down_stage_kernel_bit_exact(dev, cin, h, w):
    g = _gen(3)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e0 = _block(g, cin, 2 * cin, 2, dev)
    e1 = _block(g, 2 * cin, 2 * cin, 1, dev)
    before = K.down_stage_i8.launches
    _exact(K.down_stage_i8(x, e0, e1), K.down_stage_i8_plain(x, e0, e1))
    assert K.down_stage_i8.launches == before + 1


@pytest.mark.parametrize("cin,cout", [(20, 40), (64, 72), (36, 64)])
def test_down_stage_kernel_refuses_widths_before_launch(dev, cin, cout):
    g = _gen(18)
    x = _codes(g, (1, 6, 10, cin)).to(dev)
    e0 = _block(g, cin, cout, 2, dev)
    e1 = _block(g, cout, cout, 1, dev)
    before = K.down_stage_i8.launches
    with pytest.raises(ValueError, match="conv_i8_mma_kernel"):
        K.down_stage_i8(x, e0, e1)
    assert K.down_stage_i8.launches == before


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("cin,cout,cdin,stride,h,w", [
    (48, 24, 80, 2, 11, 23), (64, 128, 64, 1, 9, 70),
    (128, 256, 128, 2, 16, 33), (256, 40, 32, 1, 5, 6)])
def test_conv_mma_kernel_modes_bit_exact(dev, mode, cin, cout, cdin, stride,
                                         h, w):
    """One conv_i8_mma_kernel launch in each epilogue mode against the
    plain formula: cout % 16 == 8 (8-byte stores), projections whose cin is
    not a multiple of the 64-byte chunk, both strides."""
    g = _gen(19)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    y = K.qconv(x, e["w"], stride, 1).float()
    z = K.fma(y, e["m"], e["c"])
    kw = {}
    if mode == 1:
        res = _codes(g, (1, ho, wo, cout)).to(dev)
        kw = {"res": res, "rr": 0.75}
        z = K.fma(res.float(), 0.75, z)
    elif mode == 2:
        xd = _codes(g, (1, 2 * ho, 2 * wo - 1, cdin)).to(dev)
        down = _cbr(g, 1, cdin, cout, dev)
        kw = {"xd": xd, "down": down, "sd": 2}
        z = K.fma(K.qconv(xd, down["w"], 2, 0).float(), down["m"], z) \
            + down["c"]
    _exact(K._launch_conv_mma(x, e, stride, mode=mode, **kw),
           K.requant(torch.relu(z)))


# K5 is K4's first two launches; at (256, 64, 128), the main path's stage
# 4, both have 128 output tiles and split each tile's K walk over a
# two-block cluster (conv2 with the projection's chunks on the first).
@pytest.mark.parametrize("cin,h,w", [(256, 9, 13), (256, 16, 33),
                                     (256, 64, 128), (64, 7, 9)])
def test_down_block_kernel_bit_exact(dev, cin, h, w):
    g = _gen(5)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _block(g, cin, 2 * cin, 2, dev)
    before = K.down_block_i8.launches
    _exact(K.down_block_i8(x, e), K.down_block_i8_plain(x, e))
    assert K.down_block_i8.launches == before + 1


# K6 at C > 64 runs the streaming kernel, its K walk split over a two-block
# cluster when the launch has no more tiles than the card has SMs:
# (512, 32, 64) is the main path's (128 tiles), (512, 1, 1) one pixel, C =
# 192 an odd chunk count (27: the two blocks take 13 and 14); C = 64 takes
# the resident-weight route.
@pytest.mark.parametrize("c,h,w", [(512, 5, 7), (512, 32, 64), (256, 3, 35),
                                   (512, 1, 1), (192, 9, 13), (64, 17, 23)])
def test_res_block_kernel_bit_exact(dev, c, h, w):
    g = _gen(6)
    x = _codes(g, (1, h, w, c)).to(dev)
    e = _block(g, c, c, 1, dev)
    before = K.res_block_i8.launches
    _exact(K.res_block_i8(x, e), K.res_block_i8_plain(x, e))
    assert K.res_block_i8.launches == before + 1


@pytest.mark.parametrize("fn", ["l1_stage_i8", "res_block_i8"])
@pytest.mark.parametrize("c", [36, 20])
def test_identity_blocks_refuse_widths_before_launch(dev, fn, c):
    """K3 and K6 take C % 16 == 0 on the card; any other width raises
    before a launch (the plain versions take any C % 4 == 0)."""
    g = _gen(20)
    x = _codes(g, (1, 6, 10, c)).to(dev)
    e = _block(g, c, c, 1, dev)
    kern = getattr(K, fn)
    args = (x, e, e) if fn == "l1_stage_i8" else (x, e)
    before = kern.launches
    with pytest.raises(ValueError, match="cin must be a positive multiple"):
        kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before


def _conv_mma_reference(g, x, e, mode, dev):
    """The plain stride-1 3x3 link in mode 0 or 1 (residual codes drawn
    from g) and the residual keywords for the launch."""
    z = K.fma(K.qconv(x, e["w"], 1, 1).float(), e["m"], e["c"])
    if mode == 0:
        return K.requant(torch.relu(z)), {}
    res = _codes(g, (*x.shape[:3], e["w"].shape[3])).to(dev)
    z = K.fma(res.float(), 0.75, z)
    return K.requant(torch.relu(z)), {"res": res, "rr": 0.75}


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("cin,cout,h,w", [(48, 24, 11, 23), (64, 136, 9, 70),
                                          (16, 72, 2, 3), (128, 40, 5, 6)])
def test_conv_mma_res_kernel_bit_exact(dev, mode, cin, cout, h, w):
    """One resident-weight launch against the plain formula: cout % 16 ==
    8 (8-byte stores), cout above one 64-channel block, part-filled K
    chunks, and cin = 128 (two chunks a tap, 74 KB of weights)."""
    g = _gen(21)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    ref, kw = _conv_mma_reference(g, x, e, mode, dev)
    _exact(K._launch_conv_mma_res(x, e, mode=mode, **kw), ref)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("cin,cout,h,w", [(48, 24, 11, 23), (256, 40, 5, 6),
                                          (192, 64, 3, 4), (512, 512, 32, 64)])
def test_conv_mma_kernel_split_bit_exact(dev, mode, cin, cout, h, w):
    """The streaming kernel with each tile's K walk split over a two-block
    cluster, against the plain formula and the unsplit launch: odd chunk
    counts (9 and 27) and the main path's stage-4 link."""
    g = _gen(22)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    ref, kw = _conv_mma_reference(g, x, e, mode, dev)
    _exact(K._launch_conv_mma(x, e, 1, mode=mode, split=2, **kw), ref)
    _exact(K._launch_conv_mma(x, e, 1, mode=mode, split=1, **kw), ref)


def test_conv_mma_kernel_refuses_a_split_projection(dev):
    """A projection launch splits over one or two blocks only: a split of
    three is refused at launch."""
    g = _gen(23)
    x = _codes(g, (1, 4, 6, 64)).to(dev)
    e = _cbr(g, 3, 64, 64, dev)
    xd = _codes(g, (1, 8, 12, 32)).to(dev)
    with pytest.raises(RuntimeError, match="conv_i8_mma_kernel"):
        K._launch_conv_mma(x, e, 1, mode=2, xd=xd, down=_cbr(g, 1, 32, 64,
                                                             dev), sd=2,
                           split=3)


# (cin, cout, cdin, h, w): the main path's K5 conv2 (72 main chunks and 4
# projection chunks: 34 + 4 on the first block, 38 on the second); 9 main
# and 2 projection chunks, cout % 16 == 8; cdin = 1024 (16 projection
# chunks against 9 main: the first block walks the projection alone).
@pytest.mark.parametrize("cin,cout,cdin,h,w", [
    (512, 512, 256, 32, 64), (48, 24, 80, 11, 23), (16, 32, 1024, 5, 7)])
def test_conv_mma_kernel_split_projection_bit_exact(dev, cin, cout, cdin, h,
                                                    w):
    """Mode 2 with each tile's K walk split over a two-block cluster, against
    the unsplit launch and the plain formula."""
    g = _gen(25)
    x = _codes(g, (1, h, w, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    xd = _codes(g, (1, 2 * h, 2 * w, cdin)).to(dev)
    down = _cbr(g, 1, cdin, cout, dev)
    z = K.fma(K.qconv(x, e["w"], 1, 1).float(), e["m"], e["c"])
    z = K.fma(K.qconv(xd, down["w"], 2, 0).float(), down["m"], z) + down["c"]
    ref = K.requant(torch.relu(z))
    kw = {"xd": xd, "down": down, "sd": 2}
    _exact(K._launch_conv_mma(x, e, 1, mode=2, split=2, **kw), ref)
    _exact(K._launch_conv_mma(x, e, 1, mode=2, split=1, **kw), ref)


@pytest.mark.parametrize("fn", ["conv3x3s2_i8", "down_block_i8"])
def test_k2_k5_refuse_widths_before_launch(dev, fn):
    """K2 and K5 take cin % 16 == 0 on the card; cin = 36 raises before a
    launch (the plain versions take any cin)."""
    g = _gen(26)
    x = _codes(g, (1, 6, 10, 36)).to(dev)
    kern = getattr(K, fn)
    if fn == "conv3x3s2_i8":
        e = _cbr(g, 3, 36, 64, dev)
        args = (x, e["w"], e["m"], e["c"])
    else:
        args = (x, _block(g, 36, 64, 2, dev))
    before = kern.launches
    with pytest.raises(ValueError, match="cin must be a positive multiple"):
        kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_conv_kernel_at_cin_512(dev, mode):
    """One streaming tensor-core launch at cin=512 (72 chunks; the host
    rule splits the 10 tiles over two-block clusters) in each epilogue
    mode, against the plain formula: ragged 7 x 37 output, cout 192."""
    g = _gen(7)
    x = _codes(g, (1, 7, 37, 512)).to(dev)
    e = _cbr(g, 3, 512, 192, dev)
    y = K.qconv(x, e["w"], 1, 1).float()
    z = K.fma(y, e["m"], e["c"])
    kw = {}
    if mode == 1:
        res = _codes(g, (1, 7, 37, 192)).to(dev)
        kw = {"res": res, "rr": 0.75}
        z = K.fma(res.float(), 0.75, z)
    elif mode == 2:
        xd = _codes(g, (1, 13, 73, 256)).to(dev)
        down = _cbr(g, 1, 256, 192, dev)
        kw = {"xd": xd, "down": down, "sd": 2}
        z = K.fma(K.qconv(xd, down["w"], 2, 0).float(), down["m"], z) \
            + down["c"]
    _exact(K._launch_conv_mma(x, e, 1, mode=mode, **kw),
           K.requant(torch.relu(z)))


def test_conv_launch_over_shared_memory_raises(dev):
    """A resident-weight launch whose weights exceed the device's shared
    memory raises a ValueError naming cin and k before any launch (9 taps
    x 1024 channels x 64 outputs is ~590 KB)."""
    g = _gen(8)
    x = _codes(g, (1, 9, 9, 1024)).to(dev)
    e = _cbr(g, 3, 1024, 64, dev)
    with pytest.raises(ValueError, match=r"cin=1024, k=3"):
        K._launch_conv_mma_res(x, e)


# -- the tensor-core convs' 1x1 and dilated windows and float32 epilogue ------

def _plain_conv(x, e, stride, dilation, mode, out_f32, res=None, rr=0.0,
                xd=None, down=None, sd=1):
    """The plain version of one tensor-core launch: the k x k conv (pad =
    dilation for a 3x3, 0 for a 1x1) and its epilogue chain."""
    k = e["w"].shape[0]
    y = K.qconv(x, e["w"], stride, dilation if k == 3 else 0, dilation)
    z = K.fma(y.float(), e["m"], e["c"])
    if mode == 1:
        z = K.fma(res.float(), rr, z)
    elif mode == 2:
        z = K.fma(K.qconv(xd, down["w"], sd, 0).float(), down["m"], z) \
            + down["c"]
    z = torch.relu(z)
    return z if out_f32 else K.requant(z)


def _launch(route, x, e, stride, dilation, mode, out_f32, **kw):
    """One launch on a route: the resident-weight kernel, or the streaming
    one unsplit or split over a two-block cluster."""
    if route == "resident":
        return K._launch_conv_mma_res(x, e, mode=mode, stride=stride,
                                      dilation=dilation, out_f32=out_f32,
                                      **kw)
    return K._launch_conv_mma(x, e, stride, mode=mode, dilation=dilation,
                              out_f32=out_f32, split=int(route[-1]), **kw)


# the resident route at cin 48 (one part-filled chunk a tap), the streaming
# one at cin 144 (three chunks a tap, the last part-filled); a ragged 13 x
# 21 input; cout 8 (one n8 group), 64 (one block) and 200 (four blocks, the
# last part-filled, cout % 16 == 8)
ROUTES = [("resident", 48), ("split1", 144), ("split2", 144)]


@pytest.mark.parametrize("cout", [8, 64, 200])
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("route,cin", ROUTES)
def test_conv_1x1_bit_exact(dev, route, cin, mode, stride, out_f32, cout):
    """A 1x1 launch (pad 0) in each mode, at stride 1 and 2, codes or
    float32 out, on each route (mode 2, a projection, streams only)."""
    if route == "resident" and mode == 2:
        pytest.skip("a projection launch runs on the streaming kernel only")
    g = _gen(30)
    x = _codes(g, (1, 13, 21, cin)).to(dev)
    e = _cbr(g, 1, cin, cout, dev)
    ho, wo = (13 - 1) // stride + 1, (21 - 1) // stride + 1
    kw = {}
    if mode == 1:
        kw = {"res": _codes(g, (1, ho, wo, cout)).to(dev), "rr": 0.75}
    elif mode == 2:
        kw = {"xd": _codes(g, (1, 2 * ho, 2 * wo - 1, 80)).to(dev),
              "down": _cbr(g, 1, 80, cout, dev), "sd": 2}
    got = _launch(route, x, e, stride, 1, mode, out_f32, **kw)
    _exact(got, _plain_conv(x, e, stride, 1, mode, out_f32, **kw))


@pytest.mark.parametrize("cout", [8, 64, 200])
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("route,cin", ROUTES)
def test_conv_3x3_dilated_bit_exact(dev, route, cin, dilation, stride,
                                    out_f32, cout):
    """A CBR 3x3 at pad = dilation (1, 2, 4), stride 1 and 2, codes or
    float32 out, on each route: taps d apart, most in the pad at d = 4 on
    a 13 x 21 input."""
    g = _gen(31)
    x = _codes(g, (1, 13, 21, cin)).to(dev)
    e = _cbr(g, 3, cin, cout, dev)
    got = _launch(route, x, e, stride, dilation, 0, out_f32)
    _exact(got, _plain_conv(x, e, stride, dilation, 0, out_f32))


@pytest.mark.parametrize("route", ["resident", "split1"])
def test_conv_1x1_residual_waits_for_a_short_tile(dev, route):
    """A 1x1 identity link whose tile is one K chunk (cin 64): the resident
    kernel's residual tile lands before that tile's epilogue."""
    g = _gen(32)
    x = _codes(g, (1, 37, 45, 64)).to(dev)
    e = _cbr(g, 1, 64, 256, dev)
    res = _codes(g, (1, 37, 45, 256)).to(dev)
    for out_f32 in (False, True):
        got = _launch(route, x, e, 1, 1, 1, out_f32, res=res, rr=0.75)
        _exact(got, _plain_conv(x, e, 1, 1, 1, out_f32, res=res, rr=0.75))


@pytest.mark.parametrize("kw", [
    {"mode": 1, "out_f32": True}, {"mode": 0, "dilation": 2, "k": 1},
    {"mode": 1, "dilation": 2}])
def test_conv_refuses_combinations_it_has_no_kernel_for(dev, kw):
    """Float32 out from a 3x3 in mode 1, a dilated 1x1 and a dilated
    residual link have no compiled instantiation: the entry points refuse
    them at launch, on both kernels."""
    g = _gen(33)
    k = kw.get("k", 3)
    x = _codes(g, (1, 6, 10, 64)).to(dev)
    e = _cbr(g, k, 64, 64, dev)
    res = _codes(g, (1, 6, 10, 64)).to(dev)
    extra = {"res": res, "rr": 0.75} if kw["mode"] == 1 else {}
    for route in ("resident", "split1"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _launch(route, x, e, 1, kw.get("dilation", 1), kw["mode"],
                    kw.get("out_f32", False), **extra)


# the main path's sp3 and decoder convs at 1024x2048 and PSPNet's stem2 and
# layer1 3x3 at 480x480 (the resident route and, below one resident tile a
# SM, the streaming one): (name, input shape, k, cout, emit_int8)
DECODER_CONVS = [("sp3", (1, 128, 256, 64), 1, 128, True),
                 ("stem2", (1, 240, 240, 64), 3, 64, True),
                 ("layer1_conv2", (1, 120, 120, 64), 3, 64, True),
                 ("arm0", (1, 32, 64, 512), 3, 128, False),
                 ("refine0", (1, 64, 128, 128), 3, 128, False),
                 ("arm1", (1, 64, 128, 256), 3, 128, False),
                 ("refine1", (1, 128, 256, 128), 3, 128, True),
                 ("ffm", (1, 128, 256, 256), 1, 256, False),
                 ("head", (1, 128, 256, 256), 3, 64, False)]


@pytest.mark.parametrize("name,shape,k,cout,emit_int8", DECODER_CONVS,
                         ids=[c[0] for c in DECODER_CONVS])
def test_cbr_kernel_at_the_decoder_shapes(dev, name, shape, k, cout,
                                          emit_int8):
    """cbr_i8 at the served R18.speed graph's seven shapes and two of
    PSPNet's, one launch each on the route ``conv_route`` picks, bit-exact
    against apply_cbr (codes or float32)."""
    g = _gen(34)
    x = _codes(g, shape).to(dev)
    e = _cbr(g, k, shape[3], cout, dev)
    pad = 1 if k == 3 else 0
    before = K.cbr_i8.launches
    got = K.cbr_i8(x, e, 1, pad, emit_int8)
    torch.cuda.synchronize()
    assert K.cbr_i8.launches == before + 1
    _exact(got, K.apply_cbr(x, e, 1, pad, emit_int8))


@pytest.mark.parametrize("case", ["cin", "pad", "k", "bottleneck"])
def test_cbr_and_bottleneck_refuse_widths_before_launch(dev, case):
    """cbr_i8 and bottleneck_i8 take cin % 16 == 0, a 3x3 at pad =
    dilation or a 1x1 at pad 0 on the card; anything else raises before a
    launch (the plain versions take any)."""
    g = _gen(35)
    if case == "bottleneck":
        x = _codes(g, (1, 6, 10, 64)).to(dev)
        e = _bottleneck(g, 64, 36, 64, False, dev)
        kern, call = K.bottleneck_i8, lambda: K.bottleneck_i8(x, e, 1, 1)
    else:
        cin = 36 if case == "cin" else 64
        k = 5 if case == "k" else 3
        x = _codes(g, (1, 6, 10, cin)).to(dev)
        e = _cbr(g, k, cin, 64, dev)
        pad = 2 if case == "pad" else k // 2
        kern, call = K.cbr_i8, lambda: K.cbr_i8(x, e, 1, pad)
    before = kern.launches
    with pytest.raises(ValueError, match="tensor cores"):
        call()
    torch.cuda.synchronize()
    assert kern.launches == before


# -- K10 and the dilated Bottleneck body (PSPNet) ------------------------------

@pytest.mark.parametrize("shape", [(1, 240, 240, 128), (1, 15, 17, 8),
                                   (1, 1, 1, 4), (1, 2, 3, 12),
                                   (1, 64, 130, 64)])
def test_maxpool_kernel_bit_exact(dev, shape):
    """Any H, W (odd ones too) and any code, the pad identity -128 among
    them."""
    g = _gen(15)
    x = _codes(g, shape, lo=-128)
    x.view(-1)[:8] = -128
    x = x.to(dev)
    before = K.maxpool2d_3x3s2_i8.launches
    got = K.maxpool2d_3x3s2_i8(x)
    torch.cuda.synchronize()
    assert K.maxpool2d_3x3s2_i8.launches == before + 1
    assert got.shape == (1, (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                         shape[3])
    _exact(got, K.maxpool_i8(x))


def _pool_codes(g, shape, dev, offset=0):
    """Seeded codes in [-128, 127] (every tenth -128) on the card, starting
    ``offset`` bytes past a 16-byte boundary."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    buf = torch.empty(n + 16, dtype=torch.int8, device=dev)
    x = buf[(-buf.data_ptr() + offset) % 16:][:n].view(shape)
    x.copy_(_codes(g, shape, lo=-128))
    x.view(-1)[::10] = -128
    return x


def _pool_launch(x, route):
    """One K10 launch through the wrapper on ``route`` (checked by the
    wrapper's route counts); bit-exact against maxpool_i8."""
    before = K.maxpool2d_3x3s2_i8.launches
    routes = dict(K.maxpool2d_3x3s2_i8.routes)
    got = K.maxpool2d_3x3s2_i8(x)
    torch.cuda.synchronize()
    assert K.maxpool2d_3x3s2_i8.launches == before + 1
    routes[route] += 1
    assert K.maxpool2d_3x3s2_i8.routes == routes
    _exact(got, K.maxpool_i8(x))


@pytest.mark.parametrize("shape", [
    (1, 240, 240, 128),                    # PSPNet's pool input
    (1, 15, 17, 16), (1, 17, 15, 32), (1, 13, 9, 64), (1, 9, 13, 256),
    (1, 13, 11, 16),                       # ho = 7: not a multiple of 2, 4, 8
    (1, 5, 240, 128),                      # ho = 3
    (1, 1, 1, 16), (1, 2, 3, 16)])
def test_maxpool_16_byte_route_bit_exact(dev, shape):
    _pool_launch(_pool_codes(_gen(16), shape, dev), 16)


@pytest.mark.parametrize("shape,offset", [
    ((1, 15, 17, 4), 0), ((1, 15, 17, 8), 0), ((1, 13, 9, 12), 0),
    ((1, 9, 13, 20), 0), ((1, 240, 240, 20), 0),
    ((1, 15, 17, 128), 4),                 # a view 4 bytes off 16
    ((1, 13, 9, 16), 4), ((1, 13, 9, 16), 8)])
def test_maxpool_4_byte_route_bit_exact(dev, shape, offset):
    _pool_launch(_pool_codes(_gen(17), shape, dev, offset), 4)


@pytest.mark.parametrize("shape,route", [((1, 15, 17, 16), 16),
                                         ((1, 16, 18, 128), 16),
                                         ((1, 15, 17, 12), 4)])
@pytest.mark.parametrize("fill", ["edges", "all"])
def test_maxpool_pad_identity_bit_exact(dev, shape, route, fill):
    """-128 planted on every edge row and column (where the pad meets
    real codes), or everywhere."""
    x = _pool_codes(_gen(18), shape, dev)
    if fill == "all":
        x.fill_(-128)
    else:
        for sl in ((slice(None), 0), (slice(None), -1),
                   (slice(None), slice(None), 0),
                   (slice(None), slice(None), -1)):
            x[sl] = -128
    _pool_launch(x, route)


def _cbr_k(g, k, cin, cout, dev):
    """_cbr with the epilogue scale of a k x k conv (1x1 convs included)."""
    e = _cbr(g, k, cin, cout, dev)
    e["m"] = e["m"] * (9 / (k * k)) ** 0.5
    return e


@pytest.mark.parametrize("cin,stride,dilation", [(64, 1, 2), (64, 1, 4),
                                                 (256, 1, 2), (512, 1, 4),
                                                 (128, 2, 1), (64, 2, 2)])
def test_conv_kernel_dilated_bit_exact(dev, cin, stride, dilation):
    """cbr_i8 at the body's dilations, one weight chunk (cin <= 128) and
    several (cin 256, 512)."""
    g = _gen(16)
    x = _codes(g, (1, 19, 45, cin)).to(dev)
    e = _cbr_k(g, 3, cin, 96, dev)
    before = K.cbr_i8.launches
    got = K.cbr_i8(x, e, stride, dilation, dilation=dilation)
    assert K.cbr_i8.launches == before + 1
    _exact(got, K.apply_cbr(x, e, stride, dilation, dilation=dilation))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_conv_kernel_out_f32_bit_exact(dev, mode):
    """The float32 epilogue (the body's last block: a 1x1 at cin 512) in
    each mode, on the streaming kernel."""
    g = _gen(17)
    x = _codes(g, (1, 9, 37, 512)).to(dev)
    e = _cbr_k(g, 1, 512, 256, dev)
    z = K.fma(K.qconv(x, e["w"], 1, 0).float(), e["m"], e["c"])
    kw = {}
    if mode == 1:
        res = _codes(g, (1, 9, 37, 256)).to(dev)
        rr = float(torch.tensor(0.0371))  # the kernel takes a float32
        kw = {"res": res, "rr": rr}
        z = K.fma(res.float(), rr, z)
    elif mode == 2:
        xd = _codes(g, (1, 9, 37, 1024)).to(dev)
        down = _cbr_k(g, 1, 1024, 256, dev)
        kw = {"xd": xd, "down": down, "sd": 1}
        z = K.fma(K.qconv(xd, down["w"], 1, 0).float(), down["m"], z) \
            + down["c"]
    got = K._launch_conv_mma(x, e, 1, mode=mode, out_f32=True, **kw)
    assert got.dtype == torch.float32
    _exact(got, torch.relu(z))


def _bottleneck(g, cin, mid, cout, projection, dev):
    e = {"conv1": _cbr_k(g, 1, cin, mid, dev),
         "conv2": _cbr_k(g, 3, mid, mid, dev),
         "conv3": _cbr_k(g, 1, mid, cout, dev),
         "res_ratio": float(torch.rand((), generator=g)) + 0.3}
    if projection:
        e["down"] = _cbr_k(g, 1, cin, cout, dev)
    return e


# ResNet-50 at output stride 8: (cin, mid, cout, stride, dilation,
# projection, emit_int8); layer4_0's projection reads cin = 1024
R50_BLOCKS = [(64, 64, 256, 1, 1, True, True), (256, 64, 256, 1, 1, False,
                                                  True),
              (256, 128, 512, 2, 1, True, True),
              (512, 256, 1024, 1, 1, True, True),
              (1024, 256, 1024, 1, 2, False, True),
              (1024, 512, 2048, 1, 2, True, True),
              (2048, 512, 2048, 1, 4, False, True),
              (2048, 512, 2048, 1, 4, False, False)]


@pytest.mark.parametrize("case", R50_BLOCKS)
def test_bottleneck_kernel_bit_exact(dev, case):
    cin, mid, cout, stride, dilation, proj, emit = case
    g = _gen(18)
    x = _codes(g, (1, 23, 30, cin)).to(dev)
    e = _bottleneck(g, cin, mid, cout, proj, dev)
    before = K.bottleneck_i8.launches
    got = K.bottleneck_i8(x, e, stride, dilation, emit)
    torch.cuda.synchronize()
    assert K.bottleneck_i8.launches == before + 3
    ref = K.apply_bottleneck(x, e, stride, dilation, emit)
    _exact(got, ref)
    assert 0 < float((ref > 0).float().mean()) < 1


@pytest.mark.parametrize("shape,out_hw", [
    ((1, 13, 21, 19), (100, 167)),   # neither H nor W a multiple of 32
    ((2, 16, 24, 150), (97, 131)),   # ADE's 150 classes, batch 2
    ((1, 128, 256, 19), (1024, 2048)),  # the serving shape
    ((1, 1, 9, 19), (5, 40)),        # a single source row
])
def test_upsample_argmax_kernel_meets_its_bar(dev, shape, out_hw):
    g = _gen(9)
    x = torch.randn(shape, generator=g).to(dev)
    before = U.fused_upsample_argmax.launches
    got = U.fused_upsample_argmax(x, out_hw)
    torch.cuda.synchronize()
    assert U.fused_upsample_argmax.launches == before + 1
    ref = U.fused_upsample_argmax_plain(x, out_hw)
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.int32
    scores = resize_bilinear_align_corners(x.permute(0, 3, 1, 2), out_hw)
    share, n_clear = U.label_agreement(got, ref, scores.permute(0, 2, 3, 1))
    assert share >= U.MIN_SHARE and n_clear == 0, (share, n_clear)


def _k7_per_pixel_labels(x, out_hw):
    """The one-thread-a-pixel kernel's formula on the card (float32, each
    operation rounded once: z0, z1 from the four corners, then s), first
    maximum wins."""
    def taps(n_in, n_out):
        if n_in == 1 or n_out == 1:
            z = torch.zeros(n_out, dtype=torch.long)
            return z, z, torch.ones(n_out), torch.zeros(n_out)
        src = (torch.arange(n_out, dtype=torch.float64) * (n_in - 1)
               / (n_out - 1))
        f = src.floor().long().clamp(0, n_in - 2)
        frac = (src - f).float()
        return f, f + 1, 1.0 - frac, frac

    dev = x.device
    y0, y1, a0, a1 = (t.to(dev) for t in taps(x.shape[1], out_hw[0]))
    x0, x1, b0, b1 = (t.to(dev) for t in taps(x.shape[2], out_hw[1]))
    a0, a1 = a0[:, None, None], a1[:, None, None]
    b0, b1 = b0[None, :, None], b1[None, :, None]
    labels = []
    for n in range(x.shape[0]):  # one image at a time: (H, W, C) scores
        r0, r1 = x[n, y0], x[n, y1]
        z0 = a0 * r0[:, x0] + a1 * r1[:, x0]
        z1 = a0 * r0[:, x1] + a1 * r1[:, x1]
        labels.append((b0 * z0 + b1 * z1).argmax(dim=-1))
    return torch.stack(labels).to(torch.int32)


@pytest.mark.parametrize("shape,out_hw", [
    ((1, 13, 21, 19), (100, 167)), ((2, 16, 24, 150), (97, 131)),
    ((1, 128, 256, 19), (1024, 2048)), ((1, 1, 9, 19), (5, 40)),
    ((1, 32, 512, 150), (64, 4096)), ((1, 9, 3000, 7), (17, 50))])
def test_upsample_argmax_kernel_is_the_per_pixel_formula(dev, shape, out_hw):
    """The separable kernel's labels equal the per-pixel formula's bit for
    bit (the same operations in the same rounding order), at the serving
    shape, at 150 classes on a width that needs two column chunks and
    class chunks, and downsampling 3000 source columns to 50."""
    x = torch.randn(shape, generator=_gen(11)).to(dev)
    got = U.fused_upsample_argmax(x, out_hw)
    torch.cuda.synchronize()
    assert torch.equal(got, _k7_per_pixel_labels(x, out_hw))


def test_upsample_argmax_kernel_150_classes_in_column_chunks(dev):
    """ADE's 150 classes, 4096 output columns (two 2048-column chunks) of
    512 source columns (classes in chunks): K7's bar against the plain
    version."""
    shape, out_hw = (1, 32, 512, 150), (64, 4096)
    from torchseg_tpu_torch.ops.kernels import _build
    cols, cc, _ = U.block_plan(shape[2], shape[3], out_hw[1], _build.ready(
        dev.index, "upsample_argmax").tsg_upsample_max_cols())
    assert cols < out_hw[1] and cc < shape[3]
    x = torch.randn(shape, generator=_gen(12)).to(dev)
    got = U.fused_upsample_argmax(x, out_hw)
    ref = U.fused_upsample_argmax_plain(x, out_hw)
    scores = resize_bilinear_align_corners(x.permute(0, 3, 1, 2), out_hw)
    share, n_clear = U.label_agreement(got, ref, scores.permute(0, 2, 3, 1))
    assert share >= U.MIN_SHARE and n_clear == 0, (share, n_clear)


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


# -- K8 / K9, the train-mode BN kernels ----------------------------------

BN_SHAPES = [(2, 64, 512, 512), (3, 5, 7, 11), (1, 19, 45, 47),
             (4, 3, 1, 1), (2, 128, 4, 4)]
# every distinct BN input of the DFN-R101 step at 2 x 800x800 (24) and of
# the BiSeNet-R18 step at 2 x 1024x1024 (10), as chip_smoke.py drives them
DFN_BN_SHAPES = [
    (2, 64, 400, 400), (2, 128, 400, 400), (2, 64, 200, 200),
    (2, 256, 200, 200), (2, 128, 200, 200), (2, 512, 200, 200),
    (2, 171, 200, 200), (2, 21, 200, 200), (2, 9, 200, 200),
    (2, 128, 100, 100), (2, 512, 100, 100), (2, 256, 100, 100),
    (2, 171, 100, 100), (2, 21, 100, 100), (2, 256, 50, 50),
    (2, 1024, 50, 50), (2, 512, 50, 50), (2, 171, 50, 50), (2, 21, 50, 50),
    (2, 512, 25, 25), (2, 2048, 25, 25), (2, 171, 25, 25), (2, 21, 25, 25),
    (2, 512, 1, 1)]
BISENET_BN_SHAPES = [
    (2, 64, 512, 512), (2, 64, 256, 256), (2, 64, 128, 128),
    (2, 128, 128, 128), (2, 256, 128, 128), (2, 256, 64, 64),
    (2, 128, 64, 64), (2, 512, 32, 32), (2, 128, 32, 32), (2, 128, 1, 1)]
# n = 1 (a gate at batch 1), HW = 1 with many images, odd HW
EDGE_BN_SHAPES = [(1, 7, 1, 1), (64, 13, 1, 1), (2, 3, 25, 25),
                  (2, 5, 101, 103)]
K8_SHAPES = sorted(set(BN_SHAPES + DFN_BN_SHAPES + BISENET_BN_SHAPES
                       + EDGE_BN_SHAPES))


def _bn_input(shape, dtype, dev, seed=11):
    g = _gen(seed)
    return (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype).to(dev)


def _misaligned(shape, dev, dtype=torch.float32):
    """A contiguous view one element past a 16-byte boundary."""
    n = 1
    for d in shape:
        n *= d
    x = _bn_input((1 + n,), dtype, dev)[1:].view(shape)
    assert x.data_ptr() % 16
    return x


def _check_k8(x):
    before = B.channel_sum_sumsq.launches
    got = B.channel_sum_sumsq(x)
    torch.cuda.synchronize()
    assert B.channel_sum_sumsq.launches == before + 1
    ref = B.channel_sum_sumsq_plain(x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    abs_sum = x.double().abs().sum(dim=dims)
    d = (got - ref).abs().double()
    assert bool((d[0] <= 1e-5 * abs_sum).all())
    assert bool((d[1] <= 1e-5 * ref[1].double().abs()).all())
    assert torch.equal(got, B.channel_sum_sumsq(x))  # the same every run


@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_sum_sumsq_kernel(dev, shape, dtype):
    _check_k8(_bn_input(shape, dtype, dev))


def test_channel_sum_sumsq_kernel_2d_and_misaligned(dev):
    _check_k8(_bn_input((37, 13), torch.float32, dev))
    _check_k8(_misaligned((2, 8, 16, 16), dev))  # 4 bytes past a boundary
    _check_k8(_misaligned((2, 9, 200, 200), dev))  # the cluster path
    _check_k8(_misaligned((2, 21, 25, 25), dev, torch.bfloat16))


def _bn_operands(c, dev, seed):
    g = _gen(seed)
    return [(torch.rand(c, generator=g) + 0.5).to(dev),
            (torch.randn(c, generator=g) * 0.2).to(dev),
            (torch.randn(c, generator=g) * 0.1).to(dev),
            (torch.rand(c, generator=g) + 0.5).to(dev),
            torch.tensor(3, dtype=torch.int64, device=dev), 1e-5, 0.1]


def _clone_bn(bn):
    return tuple(t.clone() if torch.is_tensor(t) else t for t in bn)


@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_sum_sumsq_fold_bit_exact(dev, shape, dtype):
    """K8's epilogue against ``bn_fold_plain`` on K8's own sums (the card
    runs the plain fold too): (mean, inv, a, b, d), the running stats and
    num_batches_tracked bit for bit, and the same bits on a second call
    (one launch each, the cluster path at the largest inputs)."""
    x = _bn_input(shape, dtype, dev, seed=16)
    bn = _bn_operands(shape[1], dev, seed=17)
    k_bn, p_bn = _clone_bn(bn), _clone_bn(bn)
    before = B.channel_sum_sumsq.launches
    got = B.channel_sum_sumsq(x, k_bn)
    torch.cuda.synchronize()
    assert B.channel_sum_sumsq.launches == before + 1
    n = x.numel() // shape[1]
    ref = B.bn_fold_plain(B.channel_sum_sumsq(x), n, *p_bn)
    assert got.shape == (5, shape[1]) and got.dtype == torch.float32
    _exact(got, ref)
    for k, p in zip(k_bn[:5], p_bn[:5]):
        _exact(k, p)
    assert int(k_bn[4]) == 4
    again = B.channel_sum_sumsq(x, _clone_bn(bn))
    _exact(again, got)


def test_channel_sum_sumsq_fold_misaligned_and_no_counter(dev):
    for x in (_misaligned((2, 21, 25, 25), dev),
              _misaligned((2, 64, 200, 200), dev)):
        bn = _bn_operands(x.shape[1], dev, seed=18)
        bn[4] = None
        k_bn, p_bn = _clone_bn(bn), _clone_bn(bn)
        got = B.channel_sum_sumsq(x, k_bn)
        ref = B.bn_fold_plain(B.channel_sum_sumsq(x), x.numel() //
                              x.shape[1], *p_bn)
        _exact(got, ref)
        _exact(k_bn[3], p_bn[3])


def test_channel_sum_sumsq_fold_refuses_bad_operands(dev):
    x = _bn_input((2, 6, 8, 8), torch.float32, dev)
    bn = _bn_operands(6, dev, seed=19)
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        B.channel_sum_sumsq(x, [bn[0].cpu()] + bn[1:])
    with pytest.raises(ValueError, match=r"\(6,\)"):
        B.channel_sum_sumsq(x, [bn[0][:5]] + bn[1:])
    with pytest.raises(TypeError, match="float32"):
        B.channel_sum_sumsq(x, [t.double() if torch.is_tensor(t) and
                                t.dtype == torch.float32 else t
                                for t in bn])


@pytest.mark.parametrize("shape", BN_SHAPES + DFN_BN_SHAPES
                         + BISENET_BN_SHAPES + EDGE_BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_scale_bias_act_kernel_bit_exact(dev, shape, dtype, act):
    """float32 a and b, most of them off the bf16 grid: with a bf16 x the
    kernel rounds them to bf16 itself, as the plain version does."""
    x = _bn_input(shape, dtype, dev, seed=12)
    g = _gen(13)
    a = (torch.rand(shape[1], generator=g) * 2 - 0.5).to(dev)
    b = torch.randn(shape[1], generator=g).to(dev)
    before = B.fused_scale_bias_act.launches
    got = B.fused_scale_bias_act(x, a, b, act)
    torch.cuda.synchronize()
    assert B.fused_scale_bias_act.launches == before + 1
    _exact(got, B.fused_scale_bias_act_plain(x, a, b, act))


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (2, 5, 7, 11),
                                   (2, 8, 64, 65), (3, 512, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_scale_bias_act_kernel_misaligned(dev, shape, dtype):
    """x one element past a 16-byte boundary and y aligned: scalar loads
    on the flat small-run grid (HW < 4096) and on the per-run grid."""
    x = _misaligned(shape, dev, dtype)
    a, b = torch.rand(shape[1], device=dev), torch.randn(shape[1],
                                                         device=dev)
    _exact(B.fused_scale_bias_act(x, a, b, "relu"),
           B.fused_scale_bias_act_plain(x, a, b, "relu"))


def test_fused_scale_bias_act_takes_strided_and_bf16_vectors(dev):
    x = _bn_input((2, 6, 9, 9), torch.bfloat16, dev)
    ab = torch.randn(6, 2, device=dev)
    for a, b in ((ab[:, 0], ab[:, 1]),
                 (ab[:, 0].bfloat16(), ab[:, 1].double())):
        _exact(B.fused_scale_bias_act(x, a, b),
               B.fused_scale_bias_act_plain(x, a, b))


def test_bn_kernels_refuse_float64_and_mixed_devices(dev):
    x = torch.zeros(2, 3, 4, 4, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        B.channel_sum_sumsq(x)
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        B.fused_scale_bias_act(x.float(), torch.ones(3), torch.zeros(3))


def test_train_batch_norm_forward_is_two_launches(dev):
    """One train-mode SyncBN forward without a process group: K8 (the sums
    and the fold, running stats and counter included) and K9, and no other
    device work, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bn = BatchNorm2d(64).to(dev).train()
    x = _bn_input((2, 64, 50, 50), torch.float32, dev).requires_grad_(True)
    bn(x, relu=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bn(x, relu=True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in events) == 2, [e.key for e in events]
    assert int(bn.num_batches_tracked) == 2


@pytest.mark.parametrize("shape,relu", [((2, 64, 48, 40), True),
                                        ((8, 64, 1, 1), False)])
def test_train_batch_norm_on_card_matches_cpu(dev, shape, relu):
    """SyncBN's Function (no group) on K8/K9: output, running stats and
    gradients on the card against the same module on the CPU."""
    g = _gen(14)
    x = torch.randn(shape, generator=g) * 1.5 + 0.3
    w = torch.randn(shape, generator=g)
    outs = []
    for device in ("cpu", dev):
        bn = BatchNorm2d(shape[1]).to(device).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, shape[1]))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, shape[1]))
        xt = x.to(device).detach().requires_grad_(True)
        y = bn(xt, relu=relu)
        (y * w.to(device)).sum().backward()
        outs.append([t.detach().cpu() for t in (
            y, xt.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)])
    for got, ref in zip(outs[1], outs[0]):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * scale + 1e-7


# ----------------------------------------------------------------------
# K11, the fused stem conv
# ----------------------------------------------------------------------

def _stem_operands(g, hw, cout, dev, batch=1):
    img = torch.randn(batch, *hw, 3, generator=g)
    k = torch.randn(7, 7, 3, cout, generator=g) * (2 / 147) ** 0.5
    a = torch.rand(cout, generator=g) + 0.5
    b = torch.randn(cout, generator=g) * 0.2
    return img, k.to(dev), a.to(dev), b.to(dev)


def _stem_input(img, fmt, dtype, dev):
    if fmt == "s2d":
        n, h, w, _ = img.shape
        x = img.reshape(n, h // 2, 2, w // 2, 2, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 12)
    elif fmt == "nhwc8":
        x = torch.cat([img, torch.zeros(*img.shape[:3], 5)], dim=-1)
    else:
        x = img
    return x.contiguous().to(dtype).to(dev), ("s2d" if fmt == "s2d"
                                              else "nhwc")


@pytest.fixture
def no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version's conv
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("fmt", ["nhwc", "nhwc8", "s2d"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout,n_sp,hw,batch", [
    (72, 64, (38, 202), 1), (128, 64, (64, 130), 1), (72, 64, (18, 2), 2),
    (5, 0, (2, 2), 1), (128, 128, (20, 258), 1)])
def test_stem_conv_kernel_meets_its_bars(dev, no_tf32, fmt, in_dtype, cout,
                                         n_sp, hw, batch):
    """Both input formats and dtypes, cout 72 (X39) and 128 (R18), output
    sizes off the 64-column and 8-row strips, a batch, empty halves."""
    img, k, a, b = _stem_operands(_gen(cout + hw[1]), hw, cout, dev, batch)
    x, form = _stem_input(img, fmt, in_dtype, dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = S.stem_conv7x7_s2.launches
        got = S.stem_conv7x7_s2(x, k, a, b, n_sp, form, out_dtype)
        torch.cuda.synchronize()
        assert S.stem_conv7x7_s2.launches == before + 1
        ref = S.stem_conv7x7_s2_plain(x, k, a, b, n_sp, form, out_dtype)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype == out_dtype
            assert g.is_contiguous()
        _, share, n_beyond = S.agreement(got, ref)
        assert n_beyond == 0
        if out_dtype == torch.bfloat16:
            assert share >= S.MIN_SHARE, share


def test_stem_conv_kernel_at_the_serving_shapes(dev, no_tf32):
    """X39.speed at 768x1536 and R18 at 1024x2048, s2d bf16 in and out."""
    for hw, cout in (((768, 1536), 72), ((1024, 2048), 128)):
        img, k, a, b = _stem_operands(_gen(hw[0]), hw, cout, dev)
        x, form = _stem_input(img, "s2d", torch.bfloat16, dev)
        got = S.stem_conv7x7_s2(x, k, a, b, 64, form)
        ref = S.stem_conv7x7_s2_plain(x, k, a, b, 64, form)
        _, share, n_beyond = S.agreement(got, ref)
        assert n_beyond == 0 and share >= S.MIN_SHARE, share


def _stem_bars(got, ref):
    _, share, n_beyond = S.agreement(got, ref)
    assert n_beyond == 0
    if got[0].dtype == torch.bfloat16:
        assert share >= S.MIN_SHARE, share


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_stem_conv_packed_route_at_the_serving_shapes(dev, no_tf32,
                                                      out_dtype):
    """The tensor-core route with the pack made once, as the served graph
    passes it: X39.speed at 768x1536 (72 = 64 + 8) and R18 at 1024x2048
    (64 + 64), s2d bf16 in."""
    for hw, cout in (((768, 1536), 72), ((1024, 2048), 128)):
        img, k, a, b = _stem_operands(_gen(hw[1]), hw, cout, dev)
        x, form = _stem_input(img, "s2d", torch.bfloat16, dev)
        pack = S.pack_stem_weights(k)
        before = S.stem_conv7x7_s2.launches
        got = S.stem_conv7x7_s2(x, k, a, b, 64, form, out_dtype, pack=pack)
        torch.cuda.synchronize()
        assert S.stem_conv7x7_s2.launches == before + 1
        _stem_bars(got, S.stem_conv7x7_s2_plain(x, k, a, b, 64, form,
                                                out_dtype))


@pytest.mark.parametrize("fmt", ["s2d", "nhwc", "nhwc8"])
@pytest.mark.parametrize("cout,n_sp,hw,batch", [
    (72, 64, (36, 1000), 1), (128, 64, (50, 394), 2), (128, 0, (6, 130), 1),
    (64, 32, (10, 66), 1), (100, 64, (14, 258), 1)])
def test_stem_conv_packed_route_off_the_tile(dev, no_tf32, fmt, cout, n_sp,
                                             hw, batch):
    """cout 72 and 128 (and 64, 100) at widths that are not a multiple of
    the tensor-core kernel's 64-column tile, a batch, an empty half."""
    img, k, a, b = _stem_operands(_gen(cout + hw[0]), hw, cout, dev, batch)
    x, form = _stem_input(img, fmt, torch.bfloat16, dev)
    pack = S.pack_stem_weights(k)
    assert "wgmma" in S.route(x)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = S.stem_conv7x7_s2(x, k, a, b, n_sp, form, out_dtype,
                                pack=pack)
        torch.cuda.synchronize()
        _stem_bars(got, S.stem_conv7x7_s2_plain(x, k, a, b, n_sp, form,
                                                out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_stem_conv_float32_input_on_the_cuda_core_route(dev, no_tf32,
                                                        out_dtype):
    """A float32 image (the float32 model's card checks, 256x512 and the
    R18 width) runs the CUDA-core kernel and meets the same bars."""
    for hw, cout in (((256, 512), 128), ((256, 512), 72), ((64, 2048), 128)):
        img, k, a, b = _stem_operands(_gen(hw[0] + cout), hw, cout, dev)
        x, form = _stem_input(img, "s2d", torch.float32, dev)
        assert "CUDA cores" in S.route(x)
        got = S.stem_conv7x7_s2(x, k, a, b, 64, form, out_dtype)
        torch.cuda.synchronize()
        _stem_bars(got, S.stem_conv7x7_s2_plain(x, k, a, b, 64, form,
                                                out_dtype))


@pytest.mark.parametrize("hw,cout,fmt", [((768, 1536), 72, "s2d"),
                                         ((256, 512), 128, "s2d"),
                                         ((50, 394), 128, "nhwc8")])
def test_stem_conv_bf16_rounds_as_the_float32_chain(dev, hw, cout, fmt):
    """The tensor-core route's bf16 output, its ambiguous roundings
    recomputed in the reference order, equals bit for bit the CUDA-core
    route's (one float32 FMA chain) on the same bf16 image."""
    img, k, a, b = _stem_operands(_gen(hw[1] + cout), hw, cout, dev)
    x, form = _stem_input(img, fmt, torch.bfloat16, dev)
    got = S.stem_conv7x7_s2(x, k, a, b, 64, form, pack=S.pack_stem_weights(k))
    ref = S.stem_conv7x7_s2(x.float(), k, a, b, 64, form)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _exact(g, r)


def test_stem_conv_refuses_a_wrong_pack(dev):
    img, k, a, b = _stem_operands(_gen(2), (8, 8), 72, dev)
    x, form = _stem_input(img, "s2d", torch.bfloat16, dev)
    before = S.stem_conv7x7_s2.launches
    for bad in (S.pack_stem_weights(k[..., :64].contiguous()),
                S.pack_stem_weights(k).float(), S.pack_stem_weights(k).cpu()):
        with pytest.raises((ValueError, TypeError)):
            S.stem_conv7x7_s2(x, k, a, b, 64, form, pack=bad)
    assert S.stem_conv7x7_s2.launches == before


def test_stem_conv_kernel_refuses_float64(dev):
    img, k, a, b = _stem_operands(_gen(1), (8, 8), 8, dev)
    with pytest.raises(TypeError):
        S.stem_conv7x7_s2(img.double().to(dev), k.double(), a.double(),
                          b.double(), 4, out_dtype=torch.float64)


@pytest.mark.parametrize("shape", [(2, 512, 1, 1), (2, 21, 200, 200)])
def test_dfn_batch_norm_layers_on_card_match_cpu(dev, shape):
    """DFN's global-context BN (n = 2 values a channel at batch 2) and a
    border RefineResidual's 21-channel BN at x4 of 800x800, with ReLU.
    At n = 2 the variance sum x^2 / n - mean^2 (JAX's formula) keeps
    only what rounding leaves of a pair that lies within ~sqrt(eps) of
    itself, so the pairs drawn here lie 0.5 to 3 apart; and the input
    gradient is what is left after the BN's projection removes both of a
    channel's directions: rounding alone, so it is held to the size of the
    terms that cancel (|g| * gamma / std)."""
    g = _gen(15)
    x = torch.randn(shape, generator=g) * 1.5 + 0.3
    if shape[0] * shape[2] * shape[3] == 2:
        half = torch.rand(shape[1], generator=g) * 1.25 + 0.25
        sign = torch.randint(0, 2, (shape[1],), generator=g) * 2 - 1
        x[1] = x[0] + (2 * half * sign)[:, None, None]
    w = torch.randn(shape, generator=g)
    weight = torch.linspace(0.5, 1.5, shape[1])
    outs = []
    for device in ("cpu", dev):
        bn = BatchNorm2d(shape[1]).to(device).train()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(torch.linspace(-0.2, 0.2, shape[1]))
        xt = x.to(device).detach().requires_grad_(True)
        y = bn(xt, relu=True)
        (y * w.to(device)).sum().backward()
        outs.append([t.detach().cpu() for t in (
            y, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var, xt.grad)])
    *got, got_dx = outs[1]
    *ref, ref_dx = outs[0]
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * float(
            b.abs().max()) + 1e-7
    inv = torch.rsqrt(x.var(dim=(0, 2, 3), unbiased=False) + 1e-5)
    terms = float((w.abs() * (weight * inv)[None, :, None, None]).max())
    assert float((got_dx - ref_dx).abs().max()) <= 1e-5 * max(
        terms, float(ref_dx.abs().max()))


# ----------------------------------------------------------------------
# K12 / K13, the multi-class sigmoid focal loss
# ----------------------------------------------------------------------

def _focal_operands(g, n, c, dtype, tdtype, dev):
    x = torch.randn(n, c, generator=g) * 4
    x.view(-1)[:3] = torch.tensor([30.0, -30.0, 0.0])
    t = torch.randint(-1, c + 2, (n,), generator=g)
    t[:4] = torch.tensor([-1, 0, 1, c + 1])
    return x.to(dtype).to(dev), t.to(tdtype).to(dev)


def _focal_close(got, ref, rel=1e-5):
    """Element by element within rel * max |ref| + 1e-6 (the kernels' exp,
    log and log1p against torch's CUDA ones: a few ulps)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    bar = rel * float(ref.float().abs().max()) + 1e-6
    assert float((got.float() - ref.float()).abs().max()) <= bar


@pytest.mark.parametrize("n", [131, 1000, 20011])
@pytest.mark.parametrize("c", [1, 19, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tdtype", [torch.int32, torch.int64])
def test_focal_loss_kernels_match_plain(dev, n, c, dtype, tdtype):
    x, t = _focal_operands(_gen(n + c), n, c, dtype, tdtype, dev)
    g = torch.randn(n, c, generator=_gen(n)).to(dev)
    before = (FL.sigmoid_focal_loss_fwd.launches,
              FL.sigmoid_focal_loss_bwd.launches)
    out = FL.sigmoid_focal_loss_fwd(x, t)
    dx = FL.sigmoid_focal_loss_bwd(x, t, g)
    torch.cuda.synchronize()
    assert (FL.sigmoid_focal_loss_fwd.launches,
            FL.sigmoid_focal_loss_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert out.dtype == torch.float32 and dx.dtype == dtype
    _focal_close(out, FL.sigmoid_focal_loss_multiclass_plain(x, t))
    # bf16 dx: both round a float32 value once, which may land one bf16
    # ulp apart
    _focal_close(dx, FL.sigmoid_focal_loss_multiclass_bwd_plain(x, t, g),
                 rel=1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.4)])
def test_focal_loss_stride0_dloss_through_autograd(dev, gamma, alpha):
    """``.sum()`` hands K13 an expanded scalar: the scalar-dloss mode gives
    the dense result, and the module's loss and gradient match the plain
    versions."""
    x, t = _focal_operands(_gen(5), 4099, 19, torch.float32, torch.int64,
                           dev)
    xk = x.clone().requires_grad_(True)
    (FL.sigmoid_focal_loss_multiclass(xk, t, gamma, alpha).sum()
     * 0.75).backward()
    ref = FL.sigmoid_focal_loss_multiclass_bwd_plain(
        x, t, torch.full_like(x, 0.75), gamma, alpha)
    _focal_close(xk.grad, ref)
    dense = FL.sigmoid_focal_loss_bwd(x, t, torch.full_like(x, 0.75), gamma,
                                      alpha)
    _focal_close(xk.grad, dense)
    xm = x.clone().requires_grad_(True)
    loss = FL.SigmoidFocalLossMulti(xm, t, gamma, alpha)
    loss.backward()
    pos = float((t > 0).sum())
    ref_loss = FL.sigmoid_focal_loss_multiclass_plain(x, t, gamma,
                                                      alpha).sum() / pos
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    _focal_close(xm.grad, FL.sigmoid_focal_loss_multiclass_bwd_plain(
        x, t, torch.full_like(x, 1.0 / pos), gamma, alpha))


def test_focal_loss_kernels_refuse_float64(dev):
    x, t = _focal_operands(_gen(1), 8, 3, torch.float64, torch.int64, dev)
    with pytest.raises(TypeError):
        FL.sigmoid_focal_loss_fwd(x, t)
    with pytest.raises(TypeError):
        FL.sigmoid_focal_loss_bwd(x, t, torch.ones_like(x))


FOCAL_EDGES = (87.3365, 87.3366, 88.7228, 88.7229, 0.0, 1e-30, 100.0)


def _focal_sweep(n, c, dtype, tdtype, dev, offset, seed):
    """(N, C) logits swept over [-100, 100] in a shuffled order, with the
    edges of the FLT_MIN clamp and of exp's overflow, 0 and +-1e-30 at
    the front, as a view ``offset`` elements into a contiguous buffer on
    the card; targets in [-1, C + 1] with every kind present."""
    g = _gen(seed)
    v = torch.linspace(-100.0, 100.0, n * c)[torch.randperm(n * c,
                                                            generator=g)]
    edges = torch.tensor(FOCAL_EDGES)
    v[:2 * len(edges)] = torch.cat([edges, -edges])
    buf = torch.zeros(n * c + offset, dtype=dtype, device=dev)
    buf[offset:] = v.to(dtype).to(dev)
    t = torch.randint(-1, c + 2, (n,), generator=g)
    t[:4] = torch.tensor([-1, 0, 1, c + 1])
    return buf[offset:].view(n, c), t.to(tdtype).to(dev)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 19, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tdtype", [torch.int32, torch.int64])
def test_focal_loss_kernels_sweep_offsets_and_classes(dev, offset, c, dtype,
                                                      tdtype):
    """The 16-byte body, the scalar head and tail and the class walk: C in
    {1, 2, 3, 5, 8, 19, 150} (a thread's 16 elements span up to 16 rows;
    below and at a 16-byte group's 4 or 8 elements the kernels walk
    element by element, from there on two targets a group), N*C
    not a multiple of 4 or 8, logits at 0-3 elements past a 16-byte
    boundary (``x[k:]`` of a contiguous buffer), swept over [-100, 100];
    forward, dense and stride-0 dloss against the plain versions."""
    n = 1007
    x, t = _focal_sweep(n, c, dtype, tdtype, dev, offset, seed=c + offset)
    assert (n * c) % 4 or c == 8
    dense = torch.randn(n, c, generator=_gen(c)).to(dev)
    scalar = torch.full((), 0.75, device=dev).expand(n, c)
    before = (FL.sigmoid_focal_loss_fwd.launches,
              FL.sigmoid_focal_loss_bwd.launches)
    out = FL.sigmoid_focal_loss_fwd(x, t)
    dx = FL.sigmoid_focal_loss_bwd(x, t, dense)
    dx0 = FL.sigmoid_focal_loss_bwd(x, t, scalar)
    torch.cuda.synchronize()
    assert (FL.sigmoid_focal_loss_fwd.launches,
            FL.sigmoid_focal_loss_bwd.launches) == (before[0] + 1,
                                                    before[1] + 2)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    _focal_close(out, FL.sigmoid_focal_loss_multiclass_plain(x, t))
    _focal_close(dx, FL.sigmoid_focal_loss_multiclass_bwd_plain(x, t, dense),
                 rel=rel)
    _focal_close(dx0, FL.sigmoid_focal_loss_multiclass_bwd_plain(
        x, t, torch.full_like(dense, 0.75)), rel=rel)
    assert bool(torch.isfinite(out).all()) and bool(
        torch.isfinite(dx.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_focal_loss_bwd_dense_dloss_out_of_phase(dev, dtype):
    """A dense dloss that is not 16-byte aligned where the logits are (a
    view one element into a buffer) sends K13 down the scalar route: the
    same gradient."""
    x, t = _focal_sweep(513, 19, dtype, torch.int64, dev, 0, seed=3)
    buf = torch.randn(513 * 19 + 1, generator=_gen(4)).to(dev)
    g = buf[1:].view(513, 19)
    _focal_close(FL.sigmoid_focal_loss_bwd(x, t, g),
                 FL.sigmoid_focal_loss_multiclass_bwd_plain(x, t, g),
                 rel=1e-5 if dtype == torch.float32 else 2 ** -7)


def test_focal_loss_kernels_many_trips_of_the_persistent_grid(dev):
    """5.7 M elements: every warp of the persistent grid takes several
    512-element chunks."""
    x, t = _focal_sweep(300_001, 19, torch.float32, torch.int32, dev, 0,
                        seed=5)
    _focal_close(FL.sigmoid_focal_loss_fwd(x, t),
                 FL.sigmoid_focal_loss_multiclass_plain(x, t))
    scalar = torch.full((), 0.5, device=dev).expand_as(x)
    _focal_close(FL.sigmoid_focal_loss_bwd(x, t, scalar),
                 FL.sigmoid_focal_loss_multiclass_bwd_plain(
                     x, t, torch.full_like(x, 0.5)))
