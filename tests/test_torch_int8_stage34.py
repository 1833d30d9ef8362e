"""PyTorch port, ResNet-18 stages 3 and 4 of the int8-through serving graph
against the JAX Pallas kernels they replace (CPU, Pallas in interpret mode,
under jit as the serving graph runs them), on identical inputs:

  K4 down_stage_i8  at stage 3's width (cin=128) vs
                    down_stage_i8_from_paired: bit-exact;
  K5 down_block_i8  at stage 4's width (cin=256 -> 512) vs
                    down_block_i8_from_paired: bit-exact;
  K6 res_block_i8   on K5's output (C=512) vs res_block_i8_std: bit-exact.

The port's side is each wrapper's plain version (apply_block, float64-exact
convs): the CUDA kernels are held to it on a card
(test_torch_cuda_kernels.py, chip_smoke.py).  Plus the wrappers' CPU path
and guards, and a spy showing which kernels ``int8_body`` runs for stages
2-4 (the CPU path counts no launches, so the counters cannot show it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.ops.pallas import int8_serve_kernels as P
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.entry import entry
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

from test_torch_int8_serve_kernels import _block, _codes, _t

RNG = np.random.default_rng


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _paired(x):
    """(1, h, w, c) -> the (h, w/2, 2c) paired width view the TPU kernels
    read (a free row-major regrouping)."""
    _, h, w, c = x.shape
    return x[0].reshape(h, w // 2, 2 * c)


def _alive(a):
    assert 0 < (np.asarray(a) > 0).mean() < 1  # neither dead nor saturated


@pytest.fixture(scope="module")
def stage4():
    """Stage 4 blocks (256 -> 512) and a (1, 8, 16, 256) input; the JAX
    kernels' outputs after each block."""
    rng = RNG(13)
    x = _codes(rng, (1, 8, 16, 256))
    j0, t0 = _block(rng, 256, 512, 2)
    j1, t1 = _block(rng, 512, 512, 1)
    wc1, wd, wc2, dmc = P.pack_down_block_weights(j0)
    rw, rmc, rrr = P.pack_res_block1_weights(j1)

    @jax.jit
    def run(x):
        y = P.down_block_i8_from_paired(_paired(x), wc1, wd, wc2, dmc, nr=4)
        return y, P.res_block_i8_std(y, rw, rmc, rrr, nr=4)

    with pltpu.force_tpu_interpret_mode():  # module scope: set it here
        y, z = jax.device_get(run(jnp.asarray(x)))
    return {"x": x, "t0": t0, "t1": t1, "y": np.asarray(y), "z": np.asarray(z)}


def test_down_block_plain_bit_exact_vs_pallas(stage4):
    got = K.down_block_i8_plain(_t(stage4["x"]), stage4["t0"])
    assert got.shape == (1, 4, 8, 512) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), stage4["y"])
    _alive(stage4["y"])


def test_res_block_plain_bit_exact_vs_pallas(stage4):
    got = K.res_block_i8_plain(_t(stage4["y"]), stage4["t1"])
    np.testing.assert_array_equal(got.numpy(), stage4["z"])
    _alive(stage4["z"])


def test_stage3_down_stage_plain_bit_exact_vs_pallas():
    rng = RNG(11)
    x = _codes(rng, (1, 8, 16, 128))
    j0, t0 = _block(rng, 128, 256, 2)
    j1, t1 = _block(rng, 256, 256, 1)
    packed = P.pack_down_stage_weights(j0, j1)
    assert P.down_stage_shapes_ok(8, 16, nr=4)
    ref = np.asarray(jax.jit(lambda x: P.down_stage_i8_from_paired(
        _paired(x), *packed, nr=4))(jnp.asarray(x)))
    got = K.down_stage_i8_plain(_t(x), t0, t1)
    assert got.shape == (1, 4, 8, 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    _alive(ref)


@pytest.mark.parametrize("kind,h,w", [("down", 9, 13), ("res", 5, 7)])
def test_stage4_blocks_plain_bit_exact_vs_xla_at_odd_sizes(kind, h, w):
    """Odd heights and widths, which the TPU kernels' shape gates refuse:
    against the XLA path (_apply_block) they stand in for."""
    rng = RNG(14)
    cin, stride = (256, 2) if kind == "down" else (512, 1)
    x = _codes(rng, (1, h, w, cin))
    j, t = _block(rng, cin, 512, stride)
    ref = np.asarray(jax.jit(lambda x: ji8._apply_block(x, j, stride))(x))
    plain = K.down_block_i8_plain if kind == "down" else K.res_block_i8_plain
    got = plain(_t(x), t)
    np.testing.assert_array_equal(got.numpy(), ref)
    _alive(ref)


def test_stage4_wrappers_on_cpu_run_the_plain_versions():
    rng = RNG(15)
    K.reset_launches()
    x = _t(_codes(rng, (1, 6, 10, 64)))
    _, d = _block(rng, 64, 128, 2)
    _, r = _block(rng, 128, 128, 1)
    y = K.down_block_i8(x, d)
    assert torch.equal(y, K.down_block_i8_plain(x, d))
    assert torch.equal(K.res_block_i8(y, r), K.res_block_i8_plain(y, r))
    assert K.down_block_i8.launches == K.res_block_i8.launches == 0


def _guard_cases():
    rng = RNG(16)
    x = _t(_codes(rng, (1, 8, 16, 256)))
    _, d = _block(rng, 256, 512, 2)
    _, r = _block(rng, 512, 512, 1)
    y = _t(_codes(rng, (1, 4, 8, 512)))
    bad_down = {**d, "down": {**d["down"], "w": d["down"]["w"][..., :256]
                              .contiguous()}}
    return {
        "down_block given an identity block": (
            ValueError, lambda: K.down_block_i8(y, r)),
        "down_block wrong cin": (
            ValueError, lambda: K.down_block_i8(x[..., :128].contiguous(), d)),
        "down_block float input": (
            TypeError, lambda: K.down_block_i8(x.float(), d)),
        "down_block projection width": (
            ValueError, lambda: K.down_block_i8(x, bad_down)),
        "res_block given a down block": (
            ValueError, lambda: K.res_block_i8(x, d)),
        "res_block wrong width": (
            ValueError, lambda: K.res_block_i8(y[..., :256].contiguous(), r)),
        "res_block batch 2": (
            ValueError, lambda: K.res_block_i8(
                y.expand(2, -1, -1, -1).contiguous(), r)),
        "res_block meta input": (
            ValueError, lambda: K.res_block_i8(y.to("meta"), r)),
    }


GUARDS = ["down_block given an identity block", "down_block wrong cin",
          "down_block float input", "down_block projection width",
          "res_block given a down block", "res_block wrong width",
          "res_block batch 2", "res_block meta input"]


@pytest.mark.parametrize("name", GUARDS)
def test_stage4_wrapper_guards_raise(name):
    cases = _guard_cases()
    assert sorted(cases) == sorted(GUARDS)
    exc, call = cases[name]
    with pytest.raises(exc):
        call()


def test_int8_body_runs_stages_2_to_4_on_k4_k5_k6(monkeypatch):
    """Stage 2 and stage 3 go through down_stage_i8, stage 4 through
    down_block_i8 then res_block_i8, each exactly once per forward, at the
    stages' channel counts."""
    infer, (pkg, xs) = entry(device="cpu", image_hw=(64, 128))
    calls = []

    def spy(name, fn):
        def wrapped(x, *blocks):
            calls.append((name, x.shape[3]))
            return fn(x, *blocks)
        monkeypatch.setattr(ti8, name, wrapped)

    for name in ("l1_stage_i8", "down_stage_i8", "down_block_i8",
                 "res_block_i8"):
        spy(name, getattr(K, name))
    _, feats = ti8.int8_body(pkg, xs)
    assert calls == [("l1_stage_i8", 64), ("down_stage_i8", 64),
                     ("down_stage_i8", 128), ("down_block_i8", 256),
                     ("res_block_i8", 512)]
    assert [f.shape[3] for f in feats] == [64, 128, 256, 512]
    assert [f.dtype for f in feats] == [torch.int8] * 4
    labels = infer(pkg, xs)
    assert tuple(labels.shape) == (1, 8, 16)
