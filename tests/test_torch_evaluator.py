"""PyTorch port, the whole-image ``Evaluator`` (``engine/evaluator.py``) and
``ops.resize.resize_linear`` against the JAX package on the CPU.

The model is the multi-process leg's ``Tiny`` (ConvBnRelu(3 -> 8) and a 1x1
conv to 3 classes, log-softmax out) with the JAX module's variables (random
BN statistics) carried by ``utils.jax_params.from_jax_variables``.  Against
``torchseg_tpu.engine.evaluator.Evaluator``: ``whole_eval`` at 8x8, at a
padded size and with an ``output_size`` resize (up and down), with and
without flip — labels equal wherever JAX's top-two score margin exceeds
1e-4; ``run_dataset(mode="whole")`` over ``SyntheticDataset`` (all of it,
and one process's shard) — histograms equal when no pixel is that close;
the multi-device path over ``devices=["cpu", "cpu"]`` gives the
single-device histogram; a dead worker (multi-device) or a failing dataset
read (prefetch) raises; ``show_image="window"`` and ``spatial_shards``
without a process group raise ``ValueError``.  ``resize_linear`` equals ``jax.image.resize(...,
"linear")`` within 1e-6 of the largest magnitude, up and down (antialiased).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.data.base import SyntheticDataset as JSyntheticDataset
from torchseg_tpu.engine.evaluator import Evaluator as JEvaluator
from torchseg_tpu.ops.blocks import ConvBnRelu as JConvBnRelu
from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
from torchseg_tpu_torch.data.base import SyntheticDataset
from torchseg_tpu_torch.engine.evaluator import Evaluator
from torchseg_tpu_torch.ops.resize import resize_linear
from torchseg_tpu_torch.parallel._multihost_worker import Tiny
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
MARGIN = 1e-4


class JTiny(fnn.Module):
    """The JAX multi-host worker's ``Tiny`` (tests/_multihost_worker.py);
    ``axis_name`` syncs its BN over that mesh axis."""

    axis_name: str = None

    @fnn.compact
    def __call__(self, x, train: bool = False):
        norm = functools.partial(JBatchNorm, axis_name=self.axis_name)
        x = JConvBnRelu(8, 3, 1, 1, norm=norm, name="c1")(x, train)
        return {"main": fnn.Conv(3, (1, 1), name="out")(x)}


@pytest.fixture(scope="module")
def models():
    jm = JTiny()
    variables = init_flax(jm, (jnp.zeros((1, 8, 8, 3)),), seed=3)
    port = Tiny()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port.eval()


def _evaluators(models, flip, **kw):
    jm, variables, port = models
    japply = jax.jit(lambda v, x: jax.nn.log_softmax(
        jm.apply(v, x, train=False)["main"], axis=-1))
    jev = JEvaluator(japply, variables, 3, MEAN, STD, is_flip=flip)
    ev = Evaluator(lambda m, x: torch.log_softmax(m(x)["main"], dim=1),
                   port, 3, MEAN, STD, is_flip=flip, device="cpu", **kw)
    return jev, ev, japply


def _jax_scores(japply, variables, img, flip, input_size, output_size):
    """JAX ``_whole_fn``'s score map before its argmax, (H, W, C)."""
    from torchseg_tpu.data.transforms import pad_image_to_shape

    margin = None
    if input_size is not None:
        img, margin = pad_image_to_shape(img, input_size, 0)
    x = (jnp.asarray(img, jnp.float32) / 255.0 - MEAN) / STD
    if margin is not None:
        t, b, l, r = (int(m) for m in margin)
        h, w = x.shape[:2]
        rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
        inside = (rows >= t) & (rows < h - b) & (cols >= l) & (cols < w - r)
        x = jnp.where(inside[:, :, None], x, 0.0)
    x = x[None]
    if flip:
        s = japply(variables, jnp.concatenate([x, x[:, :, ::-1, :]]))
        score = s[0] + s[1][:, ::-1, :]
    else:
        score = japply(variables, x)[0]
    score = jnp.exp(score)
    if margin is not None:
        score = score[t:score.shape[0] - b, l:score.shape[1] - r]
    if output_size is not None and score.shape[:2] != tuple(output_size):
        score = jax.image.resize(score, (*output_size, score.shape[2]),
                                 method="linear")
    return np.asarray(score)


def _close_pixels(scores):
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= MARGIN


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw,input_size,output_size", [
    ((8, 8), None, None),
    ((7, 9), (12, 10), None),      # centre pad, margin masked and cut
    ((8, 8), None, (13, 11)),      # upscale
    ((12, 10), None, (5, 6)),      # downscale: antialiased triangle
    ((7, 9), (12, 10), (4, 17)),
])
def test_whole_eval_matches_jax(models, flip, hw, input_size, output_size):
    jev, ev, japply = _evaluators(models, flip)
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3)).astype(
        np.uint8)
    ref = np.asarray(jev.whole_eval(img, output_size=output_size,
                                    input_size=input_size))
    got = ev.whole_eval(img, output_size=output_size, input_size=input_size)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    scores = _jax_scores(japply, models[1], img, flip, input_size,
                         output_size)
    assert np.array_equal(scores.argmax(-1), ref)
    far = ~_close_pixels(scores)
    assert far.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[far], ref[far])


class _Broken:
    """A dataset whose item ``bad`` raises."""

    def __init__(self, ds, bad):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"unreadable item {i}")
        return self.ds[i]


def _close_in_dataset(models, ds, indices, flip):
    _, variables, _ = models
    _, _, japply = _evaluators(models, flip)
    return sum(int(_close_pixels(_jax_scores(
        japply, variables, ds[i]["image"], flip, None, None)).sum())
        for i in indices)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("pidx,pcnt", [(0, 1), (1, 2)])
def test_run_dataset_whole_matches_jax(models, flip, pidx, pcnt):
    jds = JSyntheticDataset(6, (8, 8), 3)
    ds = SyntheticDataset(6, (8, 8), 3)
    jev, ev, _ = _evaluators(models, flip)
    ref = jev.run_dataset(jds, mode="whole", process_index=pidx,
                          process_count=pcnt)
    acc = ev.run_dataset(ds, mode="whole", process_index=pidx,
                         process_count=pcnt)
    assert acc.hist.device.type == "cpu"
    assert int(acc.hist.sum()) == len(range(pidx, 6, pcnt)) * 64
    close = _close_in_dataset(models, jds, range(pidx, 6, pcnt), flip)
    diff = int(np.abs(acc.hist.numpy() - ref.hist).sum())
    if close == 0:
        assert diff == 0
        assert (int(acc.labeled), int(acc.correct)) == (ref.labeled,
                                                        ref.correct)
    else:
        assert diff <= 2 * close


@pytest.mark.parametrize("flip", [False, True])
def test_multidevice_path_gives_the_single_device_histogram(models, flip):
    ds = SyntheticDataset(5, (8, 8), 3, seed=2)
    _, single, _ = _evaluators(models, flip)
    _, multi, _ = _evaluators(models, flip, devices=["cpu", "cpu"])
    one = single.run_dataset(ds, mode="whole", process_index=0,
                             process_count=1)
    two = multi.run_dataset(ds, mode="whole", process_index=0,
                            process_count=1)
    assert torch.equal(one.hist, two.hist)
    assert (int(one.labeled), int(one.correct)) == (int(two.labeled),
                                                    int(two.correct))


def test_a_dead_worker_raises(models):
    ds = _Broken(SyntheticDataset(6, (8, 8), 3), bad=4)
    _, multi, _ = _evaluators(models, False, devices=["cpu", "cpu"])
    with pytest.raises(OSError, match="unreadable item 4"):
        multi.run_dataset(ds, mode="whole", process_index=0, process_count=1)
    _, single, _ = _evaluators(models, False)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        single.run_dataset(ds, mode="whole", process_index=0,
                           process_count=1)


def test_unported_protocols_raise(models):
    # the sliding protocol, the speed protocol, the dumps and shard_crops
    # are ported (tests/test_torch_sliding_eval.py); what stays refused:
    # the interactive window, and spatial_shards without a process group
    # of a multiple of its ranks (ported: tests/test_torch_spatial.py)
    _, ev, _ = _evaluators(models, False)
    ds = SyntheticDataset(2, (8, 8), 3)
    for mode in ("whole", "sliding"):
        with pytest.raises(ValueError, match="GUI"):
            ev.run_dataset(ds, mode=mode, show_image="window")
    with pytest.raises(ValueError, match="ranks"):
        _evaluators(models, False, spatial_shards=2)


@pytest.mark.parametrize("shape,out", [
    ((3, 8, 8), (13, 11)), ((3, 12, 10), (5, 6)), ((2, 7, 9), (7, 4)),
    ((19, 16, 32), (64, 128)), ((4, 33, 17), (8, 40)),
])
def test_resize_linear_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x.transpose(1, 2, 0)),
                                      (*out, shape[0]), method="linear"))
    got = resize_linear(torch.from_numpy(x), out).numpy().transpose(1, 2, 0)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
