"""PyTorch port, the tools over the classic-stem int8-through graphs that
this slice serves, on the CPU (X39 and the bf16 decoder; the R18 int8
decoder's are in tests/test_torch_tools.py and tests/test_torch_export.py):

  ``tools/speed.py --int8-through`` on X39.speed, and with
      ``--bf16-decoder`` on X39.speed and R18.speed, prints JAX's line and
      tags (``[int8-through+dec]``, ``[int8-through(bf16-dec)]``);
  ``deploy/export.py --int8-through --bf16-decoder`` exports X39.speed for
      the CPU, equal to the live forward bit for bit (``--check``), its
      ``serve_mode`` JAX's ``int8-through``;
  the graph exported with the kernels as ``torchseg_cuda`` ops (their CPU
      implementations the plain versions) holds the Xception block's op
      (X39, int8 decoder) or K6's float32 route (R18, bf16 decoder), and
      runs as the live graph does;
  ``tools/roofline.py --int8-through`` on X39.speed counts the Xception
      blocks' int8 operations, K14's depthwise among them.

Torch runs on one intra-op thread here.
"""

import numpy as np
import pytest
import torch

from torchseg_tpu_torch.deploy import export as texport
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.tools import roofline, speed


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("experiment,flags,tag", [
    ("cityscapes.bisenet.X39.speed", [], " [int8-through+dec]"),
    ("cityscapes.bisenet.X39.speed", ["--bf16-decoder"],
     " [int8-through(bf16-dec)]"),
    ("cityscapes.bisenet.R18.speed", ["--bf16-decoder"],
     " [int8-through(bf16-dec)]")])
def test_speed_int8_through_x39_and_bf16_decoder(experiment, flags, tag,
                                                 capsys):
    info = {}
    res = speed.main(["-e", experiment, "--input-size", "1x32x64x3",
                      "--chain", "1", "--reps", "1", "--device", "cpu",
                      "--int8-through", *flags], info=info)
    assert res["ms_per_iter"] > 0 and info["forwards"] == 4
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        f"{experiment}{tag} @ 1x32x64x3: ")


def test_export_int8_through_x39_with_the_bf16_decoder(tmp_path):
    out = str(tmp_path / "art")
    texport.main(["-e", "cityscapes.bisenet.X39.speed", "-o", out,
                  "--platforms", "cpu", "--input-size", "1x32x64x3",
                  "--calib-size", "1x32x64x3", "--int8-through", "--check",
                  "--bf16-decoder"])
    infer, meta = texport.load_artifact(out, "cpu")
    assert meta["serve_mode"] == "int8-through" and meta["has_prepare"]
    img = np.random.default_rng(2).integers(0, 256, (1, 32, 64, 3)).astype(
        np.uint8)
    assert infer(torch.from_numpy(img)).shape == (1, 4, 8)


@pytest.mark.parametrize("experiment,decoder,ops", [
    ("cityscapes.bisenet.X39.speed", "int8", {"xblock_i8", "cbr_i8"}),
    ("cityscapes.bisenet.R18.speed", "bf16", {"res_block_i8", "cbr_i8"})])
def test_kernel_op_graph_runs_as_the_live_graph(experiment, decoder, ops):
    """The graph exported with the kernels as ``torchseg_cuda`` ops (their
    CPU implementations the plain versions) holds the X39 block's op, or
    K6's with its float32 route, and runs as the live graph does."""
    cfg = treg.get_experiment(experiment)
    model = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(0))
    infer, pkg, prepare = ti8.build_int8_serving_for_experiment(
        cfg, model, decoder=decoder, calib_shape=(1, 32, 64, 3))
    xs = prepare(np.zeros((1, 32, 64, 3), np.uint8))
    ep = texport.export_serving(texport.Int8ServingModule(infer, pkg), (xs,),
                                "cuda")
    seen = {str(n.target).split(".")[1] for n in ep.graph.nodes
            if str(n.target).startswith("torchseg_cuda.")}
    assert ops <= seen and "stem_pool_i8" in seen
    x = torch.randint(-128, 128, xs.shape, dtype=torch.int8,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(ep.module()(x), infer(pkg, x))
    float_res = [n for n in ep.graph.nodes
                 if str(n.target) == "torchseg_cuda.res_block_i8.default"
                 and n.meta["val"].dtype == torch.float32]
    assert len(float_res) == (decoder == "bf16" and "R18" in experiment)


def test_roofline_counts_the_xception_blocks():
    """X39.speed at 1x32x64x3: the int8 operations are the spatial path's,
    the sixteen Xception blocks' (each separable's 3x3 depthwise, K14, and
    its 1x1 pointwise at the block's output size) and the int8 decoder's
    convs; K1's stem is bf16."""
    res = roofline.main(["-e", "cityscapes.bisenet.X39.speed",
                         "--int8-through", "--input-size", "1x32x64x3",
                         "--device", "cpu"])
    cfg = treg.get_experiment("cityscapes.bisenet.X39.speed")
    model = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(0))
    _, pkg, _ = ti8.build_int8_serving_for_experiment(
        cfg, model, calib_shape=(1, 16, 32, 3))
    blocks = 0
    for li, hw in ((1, 4 * 8), (2, 2 * 4), (3, 1 * 2)):
        for bi in range(8 if li == 2 else 4):
            e = pkg[f"l{li}_{bi}"]
            for sep in (e[k] for k in ("sep1", "sep2", "sep3", "proj")
                        if k in e):
                cin, cout = sep["w"].shape[2:]
                blocks += 2 * hw * (9 * cin + cin * cout)
    assert res["flops_by_kind"]["int8"] > blocks > 0
    assert res["flops_by_kind"]["bf16"] == 2 * 16 * 32 * 80 * 4 * 4 * 12
