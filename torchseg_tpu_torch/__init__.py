"""PyTorch/CUDA port of torchseg_tpu for one NVIDIA H100.

The JAX package ``torchseg_tpu`` is the reference; this package mirrors its
module names and layout so every module has an obvious counterpart.  The
ported slices are the int8-through BiSeNet-R18 serving graph
(``deploy/int8_serve.py``) with six hand-written CUDA kernel entry points
(``ops/kernels/int8_serve_kernels.py``, ``csrc/int8_serve_kernels.cu``),
and the full-resolution R18 serving graphs (the bf16 fused-stem graph of
``deploy/fused_stem.py`` and the int8-through graph), which end in the
upsample-argmax kernel (``ops/kernels/upsample_argmax.py``,
``csrc/upsample_argmax.cu``).  The training step of BiSeNet-R18
(``entry.train_entry``; ``engine/``, ``ops/losses.py``) runs its SyncBN
(``ops/norm.py``) on the moment and affine kernels of
``ops/kernels/bn_kernels.py`` / ``csrc/bn_kernels.cu``.  PSPNet-R50
serves int8-through (``entry.serve_entry``) on the same conv kernel and an
int8 max pool.  BiSeNet-X39.speed serves in bf16 (``entry.deploy_entry``;
``models/xception.py``), the fused stem of both classic-stem BiSeNets on
``ops/kernels/stem_conv.py`` / ``csrc/stem_conv.cu``.  Training across
processes (``entry.dryrun_multichip``) adds the distributed layer
(``parallel/``), whole-image evaluation (``engine/evaluator.py``,
``ops/metrics.py``) and the synthetic dataset (``data/``); its dp x sp leg
shards the image height over ranks (``parallel/spatial.py``: the mesh,
the batch split, ``SpatialTrainer``; ``ops/spatial.py``: the halo
exchanges and the other sharded ops, with SyncBN over the 2-D group).
The training and evaluation command lines (``train.py``, ``eval.py``)
come with the deployment and measurement tools: reference ``.pth`` and
GluonCV ``.params`` checkpoints in (``utils/``), generic per-conv int8
(``deploy/quantize.py``, on the int8 tensor-core conv's float32 mode),
``torch.export`` artifacts with the kernels as ``torchseg_cuda`` ops
(``deploy/export.py``, ``ops/kernels/custom_ops.py``), DCP checkpoints
(``engine/checkpoint_orbax.py``) and ``tools/`` (speed, stats, profile,
roofline, train_speed).

Nothing here imports jax, flax or torchseg_tpu.
"""
