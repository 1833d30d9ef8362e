"""PyTorch/CUDA port of torchseg_tpu for one NVIDIA H100.

The JAX package ``torchseg_tpu`` is the reference; this package mirrors its
module names and layout so every module has an obvious counterpart.  The
ported slice is the int8-through BiSeNet-R18.speed serving graph
(``deploy/int8_serve.py``) with its four hand-written CUDA kernels
(``ops/kernels/int8_serve_kernels.py``, ``csrc/int8_serve_kernels.cu``).

Nothing here imports jax, flax or torchseg_tpu.
"""
