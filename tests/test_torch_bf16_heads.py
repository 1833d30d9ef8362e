"""PyTorch port, the bfloat16 compute dtype against the JAX package in bf16
(CPU) for the ResNet blocks (BasicBlock, Bottleneck) and the heads of
PSPNet (the PPM), PSANet (the PSA block) and DFN (RefineResidual into
ChannelAttention, the DFN head): the cases, the bars and the method are
tests/test_torch_bf16_blocks.py's."""

import pytest

from test_torch_bf16_blocks import (  # noqa: F401 (the fixture)
    HEADS,
    _one_thread,
    cases,
    check_module,
)


@pytest.mark.parametrize("name,train", cases(HEADS))
def test_bf16_head_matches_jax(name, train):
    check_module(name, train)
