"""Serving graphs: ``int8_serve`` (int8-through), ``fused_stem`` (the bf16
fused-stem graphs), ``quantize`` (generic post-training int8) and
``export`` (``torch.export`` artifacts)."""
