"""Float ops and blocks, and the int8 serving kernels (``ops.kernels``)."""
