"""Hand-written CUDA kernels with their wrappers and plain PyTorch versions.

Nothing is compiled at import: ``_build.load()`` runs nvcc at the first
launch on a CUDA tensor.
"""
