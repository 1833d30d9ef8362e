"""Hand-written CUDA kernels with their wrappers and plain PyTorch versions.

Nothing is compiled at import: ``_build.load()`` runs nvcc at the first
launch on a CUDA tensor.  The multi-class sigmoid focal loss (K12/K13) is
exported here, as the JAX package exports it from ``ops/pallas``.
"""

from .focal_loss import SigmoidFocalLossMulti, sigmoid_focal_loss_multiclass

__all__ = ["SigmoidFocalLossMulti", "sigmoid_focal_loss_multiclass"]
