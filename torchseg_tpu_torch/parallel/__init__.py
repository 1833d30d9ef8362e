"""Distributed layer (counterpart of torchseg_tpu/parallel/).

Ported: the process-group and collective helpers of ``mesh.py`` and the
two-process leg (``_multihost_worker``).  The dp x sp spatial trainer
(``spatial.py``: ``SpatialTrainer``, ``make_dp_sp_mesh``) is not ported
yet (ROADMAP A2b).
"""

from .mesh import (
    all_reduce_tensor,
    gather_metrics,
    initialize_multihost,
    reduce_mean,
    shard_batch,
)
