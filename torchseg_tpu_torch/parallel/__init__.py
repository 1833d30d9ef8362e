"""Distributed layer (counterpart of torchseg_tpu/parallel/).

The process-group and collective helpers of ``mesh.py``, the dp x sp
spatial trainer of ``spatial.py`` (``make_dp_sp_mesh``, ``place_batch``,
``SpatialTrainer``; its sharded ops are ``ops/spatial.py``) and the
four-rank leg (``_multihost_worker``).
"""

from .mesh import (
    all_reduce_tensor,
    gather_metrics,
    initialize_multihost,
    reduce_mean,
    shard_batch,
)
from .spatial import DpSpMesh, SpatialTrainer, make_dp_sp_mesh, place_batch
