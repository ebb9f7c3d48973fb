"""Parallelism layer (port of ``cliffordtpu/parallel/``): a
``torch.distributed`` DeviceMesh with ("data", "model") axes, the batch
split over "data" (DDP, or FSDP2 with ``mode="fsdp"``), the transformer
projections split over "model" (tensor parallelism), and a train step
whose losses, gradient norm and update are those of the single-device
step on the global batch.

Where JAX's sharded step draws the latent of the global batch and lets
GSPMD partition the draw, a rank here holds only its rows of the batch
and draws exactly those rows of the global draw: every draw of the port
is counter-based, and ``rows=(row0, n_rows)`` gives each element the
counter it has in the global draw (``random.counters``; kernels F and E
take the row base, ``row0``).
"""

from cliffordtpu_torch.parallel.data import global_batch_rows, make_global_batch
from cliffordtpu_torch.parallel.mesh import (
    create_mesh,
    init_distributed,
    mesh_sizes,
    parse_mesh_spec,
)
from cliffordtpu_torch.parallel.sharding import (
    ShardedModel,
    fsdp_rule,
    infer_param_sharding,
    make_sharded_cnn_train_step,
    rule_for_name,
    shard_model,
    shard_state,
    unshard_state,
)

__all__ = [
    "create_mesh", "init_distributed", "mesh_sizes", "parse_mesh_spec",
    "global_batch_rows", "make_global_batch", "ShardedModel", "fsdp_rule",
    "infer_param_sharding", "make_sharded_cnn_train_step", "rule_for_name",
    "shard_model", "shard_state", "unshard_state",
]
