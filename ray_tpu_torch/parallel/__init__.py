"""Parallelism layer of the port: meshes over `torch.distributed` ranks,
sharding rules, collectives, ring attention and the GPipe pipeline (the
counterpart of `ray_tpu.parallel`, one process per rank).
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    Mesh,
    MeshSpec,
    active_mesh,
    dp_mesh,
    single_device_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    gather_full,
    local_shard,
    logical_to_spec,
    shard_batch,
    tree_shardings,
)
from ray_tpu_torch.parallel.ring_attention import (reference_attention,
                                                   ring_attention)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

__all__ = [
    "AXIS_ORDER", "BATCH_AXES", "Mesh", "MeshSpec", "active_mesh",
    "dp_mesh", "single_device_mesh",
    "DEFAULT_RULES", "PartitionSpec", "gather_full", "local_shard",
    "logical_to_spec", "shard_batch", "tree_shardings",
    "reference_attention", "ring_attention",
    "pipeline_apply", "stack_stage_params",
]
