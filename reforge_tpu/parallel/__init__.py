"""Parallel execution: device meshes and spatial sharding.

The reference has no multi-device support (SURVEY.md §2); this package is
this program's scale-out: row-sharding over a device mesh with
XLA-inserted or explicit halo-exchange collectives, frame batches, and
layer pipelines.
"""

from .batch import BATCH_AXIS, BatchProgram, make_batch_mesh
from .halo import HaloShardedProgram, halo_pad
from .mesh import ROW_AXIS, make_row_mesh, replicated, row_sharding
from .spatial import ShardedProgram, shard_program

__all__ = [
    "BATCH_AXIS",
    "BatchProgram",
    "make_batch_mesh",
    "HaloShardedProgram",
    "halo_pad",
    "ROW_AXIS",
    "make_row_mesh",
    "replicated",
    "row_sharding",
    "ShardedProgram",
    "shard_program",
]

from .pipeline import PipelineStagedProgram, split_layers  # noqa: E402

__all__ += ["PipelineStagedProgram", "split_layers"]
