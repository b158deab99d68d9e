"""Spatial (row) sharding of graph programs across the device mesh.

Two strategies, per the scaling-book recipe (pick a mesh, annotate
shardings, let XLA insert collectives; then hand-optimize what profiling
flags):

  1. ``shard_program`` — GSPMD auto-partitioning: jit the *same* fused graph
     function with row-sharded in/out shardings.  XLA partitions every op
     and inserts halo exchanges (collective-permutes of boundary rows) for
     the shifted-slice convolutions automatically.  Zero extra code per
     kernel — but GSPMD cannot partition a custom call, so this path
     traces the plain jnp kernels, never the CUDA separable conv
     (``ops.plain_kernels``).

  2. ``shard_map`` + explicit ``jax.lax.ppermute`` halo exchange
     (halo.py) — the hand-scheduled analog of ring attention's neighbor
     passing, used by kernels whose halo metadata is known, when manual
     control beats the auto-partitioner.

Gather-based kernels (swirl, pixelate: ``halo is None``) read arbitrary
pixels; under GSPMD they induce all-gathers, which is exactly the right
semantics (and still beats host round-trips).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..graph.program import GraphProgram
from .mesh import Mesh, replicated, row_sharding


class ShardedProgram:
    """A GraphProgram jitted with row-sharded inputs/outputs over a mesh."""

    def __init__(self, program: GraphProgram, mesh: Mesh):
        self.program = program
        self.mesh = mesh
        rows = row_sharding(mesh)
        repl = replicated(mesh)

        def _forward_portable(x, t):
            from ..kernels import ops as _ops

            with _ops.plain_kernels():
                return program._forward(x, t)

        self._fused = jax.jit(
            _forward_portable,
            in_shardings=(rows, repl),
            out_shardings=rows,
        )

    def __call__(self, file_input: jnp.ndarray, t) -> jnp.ndarray:
        return self._fused(file_input, jnp.float32(t))

    def shard_input(self, file_input: jnp.ndarray) -> jnp.ndarray:
        return jax.device_put(file_input, row_sharding(self.mesh))


def shard_program(program: GraphProgram, mesh: Mesh) -> ShardedProgram:
    return ShardedProgram(program, mesh)
