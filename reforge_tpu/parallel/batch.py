"""Data-parallel batch execution: many frames across the device mesh.

Frames are independent, so data parallelism is the trivially-scaling axis
(SURVEY.md §2): shard the batch dimension across the mesh and run the
single-frame program per local frame — zero communication, linear
scaling.  Used by the CLI's batch mode (glob inputs) and available as a
library API for offline pipelines.

``shard_map`` gives every device its local frames, and a ``lax.map`` over
them runs the ordinary single-frame forward, the same per-device program
the halo executor runs (halo.py).  The frames of a local shard execute in
sequence on their device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.program import GraphProgram

BATCH_AXIS = "batch"


def make_batch_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(devices[:n], axis_names=(BATCH_AXIS,))


class BatchProgram:
    """Batch-sharded graph program: (B, 4, H, W) -> (B, 4, H, W).

    ``t`` may be a scalar (broadcast to every frame) or a (B,) vector of
    per-frame times (video batches want monotone timestamps).
    """

    def __init__(self, program: GraphProgram, mesh: Optional[Mesh] = None):
        self.program = program
        self.mesh = mesh

        def _local(batch, times):
            # One device's local frames, in sequence.
            return jax.lax.map(
                lambda bt: program._forward(bt[0], bt[1]), (batch, times)
            )

        if mesh is not None:
            from jax import shard_map

            # check_vma=False: custom-call (FFI) results carry no varying-
            # mesh-axes annotation (same as parallel/halo.py).
            fwd = shard_map(
                _local,
                mesh=mesh,
                in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                out_specs=P(BATCH_AXIS),
                check_vma=False,
            )
            batched = NamedSharding(mesh, P(BATCH_AXIS, None, None, None))
            tsharded = NamedSharding(mesh, P(BATCH_AXIS))
            self._fn = jax.jit(
                fwd, in_shardings=(batched, tsharded), out_shardings=batched
            )
        else:
            self._fn = jax.jit(_local)

    def __call__(self, batch: jnp.ndarray, t) -> jnp.ndarray:
        times = jnp.asarray(t, jnp.float32)
        if times.ndim == 0:
            times = jnp.broadcast_to(times, (batch.shape[0],))
        elif times.shape != (batch.shape[0],):
            raise ValueError(
                f"times shape {times.shape} != batch ({batch.shape[0]},)"
            )
        if self.mesh is not None:
            times = jax.device_put(
                times, NamedSharding(self.mesh, P(BATCH_AXIS))
            )
        return self._fn(batch, times)

    def shard_input(self, batch: jnp.ndarray) -> jnp.ndarray:
        if self.mesh is None:
            return batch
        return jax.device_put(
            batch, NamedSharding(self.mesh, P(BATCH_AXIS, None, None, None))
        )

    def pad_batch(self, batch: jnp.ndarray) -> tuple[jnp.ndarray, int]:
        """Pad the batch to a multiple of the mesh size; returns (padded, n)."""
        n = batch.shape[0]
        if self.mesh is None:
            return batch, n
        devs = self.mesh.shape[BATCH_AXIS]
        rem = (-n) % devs
        if rem:
            batch = jnp.concatenate([batch, batch[:1].repeat(rem, axis=0)], axis=0)
        return batch, n
