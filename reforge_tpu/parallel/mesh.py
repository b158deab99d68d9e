"""Device mesh helpers for spatial sharding.

The reference is strictly single-device (one vk::Queue on one physical
device — reference: src/vulkan/core.rs:110-123); its only concurrency is
frames-in-flight and per-pixel parallelism.  This program also scales the
spatial axis across devices: image rows are sharded over a 1-D mesh and
the neighbor collectives that convolution halos need are exchanged
between devices (the image-domain analog of ring-attention's neighbor KV
exchange).  Every GPU of a host reaches every other at the same rate, so
the mesh is the plain device list.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_row_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(devices[:n], axis_names=(ROW_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard (4, H, W) images by H across the mesh."""
    return NamedSharding(mesh, P(None, ROW_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
