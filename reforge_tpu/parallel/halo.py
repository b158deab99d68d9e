"""Explicit halo-exchange spatial sharding: shard_map + ppermute.

The hand-scheduled alternative to GSPMD auto-partitioning
(spatial.shard_program): the whole graph runs inside one ``shard_map``
over a 1-D row mesh, and each node's declared halo drives exactly the
communication it needs:

  * halo == 0    — pure local compute (pointwise/color nodes): zero
    communication, the common case.
  * halo == r    — exchange r boundary rows with each neighbor via
    ``jax.lax.ppermute`` (the image-domain analog of ring attention's
    neighbor KV passing), run the unmodified kernel on the padded slab,
    crop r rows: interior outputs only depend on genuine data, so any
    translation-invariant kernel with support <= r is exact.
  * halo is None — data-dependent access (warps, mosaics): all-gather the
    rows, run on the full image, keep the local slab.  Correct by
    construction; costs one collective.

Global edges replicate boundary rows (clamp-to-edge) or zero-fill,
matching the kernel's border convention; ppermute conveniently delivers
zeros to edge devices that have no neighbor.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..kernels.base import KernelContext
from ..graph.program import GraphProgram
from ..utils import warnln
from .mesh import Mesh, ROW_AXIS


def halo_pad(
    x: jnp.ndarray,
    r: int,
    n_devices: int,
    device_idx: Any,
    axis_name: str = ROW_AXIS,
    mode: str = "edge",
) -> jnp.ndarray:
    """Pad a local (C, h, W) slab with r rows from each neighbor.

    Devices at the global top/bottom get edge-replicated (or zero) rows
    instead — reproducing the single-device border convention exactly.

    When r exceeds the slab height, the halo is assembled by CHAINED
    neighbor ``ppermute`` hops (ceil(r/h) rounds): hop j forwards the
    block received in hop j-1, so after k hops each device holds its k
    nearest slabs on each side — never a full-image all-gather (a sigma-16
    blur on thin slabs stays on the neighbor-exchange path).
    """
    h = x.shape[1]
    if r <= h:
        bot_send = x[:, -r:, :]  # my bottom rows -> below device's top halo
        top_send = x[:, :r, :]  # my top rows -> above device's bottom halo
        from_above = jax.lax.ppermute(
            bot_send, axis_name, [(i, i + 1) for i in range(n_devices - 1)]
        )
        from_below = jax.lax.ppermute(
            top_send, axis_name, [(i, i - 1) for i in range(1, n_devices)]
        )
        if mode == "edge":
            top_edge = jnp.repeat(x[:, :1, :], r, axis=1)
            bot_edge = jnp.repeat(x[:, -1:, :], r, axis=1)
            from_above = jnp.where(device_idx == 0, top_edge, from_above)
            from_below = jnp.where(
                device_idx == n_devices - 1, bot_edge, from_below
            )
        return jnp.concatenate([from_above, x, from_below], axis=1)

    # ---- multi-hop: r > h ------------------------------------------------
    # Blocks beyond the physical mesh edge arrive as zeros (ppermute has
    # no link); edge mode then overwrites the out-of-image rows below.
    down = [(i, i + 1) for i in range(n_devices - 1)]
    up = [(i, i - 1) for i in range(1, n_devices)]
    k = min(-(-r // h), max(n_devices - 1, 1))
    above_blocks: list = []
    below_blocks: list = []
    cur_d = x
    cur_u = x
    for _ in range(k):
        cur_d = jax.lax.ppermute(cur_d, axis_name, down)
        cur_u = jax.lax.ppermute(cur_u, axis_name, up)
        above_blocks.insert(0, cur_d)
        below_blocks.append(cur_u)
    if k * h < r:  # radius reaches past the whole mesh: zero-extend
        zeros = jnp.zeros((x.shape[0], r - k * h, x.shape[2]), x.dtype)
        above_blocks.insert(0, zeros)
        below_blocks.append(zeros)
    above = jnp.concatenate(above_blocks, axis=1)[:, -r:, :]
    below = jnp.concatenate(below_blocks, axis=1)[:, :r, :]
    if mode == "edge":
        rows = jnp.arange(r, dtype=jnp.int32)[None, :, None]
        # ``above`` covers global rows [idx*h - r, idx*h): the first
        # max(0, r - idx*h) rows precede the image and must replicate
        # global row 0 — found at local index r - idx*h (device 0 has no
        # valid rows at all; its row 0 is its own first slab row).
        deficit_a = r - device_idx * h
        ref_a = jnp.where(
            device_idx == 0,
            x[:, 0:1, :],
            jax.lax.dynamic_slice_in_dim(
                above, jnp.clip(deficit_a, 0, r - 1), 1, axis=1
            ),
        )
        above = jnp.where(rows < deficit_a, ref_a, above)
        # Mirrored at the bottom: the last max(0, r - (n-1-idx)*h) rows of
        # ``below`` lie past the image and replicate the last image row.
        deficit_b = r - (n_devices - 1 - device_idx) * h
        ref_b = jnp.where(
            device_idx == n_devices - 1,
            x[:, -1:, :],
            jax.lax.dynamic_slice_in_dim(
                below, jnp.clip(r - 1 - deficit_b, 0, r - 1), 1, axis=1
            ),
        )
        below = jnp.where(rows >= r - deficit_b, ref_b, below)
    return jnp.concatenate([above, x, below], axis=1)


class HaloShardedProgram:
    """A graph program row-sharded with per-node explicit halo exchange."""

    def __init__(self, program: GraphProgram, mesh: Mesh):
        self.program = program
        self.mesh = mesh
        self.n = mesh.shape[ROW_AXIS]
        h = program.height
        if h % self.n != 0:
            raise ValueError(
                f"image height {h} is not divisible by the {self.n}-device mesh"
            )
        self.h_local = h // self.n

        self._compiled = None
        rows = P(None, ROW_AXIS, None)
        scalar = P()
        # check_vma=False: custom-call (FFI) results carry no varying-mesh-
        # axes annotation, so the vma checker would reject the (legal)
        # per-device CUDA kernel inside the shard_map body.
        self._fused = jax.jit(
            shard_map(
                self._local_forward,
                mesh=mesh,
                in_specs=(rows, scalar),
                out_specs=rows,
                check_vma=False,
            )
        )

    # Runs per device on the local slab.  shard_map bodies are per-device
    # programs, so the single-device CUDA kernel applies as it is.
    def _local_forward(self, file_input_local: jnp.ndarray, t: jnp.ndarray):
        prog = self.program
        n, h_local = self.n, self.h_local
        idx = jax.lax.axis_index(ROW_AXIS)
        # Same storage-dtype cast GraphProgram._forward applies, so the
        # sharded and fused paths are numerically identical under rgba16f.
        resources: dict[str, Any] = {
            FILE_INPUT: file_input_local.astype(prog.storage_dtype)
        }

        def ctx_for(local_height: int, row0) -> KernelContext:
            return KernelContext(
                width=prog.width,
                height=prog.height,
                time=t,
                fmt=prog.fmt,
                row_offset=row0,
                local_height=local_height,
            )

        for layer in prog.graph.layers:
            for node in layer:
                spec = node.spec
                ins_local = {
                    desc: prog.compute_input(resources[res])
                    for res, desc in node.inputs
                }
                r = node.halo
                if r is not None and r >= prog.height:
                    # A radius spanning the whole image: every output row
                    # depends on every input row; gather and be done.
                    warnln(
                        f"node '{node.name}': halo {r} spans the whole "
                        f"{prog.height}-row image; falling back to "
                        f"all-gather (full-image collective per frame)"
                    )
                    r = None
                if spec.ssbos_in or spec.ssbos_out:
                    # Buffer-touching nodes (histograms, LUTs) compute on the
                    # full image so the buffer is identical (replicated) on
                    # every device; image outputs keep the local slab.
                    r = None

                def is_buffer(desc):
                    return desc in spec.ssbos_in or desc in spec.ssbos_out

                if r is None:
                    full = {
                        d: (
                            v
                            if is_buffer(d)
                            else jax.lax.all_gather(v, ROW_AXIS, axis=1, tiled=True)
                        )
                        for d, v in ins_local.items()
                    }
                    outs = spec(ctx_for(prog.height, 0), full, node.params)
                    crop = lambda v: jax.lax.dynamic_slice_in_dim(
                        v, idx * h_local, h_local, axis=1
                    )
                elif r == 0:
                    outs = spec(
                        ctx_for(h_local, idx * h_local), ins_local, node.params
                    )
                    crop = lambda v: v
                else:
                    border = spec.border_for(node.params)
                    padded = {
                        d: v if is_buffer(d) else halo_pad(v, r, n, idx, mode=border)
                        for d, v in ins_local.items()
                    }
                    outs = spec(
                        ctx_for(h_local + 2 * r, idx * h_local - r),
                        padded,
                        node.params,
                    )
                    crop = lambda v, _r=r: v[:, _r:-_r, :]
                for res, desc in node.outputs:
                    if is_buffer(desc):
                        resources[res] = outs[desc].astype(jnp.float32)
                        continue
                    resources[res] = prog.store_output(crop(outs[desc]))
        return resources[FINAL_OUTPUT]

    def __call__(self, file_input: jnp.ndarray, t) -> jnp.ndarray:
        if self._compiled is not None:
            return self._compiled(file_input, jnp.float32(t))
        return self._fused(file_input, jnp.float32(t))

    def compile(self) -> None:
        """Eagerly AOT-compile (usable from a background thread, like
        GraphProgram.compile)."""
        prog = self.program
        shape = jax.ShapeDtypeStruct(
            (4, prog.height, prog.width),
            jnp.float32,
            sharding=NamedSharding(self.mesh, P(None, ROW_AXIS, None)),
        )
        t = jax.ShapeDtypeStruct((), jnp.float32)
        self._compiled = self._fused.lower(shape, t).compile()

    def shard_input(self, file_input: jnp.ndarray) -> jnp.ndarray:
        return jax.device_put(
            file_input, NamedSharding(self.mesh, P(None, ROW_AXIS, None))
        )
