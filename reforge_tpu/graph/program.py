"""GraphProgram: compile a built graph into executable XLA programs.

The analog of the reference's ``PipelineGraph`` + ``execute_pipeline_graph``
hot loop (src/vulkan/pipeline_graph.rs:499-592, src/vulkan/command.rs:166-242)
— but where the reference records one dispatch per node with barriers
between layers, we trace every node into ONE fused ``jax.jit`` program: XLA
fuses pointwise chains, eliminates dead nodes, and reuses buffers (the
hand-rolled aliasing pass at pipeline_graph.rs:358-427 falls out of XLA
buffer assignment for free).

Two execution modes:
  * ``__call__``        — the fused program (production path).
  * ``run_per_node``    — one jitted program per node, executed layer by
    layer with blocking timestamps: the analog of the reference's per-node
    GPU timestamp queries (command.rs:188-216) which cannot exist inside a
    fused program.  Per-node programs are also what runs while a fused
    recompile is still in flight after a live edit.
"""

from __future__ import annotations

import time as _time
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..kernels import ops
from ..kernels.base import KernelContext, quantize_rgba8
from ..utils import warnln
from .builder import BuiltGraph, PipelineNode


class GraphTraceError(Exception):
    pass


# ---- global per-node jit cache -------------------------------------------
#
# Per-node programs are cached ACROSS GraphPrograms, keyed by everything
# that shapes the traced computation: the kernel spec's identity, the
# resolved (static) params, the node's wiring and the program extent/format.
# Combined with the kernel loader's source cache (same spec object while a
# source file is unchanged), a live edit of one node rebuilds exactly one
# per-node program — every other node's executable is reused, which is what
# makes the interim unfused program (run_unfused) swap in at sub-frame
# latency while the fused XLA recompile proceeds off-thread.  The analog of
# the reference rebuilding only the edited pipeline
# (pipeline_graph.rs:329-343).
_NODE_FN_CACHE: dict[tuple, tuple[Any, Any]] = {}
_NODE_FN_CACHE_MAX = 512


def _as_f32_scalar(v):
    """Host scalar -> device f32, without a new transfer when the caller
    already holds a device f32 scalar."""
    if isinstance(v, jax.Array) and v.dtype == jnp.float32 and v.ndim == 0:
        return v
    return jnp.float32(v)


def _node_fn_key(node: PipelineNode, width: int, height: int, fmt: str):
    return (
        id(node.spec),
        tuple(sorted(node.params.items())),
        tuple(node.inputs),
        tuple(node.outputs),
        width,
        height,
        fmt,
        # Which kernels a trace picks (ops.plain_kernels): a plain
        # reference program must not be served to the production path.
        ops.custom_kernels_ok(),
    )


# Fused AOT executables cached across GraphPrograms by the full graph
# signature: revisiting a previously compiled graph (toggling an edit back,
# A->B->A) swaps the fused program with zero XLA compile.
_FUSED_CACHE: dict[tuple, tuple[Any, Any]] = {}
_FUSED_CACHE_MAX = 64


class GraphProgram:
    # Inter-node storage dtype per format: rgba8 keeps f32 but quantizes to
    # the UNORM grid (Vulkan storage-image parity); rgba16f stores bfloat16,
    # halving inter-node bandwidth like a GPU half-float render target.
    STORAGE_DTYPES = {
        "rgba32f": jnp.float32,
        "rgba8": jnp.float32,
        "rgba16f": jnp.bfloat16,
    }

    def __init__(
        self,
        graph: BuiltGraph,
        width: int,
        height: int,
        fmt: str = "rgba32f",
    ):
        self.graph = graph
        self.width = width
        self.height = height
        self.fmt = fmt
        self.storage_dtype = self.STORAGE_DTYPES.get(fmt, jnp.float32)
        self._fused = jax.jit(self._forward)
        self._node_fns: dict[str, Any] = {}
        self._seq_fns: dict[tuple, Any] = {}  # render_sequence jits
        self._compiled = None  # AOT executable from compile()
        # Interim mode after a live edit: render via cached per-node
        # programs while the fused XLA compile proceeds off-thread; flips
        # off automatically when compile() lands (engine.py:_finish_build).
        self._use_unfused = False

    # ---- tracing --------------------------------------------------------

    def _ctx(self, t) -> KernelContext:
        return KernelContext(width=self.width, height=self.height, time=t, fmt=self.fmt)

    def compute_input(self, value):
        """Storage -> compute dtype for a kernel input.

        GPU semantics: shaders compute in fp32 regardless of the
        storage-image format; rgba16f means bfloat16 STORAGE between
        nodes (the halo-sharded executor shares this policy)."""
        if value.dtype == jnp.bfloat16:
            return value.astype(jnp.float32)
        return value

    def store_output(self, value):
        """Compute -> storage dtype for a node's image output (including
        the rgba8 UNORM-grid quantization)."""
        if self.fmt == "rgba8":
            value = quantize_rgba8(value)
        return value.astype(self.storage_dtype)

    def _run_node(
        self, node: PipelineNode, ctx: KernelContext, resources: dict[str, Any]
    ) -> dict[str, Any]:
        images = {}
        for res, desc in node.inputs:
            value = resources.get(res)
            if value is None:
                raise GraphTraceError(
                    f"node '{node.name}' reads resource '{res}' before it is written"
                )
            images[desc] = self.compute_input(value)
        outs = node.spec(ctx, images, node.params)
        written = {}
        for res, desc in node.outputs:
            if desc not in outs:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' did not produce declared output "
                    f"'{desc}' (produced: {', '.join(outs)})"
                )
            value = outs[desc]
            if desc in node.spec.ssbos_out:
                expected_len = self.graph.buffer_sizes.get(res, value.shape[-1])
                if tuple(value.shape) != (expected_len,):
                    raise GraphTraceError(
                        f"kernel '{node.spec.name}' buffer output '{desc}' has "
                        f"shape {tuple(value.shape)}, expected ({expected_len},)"
                    )
                written[res] = value.astype(jnp.float32)
                continue
            expected = (4, self.height, self.width)
            if tuple(value.shape) != expected:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' output '{desc}' has shape "
                    f"{tuple(value.shape)}, expected {expected}"
                )
            written[res] = self.store_output(value)
        return written

    def _forward(self, file_input: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
        ctx = self._ctx(t)
        resources: dict[str, Any] = {
            FILE_INPUT: file_input.astype(self.storage_dtype)
        }
        for layer in self.graph.layers:
            for node in layer:
                resources.update(self._run_node(node, ctx, resources))
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out

    # ---- execution ------------------------------------------------------

    def __call__(self, file_input: jnp.ndarray, t: float | jnp.ndarray) -> jnp.ndarray:
        if self._compiled is not None:
            return self._compiled(file_input, jnp.float32(t))
        if self._use_unfused:
            return self.run_unfused(file_input, t)
        return self._fused(file_input, jnp.float32(t))

    def render_sequence(
        self,
        file_input: jnp.ndarray,
        t0: float | jnp.ndarray,
        dt: float,
        n: int,
        stack: bool = False,
    ) -> jnp.ndarray:
        """Render ``n`` frames with device-side time stepping in ONE
        dispatch: frame i sees ``_rf_time = t0 + i * dt``.

        Where the reference pipelines N command buffers against the GPU
        (frame.rs:10-18, render.rs:494), here a ``lax.scan`` sequences N
        whole-graph executions inside one XLA program, so per-frame host
        submission cost is paid once per chunk instead of once per frame.
        Used by headless multi-frame export and the throughput benchmark;
        the live preview loop still dispatches per frame (it needs every
        frame on the host).

        ``stack=False`` returns only the LAST frame (throughput mode —
        every frame still fully renders: the scan carries each frame, and
        XLA executes every iteration of the lowered while-loop);
        ``stack=True`` returns all frames as (n, 4, H, W) at the cost of
        one extra HBM copy per frame (the scan's output stacking)."""
        if n < 1:
            raise ValueError("render_sequence needs n >= 1")
        key = (int(n), bool(stack))
        fn = self._seq_fns.get(key)
        if fn is None:

            def seq(x, t_start, dt_v):
                out0 = self._forward(x, t_start)
                if n == 1:
                    return out0[None] if stack else out0

                def step(carry, i):
                    out = self._forward(x, t_start + i * dt_v)
                    return out, (out if stack else None)

                last, ys = jax.lax.scan(
                    step, out0, jnp.arange(1, n, dtype=jnp.float32)
                )
                if stack:
                    return jnp.concatenate([out0[None], ys], axis=0)
                return last

            fn = jax.jit(seq)
            self._seq_fns[key] = fn
        return fn(file_input, _as_f32_scalar(t0), _as_f32_scalar(dt))

    def run_unfused(self, file_input: jnp.ndarray, t: float | jnp.ndarray) -> jnp.ndarray:
        """Execute node-by-node through the cached per-node programs
        (non-blocking dispatch, same numerics as the fused path).

        This is the interim program after a live edit: unchanged nodes hit
        the global per-node jit cache, so only the edited node compiles —
        new output is visible at per-node-compile latency instead of
        whole-program XLA-compile latency (the reference's per-pipeline
        rebuild, render.rs:497-519)."""
        t = jnp.float32(t)
        resources: dict[str, Any] = {
            FILE_INPUT: file_input.astype(self.storage_dtype)
        }
        for layer in self.graph.layers:
            for node in layer:
                fn = self._node_fn(node)
                needed = {res: resources[res] for res, _ in node.inputs}
                resources.update(fn(needed, t))
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out

    def warm_unfused_parallel(self) -> None:
        """Compile ALL per-node programs concurrently.

        The sequential first-call compiles of ``run_unfused`` would pay the
        sum of the node compiles; dispatching every node's program from its
        own thread (with zero inputs of the right shapes) overlaps them.
        Node programs already cached are a no-op."""
        import concurrent.futures as cf

        t = jnp.float32(0.0)

        def zeros_of(res):
            size = self.graph.buffer_sizes.get(res)
            if size is not None:
                return jnp.zeros((size,), jnp.float32)
            return jnp.zeros(
                (4, self.height, self.width), self.storage_dtype
            )

        jobs = []
        for layer in self.graph.layers:
            for node in layer:
                fn = self._node_fn(node)
                needed = {res: zeros_of(res) for res, _ in node.inputs}
                jobs.append((fn, needed))
        if not jobs:
            return
        with cf.ThreadPoolExecutor(max_workers=min(8, len(jobs))) as ex:
            futures = [ex.submit(fn, needed, t) for fn, needed in jobs]
            for fu in futures:
                jax.block_until_ready(fu.result())

    def compile(self) -> None:
        """Eagerly AOT-compile the fused program for this graph's extent.

        Safe to run on a background thread: the engine's async reload path
        compiles the new program here while the previous one keeps
        rendering (the fused-program analog of the reference rebuilding a
        pipeline while the old one stays bound, pipeline_graph.rs:329-343).
        """
        key = self._fused_key()
        hit = _FUSED_CACHE.get(key)
        if hit is not None:
            self._compiled = hit[1]
            return
        shape = jax.ShapeDtypeStruct((4, self.height, self.width), jnp.float32)
        t = jax.ShapeDtypeStruct((), jnp.float32)
        compiled = self._fused.lower(shape, t).compile()
        if len(_FUSED_CACHE) >= _FUSED_CACHE_MAX:
            for k in list(_FUSED_CACHE)[: _FUSED_CACHE_MAX // 2]:
                del _FUSED_CACHE[k]
        # Pin the specs so the id()-based node keys stay unambiguous.
        specs = tuple(
            n.spec for layer in self.graph.layers for n in layer
        )
        _FUSED_CACHE[key] = (specs, compiled)
        self._compiled = compiled

    def compile_cached(self) -> bool:
        """Adopt a previously compiled fused executable for this exact
        graph signature, if one exists.  A hit also implies the graph was
        already validated, so callers can skip abstract-eval."""
        hit = _FUSED_CACHE.get(self._fused_key())
        if hit is None:
            return False
        self._compiled = hit[1]
        return True

    def _fused_key(self) -> tuple:
        return (
            tuple(
                _node_fn_key(n, self.width, self.height, self.fmt)
                for layer in self.graph.layers
                for n in layer
            ),
            tuple(sorted(self.graph.buffer_sizes.items())),
        )

    def _node_fn(self, node: PipelineNode):
        fn = self._node_fns.get(node.name)
        if fn is not None:
            return fn
        key = _node_fn_key(node, self.width, self.height, self.fmt)
        hit = _NODE_FN_CACHE.get(key)
        if hit is not None:
            fn = hit[1]
        else:
            width, height, fmt = self.width, self.height, self.fmt
            storage_dtype = self.storage_dtype

            def run(images, t, _node=node):
                ctx = KernelContext(width=width, height=height, time=t, fmt=fmt)
                # Per-node execution reuses the same dtype policy as the
                # fused trace (compute_input/store_output) with inputs
                # provided directly.
                ins = {
                    desc: (
                        images[res].astype(jnp.float32)
                        if images[res].dtype == jnp.bfloat16
                        else images[res]
                    )
                    for res, desc in _node.inputs
                }
                outs = _node.spec(ctx, ins, _node.params)
                written = {}
                for res, desc in _node.outputs:
                    value = outs[desc]
                    if desc in _node.spec.ssbos_out:
                        # Buffers stay f32 regardless of image format.
                        written[res] = value.astype(jnp.float32)
                        continue
                    if fmt == "rgba8":
                        value = quantize_rgba8(value)
                    written[res] = value.astype(storage_dtype)
                return written

            fn = jax.jit(run)
            if len(_NODE_FN_CACHE) >= _NODE_FN_CACHE_MAX:
                # Drop the oldest half; plain dicts preserve insertion order.
                for k in list(_NODE_FN_CACHE)[: _NODE_FN_CACHE_MAX // 2]:
                    del _NODE_FN_CACHE[k]
            # The value pins the spec object so id() keys cannot be reused.
            _NODE_FN_CACHE[key] = (node.spec, fn)
        self._node_fns[node.name] = fn
        return fn

    def run_per_node(
        self, file_input: jnp.ndarray, t: float | jnp.ndarray
    ) -> tuple[jnp.ndarray, dict[str, float]]:
        """Execute node-by-node, timing each dispatch (blocking).

        Returns (final_output, {node_name: milliseconds}).  Mirrors the
        per-pipeline GPU timestamp readout the reference prints each frame
        (vkutils.rs:104-134).
        """
        t = jnp.float32(t)
        # Same storage-dtype cast as _forward, for cross-mode parity.
        resources: dict[str, Any] = {
            FILE_INPUT: file_input.astype(self.storage_dtype)
        }
        times: dict[str, float] = {}
        for layer in self.graph.layers:
            for node in layer:
                fn = self._node_fn(node)
                needed = {res: resources[res] for res, _ in node.inputs}
                start = _time.perf_counter()
                written = fn(needed, t)
                jax.block_until_ready(written)
                times[node.name] = (_time.perf_counter() - start) * 1000.0
                resources.update(written)
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out, times


def make_program(
    graph: BuiltGraph, width: int, height: int, fmt: str = "rgba32f",
) -> Optional[GraphProgram]:
    """Build a GraphProgram and validate it by abstract evaluation.

    Tracing with ShapeDtypeStructs catches wiring and shape errors at build
    time (the analog of Vulkan pipeline-creation failure) without running
    any compute, so a bad live edit is rejected while the previous program
    keeps rendering.
    """
    program = GraphProgram(graph, width, height, fmt)
    if program.compile_cached():
        # This exact graph signature compiled (hence validated) before —
        # a live re-edit back to a known-good state swaps with zero
        # tracing or compilation.
        return program
    try:
        shape = jax.ShapeDtypeStruct((4, height, width), jnp.float32)
        t = jax.ShapeDtypeStruct((), jnp.float32)
        jax.eval_shape(program._forward, shape, t)
    except GraphTraceError as e:
        warnln(f"Graph build failed: {e}")
        return None
    except Exception as e:
        warnln(f"Graph build failed while tracing kernels: {e}")
        return None
    return program
