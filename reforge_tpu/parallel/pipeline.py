"""Pipeline parallelism: graph layers staged across devices.

The third parallelism axis (after spatial row-sharding and data-parallel
batching): topological layers are partitioned into S stages, one device
per stage, with activations moving stage-to-stage between devices
(``jax.device_put``).  Because JAX dispatch is asynchronous, a host loop
that keeps several frames in flight naturally fills the pipeline: device
s computes frame i while device s-1 computes frame i+1 — the multi-device
generalization of the reference's frames-in-flight (SURVEY.md §2,
pipeline-parallelism note).

Worth it for long chains of similarly-heavy nodes; for short graphs the
stage-boundary transfers dominate and single-device fusion wins.  The
engine does not default to it; it is a library strategy plus the CLI's
``--pipeline S`` for experimentation.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..graph.builder import PipelineNode
from ..graph.program import GraphProgram
from ..kernels.base import KernelContext


def _node_cost(node: PipelineNode) -> float:
    """Fallback per-node cost when no measured costs are given:
    pointwise 1, conv scales with taps."""
    halo = node.halo
    if halo is None:
        return 4.0  # gather-ish
    return 1.0 + 0.2 * halo


def measure_costs(
    program: GraphProgram,
    file_input: Optional[jnp.ndarray] = None,
    t: float = 0.0,
    reps: int = 3,
) -> dict[str, float]:
    """Measured per-node costs (ms) for stage balancing.

    Runs the program's per-node timed execution (the same machinery as
    ``--timing per-node``) ``reps`` times after a warmup and keeps the
    minimum per node — the steady-state dispatch cost, robust to one-off
    compile/caching noise."""
    if file_input is None:
        file_input = jnp.zeros((4, program.height, program.width), jnp.float32)
    program.run_per_node(file_input, t)  # warm every per-node jit
    best: dict[str, float] = {}
    for i in range(max(reps, 1)):
        _, times = program.run_per_node(file_input, t + 0.01 * i)
        for name, ms in times.items():
            if name not in best or ms < best[name]:
                best[name] = ms
    return best


def split_layers(
    layers: Sequence[Sequence[PipelineNode]],
    n_stages: int,
    node_costs: Optional[dict[str, float]] = None,
) -> list[list[list[PipelineNode]]]:
    """Partition consecutive layers into n_stages cost-balanced groups.

    ``node_costs`` maps node name -> measured ms (see measure_costs);
    nodes missing from it, or a None map, use the static heuristic."""

    def cost_of(n: PipelineNode) -> float:
        if node_costs is not None and n.name in node_costs:
            return node_costs[n.name]
        return _node_cost(n)

    costs = [sum(cost_of(n) for n in layer) for layer in layers]
    total = sum(costs) or 1.0
    target = total / n_stages
    stages: list[list] = []
    current: list = []
    acc = 0.0
    remaining_stages = n_stages
    for i, (layer, cost) in enumerate(zip(layers, costs)):
        layers_left = len(layers) - i
        if (
            current
            and acc + cost > target * 1.25
            and remaining_stages > 1
            and layers_left >= remaining_stages - 1
        ):
            stages.append(current)
            current = []
            acc = 0.0
            remaining_stages -= 1
        current.append(layer)
        acc += cost
    if current:
        stages.append(current)
    while len(stages) < n_stages and len(stages) > 0 and len(stages[-1]) > 1:
        # Split the last group if we came up short on stages.
        last = stages.pop()
        stages.append(last[:-1])
        stages.append(last[-1:])
    return stages


class PipelineStagedProgram:
    """Graph program executed as device-staged pipeline segments."""

    def __init__(self, program: GraphProgram, devices: Optional[list] = None,
                 n_stages: Optional[int] = None,
                 node_costs: Optional[dict[str, float]] = None,
                 measure: bool = False):
        """``node_costs``: measured per-node ms for stage balancing
        (see measure_costs); ``measure=True`` measures them here (runs
        the per-node programs once — a few dispatches of startup cost)."""
        self.program = program
        devs = devices if devices is not None else jax.devices()
        if measure and node_costs is None:
            node_costs = measure_costs(program)
        self.node_costs = node_costs
        n = n_stages or len(devs)
        n = max(1, min(n, len(devs), len(program.graph.layers)))
        self.stage_layers = split_layers(program.graph.layers, n, node_costs)
        # The splitter may produce fewer groups than requested (e.g. one
        # heavy trailing layer); follow the actual stage count.
        n = len(self.stage_layers)
        self.devices = devs[:n]

        # Cross-stage interface: which resources each stage consumes from
        # earlier stages and which it must export to later ones.
        produced_by_stage: list[set] = []
        self._stage_inputs: list[list[str]] = []
        self._stage_outputs: list[list[str]] = []
        for s, group in enumerate(self.stage_layers):
            nodes = [node for layer in group for node in layer]
            consumed = {res for node in nodes for res, _ in node.inputs}
            produced = {res for node in nodes for res, _ in node.outputs}
            self._stage_inputs.append(sorted(consumed - produced))
            produced_by_stage.append(produced)
        # A stage exports whatever it produces that later stages consume
        # (the host-side `live` dict carries FILE_INPUT itself), plus the
        # final output from whichever stage produces it.
        for s in range(n):
            later_needs = set()
            for s2 in range(s + 1, n):
                later_needs.update(self._stage_inputs[s2])
            exports = produced_by_stage[s] & later_needs
            if FINAL_OUTPUT in produced_by_stage[s]:
                exports.add(FINAL_OUTPUT)
            self._stage_outputs.append(sorted(exports))

        self._stage_fns = [
            jax.jit(self._make_stage_fn(s)) for s in range(n)
        ]

    def _make_stage_fn(self, s: int):
        prog = self.program
        group = self.stage_layers[s]
        out_names = list(self._stage_outputs[s])

        def stage(inputs: dict, t):
            ctx = KernelContext(
                width=prog.width, height=prog.height, time=t, fmt=prog.fmt
            )
            resources = dict(inputs)
            if FILE_INPUT in resources:
                # Storage-dtype cast parity with GraphProgram._forward.
                resources[FILE_INPUT] = resources[FILE_INPUT].astype(
                    prog.storage_dtype
                )
            for layer in group:
                for node in layer:
                    resources.update(prog._run_node(node, ctx, resources))
            return {name: resources[name] for name in out_names}

        return stage

    def shard_input(self, file_input: jnp.ndarray) -> jnp.ndarray:
        """Engine-interface parity with the sharded programs: stage input
        placement happens per stage in __call__."""
        return file_input

    def compile(self) -> None:
        """Warm every stage jit (usable from the async-reload thread)."""
        h, w = self.program.height, self.program.width
        zeros = jnp.zeros((4, h, w), jnp.float32)
        jax.block_until_ready(self(zeros, 0.0))

    def __call__(self, file_input: jnp.ndarray, t) -> jnp.ndarray:
        t = jnp.float32(t)
        live: dict[str, Any] = {FILE_INPUT: file_input}
        for s, fn in enumerate(self._stage_fns):
            dev = self.devices[s]
            inputs = {
                name: jax.device_put(live[name], dev)
                for name in self._stage_inputs[s]
            }
            if s == 0 and FILE_INPUT not in inputs:
                inputs[FILE_INPUT] = jax.device_put(file_input, dev)
            outputs = fn(inputs, jax.device_put(t, dev))
            live.update(outputs)
        return live[FINAL_OUTPUT]

    def render_stream(self, frames, times=None, depth: Optional[int] = None):
        """Multi-frame-in-flight pipelined rendering: yields outputs.

        ``frames`` is an iterable of (4, H, W) inputs; ``times`` an
        optional parallel iterable of per-frame times (defaults to the
        frame index / 60).  Every stage dispatch is asynchronous, so
        submitting frame i+1 before frame i completes keeps stage s busy
        on frame i while stage s-1 computes frame i+1 — the multi-device
        generalization of frames-in-flight (frame.rs:10-18).  At most
        ``depth`` frames (default: number of stages + 1) are in flight;
        the oldest is blocked on before the next is admitted, bounding
        device memory exactly like the engine's in-flight queue."""
        from collections import deque

        if depth is None:
            depth = len(self._stage_fns) + 1
        depth = max(depth, 1)
        pending: deque = deque()
        for i, frame in enumerate(frames):
            t = (i / 60.0) if times is None else times[i]
            if len(pending) >= depth:
                out = pending.popleft()
                jax.block_until_ready(out)
                yield out
            pending.append(self(frame, t))
        while pending:
            out = pending.popleft()
            jax.block_until_ready(out)
            yield out
