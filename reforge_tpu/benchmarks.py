"""Benchmark graph definitions and measurement helpers.

The flagship workload (BASELINE.md): 4K frames/sec through a 5-node
filter graph.  The flagship graph mirrors the BASELINE.json configs — a
real convolution (separable gaussian), an unsharp mask (second conv),
a fan-in blend, tonemapping and a vignette — shapes that exercise conv,
pointwise and gather-free spatial kernels in one fused program.
"""

from __future__ import annotations

import subprocess
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from .config import parse
from .graph import GraphProgram, build_graph, make_program


def enable_cache() -> None:
    """Benchmarks want the warm persistent jit cache too (Engine enables it
    for the live tool; standalone bench processes call this)."""
    from .engine import _enable_persistent_cache

    _enable_persistent_cache()


FLAGSHIP_CONFIG = """
// 5-node flagship: blur + unsharp fan-in, blended, tonemapped, vignetted.
input -> soften -> mixer -> tone -> vig -> output
input -> crisp -> mixer:input_image2

soften: gaussian { sigma: 4.0 }
crisp:  unsharp  { sigma: 2.0, amount: 0.8 }
mixer:  mix      { factor: 0.5 }
tone:   tonemap  { exposure: 1.1 }
vig:    vignette { strength: 0.4 }
"""


def build_flagship(width: int, height: int, fmt: str = "rgba32f") -> GraphProgram:
    cfg = parse(FLAGSHIP_CONFIG, expects_input=True)
    assert cfg is not None
    graph = build_graph(cfg)
    assert graph is not None
    program = make_program(graph, width, height, fmt)
    assert program is not None
    return program


def bench_program(
    program,
    file_input: jnp.ndarray,
    frames: int = 60,
    warmup: int = 5,
) -> dict:
    """Steady-state frames/sec, one dispatch per frame: per-frame time
    varies (traced), shapes fixed.  Same-device programs run in submission
    order, so waiting for the last frame waits for all of them."""
    out = None
    for i in range(warmup):
        out = program(file_input, float(i) * 0.01)
    jax.block_until_ready(out)
    start = _time.perf_counter()
    for i in range(frames):
        out = program(file_input, 1.0 + i * 0.016)
    jax.block_until_ready(out)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def bench_program_sequenced(
    program,
    file_input: jnp.ndarray,
    frames: int = 120,
    chunk: int = 24,
    warmup_chunks: int = 2,
) -> dict:
    """Steady-state frames/sec with device-side frame sequencing.

    Frames render in chunks of ``chunk`` per dispatch via
    ``GraphProgram.render_sequence`` (each chunk is one XLA program whose
    while-loop executes every frame).  This measures device throughput —
    what a multi-frame export achieves — where ``bench_program`` also pays
    one host dispatch per frame.  The per-chunk t0 scalars are uploaded
    before timing starts."""
    frames = max(frames // chunk, 1) * chunk
    dt = jnp.float32(0.016)
    t0s = [jnp.float32(1.0 + i * chunk * 0.016) for i in range(frames // chunk)]
    out = None
    for i in range(warmup_chunks):
        out = program.render_sequence(file_input, jnp.float32(float(i)), dt, chunk)
    jax.block_until_ready(out)
    start = _time.perf_counter()
    for t0 in t0s:
        out = program.render_sequence(file_input, t0, dt, chunk)
    jax.block_until_ready(out)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def make_test_image(height: int, width: int, seed: int = 0) -> jnp.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.random((4, height, width), dtype=np.float32)
    return jnp.asarray(img)


def device_report() -> dict:
    """What ran the numbers: JAX's device and, on a GPU, the card's name
    and power limit as nvidia-smi reports them.  Raises when JAX finds no
    GPU: a measurement never falls back to the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {devices[0].platform} "
            f"({devices[0].device_kind}); measurements need the card"
        )
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": proc.stdout.strip().splitlines(),
    }
