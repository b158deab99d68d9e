#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, at 4K, in one process.

    python chip_smoke.py [--seed N] [--four-cards]

Phases (each raises on failure, so the script exits non-zero and prints no
result):
  1. device: JAX's devices must be GPUs; prints nvidia-smi's card name and
     power limit.
  2. headless still: the 4K flagship graph through ``cli.main`` in rgba32f,
     rgba16f and rgba8; the written PNG against the reference.
  3. live loop and reload: 60 frames, one ``render_sequence`` chunk, then a
     config edit that a later frame must show.
  4. GLSL graphs: three example graphs and the gaussian_h -> gaussian_v ->
     tonemap shader chain at 4K, against the reference.
  5. separable-conv CUDA kernel against the plain path at 3840x2160.
  6. memory: ``compiled.memory_analysis()`` of the 4K flagship step.
``--four-cards`` runs only the multi-device paths on four GPUs: halo
exchange at 7680x4320 (``--shard 4``), a batch of frames, GSPMD and
pipeline staging, each against the same work on one card.

The reference is per-node execution on the plain kernel path under
highest matmul precision with f32 compute; node outputs keep their storage
format's rounding (bf16 for rgba16f, the 8-bit grid for rgba8), which is
part of what each format means.  Limits, with reasons, sit beside each
check.  The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

UHD = (3840, 2160)
UHD8K = (7680, 4320)
FORMATS = ("rgba32f", "rgba16f", "rgba8")
F32_TOL = 1e-5  # [0, 1] data: only summation order may differ


def card() -> str:
    """nvidia-smi's name and power limit for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if len(set(out)) == 1 else "; ".join(out)


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(v, 2.0 ** -126))) - 7)


def test_image(seed: int, width: int, height: int) -> np.ndarray:
    """A (H, W, 4) uint8 RGBA photo stand-in: smooth color fields, edges
    and grain, so blurs, stencils and thresholds all have work to do."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    f = rng.uniform(2.0, 9.0, 6).astype(np.float32)
    rgb = np.stack([
        0.5 + 0.4 * np.sin(f[0] * x + f[1] * y),
        0.5 + 0.4 * np.cos(f[2] * x * y + f[3] * y),
        ((x * f[4] + y * f[5]) % 1.0 > 0.5) * 0.6 + 0.2,
    ], axis=-1)
    rgb = rgb + rng.normal(0.0, 0.04, rgb.shape).astype(np.float32)
    alpha = np.full((height, width, 1), 1.0, np.float32)
    img = np.concatenate([np.clip(rgb, 0.0, 1.0), alpha], axis=-1)
    return np.round(img * 255.0).astype(np.uint8)


def reference(graph, width, height, fmt, planar, t):
    """Per-node execution, plain kernels, highest precision."""
    from reforge_tpu.graph.program import GraphProgram
    from reforge_tpu.kernels import ops

    with ops.plain_kernels(), jax.default_matmul_precision("highest"):
        out, _ = GraphProgram(graph, width, height, fmt).run_per_node(planar, t)
    return out


def load_graph(src: str, shader_path: str = "shaders"):
    from reforge_tpu.config import parse_file
    from reforge_tpu.graph import build_graph

    graph = build_graph(parse_file(src, expects_input=True,
                                   shader_path=shader_path))
    if graph is None:
        raise RuntimeError(f"graph failed to build:\n{src}")
    return graph


def check_linear(name, got, want, fmt, n_nodes):
    got = np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} or non-finite values")
    d = float(np.abs(got - want).max())
    if fmt == "rgba32f":
        tol = F32_TOL
    elif fmt == "rgba16f":
        tol = n_nodes * bf16_ulp(float(np.abs(want).max()))  # 1 ulp per boundary
    else:
        tol = n_nodes / 255.0 + 1e-6  # 1 code per boundary
    log(f"  {name}: max |diff| {d:.3g} (limit {tol:.3g})")
    if d > tol:
        raise AssertionError(f"{name}: max |diff| {d} > {tol}")


def png_mismatch(got, ref, fmt, n_nodes):
    """Count 8-bit PNG values outside the limit, and the largest difference.

    The limit is one code value: a last-bit difference before the encode
    may round to the neighbouring code.  rgba16f and rgba8 also round every
    node's output to their storage grid (bf16, the linear 1/255 grid), and
    a boundary that rounds the other way moves the nodes after it by one
    step of that grid, so there the limit adds one grid step per node
    boundary before the (monotone) sRGB encode."""
    from reforge_tpu.io import encode_planar_to_image

    enc = jax.jit(encode_planar_to_image)
    ref = jnp.asarray(ref, jnp.float32)
    want = np.asarray(enc(ref)).astype(np.int32)
    if fmt == "rgba8":
        step = jnp.float32(n_nodes / 255.0)
    elif fmt == "rgba16f":
        mag = jnp.maximum(jnp.abs(ref), 2.0 ** -126)
        step = n_nodes * jnp.exp2(jnp.floor(jnp.log2(mag)) - 7)
    else:
        step = jnp.float32(0.0)
    lo = np.asarray(enc(jnp.clip(ref - step, 0.0, 1.0))).astype(np.int32)
    hi = np.asarray(enc(ref + step)).astype(np.int32)
    bad = (got < lo - 1) | (got > hi + 1)
    return int(bad.sum()), int(np.abs(got - want).max())


def phase_device() -> jax.Device:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
            "this check runs only on the card"
        )
    log(f"phase 1 device: {devices[0].platform} {devices[0].device_kind} "
        f"x{len(devices)}")
    log(f"card: {card()}")
    return devices[0]


def phase_headless(work, rgba, in_png) -> None:
    from reforge_tpu.benchmarks import FLAGSHIP_CONFIG
    from reforge_tpu.cli import main
    from reforge_tpu.io import decode_image_to_planar
    from reforge_tpu.io.imagefile import ImageFileDecoder

    cfg = os.path.join(work, "flagship.rf")
    with open(cfg, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    graph = load_graph(FLAGSHIP_CONFIG)
    planar = jax.jit(decode_image_to_planar)(jnp.asarray(rgba))
    w, h = UHD
    for fmt in FORMATS:
        out_png = os.path.join(work, f"flagship_{fmt}.png")
        t0 = time.perf_counter()
        rc = main(["--backend", "gpu", "-i", in_png, "-o", out_png,
                   "--config", cfg, "--shader-format", fmt])
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc} for {fmt}")
        secs = time.perf_counter() - t0
        got = ImageFileDecoder(out_png).decode(w, h).astype(np.int32)
        # The one-shot render runs at _rf_time = seconds since engine start;
        # the flagship does not read the time.
        ref = reference(graph, w, h, fmt, planar, jnp.float32(0.0))
        n_bad, d = png_mismatch(got, ref, fmt, 5)
        log(f"phase 2 headless {fmt}: {secs:.1f}s through cli.main, PNG "
            f"max |diff| {d} code values, {n_bad} of {got.size} outside "
            f"the limit")
        if n_bad:
            raise AssertionError(f"headless {fmt}: {n_bad} PNG values off")


def phase_live(work, rgba, name) -> None:
    from reforge_tpu.benchmarks import FLAGSHIP_CONFIG
    from reforge_tpu.engine import Engine, RenderInfo

    w, h = UHD
    cfg = os.path.join(work, "live.rf")
    with open(cfg, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    eng = Engine(RenderInfo(
        width=w, height=h, num_frames=2, config_path=cfg,
        shader_path="shaders", fmt="rgba32f", has_input_image=True,
        async_compile=True,
    ))
    try:
        eng.load_input(rgba)
        t0 = time.perf_counter()
        eng.render_frame_blocking(0.0)
        log(f"phase 3 live: first frame (compile) {time.perf_counter() - t0:.1f}s")
        times = []
        for i in range(60):
            eng.trigger_reloads()
            s = time.perf_counter()
            eng.render_frame_blocking(i / 60.0)
            times.append(time.perf_counter() - s)
        ms = np.array(times) * 1e3
        log(f"  60 frames per dispatch: {60 / sum(times):.1f} fps, frame time "
            f"p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} "
            f"ms (host clock, blocking each frame) on {name}")
        x = eng._file_input()
        seq = eng.program.render_sequence(x, 1.0, 1.0 / 60.0, 8)
        jax.block_until_ready(seq)
        s = time.perf_counter()
        jax.block_until_ready(eng.program.render_sequence(x, 2.0, 1.0 / 60.0, 8))
        secs = time.perf_counter() - s
        log(f"  render_sequence chunk of 8: {secs * 1e3:.3f} ms "
            f"({8 / secs:.1f} fps) on {name}")

        edited = FLAGSHIP_CONFIG.replace("sigma: 4.0", "sigma: 2.5")
        assert edited != FLAGSHIP_CONFIG
        old = eng.program
        mtime = os.stat(cfg).st_mtime_ns
        s = time.perf_counter()
        with open(cfg, "w") as f:
            f.write(edited)
        os.utime(cfg, ns=(mtime + 10**9, mtime + 10**9))
        eng.trigger_reloads()
        eng.wait_for_compiles()
        if eng.program is old:
            raise AssertionError("config edit was not picked up")
        got = eng.render_frame_blocking(0.5)
        log(f"  edit -> new frame: {time.perf_counter() - s:.2f}s "
            f"(includes the fused compile)")
        want = reference(load_graph(edited), w, h, "rgba32f", x,
                         jnp.float32(0.5))
        check_linear("edited flagship frame", got, want, "rgba32f", 5)
    finally:
        eng.close()


GLSL_CHAIN = (
    "input -> gh -> gv -> tm -> output\n"
    "gh: gaussian_h { sigma: 2.0 }\ngv: gaussian_v { sigma: 2.0 }\n"
    "tm: tonemap { exposure: 1.1 }"
)


def phase_glsl(planar) -> None:
    from reforge_tpu.graph import make_program

    w, h = UHD
    graphs = {}
    for ex in ("blur_sharpen_blend", "oil_paint", "raymarch"):
        with open(os.path.join("examples", f"{ex}.rf")) as f:
            graphs[ex] = f.read()
    graphs["gaussian_h->gaussian_v->tonemap"] = GLSL_CHAIN
    t = jnp.float32(0.5)
    for name, src in graphs.items():
        graph = load_graph(src)
        s = time.perf_counter()
        prog = make_program(graph, w, h, "rgba32f")
        got = jax.block_until_ready(prog(planar, t))
        secs = time.perf_counter() - s
        want = reference(graph, w, h, "rgba32f", planar, t)
        log(f"phase 4 {name}: first frame {secs:.1f}s")
        check_linear(name, got, want, "rgba32f",
                     sum(len(layer) for layer in graph.layers))


def phase_kernel() -> None:
    from reforge_tpu.kernels import cuda_sepconv, ops

    w, h = UHD
    x32 = jax.random.uniform(jax.random.PRNGKey(7), (4, h, w), jnp.float32)
    f32_max = max(r for r in range(1, 129) if cuda_sepconv.fits(r, r, 4))
    bf16_max = max(r for r in range(1, 129) if cuda_sepconv.fits(r, r, 2))
    for dtype, rmax in ((jnp.float32, f32_max), (jnp.bfloat16, bf16_max)):
        x = x32.astype(dtype)
        for r in (1, 4, 12, rmax):
            wts = ops.gaussian_weights(max(r / 3.0, 0.34), r)
            for mode in ("edge", "zero"):
                if not ops.use_sepconv_kernel(x, r, r):
                    raise AssertionError(f"kernel not chosen for r={r} {dtype}")
                got = jax.jit(lambda a: ops.sep_conv(a, wts, wts, mode))(x)
                with ops.plain_kernels():
                    want = jax.jit(
                        lambda a: ops.sep_conv(a, wts, wts, mode))(x)
                got = np.asarray(got.astype(jnp.float32))
                want = np.asarray(want.astype(jnp.float32))
                d = float(np.abs(got - want).max())
                # f32: summation order only; bf16: each side rounds its
                # f32 sum to bf16 once, so the two may sit one ulp apart.
                tol = (F32_TOL if dtype == jnp.float32
                       else bf16_ulp(float(np.abs(want).max())))
                log(f"phase 5 kernel {jnp.dtype(dtype).name} r={r} {mode}: "
                    f"max |diff| {d:.3g} (limit {tol:.3g})")
                if d > tol:
                    raise AssertionError(f"kernel r={r} {mode} {dtype}: {d}")


def phase_memory(dev) -> None:
    from reforge_tpu.benchmarks import build_flagship

    w, h = UHD
    prog = build_flagship(w, h)
    compiled = prog._fused.lower(
        jax.ShapeDtypeStruct((4, h, w), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.float32),
    ).compile()
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    log("phase 6 memory, 4K flagship step: " + ", ".join(
        f"{k} {getattr(m, k, 'n/a')}" for k in fields))
    stats = dev.memory_stats() or {}
    log(f"  peak_bytes_in_use so far {stats.get('peak_bytes_in_use', 'n/a')}")


def four_cards(seed: int) -> None:
    from reforge_tpu.benchmarks import FLAGSHIP_CONFIG, build_flagship
    from reforge_tpu.cli import main
    from reforge_tpu.graph import make_program
    from reforge_tpu.io import decode_image_to_planar, encode
    from reforge_tpu.io.imagefile import ImageFileDecoder
    from reforge_tpu.parallel import (
        BatchProgram, HaloShardedProgram, PipelineStagedProgram,
        make_batch_mesh, make_row_mesh, shard_program,
    )

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX has {len(jax.devices())}")
    w, h = UHD8K
    t = jnp.float32(0.25)
    mesh = make_row_mesh(4)
    x = jax.random.uniform(jax.random.PRNGKey(seed), (4, h, w), jnp.float32)

    # Halo exchange through the CLI, as a user runs it, against one card.
    with tempfile.TemporaryDirectory() as work:
        rgba = test_image(seed, w, h)
        in_png = os.path.join(work, "in8k.png")
        encode(in_png, rgba)
        cfg = os.path.join(work, "flagship.rf")
        with open(cfg, "w") as f:
            f.write(FLAGSHIP_CONFIG)
        out_png = os.path.join(work, "out8k.png")
        s = time.perf_counter()
        if main(["--backend", "gpu", "-i", in_png, "-o", out_png,
                 "--config", cfg, "--shard", "4"]) != 0:
            raise RuntimeError("cli.main --shard 4 failed")
        log(f"halo --shard 4 flagship 8K through cli.main: "
            f"{time.perf_counter() - s:.1f}s")
        got = ImageFileDecoder(out_png).decode(w, h).astype(np.int32)
        planar = jax.jit(decode_image_to_planar)(jnp.asarray(rgba))
        one = build_flagship(w, h)(planar, 0.0)
        n_bad, d = png_mismatch(got, one, "rgba32f", 5)
        log(f"  PNG vs one card: max |diff| {d} code values (limit 1)")
        if n_bad:
            raise AssertionError(f"--shard 4 PNG differs by {d} codes")

    wide_src = ("input -> gs -> tone -> output\n"
                "gs: gaussian { sigma: 8.0 }\ntone: tonemap {}")
    for name, src in (("flagship", FLAGSHIP_CONFIG), ("gaussian8-tonemap", wide_src)):
        prog = make_program(load_graph(src), w, h, "rgba32f")
        one = prog(x, t)
        halo = HaloShardedProgram(prog, mesh)
        check_linear(f"halo 4 cards {name} 8K", halo(halo.shard_input(x), t),
                     one, "rgba32f", 0)
        if name != "flagship":
            hlo = halo._fused.lower(
                jax.ShapeDtypeStruct(x.shape, x.dtype,
                                     sharding=halo.shard_input(x).sharding),
                jax.ShapeDtypeStruct((), jnp.float32),
            ).compile().as_text()
            if "all-gather" in hlo:
                raise AssertionError("wide-radius halo program all-gathers")
            log("  wide-radius halo HLO: no all-gather")
        gspmd = shard_program(prog, mesh)
        check_linear(f"gspmd 4 cards {name} 8K", gspmd(gspmd.shard_input(x), t),
                     one, "rgba32f", 0)
        staged = PipelineStagedProgram(prog, devices=jax.devices()[:4])
        check_linear(f"pipeline {len(staged.devices)} stages {name} 8K",
                     staged(x, t), one, "rgba32f", 0)

    bw, bh = UHD
    prog = build_flagship(bw, bh)
    frames = jax.random.uniform(jax.random.PRNGKey(seed + 1), (4, 4, bh, bw),
                                jnp.float32)
    times = jnp.arange(4, dtype=jnp.float32) / 30.0
    bp = BatchProgram(prog, make_batch_mesh(4))
    got = bp(bp.shard_input(frames), times)
    want = jnp.stack([prog(frames[i], times[i]) for i in range(4)])
    check_linear("batch of 4 4K frames over 4 cards", got, want, "rgba32f", 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args()
    dev = phase_device()
    name = card()
    if args.four_cards:
        four_cards(args.seed)
    else:
        from reforge_tpu.io import decode_image_to_planar, encode

        w, h = UHD
        rgba = test_image(args.seed, w, h)
        with tempfile.TemporaryDirectory() as work:
            in_png = os.path.join(work, "in.png")
            encode(in_png, rgba)
            phase_headless(work, rgba, in_png)
            phase_live(work, rgba, name)
        planar = jax.jit(decode_image_to_planar)(jnp.asarray(rgba))
        phase_glsl(planar)
        phase_kernel()
        phase_memory(dev)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
