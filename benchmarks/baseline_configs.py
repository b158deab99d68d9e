#!/usr/bin/env python
"""Benchmark the five BASELINE.json reference configs (BASELINE.md).

Prints one JSON line per config with steady-state fps
(``reforge_tpu.benchmarks.bench_program``).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from reforge_tpu.benchmarks import bench_program, make_test_image
from reforge_tpu.config import parse
from reforge_tpu.graph import build_graph, make_program

CONFIGS = {
    # 1. passthrough on 512x512 (identity, rgba32f)
    "passthrough_512": ("input -> passthrough -> output", 512, 512),
    # 2. single gaussian blur at 1080p
    "gaussian_1080p": (
        "input -> gs -> output\ngs: gaussian { sigma: 4.0 }",
        1920,
        1080,
    ),
    # 3. 3-node linear chain at 1080p (fusion path)
    "chain3_1080p": (
        "input -> gs -> sobel -> tonemap -> output\ngs: blur { sigma: 2.0 }",
        1920,
        1080,
    ),
    # 4. branching blur + sharpen blended
    "branch_blend_1080p": (
        "input -> gs -> blend -> output\n"
        "input -> sh -> blend:input_image2\n"
        "gs: gaussian { sigma: 4.0 }\nsh: sharpen { amount: 0.8 }\n"
        "blend: blend { factor: 0.5 }",
        1920,
        1080,
    ),
    # 5. 4K preview path (the flagship measured by bench.py covers the
    # 5-node 4K case; here: 4K chain with a mid-run rebuild to time the
    # jit-cache swap).
    "preview_4k": (
        "input -> gs -> tonemap -> vignette -> output\n"
        "gs: gaussian { sigma: 3.0 }",
        3840,
        2160,
    ),
}


def main() -> int:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    results = {}
    for name, (src, w, h) in CONFIGS.items():
        cfg = parse(src, expects_input=True)
        prog = make_program(build_graph(cfg), w, h)
        img = make_test_image(h, w, seed=1)
        r = bench_program(prog, img, frames=frames)
        results[name] = r
        print(
            json.dumps(
                {
                    "metric": name,
                    "value": round(r["fps"], 2),
                    "unit": "fps",
                    "ms_per_frame": round(r["ms_per_frame"], 3),
                    "size": f"{w}x{h}",
                }
            ),
            flush=True,
        )

    # Reload-swap timing on the 4K preview config: rebuild + recompile a
    # parameter-edited variant while measuring wall time (warm process).
    src, w, h = CONFIGS["preview_4k"]
    edited = src.replace("sigma: 3.0", "sigma: 3.5")
    t0 = time.perf_counter()
    prog2 = make_program(build_graph(parse(edited, True)), w, h)
    prog2.compile()
    rebuild_s = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "metric": "reload_rebuild_compile_4k",
                "value": round(rebuild_s * 1000, 1),
                "unit": "ms",
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
