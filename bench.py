#!/usr/bin/env python
"""Flagship throughput: 4K frames/sec through the 5-node flagship graph.

Runs only on a GPU (it exits non-zero elsewhere).  Prints the device
(JAX platform, device kind and count, and nvidia-smi's card name and power
limit) on stderr, then ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "fps", ...}
"""

import json
import sys
import time

from reforge_tpu.benchmarks import (
    bench_program,
    bench_program_sequenced,
    build_flagship,
    device_report,
    enable_cache,
    make_test_image,
)


def main() -> int:
    try:
        device = device_report()
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"# device: {json.dumps(device)}", file=sys.stderr)
    enable_cache()
    width, height = 3840, 2160
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 120

    program = build_flagship(width, height)
    img = make_test_image(height, width)

    t0 = time.perf_counter()
    # Device throughput via device-side frame sequencing (render_sequence),
    # best of three windows; one dispatch per frame is reported beside it.
    windows = [
        bench_program_sequenced(program, img, frames=frames)
        for _ in range(3)
    ]
    result = max(windows, key=lambda r: r["fps"])
    per_dispatch = bench_program(program, img, frames=min(frames, 60))
    elapsed = time.perf_counter() - t0

    print(
        f"# 4K 5-node graph rgba32f: {result['fps']:.2f} fps "
        f"({result['ms_per_frame']:.3f} ms/frame) sequenced "
        f"(windows: {', '.join(f'{w['fps']:.1f}' for w in windows)}); "
        f"{per_dispatch['fps']:.2f} fps per dispatch; "
        f"{elapsed:.1f}s incl. warmup/compile",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "4k_fps_5node_graph",
                "value": round(result["fps"], 2),
                "unit": "fps",
                "per_dispatch_fps": round(per_dispatch["fps"], 2),
                "device": {k: device[k] for k in ("platform", "kind", "count")},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
