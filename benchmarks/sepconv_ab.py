#!/usr/bin/env python
"""Plain XLA against the fused separable-conv CUDA kernel, end to end.

Times the 4K flagship graph in rgba32f and rgba16f, once traced with the
plain jnp convolutions (``ops.plain_kernels``) and once with the CUDA
kernel, both one dispatch per frame and through ``render_sequence``.
Sides alternate plain, kernel, kernel, plain in every round, all in one
process on one card.  Then one profiler trace of each side (rgba32f, per
dispatch) is reduced to device time per operation.

    python benchmarks/sepconv_ab.py [--rounds 5] [--out DIR]

Needs a GPU.  Writes ``ab.json`` and the traces under --out.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from reforge_tpu.benchmarks import (  # noqa: E402
    bench_program,
    bench_program_sequenced,
    build_flagship,
    device_report,
    make_test_image,
)
from reforge_tpu.kernels import ops  # noqa: E402

W, H = 3840, 2160


class Side:
    """One side of the comparison: a flagship program whose traces all
    happen with (kernel) or without (plain) the CUDA kernel."""

    def __init__(self, fmt: str, plain: bool):
        self.plain = plain
        with self._ctx():
            self.program = build_flagship(W, H, fmt)
            self.x = make_test_image(H, W).astype(self.program.storage_dtype)
            bench_program(self.program, self.x, frames=2, warmup=2)
            bench_program_sequenced(self.program, self.x, frames=24, chunk=24,
                                    warmup_chunks=1)

    def _ctx(self):
        return ops.plain_kernels() if self.plain else _Null()

    def run(self) -> dict:
        with self._ctx():
            per = bench_program(self.program, self.x, frames=60)
            seq = bench_program_sequenced(self.program, self.x, frames=120)
        return {"per_dispatch_ms": per["ms_per_frame"],
                "sequenced_ms": seq["ms_per_frame"]}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def trace_device_time(side: Side, out_dir: str, frames: int = 10) -> dict:
    """Device time per operation name over ``frames`` dispatches."""
    os.makedirs(out_dir, exist_ok=True)
    with side._ctx():
        jax.block_until_ready(side.program(side.x, 0.0))
        jax.profiler.start_trace(out_dir)
        for i in range(frames):
            out = side.program(side.x, 0.1 * i)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
    paths = []
    for root, _dirs, files in os.walk(out_dir):
        paths += [os.path.join(root, f) for f in files if f.endswith(".xplane.pb")]
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_op: dict = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "frames": frames,
        "device_busy_ms_per_frame": busy / frames / 1e6,
        "window_ms": window / 1e6,
        "idle_share_in_window": 1.0 - busy / window if window else None,
        "top_ops_ms_per_frame": [(n, t / frames / 1e6) for n, t in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/sepconv_ab")
    args = ap.parse_args()
    device = device_report()
    print(f"# device: {json.dumps(device)}", flush=True)
    result = {"device": device, "formats": {}}
    for fmt in ("rgba32f", "rgba16f"):
        sides = {"plain": Side(fmt, plain=True), "kernel": Side(fmt, plain=False)}
        runs = {"plain": [], "kernel": []}
        for _ in range(args.rounds):
            for name in ("plain", "kernel", "kernel", "plain"):
                runs[name].append(sides[name].run())
        summary = {}
        for name, rs in runs.items():
            for metric in ("per_dispatch_ms", "sequenced_ms"):
                vals = sorted(r[metric] for r in rs)
                q = statistics.quantiles(vals, n=4)
                summary[f"{name}_{metric}"] = {
                    "median": statistics.median(vals), "q1": q[0], "q3": q[2],
                    "min": vals[0], "max": vals[-1], "n": len(vals),
                }
        result["formats"][fmt] = {"runs": runs, "summary": summary}
        for metric in ("per_dispatch_ms", "sequenced_ms"):
            p = summary[f"plain_{metric}"]
            k = summary[f"kernel_{metric}"]
            print(f"{fmt} {metric}: plain median {p['median']:.4f} "
                  f"(IQR {p['q1']:.4f}-{p['q3']:.4f}), kernel median "
                  f"{k['median']:.4f} (IQR {k['q1']:.4f}-{k['q3']:.4f}) "
                  f"[{device['nvidia_smi'][0]}]", flush=True)
        if fmt == "rgba32f":
            for name, side in sides.items():
                tr = trace_device_time(side, os.path.join(args.out, f"trace_{name}"))
                result["formats"][fmt][f"trace_{name}"] = tr
                print(f"{fmt} trace {name}: device busy "
                      f"{tr['device_busy_ms_per_frame']:.4f} ms/frame, idle "
                      f"share {tr['idle_share_in_window']:.3f}", flush=True)
                for op, ms in tr["top_ops_ms_per_frame"]:
                    print(f"    {ms:8.4f} ms  {op[:90]}", flush=True)
        del sides
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
