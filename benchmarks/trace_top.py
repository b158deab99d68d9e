#!/usr/bin/env python
"""Summarize a jax.profiler trace directory: top device ops by total time.

jax.profiler.start_trace writes a TensorBoard-format trace; this reads
the newest ``*.trace.json.gz`` under the directory and aggregates
device-lane complete events by name — enough to attribute a frame's time
to XLA fusions and custom kernels without a TensorBoard instance.

Usage: python benchmarks/trace_top.py TRACE_DIR [--n 30]
       python benchmarks/trace_top.py TRACE_DIR --grep fusion
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def newest_trace(root: str) -> str:
    paths = glob.glob(
        os.path.join(root, "**", "*.trace.json.gz"), recursive=True
    )
    if not paths:
        raise SystemExit(f"no *.trace.json.gz under {root}")
    return max(paths, key=os.path.getmtime)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--grep", default=None)
    ap.add_argument("--pids", action="store_true",
                    help="list process/thread names instead of ops")
    args = ap.parse_args()

    path = newest_trace(args.root)
    print(f"# {path}", file=sys.stderr)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])

    pid_names = {}
    tid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e["tid"])] = e["args"].get("name", "")

    if args.pids:
        for k, v in sorted(pid_names.items()):
            print("pid", k, v)
        for k, v in sorted(tid_names.items()):
            print("tid", k, v)
        return 0

    # Keep device-side lanes (GPU streams, XLA ops), skip python/host.
    def is_device(e):
        pname = pid_names.get(e.get("pid"), "").lower()
        tname = tid_names.get((e.get("pid"), e.get("tid")), "").lower()
        return (
            "/device" in pname or "gpu" in pname or "xla" in tname
            or "stream" in tname or "steps" in tname or "ops" in tname
        )

    total = collections.Counter()
    count = collections.Counter()
    span = [None, None]
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if not is_device(e):
            continue
        name = e["name"]
        if args.grep and args.grep not in name:
            continue
        total[name] += e["dur"]
        count[name] += 1
        ts, te = e["ts"], e["ts"] + e["dur"]
        span[0] = ts if span[0] is None else min(span[0], ts)
        span[1] = te if span[1] is None else max(span[1], te)

    if span[0] is not None:
        print(f"# device span: {(span[1] - span[0]) / 1e3:.3f} ms")
    for name, us in total.most_common(args.n):
        print(f"{us / 1e3:10.3f} ms  x{count[name]:<6d} {name[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
