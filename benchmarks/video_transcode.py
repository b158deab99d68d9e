#!/usr/bin/env python
"""End-to-end video transcode throughput: decode -> graph -> encode.

Answers the README's video-mode claim with a measured number: a 1080p
clip (>= 300 frames) transcoded through the flagship 5-node graph via
the real CLI (`python -m reforge_tpu -i clip.mp4 -o out.mp4 --config
flagship.rf --batch-frames K`), with `_rf_time` advancing per frame.
Also measures each pipeline stage alone so the bottleneck is NAMED, not
guessed:

  * decode-only: VideoFrames iteration rate (native libav -> RGBA8)
  * encode-only: VideoEncoder rate on a constant frame (host H.264)
  * compute-only: the flagship program's device fps (a quick sequenced
    run)

Usage: python benchmarks/video_transcode.py [frames [width height]]
"""

import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CLIP = "/tmp/rf_bench_clip_1080p.mp4"  # rebound per-run by main()
FLAGSHIP_RF = "/tmp/rf_bench_flagship.rf"


def make_clip(frames: int, width: int, height: int) -> None:
    from reforge_tpu.io.imagefile import VideoEncoder

    # The filename is keyed on the parameters (main() below), so an
    # existing file IS the requested clip.
    if os.path.exists(CLIP):
        return
    enc = VideoEncoder(CLIP, width, height, fps=30.0)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.zeros((height, width, 4), np.uint8)
    base[..., 3] = 255
    t0 = time.perf_counter()
    for i in range(frames):
        ph = i * 0.1
        base[..., 0] = (127 + 120 * np.sin(xs * 0.01 + ph)).astype(np.uint8)
        base[..., 1] = (127 + 120 * np.sin(ys * 0.013 - ph)).astype(np.uint8)
        base[..., 2] = (127 + 120 * np.sin((xs + ys) * 0.007 + ph)).astype(
            np.uint8
        )
        enc.write(base)
    enc.close()
    print(
        f"clip: {frames} frames {width}x{height} written in "
        f"{time.perf_counter() - t0:.1f}s"
    )


def stage_rates(frames: int, width: int, height: int) -> None:
    from reforge_tpu.io.imagefile import (
        ImageFileDecoder,
        VideoEncoder,
        VideoFrames,
    )

    dec = ImageFileDecoder(CLIP)
    t0 = time.perf_counter()
    n = 0
    for _ in VideoFrames(dec, width, height):
        n += 1
    dt = time.perf_counter() - t0
    print(f"decode-only : {n / dt:7.1f} fps ({n} frames, {dt:.1f}s)")

    frame = np.zeros((height, width, 4), np.uint8)
    frame[..., 3] = 255
    enc = VideoEncoder("/tmp/rf_bench_encode_only.mp4", width, height, 30.0)
    t0 = time.perf_counter()
    for _ in range(frames):
        enc.write(frame)
    enc.close()
    dt = time.perf_counter() - t0
    print(f"encode-only : {frames / dt:7.1f} fps ({dt:.1f}s)")


def compute_rate(width: int, height: int) -> None:
    from reforge_tpu.benchmarks import (
        bench_program_sequenced,
        build_flagship,
        enable_cache,
        make_test_image,
    )

    enable_cache()
    prog = build_flagship(width, height)
    img = make_test_image(height, width)
    r = bench_program_sequenced(prog, img, frames=96)
    print(f"compute-only: {r['fps']:7.1f} fps (device, sequenced)")


def cli_transcode(kbatch: int) -> None:
    cmd = [
        sys.executable, "-m", "reforge_tpu",
        "-i", CLIP, "-o", f"/tmp/rf_bench_out_k{kbatch}.mp4",
        "--config", FLAGSHIP_RF,
        "--batch-frames", str(kbatch),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    wall = time.perf_counter() - t0
    tail = (proc.stderr or "").strip().splitlines()
    m = None
    for line in reversed(tail):
        m = re.search(r"Processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\)", line)
        if m:
            break
    if m:
        print(
            f"transcode K={kbatch:2d}: {m.group(3):>7s} fps "
            f"({m.group(1)} frames, {m.group(2)}s loop, {wall:.1f}s wall)"
        )
    else:
        print(f"transcode K={kbatch}: FAILED rc={proc.returncode}")
        print((proc.stderr or "")[-2000:])


def main() -> int:
    from reforge_tpu.benchmarks import FLAGSHIP_CONFIG

    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    width = int(sys.argv[2]) if len(sys.argv) > 2 else 1920
    height = int(sys.argv[3]) if len(sys.argv) > 3 else 1080
    global CLIP
    CLIP = f"/tmp/rf_bench_clip_{frames}f_{width}x{height}.mp4"
    with open(FLAGSHIP_RF, "w") as f:
        f.write(FLAGSHIP_CONFIG)
    make_clip(frames, width, height)
    stage_rates(frames, width, height)
    compute_rate(width, height)
    for k in (1, 24):
        cli_transcode(k)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
