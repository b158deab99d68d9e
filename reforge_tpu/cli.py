"""CLI and frame driver.

Flag-compatible with the reference binary (reference: src/main.rs:43-71):
positional single-shader path, -i/--input-file, -o/--output-file,
--width/--height, --shader-format {rgba8,rgba32f}, --config, --shader-path,
--num-frames — plus extensions (--frames benchmark cap, --timing,
--preview backend, --shard for spatial sharding, --backend).

Headless mode (an --output-file given) runs one frame and encodes it
(main.rs:220-224); otherwise the live loop previews frames, polling config
and kernel files for live reload each frame and printing the
``Frame: Xms, Frame-Avg: Yms, GPU: {...}`` status line (main.rs:152-157).
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time
from typing import Optional

import numpy as np

from . import utils
from .engine import Engine, RenderInfo
from .io import ImageFileDecoder, ImageFileError, encode
from .utils import TERM_CLEAR, warnln


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="reforge-tpu",
        description="Image-processing graph engine (JAX; runs on GPUs)",
    )
    p.add_argument(
        "positionals",
        nargs="*",
        default=[],
        metavar="<shader|input-file> [output-file]",
        help="Reference-style positionals (main.rs:45-48): an input image "
        "and optional output image; a kernel file (.comp/.frag/.glsl/.py) "
        "anywhere in the list runs single-shader mode instead of a config",
    )
    p.add_argument("-i", "--input-file", help="File to read from")
    p.add_argument("-o", "--output-file", help="Image file to write to (png/jpg)")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument(
        "--shader-format",
        choices=["rgba8", "rgba16f", "rgba32f"],
        default="rgba32f",
        help="Intermediate format: rgba8 quantizes between nodes, rgba16f stores bfloat16",
    )
    p.add_argument("--config", help="Path to the pipeline configuration file")
    p.add_argument(
        "--shader-path",
        default="shaders",
        help="Path to the kernel directory (.comp / .py files)",
    )
    p.add_argument(
        "--start",
        type=float,
        default=0.0,
        metavar="SEC",
        help="Video mode: seek to this timestamp before processing",
    )
    p.add_argument(
        "--duration",
        type=float,
        default=None,
        metavar="SEC",
        help="Video mode: stop after this many seconds of input",
    )
    p.add_argument(
        "--fps",
        type=float,
        default=None,
        metavar="FPS",
        help="Animated export (image/generator -> video): output frame "
        "rate (default 30); frame i renders with _rf_time = --start + "
        "i / fps",
    )
    p.add_argument(
        "--batch-frames",
        type=int,
        default=1,
        metavar="K",
        help="Video mode: run K frames per device dispatch (one vmapped "
        "program with per-frame times) — higher offline-transcode "
        "throughput at K frames of latency",
    )
    p.add_argument(
        "--num-frames",
        type=int,
        default=2,
        help="Frames in flight for the live loop",
    )
    p.add_argument(
        "--frames",
        type=int,
        default=0,
        help="Stop after N frames (0 = run until quit); useful for benchmarks",
    )
    p.add_argument(
        "--timing",
        choices=["fused", "per-node"],
        default="fused",
        help="per-node disables fusion to time each kernel like the reference's GPU timestamps",
    )
    p.add_argument(
        "--preview",
        choices=["auto", "window", "kitty", "none"],
        default="auto",
    )
    p.add_argument(
        "--shard",
        type=int,
        default=0,
        help="Row-shard the graph across N devices (0 = single device)",
    )
    p.add_argument(
        "--pipeline",
        type=int,
        default=0,
        metavar="S",
        help="Stage graph layers across S devices (pipeline parallelism; "
        "experimental)",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "gpu", "cpu"],
        default="auto",
        help="JAX platform: auto = JAX's default device; gpu fails when "
        "no GPU is found (never falls back to the CPU); cpu forces the CPU",
    )
    p.add_argument(
        "--debug-nans",
        action="store_true",
        help="Abort with a traceback when any kernel produces NaN "
        "(the validation-layer analog; SURVEY.md §5)",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="Write a jax.profiler trace of the run to DIR "
        "(view with TensorBoard / Perfetto)",
    )
    return p


_KERNEL_EXTS = (".comp", ".frag", ".glsl", ".py")


def _assign_positionals(args) -> Optional[str]:
    """Reference-style positionals: ``reforge <input-file> [output-file]``
    (main.rs:45-48), extended so a kernel file anywhere in the list selects
    single-shader mode.  Returns an error message or None."""
    args.shader = None
    rest = []
    for a in args.positionals:
        if a.lower().endswith(_KERNEL_EXTS):
            if args.shader is not None:
                return f"Multiple kernel files given: {args.shader!r} and {a!r}"
            args.shader = a
        else:
            rest.append(a)
    if len(rest) > 2:
        return f"Too many positional arguments: {rest!r}"
    if rest:
        if args.input_file:
            return "Input file given both positionally and with -i"
        args.input_file = rest[0]
    if len(rest) == 2:
        if args.output_file:
            return "Output file given both positionally and with -o"
        args.output_file = rest[1]
    return None


def main(argv: Optional[list[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    err = _assign_positionals(args)
    if err is not None:
        warnln(err)
        return 1

    if args.backend != "auto":
        err = _select_backend(args.backend)
        if err is not None:
            print(f"Error: {err}", file=sys.stderr)
            return 2
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)

    if args.config and args.shader:
        warnln("Cannot specify both a config and shader file")
        return 1

    headless = args.output_file is not None
    num_frames = 1 if headless else args.num_frames
    from .io import is_video_path

    # Single-image headless render: one frame through one combined
    # decode -> graph -> encode program, then exit (the reference renders
    # its headless frame right after its shader compiles,
    # src/main.rs:220-224).  Sharded/pipelined renders keep the ordinary
    # frame path: their executors (HaloShardedProgram/PipelineStagedProgram)
    # ARE the program, and render_one_shot would bypass them.
    one_shot = (
        headless
        and not is_video_path(args.output_file)
        and not args.shard
        and not args.pipeline
    )

    # Batch mode: a glob or directory input processes every matched image
    # through one data-parallel vmapped program (docs/sharding.md).
    if args.input_file:
        inputs = _expand_inputs(args.input_file)
        if len(inputs) > 1:
            if not args.output_file:
                warnln("Batch input requires -o (an output directory or a "
                       "pattern containing {})")
                return 1
            return _run_batch(args, inputs)
        if len(inputs) == 1 and inputs[0] != args.input_file:
            # A glob/directory matching exactly one image: run it as the
            # single input rather than opening the pattern string.
            args.input_file = inputs[0]

    decoder = None
    if args.input_file:
        try:
            decoder = ImageFileDecoder(args.input_file)
        except ImageFileError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if decoder is not None:
        width, height = utils.get_dim(
            decoder.width, decoder.height, args.width, args.height
        )
    else:
        width, height = utils.get_dim(800, 600, args.width, args.height)

    info = RenderInfo(
        width=width,
        height=height,
        num_frames=num_frames,
        config_path=args.config,
        shader_path=args.shader_path,
        fmt=args.shader_format,
        has_input_image=args.input_file is not None,
        shader_file_path=args.shader,
        timing=args.timing,
        shard=args.shard,
        pipeline_stages=args.pipeline,
        # Live loop: compile reloads on a background thread so the old
        # program keeps producing frames; headless runs compile inline.
        async_compile=not headless,
        one_shot=one_shot,
    )

    try:
        # One-shot engine construction pre-compiles the per-node programs
        # (possibly slow on a cold cache): keep the user informed.
        engine = (
            _with_compile_status(lambda: Engine(info))
            if one_shot
            else Engine(info)
        )
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    video_out = headless and is_video_path(args.output_file)
    # Animated export: a video OUTPUT from a still image (or a
    # generator-only graph) renders the time-varying graph over
    # --duration seconds instead of transcoding input frames.
    animate = video_out and (
        decoder is None or not is_video_path(args.input_file)
    )
    rgba = None
    if decoder is not None and (not video_out or animate):
        # Video transcode mode must not pre-consume the first frame.
        t0 = _time.perf_counter()
        rgba = decoder.decode(width, height)
        if not one_shot:
            # One-shot renders decode on device INSIDE the combined
            # program (render_one_shot): uploading here would compile a
            # separate decode executable for nothing.
            engine.load_input(rgba)
        print(f"File Decode and resize: {utils.get_elapsed_ms(t0):.2f}ms")

    profiling = False
    if args.profile:
        import jax

        try:
            jax.profiler.start_trace(args.profile)
            profiling = True
        except Exception as e:
            warnln(f"Cannot start profiler trace at {args.profile}: {e}")

    try:
        if headless:
            if animate:
                return _run_animate(engine, args, width, height)
            if video_out:
                return _run_video(engine, decoder, args, width, height)
            if one_shot:
                out_u8 = _with_compile_status(
                    lambda: engine.render_one_shot(rgba)
                )
            else:
                # Sharded/pipelined single-frame render: the ordinary
                # frame path dispatches through the parallel executor.
                out = _with_compile_status(engine.render_frame_blocking)
                out_u8 = engine.read_output(out)
            encode(args.output_file, out_u8)
            return 0
        return _run_live_loop(engine, args)
    finally:
        engine.close()
        if profiling:
            import jax

            try:
                jax.profiler.stop_trace()
                print(f"Profiler trace written to {args.profile}", file=sys.stderr)
            except Exception as e:  # trace export failure must not eat the run
                warnln(f"Profiler trace export failed: {e}")


def _select_backend(backend: str) -> Optional[str]:
    """Apply ``--backend``; returns an error message or None."""
    import jax

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return None
    try:
        found = jax.default_backend()
    except RuntimeError as e:  # no usable platform at all
        found = f"none ({e})"
    if found != "gpu":
        return f"--backend gpu requested but JAX found no GPU (backend: {found})"
    return None


def _with_compile_status(fn):
    """Run ``fn()`` printing a status line to stderr if it takes > 2 s
    (first-frame XLA compiles can; silence reads as a hang).  On a TTY
    the line updates in place; redirected stderr (logs, CI) gets plain
    lines at a lower cadence instead of control bytes."""
    import threading

    done = threading.Event()
    tty = sys.stderr.isatty()

    def ticker():
        if done.wait(2.0):
            return
        start = _time.perf_counter() - 2.0
        while True:
            elapsed = _time.perf_counter() - start
            if tty:
                sys.stderr.write(
                    f"\r\x1b[2KCompiling graph... ({elapsed:.0f}s)"
                )
            else:
                sys.stderr.write(f"Compiling graph... ({elapsed:.0f}s)\n")
            sys.stderr.flush()
            if done.wait(3.0 if tty else 15.0):
                break
        if tty:
            sys.stderr.write("\r\x1b[2K")
            sys.stderr.flush()

    th = threading.Thread(target=ticker, daemon=True)
    th.start()
    try:
        return fn()
    finally:
        done.set()
        th.join()


def _expand_inputs(path: str) -> list[str]:
    """Glob patterns and directories expand to sorted image lists."""
    import glob as _glob

    if os.path.isdir(path):
        entries = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff"))
        )
        return entries
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path] if os.path.exists(path) else []


def _batch_output_path(pattern: str, input_path: str) -> str:
    stem = os.path.splitext(os.path.basename(input_path))[0]
    if "{}" in pattern:
        return pattern.replace("{}", stem)
    # Treat as a directory.
    os.makedirs(pattern, exist_ok=True)
    return os.path.join(pattern, stem + ".png")


def _run_batch(args, inputs: list[str]) -> int:
    """Decode N images, run one vmapped data-parallel program, encode N."""
    import time as _t

    import jax
    import jax.numpy as jnp

    from .io import decode_image_to_planar, encode_planar_to_image
    from .parallel import BatchProgram, make_batch_mesh

    try:
        first = ImageFileDecoder(inputs[0])
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    width, height = utils.get_dim(first.width, first.height, args.width, args.height)

    info = RenderInfo(
        width=width,
        height=height,
        num_frames=1,
        config_path=args.config,
        shader_path=args.shader_path,
        fmt=args.shader_format,
        has_input_image=True,
        shader_file_path=args.shader,
    )
    try:
        engine = Engine(info)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    t0 = _t.perf_counter()
    frames = []
    for path in inputs:
        try:
            dec = first if path == inputs[0] else ImageFileDecoder(path)
            frames.append(dec.decode(width, height))
        except ImageFileError as e:
            print(f"Error decoding {path}: {e}", file=sys.stderr)
            return 1
    batch_u8 = jnp.asarray(np.stack(frames))
    print(
        f"Decoded {len(inputs)} images at {width}x{height} in "
        f"{utils.get_elapsed_ms(t0):.0f}ms",
        file=sys.stderr,
    )

    mesh = make_batch_mesh(args.shard) if args.shard else None
    bp = BatchProgram(engine.program, mesh)
    planar = jax.vmap(decode_image_to_planar)(batch_u8)
    planar, n = bp.pad_batch(planar)
    out = bp(bp.shard_input(planar), 0.0)
    rgba = np.asarray(jax.vmap(encode_planar_to_image)(out[:n]))

    for i, path in enumerate(inputs):
        encode(_batch_output_path(args.output_file, path), rgba[i])
    print(
        f"Processed {len(inputs)} images in {utils.get_elapsed_ms(t0):.0f}ms total",
        file=sys.stderr,
    )
    return 0


class _FrameWriter:
    """Background readback+encode: the main thread queues device frames
    while a daemon thread fetches and encodes them in order, so the next
    frames compute on the device meanwhile.  After a failure the queue
    drains without writing; the first error surfaces via ``finish``."""

    def __init__(self, engine: Engine, enc, maxsize: int):
        import queue
        import threading

        self._engine = engine
        self._enc = enc
        # Device frames waiting for the writer: the in-flight bound.
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._errors:
                continue  # drain remaining items after a failure
            try:
                self._enc.write(self._engine.read_output(item))
            except Exception as e:  # surfaced on the main thread
                self._errors.append(e)

    def put(self, frame) -> None:
        self._q.put(frame)

    @property
    def failed(self) -> bool:
        return bool(self._errors)

    def finish(self):
        """Join the writer; returns the first write error, if any."""
        self._q.put(None)
        self._thread.join()
        return self._errors[0] if self._errors else None


def _run_animate(engine: Engine, args, width: int, height: int) -> int:
    """Render a time-varying graph over a still image (or a generator
    graph) into a video: ``-i photo.jpg -o out.mp4 --duration 5``.

    Frames are sequenced ON DEVICE in chunks via
    ``GraphProgram.render_sequence`` (``_rf_time`` advances per frame
    inside one dispatch), so throughput is device-bound rather than
    per-frame-submission-bound; a writer thread overlaps readback+encode
    with the next chunk's compute.  ``--start`` sets the initial
    ``_rf_time``; ``--fps`` the output rate."""
    import time as _t

    from .io import ImageFileError, VideoEncoder

    dur = getattr(args, "duration", None)
    if not dur or dur <= 0:
        print(
            "Error: animated video export (image/generator -> video) needs "
            "--duration SEC (and optionally --fps)",
            file=sys.stderr,
        )
        return 1
    fps = float(getattr(args, "fps", 0) or 30.0)
    total = max(1, round(dur * fps))
    if args.frames:
        total = min(total, args.frames)
    try:
        enc = VideoEncoder(args.output_file, width, height, fps)
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    writer = _FrameWriter(engine, enc, maxsize=16)  # device frames in flight

    x = engine._file_input()
    t_start = float(getattr(args, "start", 0.0) or 0.0)
    dt = 1.0 / fps
    chunk = 8
    t0 = _t.perf_counter()
    done = 0
    while done < total and not writer.failed:
        k = min(chunk, total - done)
        # Always render a full chunk (one compiled program for the whole
        # export); surplus frames of a ragged tail are simply not encoded.
        frames = engine.program.render_sequence(
            x, t_start + done * dt, dt, chunk, stack=True
        )
        for i in range(k):
            writer.put(frames[i])
        done += k
        rate = done / max(_t.perf_counter() - t0, 1e-9)
        sys.stderr.write(f"\rFrame {done}/{total}  ({rate:5.1f} fps)")
        sys.stderr.flush()
    err = writer.finish()
    if err is not None:
        print(f"\nError: {err}", file=sys.stderr)
        try:
            enc.close()
        except ImageFileError:
            pass
        return 1
    try:
        enc.close()
    except ImageFileError as e:
        print(f"\nError finalizing video: {e}", file=sys.stderr)
        return 1
    elapsed = _t.perf_counter() - t0
    sys.stderr.write(
        f"\rRendered {done} frames in {elapsed:.1f}s "
        f"({done / max(elapsed, 1e-9):.1f} fps) -> {args.output_file}\n"
    )
    return 0


def _run_video(engine: Engine, decoder, args, width: int, height: int) -> int:
    """Stream every frame of a video through the graph into a video file.

    The device pipeline stays busy: frame i+1 decodes on the host while
    frame i runs on device (the video analog of frames-in-flight).
    """
    import time as _t

    from .io import ImageFileError, VideoEncoder, VideoFrames

    if decoder is None:
        print("Error: video output requires an input file (-i)", file=sys.stderr)
        return 1
    try:
        frames = VideoFrames(
            decoder, width, height,
            start=getattr(args, "start", 0.0) or 0.0,
            duration=getattr(args, "duration", None),
        )
        fps = frames.fps
        enc = VideoEncoder(args.output_file, width, height, fps)
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    t0 = _t.perf_counter()
    count = 0
    # Decode, dispatch, and readback+encode run as a three-stage pipeline:
    # the main thread decodes frame i+2 and dispatches i+1 while the
    # writer thread fetches frame i from the device and encodes it.
    # In-flight frames are bounded by the queue depth plus the frame
    # being encoded.
    writer = _FrameWriter(engine, enc, maxsize=3)

    # Frame batching (--batch-frames K): K frames run as ONE vmapped
    # dispatch with per-frame times, amortizing per-dispatch overhead —
    # the offline-transcode analog of raising --num-frames.  K=1 keeps the
    # latency-oriented single-frame pipeline.
    kbatch = max(1, getattr(args, "batch_frames", 1) or 1)
    vfwd = None
    pending_planar: list = []
    pending_t0 = 0

    def _flush_batch():
        nonlocal vfwd
        if not pending_planar:
            return
        import jax

        import jax.numpy as jnp

        if vfwd is None:
            # Unroll K forward calls inside ONE jit: a static unroll gives
            # XLA K independent subgraphs to schedule in a single dispatch.
            fwd = engine.program._forward

            def _kfwd(batch, times):
                import jax.numpy as _jnp

                return _jnp.stack(
                    [fwd(batch[i], times[i]) for i in range(kbatch)]
                )

            vfwd = jax.jit(_kfwd)
        n = len(pending_planar)
        batch = pending_planar + [pending_planar[-1]] * (kbatch - n)
        times = jnp.asarray(
            [(pending_t0 + i) / fps for i in range(kbatch)], jnp.float32
        )
        outs = vfwd(jnp.stack(batch), times)
        for i in range(n):
            writer.put(outs[i])
        pending_planar.clear()

    try:
        for rgba in frames:
            if writer.failed:
                break
            if kbatch > 1:
                if not pending_planar:
                    pending_t0 = count
                pending_planar.append(engine.decode_to_planar(rgba))
                if len(pending_planar) == kbatch:
                    _flush_batch()
            else:
                engine.load_input(rgba)
                writer.put(engine.render_frame(t=count / fps))
            count += 1
            if args.frames and count >= args.frames:
                break
            if count % 25 == 0:
                rate = count / (_t.perf_counter() - t0)
                sys.stderr.write(f"\rFrame {count}  ({rate:5.1f} fps)")
                sys.stderr.flush()
        if kbatch > 1 and not writer.failed:
            _flush_batch()
    except ImageFileError as e:
        writer.finish()
        print(f"\nError: {e}", file=sys.stderr)
        try:
            enc.close()
        except ImageFileError:
            pass
        return 1
    err = writer.finish()
    if err is not None:
        print(f"\nError: {err}", file=sys.stderr)
        try:
            enc.close()
        except ImageFileError:
            pass
        return 1
    try:
        enc.close()
    except ImageFileError as e:
        print(f"\nError finalizing video: {e}", file=sys.stderr)
        return 1
    elapsed = _t.perf_counter() - t0
    sys.stderr.write(
        f"\rProcessed {count} frames in {elapsed:.1f}s "
        f"({count / max(elapsed, 1e-9):.1f} fps) -> {args.output_file}\n"
    )
    return 0


def _run_live_loop(engine: Engine, args) -> int:
    from .window import NullPreview, create_preview

    preview = create_preview(args.preview, engine.info.width, engine.info.height)
    avg_ms = 0.0
    frame_timer = _time.perf_counter()
    frames_run = 0
    try:
        while True:
            if preview.poll_quit():
                break
            resized = preview.poll_resize()
            if resized is not None:
                engine.resize(*resized)
            if engine.trigger_reloads():
                sys.stderr.write(TERM_CLEAR)

            elapsed_ms = utils.get_elapsed_ms(frame_timer)
            avg_ms = utils.moving_avg(avg_ms, elapsed_ms)
            frame_timer = _time.perf_counter()
            sys.stderr.write(
                f"\rFrame: {elapsed_ms:5.2f}ms, Frame-Avg: {avg_ms:5.2f}ms, "
                f"GPU: {{{engine.gpu_times_str()}}}"
            )
            sys.stderr.flush()

            out = engine.render_frame()
            if not isinstance(preview, NullPreview):
                preview.show(engine.read_output_scaled(out, preview.target_px()))

            frames_run += 1
            if args.frames and frames_run >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sys.stderr.write("\n")
        preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
