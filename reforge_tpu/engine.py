"""Render engine: frame lifecycle, live reload, keep-last-good swapping.

This program's analog of the reference's orchestrator (reference:
src/render.rs).  Responsibilities map 1:1:

  * own the compiled graph program + input image        (render.rs:42-57)
  * frame lifecycle driven by the CLI loop              (render.rs:328-495)
  * live reload: poll config + kernel-file mtimes, rebuild, keep the
    last-good program on any failure                    (render.rs:497-519)
  * ``_rf_time`` updates every frame without rebuilding (render.rs:212-223)
  * per-node and whole-frame timing readouts            (render.rs:521-523)

What has no analog: descriptor sets, command buffers, barriers, fences and
the swapchain — XLA compiles the whole graph into one program and JAX's
async dispatch pipelines host work against device compute (the reference's
frames-in-flight machinery, frame.rs:10-18, collapses into a bounded queue
of in-flight dispatches).

Reload-latency design: rebuilding a program re-traces and re-jits.  The
engine swaps in the new program immediately but the *compile* happens on
the next frame's dispatch; with the persistent compilation cache
(``_enable_persistent_cache``) repeated edits hit warm cache.  An optional
background compile thread (``async_compile=True``) compiles the new program
off-thread while the old one keeps rendering — the old graph keeps
producing frames, exactly the reference's behavior during shader rebuild.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time as _time
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import utils
from .config import Config, parse_file, single_shader_parse
from .graph import BuiltGraph, GraphProgram, build_graph, make_program
from .io import decode_image_to_planar, encode_planar_to_image
from .utils import warnln


DEFAULT_CONFIG = "input -> passthrough -> output"

# Hot-path jits hoisted to module level: constructing jax.jit wrappers per
# frame would lose the C++ fast-path dispatch cache.
_decode_jit = jax.jit(decode_image_to_planar)
_encode_jit = jax.jit(encode_planar_to_image)


@functools.lru_cache(maxsize=8)
def _scaled_encode_jit(step: int):
    """Device-side box-downsample (by integer step) + sRGB encode.

    The live preview displays at most the window/terminal size, so
    fetching the full frame (132 MB at 4K) to downsample on the host
    wastes fetch bandwidth.  The average runs in LINEAR light before the
    sRGB encode (correct downsampling; the host path averaged post-encode
    u8)."""

    def fn(planar):
        x = planar.astype(jnp.float32)
        c, h, w = x.shape
        hc, wc = h // step, w // step
        cells = x[:, : hc * step, : wc * step].reshape(c, hc, step, wc, step)
        return encode_planar_to_image(cells.mean(axis=(2, 4)))

    return jax.jit(fn)


@dataclasses.dataclass
class RenderInfo:
    """Engine construction parameters (reference: RenderInfo, render.rs:30-40)."""

    width: int
    height: int
    num_frames: int = 2
    config_path: Optional[str] = None
    shader_path: str = "shaders"
    fmt: str = "rgba32f"  # "rgba8" | "rgba32f"
    has_input_image: bool = False
    shader_file_path: Optional[str] = None
    timing: str = "fused"  # "fused" | "per-node"
    async_compile: bool = False
    # Row-shard the graph across N devices with explicit halo exchange
    # (0 = single device).  The reference has no multi-device mode; this is
    # the scale axis for frames too large for one card (SURVEY.md §2).
    shard: int = 0
    # Stage graph layers across N devices (pipeline parallelism); mutually
    # exclusive with shard.
    pipeline_stages: int = 0
    # Single-frame headless render (Engine.render_one_shot): one combined
    # decode -> graph -> encode program instead of the frame loop's
    # programs; direct render_frame calls run the per-node programs.
    one_shot: bool = False


# Where compiled programs are kept when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed directory inside the checkout (ignored by git).  The path
# must not change between runs, or a later process never finds an entry.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_cache() -> None:
    """Keep compiled programs across processes, on every backend: a cold
    start, a reload and a one-shot render then reuse earlier compiles (and
    XLA's autotuning choices).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and no
    directory is set here; otherwise the cache goes to DEFAULT_CACHE_DIR.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


class Engine:
    def __init__(self, info: RenderInfo):
        _enable_persistent_cache()
        self.info = info
        self.frame_index = 0
        self.start_time = _time.perf_counter()
        self.last_gpu_times: dict[str, float] = {}
        self._inflight: list[Any] = []
        self._input_planar: Optional[jnp.ndarray] = None
        self._compile_lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._build_seq = 0
        self._pending_seq = 0
        self._resize_target: Optional[tuple[int, int]] = None

        config = self._create_config()
        if config is None:
            raise RuntimeError("Failed to parse initial pipeline configuration")
        program = self._build_program(config)
        if program is None:
            raise RuntimeError("Failed to build initial pipeline graph")
        self.config = config
        self.program = program

        self._last_config_mtime = (
            utils.get_modified_time(info.config_path) if info.config_path else 0
        )
        self._last_kernel_mtimes = self._kernel_mtimes()
        self._watcher = self._make_watcher()
        self._force_poll = False

    # ---- construction helpers ------------------------------------------

    def _create_config(self) -> Optional[Config]:
        """Config source priority: --config file, single-shader, default
        passthrough chain (reference: render.rs:100-118)."""
        info = self.info
        if info.config_path is not None:
            contents = _read_file(info.config_path)
            if contents is None:
                warnln("Empty configuration file")
                return None
            return parse_file(contents, info.has_input_image, info.shader_path)
        if info.shader_file_path is not None:
            return single_shader_parse(info.shader_file_path, info.has_input_image)
        return parse_file(DEFAULT_CONFIG, True, info.shader_path)

    def _build_program(self, config: Config) -> Optional[GraphProgram]:
        graph = build_graph(config)
        if graph is None:
            return None
        width, height = self._target_size()
        one_shot = (
            self.info.one_shot
            and not self.info.shard
            and not self.info.pipeline_stages
        )
        program = make_program(graph, width, height, self.info.fmt)
        if program is None:
            return None
        if one_shot:
            # Fallback mode for direct render_frame calls; the CLI's
            # one-shot path uses render_one_shot (one combined compile).
            program._use_unfused = True
        if self.info.pipeline_stages:
            from .parallel import PipelineStagedProgram

            if self.info.shard:
                warnln(
                    "--shard is ignored when --pipeline is given; "
                    "running pipeline-staged only"
                )
            try:
                program.sharded = PipelineStagedProgram(  # type: ignore[attr-defined]
                    program, n_stages=self.info.pipeline_stages,
                    # Balance stages on measured per-node dispatch times
                    # (a few warmup dispatches at build), not the static
                    # tap-count heuristic.
                    measure=True,
                )
            except Exception as e:
                warnln(f"Cannot pipeline-stage graph: {e}; running single-device")
            return program
        if not self.info.shard:
            return program
        from .parallel import HaloShardedProgram, make_row_mesh

        try:
            mesh = make_row_mesh(self.info.shard)
            sharded = HaloShardedProgram(program, mesh)
        except ValueError as e:
            warnln(f"Cannot shard graph: {e}; running single-device")
            return program
        # Wrap: the engine calls program(input, t) and run_per_node for
        # timing; sharded execution keeps the unsharded program for the
        # per-node timing path.
        program.sharded = sharded  # type: ignore[attr-defined]
        return program

    def _kernel_mtimes(self) -> dict[str, int]:
        """Track mtimes of all file-backed kernels (reference: render.rs:225-249)."""
        times: dict[str, int] = {}
        for name, gp in self.config.graph_pipelines.items():
            if gp.file_path:
                times[gp.file_path] = utils.get_modified_time(gp.file_path)
        return times

    # ---- input ----------------------------------------------------------

    def load_input(self, rgba_u8: np.ndarray) -> None:
        """Upload the decoded sRGB image and linearize on device."""
        dev = jnp.asarray(rgba_u8)
        self._input_planar = _decode_jit(dev)

    def decode_to_planar(self, rgba_u8: np.ndarray) -> jnp.ndarray:
        """Decode one sRGB frame to a linear planar array without touching
        the engine's current input (video frame-batching path)."""
        return _decode_jit(jnp.asarray(rgba_u8))

    def _file_input(self) -> jnp.ndarray:
        if self._input_planar is not None:
            return self._input_planar
        # Generator-only graphs never read this; XLA DCEs the argument.
        return jnp.zeros((4, self.info.height, self.info.width), jnp.float32)

    # ---- live reload ----------------------------------------------------

    def trigger_reloads(self) -> bool:
        """Poll config/kernel mtimes and rebuild as needed.

        Returns True when the program was swapped (the CLI clears its timer
        line, reference main.rs:139-143).  Any failure keeps the last-good
        program (render.rs:121-136).

        With ``async_compile`` the rebuild validates and starts compiling on
        a background thread while the previous program keeps producing
        frames; the swap lands on a later poll once the compile finishes —
        the engine never shows a stalled frame, improving on the
        reference's device_wait_idle stall during rebuild (render.rs:125).
        """
        swapped = self._adopt_pending()
        # Native inotify fast path: skip the per-file mtime stats entirely
        # on quiet frames (the mtime comparison below stays authoritative
        # when the watcher reports directory activity or is unavailable).
        # A swap recreates the watcher, so edits racing the swap can have
        # their events dropped between the old instance's last poll and
        # the new one's creation — _force_poll makes the first check
        # after every swap consult mtimes unconditionally.
        if (
            self._watcher is not None
            and not self._force_poll
            and not self._watcher.poll()
        ):
            return swapped
        self._force_poll = False
        if self._config_changed():
            swapped = self._recreate_program() or swapped
        else:
            swapped = self._reload_changed_kernels() or swapped
        return swapped

    def _make_watcher(self):
        from .runtime.watcher import FileWatcher

        paths = list(self._last_kernel_mtimes)
        if self.info.config_path:
            paths.append(self.info.config_path)
        if not paths:
            return None
        watcher = FileWatcher(paths)
        return watcher if watcher.active else None

    def _adopt_pending(self) -> bool:
        with self._compile_lock:
            pending = self._pending
            self._pending = None
        if pending is None:
            return False
        config, program = pending
        if program is self.program:
            # Interim program already adopted; the fused executable flipped
            # in place when its background compile landed.
            return False
        self._swap(config, program)
        return True

    def _finish_build(self, config: Config) -> bool:
        """Build (validate) + compile the program: inline, or off-thread.

        The async path runs the WHOLE rebuild — kernel loading, descriptor
        matching, abstract-eval validation, and XLA compile — on a
        background thread so the frame loop never blocks; the old program
        keeps rendering until the new one is ready.  A generation counter
        makes rapid successive edits last-writer-wins.
        """
        if not self.info.async_compile:
            program = self._build_program(config)
            if program is None:
                return False
            self._swap(config, program)
            return True

        with self._compile_lock:
            self._build_seq += 1
            seq = self._build_seq

        def publish(program):
            with self._compile_lock:
                if seq >= self._pending_seq:
                    self._pending = (config, program)
                    self._pending_seq = seq
                    return True
                return False

        def work():
            try:
                program = self._build_program(config)
                if program is None:
                    return  # warned already; keep last good
                sharded = getattr(program, "sharded", None)
                if sharded is None and program._compiled is not None:
                    # Fused executable already cached (make_program adopted
                    # it): swap immediately, nothing to compile.
                    publish(program)
                    return
                if sharded is None:
                    # Stage 1: interim unfused program.  Unchanged nodes hit
                    # the global per-node jit cache, so this compiles only
                    # the edited node — the new output becomes visible at
                    # per-node latency (reference: per-pipeline rebuild,
                    # render.rs:497-519), while the fused whole-graph
                    # compile continues below.
                    try:
                        # Parallel: edits touching several nodes compile
                        # them concurrently (single-node edits hit the
                        # per-node cache either way).
                        program.warm_unfused_parallel()
                        program._use_unfused = True
                        publish(program)
                    except Exception as e:
                        warnln(f"Interim per-node program failed: {e}")
                        program._use_unfused = False
                if sharded is not None:
                    sharded.compile()
                else:
                    # Setting _compiled flips __call__ to the fused
                    # executable; no republish needed if the interim
                    # program was already adopted.
                    program.compile()
            except Exception as e:  # any failure: keep last good
                warnln(f"Background rebuild failed: {e}")
                return
            publish(program)

        thread = threading.Thread(target=work, daemon=True, name="rf-compile")
        self._build_threads = [
            th for th in getattr(self, "_build_threads", []) if th.is_alive()
        ]
        self._build_threads.append(thread)
        thread.start()
        return False

    def wait_for_compiles(self) -> None:
        """Block until all background rebuilds (and their fused compiles)
        have landed, then adopt the result."""
        for th in list(getattr(self, "_build_threads", [])):
            th.join()
        self._adopt_pending()

    def close(self) -> None:
        """Join outstanding background compiles and drain in-flight frames.

        XLA compile threads alive at interpreter teardown abort the
        process; anything embedding the engine (CLI, benchmarks, tests)
        should close it before exit."""
        for th in getattr(self, "_build_threads", []):
            th.join()
        self._drain()
        if getattr(self, "_watcher", None) is not None:
            self._watcher.close()
            self._watcher = None

    def _config_changed(self) -> bool:
        path = self.info.config_path
        if path is None:
            return False
        current = utils.get_modified_time(path)
        if current == 0:
            if self._last_config_mtime != 0:
                warnln(f"Unable to access config file: {path}")
                self._last_config_mtime = 0
            return False
        if current == self._last_config_mtime:
            return False
        self._last_config_mtime = current
        return True

    def _reload_changed_kernels(self) -> bool:
        current = self._kernel_mtimes()
        changed = False
        for path, last in self._last_kernel_mtimes.items():
            now = current.get(path, 0)
            if now == 0:
                if last != 0:
                    warnln(f"Unable to access kernel file: {path}")
            elif now != last:
                changed = True
        self._last_kernel_mtimes = current
        if not changed:
            return False
        # Kernel sources are re-read during graph build, so a kernel edit is
        # a program rebuild with the SAME config (the reference rebuilds just
        # one pipeline, pipeline_graph.rs:329-343; with fused XLA programs
        # the unit of recompilation is the program).
        return self._rebuild_keeping_config()

    def _recreate_program(self) -> bool:
        config = self._create_config()
        if config is None:
            return False
        return self._finish_build(config)

    def _rebuild_keeping_config(self) -> bool:
        return self._finish_build(self.config)

    def resize(self, width: int, height: int) -> bool:
        """Rebuild the graph at a new extent (window resize, no input image).

        With an input image the graph extent stays pinned to it — the
        preview scales instead (reference render.rs:529-532 semantics).
        The current extent stays in force until the rebuilt program swaps
        in: the old (possibly AOT-compiled, fixed-shape) program keeps
        rendering old-extent frames in the meantime.
        """
        if self.info.has_input_image:
            return False
        if (width, height) == self._target_size():
            return False
        self._resize_target = (width, height)
        return self._rebuild_keeping_config()

    def _target_size(self) -> tuple[int, int]:
        return self._resize_target or (self.info.width, self.info.height)

    def _swap(self, config: Config, program: GraphProgram) -> None:
        self._drain()
        self.config = config
        self.program = program
        # A pending resize takes effect with the program built for it.
        if (program.width, program.height) != (self.info.width, self.info.height):
            self.info.width, self.info.height = program.width, program.height
        if self._resize_target == (program.width, program.height):
            self._resize_target = None
        self.frame_index = 0
        self.last_gpu_times = {}
        self._last_kernel_mtimes = self._kernel_mtimes()
        # The new graph may reference different kernel files/directories.
        if getattr(self, "_watcher", None) is not None:
            self._watcher.close()
        self._watcher = self._make_watcher()
        self._force_poll = True  # see trigger_reloads: no event loss on swap

    # ---- frame execution ------------------------------------------------

    @property
    def time_since_start(self) -> float:
        return _time.perf_counter() - self.start_time

    def render_frame(self, t: Optional[float] = None) -> jnp.ndarray:
        """Dispatch one frame; returns the (4, H, W) linear output array.

        Dispatch is asynchronous; a bounded in-flight queue of depth
        ``num_frames`` provides the frames-in-flight pipelining the
        reference gets from multiple command buffers + fences.
        """
        if t is None:
            t = self.time_since_start
        if self.info.timing == "per-node":
            out, times = self.program.run_per_node(self._file_input(), t)
            self.last_gpu_times = times
        else:
            start = _time.perf_counter()
            sharded = getattr(self.program, "sharded", None)
            if sharded is not None:
                # AOT-compiled sharded executables require the compiled input
                # sharding; device_put to the same sharding is a no-op on
                # already-sharded frames.
                out = sharded(sharded.shard_input(self._file_input()), t)
            else:
                out = self.program(self._file_input(), t)
            self._inflight.append(out)
            if len(self._inflight) >= max(1, self.info.num_frames):
                # Analog of wait_for_frame_fence (render.rs:328-337): block
                # on the oldest in-flight frame, not the newest.
                oldest = self._inflight.pop(0)
                jax.block_until_ready(oldest)
            self.last_gpu_times = {
                "graph": (_time.perf_counter() - start) * 1000.0
            }
        self.frame_index = (self.frame_index + 1) % max(1, self.info.num_frames)
        return out

    def render_frame_blocking(self, t: Optional[float] = None) -> jnp.ndarray:
        out = self.render_frame(t)
        jax.block_until_ready(out)
        return out

    def render_one_shot(
        self, rgba_u8: Optional[np.ndarray], t: Optional[float] = None
    ) -> np.ndarray:
        """Render ONE frame as a single combined XLA program:
        decode -> graph -> sRGB encode, straight from the host u8 image
        to the host u8 result.

        One compile (one persistent-cache entry) instead of one per node,
        and no separate decode/encode executables.  The reference's
        headless mode is the same shape: per-shader compiles, one execute,
        encode, exit (src/main.rs:220-224).
        """
        if t is None:
            t = self.time_since_start
        program = self.program

        def fn(u8, tt):
            planar = decode_image_to_planar(u8)
            out = program._forward(planar, tt)
            return encode_planar_to_image(out)

        if rgba_u8 is None:
            # Generator-only graph: the input argument is DCE'd by XLA.
            rgba_u8 = np.zeros(
                (self.info.height, self.info.width, 4), np.uint8
            )
        return np.asarray(
            jax.jit(fn)(jnp.asarray(rgba_u8), jnp.float32(t))
        )

    def read_output(self, out: jnp.ndarray) -> np.ndarray:
        """Device linear (4,H,W) -> host sRGB (H,W,4) uint8 (render.rs:406-433)."""
        return np.asarray(_encode_jit(out))

    def read_output_scaled(self, out: jnp.ndarray,
                           target_px: Optional[int]) -> np.ndarray:
        """Like read_output, but box-downsampled ON DEVICE so only the
        preview-sized image crosses to the host (the swapchain-blit
        analog, command.rs:97-141, placed before the fetch instead of
        after).  ``target_px`` bounds the longer output edge; None or a
        bound at/above the frame size fetches full resolution."""
        if target_px is None or target_px <= 0:
            return self.read_output(out)
        h, w = out.shape[1], out.shape[2]
        # Floor division: the result never drops BELOW the display bound
        # (the backend would have to upscale — blurry); a window at
        # 50–100% of the frame gets the full frame and the backend's own
        # high-quality downscale.  Capped at the short edge so extreme
        # aspect ratios never produce an empty image.
        step = max(1, min(max(h, w) // int(target_px), min(h, w)))
        if step == 1:
            return self.read_output(out)
        return np.asarray(_scaled_encode_jit(step)(out))

    def gpu_times_str(self) -> str:
        return ", ".join(f"{k}: {v:.3f}ms" for k, v in self.last_gpu_times.items())

    def _drain(self) -> None:
        for arr in self._inflight:
            jax.block_until_ready(arr)
        self._inflight.clear()


def _read_file(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            contents = f.read()
        return contents if contents else None
    except OSError:
        return None
