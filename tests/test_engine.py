"""Engine lifecycle tests: frame loop, live reload, keep-last-good."""

import os
import time

import numpy as np
import pytest

from reforge_tpu import utils
from reforge_tpu.engine import Engine, RenderInfo


def write(path, text, bump_from=None):
    with open(path, "w") as f:
        f.write(text)
    if bump_from is not None:
        # mtime_ns resolution is fine, but make strictly increasing to be safe.
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, bump_from + 1_000_000))


def make_engine(tmp_path, config_text, w=24, h=16, **kw):
    cfg = tmp_path / "graph.rf"
    write(str(cfg), config_text)
    info = RenderInfo(
        width=w,
        height=h,
        config_path=str(cfg),
        shader_path=str(tmp_path),
        has_input_image=True,
        **kw,
    )
    eng = Engine(info)
    rgba = np.random.default_rng(0).integers(0, 256, (h, w, 4), dtype=np.uint8)
    eng.load_input(rgba)
    return eng, str(cfg)


class TestEngine:
    def test_render_frame(self, tmp_path):
        eng, _ = make_engine(tmp_path, "input -> invert -> output")
        out = eng.render_frame_blocking(0.0)
        assert out.shape == (4, 16, 24)

    def test_config_reload_swaps_program(self, tmp_path):
        eng, cfg = make_engine(tmp_path, "input -> invert -> output")
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old_mtime = utils.get_modified_time(cfg)
        write(cfg, "input -> passthrough -> output", bump_from=old_mtime)
        assert eng.trigger_reloads() is True
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        assert not np.allclose(out1, out2)
        # passthrough output == linearized input
        inp = np.asarray(eng._input_planar)
        np.testing.assert_allclose(out2, inp, atol=1e-6)

    def test_bad_edit_keeps_last_good(self, tmp_path):
        eng, cfg = make_engine(tmp_path, "input -> invert -> output")
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old = utils.get_modified_time(cfg)
        write(cfg, "input -> invert -> @@@garbage", bump_from=old)
        assert eng.trigger_reloads() is False
        assert any("Invalid token" in w for w in utils.recent_warnings())
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_array_equal(out1, out2)
        # Fixing the file swaps again.
        old = utils.get_modified_time(cfg)
        write(cfg, "input -> passthrough -> output", bump_from=old)
        assert eng.trigger_reloads() is True

    def test_unchanged_config_no_reload(self, tmp_path):
        eng, _ = make_engine(tmp_path, "input -> invert -> output")
        assert eng.trigger_reloads() is False

    def test_py_kernel_file_and_reload(self, tmp_path):
        kpath = tmp_path / "doubler.py"
        kpath.write_text(
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('doubler', register=False)\n"
            "def doubler(ctx, input_image, *, gain=2.0):\n"
            "    return input_image * gain\n"
        )
        eng, _ = make_engine(tmp_path, "input -> doubler -> output")
        inp = np.asarray(eng._input_planar)
        out = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out, inp * 2.0, atol=1e-6)

        # Edit the kernel file -> program rebuilds with new code.
        old = utils.get_modified_time(str(kpath))
        kpath.write_text(
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('doubler', register=False)\n"
            "def doubler(ctx, input_image, *, gain=3.0):\n"
            "    return input_image * gain\n"
        )
        os.utime(str(kpath), ns=(old + 1_000_000, old + 1_000_000))
        assert eng.trigger_reloads() is True
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out2, inp * 3.0, atol=1e-6)

    def test_broken_kernel_edit_keeps_last_good(self, tmp_path):
        kpath = tmp_path / "mykern.py"
        kpath.write_text(
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('mykern', register=False)\n"
            "def mykern(ctx, input_image):\n"
            "    return input_image * 0.5\n"
        )
        eng, _ = make_engine(tmp_path, "input -> mykern -> output")
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old = utils.get_modified_time(str(kpath))
        kpath.write_text("this is not python !!!")
        os.utime(str(kpath), ns=(old + 1_000_000, old + 1_000_000))
        assert eng.trigger_reloads() is False
        assert any("Error loading kernel" in w for w in utils.recent_warnings())
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_array_equal(out1, out2)

    def test_per_node_timing_mode(self, tmp_path):
        eng, _ = make_engine(
            tmp_path, "input -> blur -> sobel -> output", timing="per-node"
        )
        eng.render_frame_blocking(0.0)
        assert set(eng.last_gpu_times) == {"blur", "sobel"}
        s = eng.gpu_times_str()
        assert "blur:" in s and "ms" in s

    def test_single_shader_mode(self, tmp_path):
        kpath = tmp_path / "half.py"
        kpath.write_text(
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('half', register=False)\n"
            "def half(ctx, input_image):\n"
            "    return input_image * 0.5\n"
        )
        info = RenderInfo(
            width=24,
            height=16,
            shader_file_path=str(kpath),
            has_input_image=True,
        )
        eng = Engine(info)
        rgba = np.random.default_rng(0).integers(0, 256, (16, 24, 4), np.uint8)
        eng.load_input(rgba)
        out = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out, np.asarray(eng._input_planar) * 0.5, atol=1e-6)


class TestCli:
    def test_headless_end_to_end(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        rgba = np.random.default_rng(3).integers(0, 256, (32, 48, 4), np.uint8)
        rgba[..., 3] = 255
        inp = str(tmp_path / "in.png")
        outp = str(tmp_path / "out.png")
        encode(inp, rgba)
        rc = main(["-i", inp, "-o", outp])
        assert rc == 0
        out = np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(outp))
        np.testing.assert_array_equal(out, rgba)  # default passthrough, lossless

    def test_headless_with_config(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        rgba = np.full((16, 16, 4), 100, np.uint8)
        inp = str(tmp_path / "in.png")
        outp = str(tmp_path / "out.png")
        cfgp = str(tmp_path / "g.rf")
        encode(inp, rgba)
        write(cfgp, "input -> invert -> output")
        rc = main(["-i", inp, "-o", outp, "--config", cfgp])
        assert rc == 0

    def test_conflicting_args(self):
        from reforge_tpu.cli import main

        assert main(["shader.comp", "--config", "x.rf"]) == 1

    def test_missing_input_file(self):
        from reforge_tpu.cli import main

        assert main(["-i", "/nonexistent/x.png", "-o", "/tmp/y.png"]) == 1

    def test_backend_choices(self):
        from reforge_tpu.cli import build_arg_parser

        parser = build_arg_parser()
        for choice in ("auto", "gpu", "cpu"):
            assert parser.parse_args(["--backend", choice]).backend == choice
        with pytest.raises(SystemExit):
            parser.parse_args(["--backend", "metal"])

    def test_backend_gpu_without_gpu_exits_nonzero(self, tmp_path, capsys):
        """--backend gpu never falls back to the CPU: no GPU, no render."""
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        inp, out = tmp_path / "in.png", tmp_path / "out.png"
        encode(str(inp), np.full((8, 8, 4), 128, np.uint8))
        rc = main(["--backend", "gpu", "-i", str(inp), "-o", str(out)])
        assert rc != 0
        assert "no GPU" in capsys.readouterr().err
        assert not out.exists()

    def test_reference_style_positionals(self, tmp_path):
        # ``reforge <input-file> [output-file]`` (reference main.rs:45-48).
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        rgba = np.random.default_rng(5).integers(0, 256, (16, 24, 4), np.uint8)
        rgba[..., 3] = 255
        inp = str(tmp_path / "in.png")
        outp = str(tmp_path / "out.png")
        encode(inp, rgba)
        assert main([inp, outp]) == 0
        out = np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(outp))
        np.testing.assert_array_equal(out, rgba)

    def test_shader_plus_image_positionals(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        rgba = np.full((8, 8, 4), 100, np.uint8)
        rgba[..., 3] = 255
        inp = str(tmp_path / "in.png")
        outp = str(tmp_path / "out.png")
        shp = str(tmp_path / "half.py")
        encode(inp, rgba)
        write(
            shp,
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('half', register=False)\n"
            "def half(ctx, input_image):\n"
            "    return input_image * 0.5\n",
        )
        assert main([shp, inp, outp]) == 0

    def test_positional_conflicts(self):
        from reforge_tpu.cli import main

        assert main(["a.png", "-i", "b.png"]) == 1
        assert main(["a.png", "b.png", "c.png"]) == 1
        assert main(["x.comp", "y.comp"]) == 1
        assert main(["a.png", "out.png", "-o", "z.png"]) == 1


class TestCompileCache:
    """Compiled programs persist across processes on every backend."""

    def _updates(self, monkeypatch):
        import jax

        seen = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda name, value: seen.__setitem__(name, value))
        return seen

    def test_default_is_a_fixed_dir_in_the_checkout(self, monkeypatch):
        from reforge_tpu import engine

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(os, "makedirs", lambda p, exist_ok=False: None)
        seen = self._updates(monkeypatch)
        engine._enable_persistent_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(engine.__file__)))
        assert seen["jax_compilation_cache_dir"] == os.path.join(root, ".jax_cache")
        assert engine.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")

    def test_env_var_wins(self, monkeypatch, tmp_path):
        from reforge_tpu import engine

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        seen = self._updates(monkeypatch)
        engine._enable_persistent_cache()
        assert "jax_compilation_cache_dir" not in seen
        assert seen["jax_persistent_cache_min_compile_time_secs"] == 0.5


class TestAsyncReload:
    def test_async_compile_swap(self, tmp_path):
        eng, cfg = make_engine(
            tmp_path, "input -> invert -> output", async_compile=True
        )
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old = utils.get_modified_time(cfg)
        write(cfg, "input -> passthrough -> output", bump_from=old)

        # First poll starts the background compile; the old program still
        # renders (no stall, no swap yet necessarily).
        t0 = time.perf_counter()
        first = eng.trigger_reloads()
        poll_latency = time.perf_counter() - t0
        assert poll_latency < 5.0  # validation+trace only, no full compile

        # Keep rendering while compiling; eventually the swap lands.
        swapped = first
        deadline = time.time() + 60
        while not swapped and time.time() < deadline:
            eng.render_frame_blocking(0.0)
            time.sleep(0.02)
            swapped = eng.trigger_reloads()
        assert swapped, "async compile never delivered the new program"
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out2, np.asarray(eng._input_planar), atol=1e-6)

    def test_async_bad_edit_keeps_rendering(self, tmp_path):
        eng, cfg = make_engine(
            tmp_path, "input -> invert -> output", async_compile=True
        )
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old = utils.get_modified_time(cfg)
        write(cfg, "totally broken @@@", bump_from=old)
        assert eng.trigger_reloads() is False
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_array_equal(out1, out2)

    def test_rapid_edits_settle_on_last(self, tmp_path):
        # Five edits fired faster than compiles can finish (including one
        # broken intermediate) must never crash the frame loop and must
        # settle on the LAST config (generation counter discards stale
        # builds).
        eng, cfg = make_engine(
            tmp_path, "input -> invert -> output", async_compile=True
        )
        eng.render_frame_blocking(0.0)
        edits = [
            "input -> passthrough -> output",
            "input -> gs -> output\ngs: gaussian { sigma: 1.0 }",
            "broken @@@ config",
            "input -> invert -> output",
            "input -> gamma -> output\ngamma: gamma { value: 2.0 }",
        ]
        mt = utils.get_modified_time(cfg)
        for text in edits:
            write(cfg, text, bump_from=mt)
            mt = utils.get_modified_time(cfg)
            eng.trigger_reloads()
            eng.render_frame_blocking(0.0)
            time.sleep(0.05)
        ref = np.asarray(eng._input_planar)
        deadline = time.time() + 90
        settled = False
        while time.time() < deadline and not settled:
            eng.trigger_reloads()
            out = np.asarray(eng.render_frame_blocking(0.0))
            settled = np.allclose(out[:3], ref[:3] ** 0.5, atol=1e-5)
            time.sleep(0.02)
        assert settled, "last edit (gamma) never became the rendered program"
        assert "gamma" in eng.config.graph_pipelines


class TestBatchMode:
    def test_batch_directory(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode
        from PIL import Image

        indir = tmp_path / "in"
        outdir = tmp_path / "out"
        indir.mkdir()
        rng = np.random.default_rng(1)
        for i in range(5):
            rgba = rng.integers(0, 256, (16, 24, 4), np.uint8)
            rgba[..., 3] = 255
            encode(str(indir / f"f{i}.png"), rgba)
        cfg = tmp_path / "g.rf"
        cfg.write_text("input -> invert -> output")
        rc = main(["-i", str(indir), "-o", str(outdir), "--config", str(cfg),
                   "--shader-path", str(tmp_path), "--shard", "4"])
        assert rc == 0
        outs = sorted(outdir.iterdir())
        assert len(outs) == 5
        # Batch result equals single-image result.
        rc = main(["-i", str(indir / "f2.png"), "-o", str(tmp_path / "single.png"),
                   "--config", str(cfg), "--shader-path", str(tmp_path)])
        assert rc == 0
        a = np.asarray(Image.open(str(outdir / "f2.png")))
        b = np.asarray(Image.open(str(tmp_path / "single.png")))
        # vmap reassociates float sums; allow sRGB-encode rounding flips.
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1

    def test_batch_requires_output(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode

        indir = tmp_path / "in"
        indir.mkdir()
        for i in range(2):
            encode(str(indir / f"f{i}.png"), np.zeros((8, 8, 4), np.uint8))
        assert main(["-i", str(indir)]) == 1


class TestShardedReload:
    def test_async_reload_with_shard(self, tmp_path):
        """Regression: AOT-compiled sharded programs must accept the engine's
        input after an async reload swap (sharding mismatch bug)."""
        eng, cfg = make_engine(
            tmp_path, "input -> invert -> output", w=32, h=32,
            shard=4, async_compile=True,
        )
        out1 = np.asarray(eng.render_frame_blocking(0.0))
        old = utils.get_modified_time(cfg)
        write(cfg, "input -> passthrough -> output", bump_from=old)
        swapped = eng.trigger_reloads()
        deadline = time.time() + 60
        while not swapped and time.time() < deadline:
            eng.render_frame_blocking(0.0)
            time.sleep(0.02)
            swapped = eng.trigger_reloads()
        assert swapped
        out2 = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out2, np.asarray(eng._input_planar), atol=1e-6)


class TestReloadSoak:
    def test_rapid_mixed_edits_soak(self, tmp_path):
        """Stress the reload state machine: a burst of edits alternating
        valid configs, broken configs, broken kernels, and param changes;
        the engine must keep producing frames and settle on the last valid
        graph."""
        kpath = tmp_path / "soak.py"
        kpath.write_text(
            "from reforge_tpu.kernels import kernel\n"
            "@kernel('soak', register=False)\n"
            "def soak(ctx, input_image, *, gain=1.0):\n"
            "    return input_image * gain\n"
        )
        eng, cfg = make_engine(
            tmp_path, "input -> soak -> output\nsoak: soak { gain: 1.0 }",
            async_compile=True,
        )
        eng.render_frame_blocking(0.0)

        edits = [
            "input -> soak -> output\nsoak: soak { gain: 2.0 }",
            "broken @@@ config",
            "input -> soak -> invert -> output\nsoak: soak { gain: 2.0 }",
            "input -> nonexistent_kern -> output",
            "input -> soak -> output\nsoak: soak { gain: 3.0 }",
            "input -> soak -> @@@",
            "input -> soak -> output\nsoak: soak { gain: 4.0 }",
        ]
        for text in edits:
            old = utils.get_modified_time(cfg)
            write(cfg, text, bump_from=old)
            eng.trigger_reloads()
            # Frames must keep flowing regardless of edit validity.
            out = eng.render_frame_blocking(0.0)
            assert np.isfinite(np.asarray(out)).all()

        # Drain pending async builds; the final valid graph (gain 4) wins.
        deadline = time.time() + 60
        while time.time() < deadline:
            eng.render_frame_blocking(0.0)
            eng.trigger_reloads()
            out = np.asarray(eng.render_frame_blocking(0.0))
            if np.allclose(out, np.asarray(eng._input_planar) * 4.0, atol=1e-5):
                break
            time.sleep(0.05)
        np.testing.assert_allclose(
            np.asarray(eng.render_frame_blocking(0.0)),
            np.asarray(eng._input_planar) * 4.0,
            atol=1e-5,
        )


class TestReloadCaches:
    def test_unfused_matches_fused(self, tmp_path):
        eng, _ = make_engine(
            tmp_path,
            "input -> gs -> tone -> output\n"
            "gs: gaussian { sigma: 1.5 }\ntone: tonemap { exposure: 1.2 }",
        )
        x = eng._file_input()
        fused = np.asarray(eng.program(x, 0.25))
        unfused = np.asarray(eng.program.run_unfused(x, 0.25))
        np.testing.assert_allclose(unfused, fused, atol=1e-6)

    def test_node_fns_reused_across_programs(self, tmp_path):
        from reforge_tpu.config import parse
        from reforge_tpu.graph import build_graph
        from reforge_tpu.graph.program import GraphProgram

        src = (
            "input -> gs -> tone -> output\n"
            "gs: gaussian { sigma: 1.5 }\ntone: tonemap { exposure: 1.2 }"
        )
        p1 = GraphProgram(build_graph(parse(src, expects_input=True)), 24, 16)
        p2 = GraphProgram(build_graph(parse(src, expects_input=True)), 24, 16)
        for layer1, layer2 in zip(p1.graph.layers, p2.graph.layers):
            for n1, n2 in zip(layer1, layer2):
                assert p1._node_fn(n1) is p2._node_fn(n2), n1.name

    def test_fused_executable_reused_across_rebuilds(self, tmp_path):
        from reforge_tpu.config import parse
        from reforge_tpu.graph import build_graph
        from reforge_tpu.graph.program import GraphProgram

        src = "input -> vig -> output\nvig: vignette { strength: 0.3 }"
        p1 = GraphProgram(build_graph(parse(src, expects_input=True)), 24, 16)
        assert not p1.compile_cached()  # never compiled yet
        p1.compile()
        p2 = GraphProgram(build_graph(parse(src, expects_input=True)), 24, 16)
        assert p2.compile_cached()
        assert p2._compiled is p1._compiled
        # A param change must NOT hit the cache.
        src3 = "input -> vig -> output\nvig: vignette { strength: 0.7 }"
        p3 = GraphProgram(build_graph(parse(src3, expects_input=True)), 24, 16)
        assert not p3.compile_cached()

    def test_warm_reedit_adopts_without_compile(self, tmp_path):
        """Editing back to a previously compiled config swaps via the fused
        cache (interim per-node stage skipped entirely)."""
        eng, cfg = make_engine(
            tmp_path, "input -> invert -> output", async_compile=True
        )
        eng.render_frame_blocking(0.0)
        mt = utils.get_modified_time(cfg)
        for text in (
            "input -> passthrough -> output",
            "input -> invert -> output",
            "input -> passthrough -> output",
        ):
            write(cfg, text, bump_from=mt)
            mt = utils.get_modified_time(cfg)
            eng.trigger_reloads()
            eng.wait_for_compiles()
        # The final passthrough program must have adopted the SAME cached
        # executable compiled for the first passthrough edit.
        assert eng.program._compiled is not None
        out = np.asarray(eng.render_frame_blocking(0.0))
        np.testing.assert_allclose(out, np.asarray(eng._input_planar), atol=1e-6)
        eng.close()

    def test_kernel_spec_cache_by_source(self, tmp_path):
        from reforge_tpu.kernels.loader import load_kernel_file

        path = tmp_path / "k.py"
        path.write_text(
            "from reforge_tpu.kernels.base import kernel\n"
            "@kernel('k', register=False)\n"
            "def k(ctx, input_image):\n"
            "    return input_image * 0.5\n"
        )
        s1 = load_kernel_file(str(path))
        s2 = load_kernel_file(str(path))
        assert s1 is s2  # unchanged source -> same spec object
        path.write_text(
            "from reforge_tpu.kernels.base import kernel\n"
            "@kernel('k', register=False)\n"
            "def k(ctx, input_image):\n"
            "    return input_image * 0.25\n"
        )
        s3 = load_kernel_file(str(path))
        assert s3 is not s1

    def test_animated_export(self, tmp_path):
        # Still image + time-varying graph -> video of --duration seconds
        # (device-sequenced render_sequence chunks).
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode
        from reforge_tpu.io.imagefile import native_backend_available

        if not native_backend_available():
            pytest.skip("native backend not built")
        rgba = np.random.default_rng(4).integers(0, 256, (24, 32, 4), np.uint8)
        rgba[..., 3] = 255
        inp = str(tmp_path / "in.png")
        outp = str(tmp_path / "anim.mp4")
        cfgp = str(tmp_path / "g.rf")
        encode(inp, rgba)
        write(cfgp, "input -> wv -> output\nwv: wave { amplitude: 5.0, speed: 3.0 }\n")
        rc = main(["-i", inp, "-o", outp, "--config", cfgp,
                   "--duration", "0.5", "--fps", "10"])
        assert rc == 0
        from reforge_tpu.io import VideoFrames
        from reforge_tpu.io.imagefile import ImageFileDecoder

        dec = ImageFileDecoder(outp)
        frames = [f.copy() for f in VideoFrames(dec, dec.width, dec.height)]
        assert len(frames) == 5
        assert not np.array_equal(frames[0], frames[4])  # time advanced

    def test_animated_export_needs_duration(self, tmp_path):
        from reforge_tpu.cli import main
        from reforge_tpu.io import encode
        from reforge_tpu.io.imagefile import native_backend_available

        if not native_backend_available():
            pytest.skip("native backend not built")
        rgba = np.full((16, 16, 4), 90, np.uint8)
        inp = str(tmp_path / "in.png")
        encode(inp, rgba)
        assert main(["-i", inp, "-o", str(tmp_path / "o.mp4")]) == 1


class TestScaledReadback:
    def test_read_output_scaled(self):
        """Device-side preview downsample: box average in LINEAR light,
        then sRGB encode; full-res when the target covers the frame."""
        import jax.numpy as jnp

        from reforge_tpu.engine import Engine, RenderInfo

        info = RenderInfo(width=64, height=32, num_frames=1,
                          has_input_image=True)
        eng = Engine(info)
        rng = np.random.default_rng(11)
        out = jnp.asarray(rng.random((4, 32, 64), dtype=np.float32))
        full = eng.read_output(out)
        assert eng.read_output_scaled(out, None).shape == (32, 64, 4)
        assert eng.read_output_scaled(out, 64).shape == (32, 64, 4)
        small = eng.read_output_scaled(out, 32)  # step 2
        assert small.shape == (16, 32, 4)
        # Linear-light average of a 2x2 cell, then encode.
        lin = np.asarray(out, np.float64)
        cells = lin.reshape(4, 16, 2, 32, 2).mean(axis=(2, 4))
        want = np.asarray(eng.read_output(jnp.asarray(cells, jnp.float32)))
        np.testing.assert_allclose(small.astype(int), want.astype(int), atol=1)


class TestOneShot:
    """One-shot headless path: a single combined decode->graph->encode
    compile (engine.render_one_shot) instead of one per node."""

    def test_render_one_shot_matches_frame_path(self, tmp_path):
        eng, _ = make_engine(
            tmp_path,
            "input -> invert -> output",
            one_shot=True,
        )
        # one-shot engines run unfused outside render_one_shot
        assert eng.program._use_unfused
        rgba = np.random.default_rng(3).integers(
            0, 256, (16, 24, 4), dtype=np.uint8
        )
        got = eng.render_one_shot(rgba, t=0.25)
        assert got.shape == (16, 24, 4) and got.dtype == np.uint8
        # reference: the ordinary frame path on an identical engine
        eng2, _ = make_engine(tmp_path, "input -> invert -> output")
        eng2.load_input(rgba)
        want = eng2.read_output(eng2.render_frame_blocking(0.25))
        np.testing.assert_array_equal(got, want)

    def test_render_one_shot_generator_only(self, tmp_path):
        eng, _ = make_engine(
            tmp_path,
            "cb -> output\ncb: checkerboard { size: 4 }",
            one_shot=True,
        )
        out = eng.render_one_shot(None, t=0.0)
        assert out.shape == (16, 24, 4)
        assert out[..., :3].std() > 0  # the pattern rendered
