"""Spatial sharding tests on the virtual 8-device CPU mesh.

Both strategies (GSPMD auto-partitioning and explicit shard_map halo
exchange) must produce outputs identical to single-device execution for
every kernel class: pointwise, coordinate-dependent, convolution (halo
exchange), and gather (all-gather fallback)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu import utils
from reforge_tpu.config import parse
from reforge_tpu.graph import build_graph, make_program
from reforge_tpu.parallel import (
    HaloShardedProgram,
    make_row_mesh,
    shard_program,
)

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV
    return make_row_mesh(N_DEV)


def build(src, w=64, h=64):
    cfg = parse(src, expects_input=True)
    assert cfg is not None, utils.recent_warnings()
    graph = build_graph(cfg)
    assert graph is not None, utils.recent_warnings()
    prog = make_program(graph, w, h)
    assert prog is not None
    return prog


def rand_image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random((4, h, w), dtype=np.float32))


CASES = {
    "pointwise": "input -> invert -> tonemap -> output",
    "coordinate": "input -> vignette -> scanlines -> output",
    "conv": "input -> gs -> sharpen -> output\ngs: gaussian { sigma: 2.0 }",
    "gather": "input -> px -> output\npx: pixelate { size: 8 }",
    "branching": (
        "input -> gs -> mixit -> output\n"
        "input -> sharpen -> mixit:input_image2\n"
        "gs: gaussian { sigma: 1.5 }\nmixit: mix { factor: 0.5 }"
    ),
    "generator_blend": (
        "input -> mixit -> output\n"
        "cb -> mixit:input_image2\n"
        "cb: checkerboard { size: 8 }\nmixit: mix { factor: 0.3 }"
    ),
    "edge_preserving": (
        "input -> med -> smooth -> output\n"
        "med: median3 {}\n"
        "smooth: bilateral { radius: 3, sigma_range: 0.1 }"
    ),
    "stylized": (
        "input -> grade -> dots -> output\n"
        "grade: levels { in_black: 0.05 }\ndots: halftone { size: 8 }"
    ),
}


class TestHaloSharding:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_single_device(self, mesh, name):
        prog = build(CASES[name])
        img = rand_image()
        want = np.asarray(prog(img, 0.25))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.25))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)

    def test_wide_halo_multihop_exchange(self, mesh):
        # sigma 8 -> halo 24 > h_local 8: exact via chained neighbor
        # ppermute hops (3 rounds), never a full-image all-gather.
        prog = build("input -> gs -> output\ngs: gaussian { sigma: 8.0 }")
        img = rand_image()
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert not any("all-gather" in w for w in utils.recent_warnings())
        hlo = (
            sharded._fused.lower(
                jax.ShapeDtypeStruct(img.shape, img.dtype),
                jax.ShapeDtypeStruct((), jnp.float32),
            )
            .compile()
            .as_text()
        )
        assert "all-gather" not in hlo, "wide halo must not all-gather"

    def test_sigma16_on_128_rows_multihop(self, mesh):
        # VERDICT r2 #5's named case: sigma 16 (halo 48) on 8 devices of a
        # 128-row image (16-row slabs -> 3 hops), both border modes deep
        # into the synthetic edge region.
        prog = build(
            "input -> gs -> output\ngs: gaussian { sigma: 16.0 }", h=128
        )
        img = rand_image(h=128)
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert not any("all-gather" in w for w in utils.recent_warnings())

    def test_whole_image_radius_still_gathers(self, mesh):
        # halo >= the image height: every row depends on every row; the
        # gather demotion remains, and remains observable.
        prog = build(
            "input -> gs -> output\ngs: gaussian { sigma: 24.0 }", h=64
        )
        assert prog.graph.layers[0][0].halo >= 64
        img = rand_image()
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert any("all-gather" in w for w in utils.recent_warnings())

    def test_batch_mesh_rejects_oversubscription(self):
        from reforge_tpu.parallel import make_batch_mesh

        with pytest.raises(ValueError, match="have"):
            make_batch_mesh(len(jax.devices()) + 1)

    @pytest.mark.parametrize("name", ["conv", "coordinate", "branching"])
    def test_batch_sharded_matches_loop(self, name):
        """shard_map batch execution == the single-frame program run frame
        by frame, with PER-FRAME times (each frame must see its own t)."""
        from reforge_tpu.parallel import BatchProgram, make_batch_mesh

        prog = build(CASES[name])
        bmesh = make_batch_mesh(N_DEV)
        bp = BatchProgram(prog, bmesh)
        rng = np.random.default_rng(7)
        batch = jnp.asarray(rng.random((N_DEV, 4, 64, 64), dtype=np.float32))
        times = jnp.asarray(np.linspace(0.0, 1.5, N_DEV), jnp.float32)
        got = np.asarray(bp(bp.shard_input(batch), times))
        for b in range(N_DEV):
            want = np.asarray(prog(batch[b], float(times[b])))
            np.testing.assert_allclose(
                got[b], want, atol=1e-5, err_msg=f"{name} frame {b}"
            )

    def test_batch_scalar_time_broadcasts(self):
        from reforge_tpu.parallel import BatchProgram

        prog = build(CASES["pointwise"])
        bp = BatchProgram(prog)  # no mesh: single-device lax.map path
        rng = np.random.default_rng(3)
        batch = jnp.asarray(rng.random((3, 4, 64, 64), dtype=np.float32))
        got = np.asarray(bp(batch, 0.5))
        for b in range(3):
            np.testing.assert_allclose(
                got[b], np.asarray(prog(batch[b], 0.5)), atol=1e-6
            )

    def test_batch_time_vector_shape_checked(self):
        from reforge_tpu.parallel import BatchProgram

        prog = build(CASES["pointwise"])
        bp = BatchProgram(prog)
        batch = jnp.zeros((3, 4, 64, 64), jnp.float32)
        with pytest.raises(ValueError, match="times shape"):
            bp(batch, jnp.zeros((2,), jnp.float32))

    def test_indivisible_height_rejected(self, mesh):
        prog = build("input -> invert -> output", h=60)
        with pytest.raises(ValueError, match="not divisible"):
            HaloShardedProgram(prog, mesh)

    @pytest.mark.parametrize("fmt", ["rgba8", "rgba16f"])
    def test_non_f32_formats_sharded(self, mesh, fmt):
        cfg = parse(CASES["conv"], expects_input=True)
        prog = make_program(build_graph(cfg), 64, 64, fmt)
        img = rand_image()
        want = np.asarray(prog(img, 0.0), np.float32)
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0), np.float32)
        # Exact across modes: the sharded path applies the same FILE_INPUT
        # storage-dtype cast as the fused path, so under rgba16f both
        # quantize identically before the first node.
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=fmt)

    def test_ssbo_pipeline_sharded(self, mesh, tmp_path):
        """histogram -> equalize: SSBO nodes run full-image so the buffer is
        replicated; image nodes stay sharded; output must match exactly."""
        import shutil

        for f in ("histogram.comp", "equalize.comp"):
            shutil.copy(f"shaders/{f}", tmp_path / f)
        from reforge_tpu.config import parse_file

        cfg = parse_file(
            "input -> histogram\n"
            "histogram:Bins -> equalize:Bins\n"
            "input -> equalize -> output",
            True,
            str(tmp_path),
        )
        graph = build_graph(cfg)
        prog = make_program(graph, 64, 64)
        img = rand_image(seed=5)
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_derivative_kernel_sharded(self, mesh, tmp_path):
        """fwidth reads the next row: the registered 1-row halo must make
        sharded output bit-match single-device."""
        (tmp_path / "outline.comp").write_text("""
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float y = dot(c.rgb, vec3(0.2126, 0.7152, 0.0722));
    imageStore(output_image, pos, vec4(vec3(fwidth(y) * 4.0), c.a));
}
""")
        from reforge_tpu.config import parse_file

        cfg = parse_file("input -> outline -> output", True, str(tmp_path))
        prog = make_program(build_graph(cfg), 64, 64)
        img = rand_image(seed=6)
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_glsl_kernel_sharded(self, mesh, tmp_path):
        """A .comp kernel with clamp-origin conv shards exactly."""
        (tmp_path / "hblur.comp").write_text("""
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 acc = vec4(0.0);
    for (int d = -2; d <= 2; d++) {
        acc += imageLoad(input_image, clamp(pos + ivec2(0, d), ivec2(0), size - ivec2(1)));
    }
    imageStore(output_image, pos, acc / 5.0);
}
""")
        from reforge_tpu.config import parse_file

        cfg = parse_file(
            "input -> hblur -> output", True, str(tmp_path)
        )
        graph = build_graph(cfg)
        prog = make_program(graph, 64, 64)
        img = rand_image()
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_glsl_coordinate_kernel_sharded(self, mesh, tmp_path):
        """gl_GlobalInvocationID.y must be globally correct per shard."""
        (tmp_path / "ygrad.comp").write_text("""
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    float v = float(pos.y) / float(size.y - 1);
    imageStore(output_image, pos, vec4(v, v, v, 1.0));
}
""")
        from reforge_tpu.config import parse_file

        cfg = parse_file("input -> ygrad -> output", True, str(tmp_path))
        graph = build_graph(cfg)
        prog = make_program(graph, 64, 64)
        img = rand_image()
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-6)
        # Sanity: actually a gradient spanning 0..1 globally.
        assert got[0, 0, 0] == 0.0 and abs(got[0, -1, 0] - 1.0) < 1e-6


class TestGspmdSharding:
    @pytest.mark.parametrize("name", ["pointwise", "conv", "branching"])
    def test_matches_single_device(self, mesh, name):
        prog = build(CASES[name])
        img = rand_image()
        want = np.asarray(prog(img, 0.25))
        sharded = shard_program(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.25))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)

    def test_gspmd_traces_plain_kernels(self, mesh, monkeypatch):
        """A custom call cannot be partitioned: on a GPU backend the GSPMD
        program traces the plain separable conv, while the per-device halo
        program may use the CUDA kernel."""
        from reforge_tpu.kernels import cuda_sepconv, ops

        calls = []

        def spy(x, wh, ww, mode="edge"):
            calls.append(x.shape)
            with ops.plain_kernels():
                return ops.sep_conv(x, wh, ww, mode)

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(cuda_sepconv, "sep_conv", spy)
        prog = build(CASES["conv"])
        calls.clear()  # make_program's validation trace is not under test
        args = (
            jax.ShapeDtypeStruct((4, 64, 64), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.float32),
        )
        shard_program(prog, mesh)._fused.lower(*args)
        assert calls == []
        HaloShardedProgram(prog, mesh)._fused.lower(*args)
        assert calls and all(shape[0] == 4 for shape in calls)


class TestBorderModes:
    def test_zero_border_glsl_sharded(self, mesh, tmp_path):
        """Unclamped imageLoad (zero OOB) must shard exactly, including the
        global top/bottom rows (edge devices zero-fill, not edge-replicate)."""
        (tmp_path / "vblur0.comp").write_text("""
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 acc = vec4(0.0);
    for (int d = -2; d <= 2; d++) {
        acc += imageLoad(input_image, pos + ivec2(0, d));
    }
    imageStore(output_image, pos, acc / 5.0);
}
""")
        from reforge_tpu.config import parse_file

        cfg = parse_file("input -> vblur0 -> output", True, str(tmp_path))
        graph = build_graph(cfg)
        spec = graph.nodes["vblur0"].spec
        assert spec.border_for({}) == "zero"
        prog = make_program(graph, 64, 64)
        img = rand_image()
        want = np.asarray(prog(img, 0.0))
        sharded = HaloShardedProgram(prog, mesh)
        got = np.asarray(sharded(sharded.shard_input(img), 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_mixed_borders_fall_back_to_gather(self, tmp_path):
        (tmp_path / "mixed.comp").write_text("""
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 a = imageLoad(input_image, pos + ivec2(0, 1));
    vec4 b = imageLoad(input_image, clamp(pos + ivec2(0, -1), ivec2(0), size - ivec2(1)));
    imageStore(output_image, pos, (a + b) * 0.5);
}
""")
        from reforge_tpu.kernels.loader import load_kernel_file

        spec = load_kernel_file(str(tmp_path / "mixed.comp"))
        assert spec.halo_for({}) is None  # gather fallback, always correct


class TestPipelineParallel:
    def test_staged_matches_single_device(self):
        from reforge_tpu.parallel import PipelineStagedProgram

        src = (
            "input -> gs -> sharpen -> tone -> vig -> output\n"
            "gs: gaussian { sigma: 2.0 }\ntone: tonemap {}\nvig: vignette {}\n"
        )
        prog = build(src)
        img = rand_image()
        want = np.asarray(prog(img, 0.1))
        staged = PipelineStagedProgram(prog, devices=jax.devices()[:4])
        assert len(staged.stage_layers) >= 2
        got = np.asarray(staged(img, 0.1))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_staged_branching_graph(self):
        from reforge_tpu.parallel import PipelineStagedProgram

        prog = build(CASES["branching"])
        img = rand_image(seed=5)
        want = np.asarray(prog(img, 0.0))
        staged = PipelineStagedProgram(prog, devices=jax.devices()[:2])
        got = np.asarray(staged(img, 0.0))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_more_stages_than_layers_clamps(self):
        from reforge_tpu.parallel import PipelineStagedProgram

        prog = build("input -> invert -> output")
        staged = PipelineStagedProgram(prog, devices=jax.devices())
        assert len(staged.stage_layers) == 1
        img = rand_image()
        np.testing.assert_allclose(
            np.asarray(staged(img, 0.0)), np.asarray(prog(img, 0.0)), atol=1e-6
        )

    def test_measured_costs_balance_stages(self):
        """split_layers balances on measured per-node ms when given: a
        chain where one node dominates puts the boundary right after it
        instead of splitting by the static heuristic's layer count."""
        from reforge_tpu.parallel import PipelineStagedProgram
        from reforge_tpu.parallel.pipeline import split_layers

        src = (
            "input -> a -> b -> c -> d -> output\n"
            "a: invert {}\nb: invert {}\nc: invert {}\nd: invert {}\n"
        )
        prog = build(src)
        # 'a' measured 10x heavier than the rest: stage 1 = just 'a'.
        costs = {"a": 10.0, "b": 1.0, "c": 1.0, "d": 1.0}
        groups = split_layers(prog.graph.layers, 2, costs)
        assert len(groups) == 2
        assert [n.name for layer in groups[0] for n in layer] == ["a"]
        # And the uniform-cost split stays balanced 2/2.
        groups = split_layers(prog.graph.layers, 2, {k: 1.0 for k in costs})
        assert len(groups[0]) == 2 and len(groups[1]) == 2

    def test_measure_true_runs_and_matches(self):
        from reforge_tpu.parallel import PipelineStagedProgram

        prog = build(CASES["conv"])
        img = rand_image()
        staged = PipelineStagedProgram(
            prog, devices=jax.devices()[:2], measure=True
        )
        assert staged.node_costs and all(
            v >= 0.0 for v in staged.node_costs.values()
        )
        np.testing.assert_allclose(
            np.asarray(staged(img, 0.0)), np.asarray(prog(img, 0.0)), atol=1e-5
        )

    def test_render_stream_matches_sequential(self):
        """Multi-frame-in-flight streaming == one-at-a-time calls, with
        per-frame times, in order."""
        from reforge_tpu.parallel import PipelineStagedProgram

        prog = build(CASES["coordinate"])
        staged = PipelineStagedProgram(prog, devices=jax.devices()[:3])
        rng = np.random.default_rng(11)
        frames = [
            jnp.asarray(rng.random((4, 64, 64), dtype=np.float32))
            for _ in range(5)
        ]
        times = [0.0, 0.3, 0.6, 0.9, 1.2]
        got = list(staged.render_stream(frames, times, depth=3))
        assert len(got) == 5
        for i, (f, t) in enumerate(zip(frames, times)):
            np.testing.assert_allclose(
                np.asarray(got[i]), np.asarray(prog(f, t)), atol=1e-5,
                err_msg=f"frame {i}",
            )
