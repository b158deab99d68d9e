"""Graph synthesis + fused program tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu import utils
from reforge_tpu.config import parse
from reforge_tpu.graph import build_graph, make_program
from reforge_tpu.kernels import ops


def build(src, expects_input=True, w=24, h=16, fmt="rgba32f"):
    cfg = parse(src, expects_input)
    assert cfg is not None, utils.recent_warnings()
    graph = build_graph(cfg)
    if graph is None:
        return None, None
    return graph, make_program(graph, w, h, fmt)


def rand_image(h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random((4, h, w), dtype=np.float32))


class TestScheduling:
    def test_linear_chain_layers(self):
        graph, _ = build("input -> blur -> sharpen -> output")
        assert [[n.name for n in layer] for layer in graph.layers] == [
            ["blur"],
            ["sharpen"],
        ]

    def test_branching_layers(self):
        src = (
            "input -> blur -> mix -> output\n"
            "input -> sharpen -> mix:input_image2\n"
        )
        graph, _ = build(src)
        names = [[n.name for n in layer] for layer in graph.layers]
        assert names == [["blur", "sharpen"], ["mix"]]

    def test_cycle_detected(self):
        # a2 reads b2's output and b2 reads a2's -> cycle
        src = (
            "input -> mixer -> output\n"
            "mixer -> blur2 -> mixer:input_image2\n"
            "mixer: mix {}\nblur2: blur {}\n"
        )
        cfg = parse(src, True)
        assert cfg is not None
        assert build_graph(cfg) is None
        assert any("cycle" in w.lower() for w in utils.recent_warnings())

    def test_unknown_kernel_fails_build(self):
        graph, _ = build("input -> nonexistent_kernel_xyz -> output")
        assert graph is None
        assert any("No kernel source" in w for w in utils.recent_warnings())

    def test_unknown_descriptor_fails_build(self):
        graph, _ = build("input -> blur:bogus_desc -> sharpen -> output")
        assert graph is None
        assert any("bogus_desc" in w for w in utils.recent_warnings())

    def test_unconnected_input_fails_build(self):
        # blend needs input_image2 but only one input is wired
        graph, _ = build("input -> blend -> output")
        assert graph is None
        assert any("not connected" in w for w in utils.recent_warnings())


class TestExecution:
    def test_passthrough_identity(self):
        _, prog = build("input -> passthrough -> output")
        img = rand_image()
        out = np.asarray(prog(img, 0.0))
        np.testing.assert_array_equal(out, np.asarray(img))

    def test_three_node_chain(self):
        _, prog = build(
            "input -> gs -> sobel -> tonemap -> output\n"
            "gs: gaussian { sigma: 1.5 }\n"
        )
        img = rand_image()
        out = np.asarray(prog(img, 0.0))
        assert out.shape == (4, 16, 24)
        assert np.isfinite(out).all()

    def test_branching_equals_manual(self):
        src = (
            "input -> gs -> mixit -> output\n"
            "input -> sharp -> mixit:input_image2\n"
            "gs: gaussian { sigma: 2.0 }\n"
            "sharp: sharpen { amount: 0.5 }\n"
            "mixit: mix { factor: 0.5 }\n"
        )
        _, prog = build(src)
        img = rand_image(16, 24, seed=7)
        out = np.asarray(prog(img, 0.0))

        from reforge_tpu.kernels import KernelContext, lookup_builtin

        ctx = KernelContext(width=24, height=16, time=0.0)
        g = lookup_builtin("gaussian")
        s = lookup_builtin("sharpen")
        m = lookup_builtin("mix")
        blurred = g(ctx, {"input_image": img}, g.resolve_params({"sigma": 2.0}))[
            "output_image"
        ]
        sharped = s(ctx, {"input_image": img}, s.resolve_params({"amount": 0.5}))[
            "output_image"
        ]
        mixed = m(
            ctx,
            {"input_image": blurred, "input_image2": sharped},
            m.resolve_params({"factor": 0.5}),
        )["output_image"]
        np.testing.assert_allclose(out, np.asarray(mixed), atol=1e-6)

    def test_rgba8_quantization(self):
        _, prog = build("input -> passthrough -> output", fmt="rgba8")
        img = rand_image()
        out = np.asarray(prog(img, 0.0))
        np.testing.assert_allclose(out, np.round(np.asarray(img) * 255) / 255, atol=1e-7)
        steps = np.unique(np.round(out * 255) - out * 255)
        np.testing.assert_allclose(steps, 0.0, atol=1e-4)

    def test_generator_graph(self):
        _, prog = build(
            "checkerboard -> invert -> output\ncheckerboard: checkerboard { size: 8 }",
            expects_input=False,
        )
        img = jnp.zeros((4, 16, 24), jnp.float32)
        out = np.asarray(prog(img, 0.0))
        assert out.shape == (4, 16, 24)
        assert len(np.unique(out[0])) == 2

    def test_per_node_timing(self):
        _, prog = build(
            "input -> blur -> sobel -> output\n"
        )
        img = rand_image()
        out, times = prog.run_per_node(img, 0.0)
        assert set(times) == {"blur", "sobel"}
        assert all(t >= 0.0 for t in times.values())
        fused = np.asarray(prog(img, 0.0))
        np.testing.assert_allclose(np.asarray(out), fused, atol=1e-6)

    def test_time_threading(self):
        _, prog = build("input -> wv -> output\nwv: wave { amplitude: 4.0 }\n")
        img = rand_image(32, 32)
        out0 = np.asarray(prog(img, 0.0))
        out1 = np.asarray(prog(img, 0.5))
        assert not np.allclose(out0, out1)
        # Changing time must NOT recompile (time is traced, not static).
        from reforge_tpu.graph.program import GraphProgram  # noqa

        assert prog._fused._cache_size() == 1

    def test_render_sequence(self):
        """Device-side frame sequencing matches per-frame dispatches."""
        _, prog = build("input -> wv -> output\nwv: wave { amplitude: 4.0 }\n",
                        w=32, h=32)
        img = rand_image(32, 32)
        dt = 0.25
        stacked = np.asarray(prog.render_sequence(img, 0.0, dt, 3, stack=True))
        assert stacked.shape == (3, 4, 32, 32)
        for i in range(3):
            want = np.asarray(prog(img, jnp.float32(0.0) + i * jnp.float32(dt)))
            np.testing.assert_allclose(stacked[i], want, atol=1e-5)
        last = np.asarray(prog.render_sequence(img, 0.0, dt, 3))
        np.testing.assert_allclose(last, stacked[2], atol=1e-5)
        single = np.asarray(prog.render_sequence(img, 0.5, dt, 1))
        np.testing.assert_allclose(single, np.asarray(prog(img, 0.5)), atol=1e-5)

    def test_multi_writer_last_wins(self):
        # Two chains both writing the final output: later topo order wins,
        # matching the reference's execution-order overwrite.
        src = "input -> blur -> output\ninput -> blur -> sharpen -> output\n"
        _, prog = build(src)
        img = rand_image()
        out = np.asarray(prog(img, 0.0))
        assert out.shape == (4, 16, 24)


class TestRgba16f:
    def test_bf16_storage(self):
        _, prog = build("input -> gs -> tonemap -> output\ngs: gaussian { sigma: 2.0 }",
                        fmt="rgba16f")
        img = rand_image()
        out = prog(img, 0.0)
        assert out.dtype == jnp.bfloat16
        # Within half-float tolerance of the f32 result.
        _, prog32 = build("input -> gs -> tonemap -> output\ngs: gaussian { sigma: 2.0 }")
        ref = np.asarray(prog32(img, 0.0))
        got = np.asarray(out.astype(jnp.float32))
        assert np.abs(got - ref).max() < 0.02


FLAGSHIP = (
    "input -> soften -> mixer -> tone -> vig -> output\n"
    "input -> crisp -> mixer:input_image2\n"
    "soften: gaussian { sigma: 4.0 }\n"
    "crisp: unsharp { sigma: 2.0, amount: 0.8 }\n"
    "mixer: mix { factor: 0.5 }\n"
    "tone: tonemap { exposure: 1.1 }\n"
    "vig: vignette { strength: 0.4 }"
)
CONV_STENCIL_POINT = (
    "input -> soft -> edges -> tone -> output\n"
    "soft: blur { sigma: 4.0 }\nedges: sobel { amount: 1.0 }\n"
    "tone: tonemap { exposure: 1.1 }"
)
CHAIN3 = (
    "input -> gs -> edge -> tone -> output\n"
    "gs: gaussian { sigma: 2 }\nedge: sobel {}\ntone: tonemap {}\n"
)
GLSL_PAIR = (
    "input -> gh -> gv -> tm -> output\n"
    "gh: gaussian_h { sigma: 2.0 }\ngv: gaussian_v { sigma: 2.0 }\n"
    "tm: tonemap { exposure: 1.1 }"
)
# A directional (asymmetric) clamped tap sum, and an unclamped one whose
# out-of-image loads read zeros (GL robust access).
ASYM_1D = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 hi = imageSize(input_image) - ivec2(1);
    vec3 acc = vec3(0.0);
    acc += 0.6 * imageLoad(input_image, pos).rgb;
    acc += 0.3 * imageLoad(input_image, clamp(pos + ivec2(1, 0), ivec2(0), hi)).rgb;
    acc += 0.1 * imageLoad(input_image, clamp(pos + ivec2(2, 0), ivec2(0), hi)).rgb;
    imageStore(output_image, pos, vec4(acc, imageLoad(input_image, pos).a));
}
"""
ZERO_1D = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec3 acc = vec3(0.0);
    acc += 0.2 * imageLoad(input_image, pos + ivec2(-2, 0)).rgb;
    acc += 0.2 * imageLoad(input_image, pos + ivec2(-1, 0)).rgb;
    acc += 0.2 * imageLoad(input_image, pos).rgb;
    acc += 0.25 * imageLoad(input_image, pos + ivec2(1, 0)).rgb;
    acc += 0.15 * imageLoad(input_image, pos + ivec2(2, 0)).rgb;
    imageStore(output_image, pos, vec4(acc, imageLoad(input_image, pos).a));
}
"""

# Whole graphs at their shape and storage format: (config, width, height,
# format, extra shader files).  Configs naming .comp kernels resolve them
# in shaders/ (or among the extra files).
WHOLE_GRAPH_CASES = {
    "flagship_f32": (FLAGSHIP, 72, 48, "rgba32f", {}),
    "flagship_rgba8": (FLAGSHIP, 72, 48, "rgba8", {}),
    "flagship_rgba16f": (FLAGSHIP, 72, 48, "rgba16f", {}),
    "heavy_conv_f32": (
        "input -> gs -> tone -> output\n"
        "gs: gaussian { sigma: 8.0 }\ntone: tonemap { exposure: 1.1 }",
        128, 96, "rgba32f", {}),
    "heavy_conv_rgba16f": (
        "input -> gs -> tone -> output\n"
        "gs: gaussian { sigma: 8.0 }\ntone: tonemap { exposure: 1.1 }",
        128, 96, "rgba16f", {}),
    "coord_planes": (
        "input -> soften -> vig -> lines -> output\n"
        "soften: gaussian { sigma: 2.0 }\nvig: vignette { strength: 0.5 }\n"
        "lines: scanlines { period: 3, darkness: 0.4 }", 72, 48, "rgba32f", {}),
    "conv_stencil_point": (CONV_STENCIL_POINT, 128, 48, "rgba32f", {}),
    "conv_stencil_point_rgba8": (CONV_STENCIL_POINT, 128, 48, "rgba8", {}),
    "conv_stencil_point_rgba16f": (CONV_STENCIL_POINT, 128, 48, "rgba16f", {}),
    "conv_of_conv": (
        "input -> a -> b -> output\na: blur { sigma: 3.0 }\nb: blur { sigma: 2.0 }",
        128, 48, "rgba32f", {}),
    "bloom": (
        "input -> glow -> output\n"
        "glow: bloom { threshold: 0.4, sigma: 3.0, intensity: 0.8 }",
        128, 48, "rgba32f", {}),
    "point_feeding_conv_fan": (
        "input -> th -> bl -> m -> output\ninput -> m:input_image2\n"
        "th: threshold { value: 0.4 }\nbl: blur { sigma: 2.0 }\n"
        "m: mix { factor: 0.6 }", 128, 48, "rgba32f", {}),
    "median_saturation": (
        "input -> med -> sat -> output\n"
        "med: median3 {}\nsat: saturation { amount: 1.4 }", 128, 48, "rgba32f", {}),
    "sharpen_grayscale": (
        "input -> sh -> gray -> output\n"
        "sh: sharpen { amount: 0.7 }\ngray: grayscale {}", 128, 48, "rgba32f", {}),
    "coord_point_feeding_conv": (
        "input -> v -> b -> output\n"
        "v: vignette { strength: 0.5 }\nb: blur { sigma: 2.0 }", 128, 48, "rgba32f", {}),
    "emboss_unsharp_chain": (
        "input -> e -> u -> output\n"
        "e: emboss { amount: 0.9 }\nu: unsharp { sigma: 2.0, amount: 0.8 }",
        128, 48, "rgba32f", {}),
    "blur_edge_tone_rgba16f": (
        "input -> gs -> edge -> tone -> output\n"
        "gs: blur { sigma: 4.0 }\nedge: sobel {}\ntone: tonemap {}",
        128, 96, "rgba16f", {}),
    "tone_blur_rgba16f": (
        "input -> tone -> gs -> output\ntone: tonemap {}\ngs: blur { sigma: 4.0 }",
        128, 96, "rgba16f", {}),
    "unsharp_gray_rgba16f": (
        "input -> u -> gray -> output\n"
        "u: unsharp { sigma: 4.0, amount: 0.8 }\ngray: grayscale {}",
        128, 96, "rgba16f", {}),
    "bloom_rgba16f": (
        "input -> glow -> output\n"
        "glow: bloom { threshold: 0.4, sigma: 4.0, intensity: 0.8 }",
        128, 96, "rgba16f", {}),
    "conv_of_conv_rgba16f": (
        "input -> a -> b -> output\na: blur { sigma: 4.0 }\nb: blur { sigma: 3.0 }",
        128, 96, "rgba16f", {}),
    "heavy_conv_chain": (
        "input -> gs -> edge -> tone -> output\n"
        "gs: gaussian { sigma: 6.0 }\nedge: sobel {}\ntone: tonemap {}",
        128, 96, "rgba32f", {}),
    "tone_heavy_conv": (
        "input -> tone -> gs -> output\ntone: tonemap {}\ngs: gaussian { sigma: 6.0 }",
        128, 96, "rgba32f", {}),
    "heavy_conv_of_conv": (
        "input -> a -> b -> output\n"
        "a: gaussian { sigma: 6.0 }\nb: gaussian { sigma: 6.0 }",
        128, 96, "rgba32f", {}),
    "chain3": (CHAIN3, 128, 48, "rgba32f", {}),
    "heads_tails": (
        "input -> tm -> gs -> edge -> tm2 -> output\n"
        "tm: tonemap {}\ngs: gaussian { sigma: 2 }\n"
        "edge: sobel {}\ntm2: tonemap {}\n", 128, 48, "rgba32f", {}),
    "glsl_pair": (GLSL_PAIR, 128, 48, "rgba32f", {}),
    "glsl_pair_rgba16f": (GLSL_PAIR, 128, 48, "rgba16f", {}),
    "glsl_sharpen": (
        "input -> sh -> tm -> output\n"
        "sh: sharpen { amount: 0.7 }\ntm: tonemap { exposure: 1.0 }",
        128, 48, "rgba32f", {}),
    "glsl_conv_point": (
        "input -> gh -> sep -> output\n"
        "gh: gaussian_h { sigma: 3.0 }\nsep: sepia {}", 128, 48, "rgba32f", {}),
    "glsl_point_builtin_conv": (
        "input -> tm -> b -> output\n"
        "tm: tonemap { exposure: 1.2 }\nb: blur { sigma: 2.0 }", 128, 48, "rgba32f", {}),
    "glsl_single_1d": (
        "input -> gv -> tm -> output\n"
        "gv: gaussian_v { sigma: 2.0 }\ntm: tonemap {}", 128, 48, "rgba32f", {}),
    "glsl_same_axis_pair": (
        "input -> a -> b -> output\n"
        "a: gaussian_v { sigma: 1.5 }\nb: gaussian_v { sigma: 1.5 }",
        128, 64, "rgba32f", {}),
    "glsl_lone_conv_pair_tone": (
        "input -> a -> b -> tm -> output\n"
        "a: gaussian_v { sigma: 2.0 }\nb: gaussian_v { sigma: 2.0 }\n"
        "tm: tonemap {}", 128, 64, "rgba32f", {}),
    "glsl_asymmetric_conv": (
        "input -> mblur -> tm -> output\ntm: tonemap {}",
        128, 48, "rgba32f", {"mblur.comp": ASYM_1D}),
    "glsl_zero_border_conv": (
        "input -> nblur -> tm -> output\ntm: tonemap {}",
        128, 48, "rgba32f", {"nblur.comp": ZERO_1D}),
    "glsl_zero_border_then_builtin": (
        "input -> nblur -> gs -> output\ngs: gaussian { sigma: 2.0 }",
        128, 48, "rgba32f", {"nblur.comp": ZERO_1D}),
}


def _bf16_ulp(v: float) -> float:
    """bf16 spacing at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(v, 2.0 ** -126))) - 7)


class TestWholeGraph:
    """The production whole-graph program (one jit of every node) against
    the reference: per-node execution on the plain kernel path under
    highest matmul precision, f32 compute, with the format's own storage
    rounding at every node boundary."""

    @pytest.mark.parametrize("name", sorted(WHOLE_GRAPH_CASES))
    def test_matches_reference(self, name, tmp_path):
        import shutil

        import jax

        from reforge_tpu.config import parse_file
        from reforge_tpu.graph.program import GraphProgram

        src, w, h, fmt, files = WHOLE_GRAPH_CASES[name]
        shader_path = "shaders"
        if files:
            shader_path = str(tmp_path)
            for fname in ("gaussian_h.comp", "gaussian_v.comp"):
                shutil.copy(f"shaders/{fname}", tmp_path / fname)
            for fname, text in files.items():
                (tmp_path / fname).write_text(text)
        graph = build_graph(parse_file(src, expects_input=True,
                                       shader_path=shader_path))
        assert graph is not None, utils.recent_warnings()
        img = rand_image(h, w, seed=11)
        t = jnp.float32(0.3)

        got = np.asarray(make_program(graph, w, h, fmt)(img, t), np.float32)
        with ops.plain_kernels(), jax.default_matmul_precision("highest"):
            want, _ = GraphProgram(graph, w, h, fmt).run_per_node(img, t)
        want = np.asarray(want, np.float32)

        assert got.shape == (4, h, w) and np.isfinite(got).all()
        d = np.abs(got - want).max()
        nodes = sum(len(layer) for layer in graph.layers)
        if fmt == "rgba32f":
            tol = 1e-5  # [0, 1] data: only summation order may differ
        elif fmt == "rgba16f":
            # one bf16 ulp per node boundary
            tol = nodes * _bf16_ulp(float(np.abs(want).max()))
        else:
            # one code of the 8-bit grid per node boundary: a boundary that
            # rounds the other way moves the nodes after it by a code
            tol = nodes / 255.0 + 1e-6
        assert d <= tol, (name, fmt, d, tol)
