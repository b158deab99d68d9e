"""GLSL-subset translator tests: reflection, numerics, control flow, errors."""

import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu.glsl import GlslError, translate_shader
from reforge_tpu.kernels.base import KernelContext

HEADER = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""


def run_shader(body, img=None, params=None, h=12, w=16, extra_decls="", t=0.0,
               images=None):
    src = HEADER + extra_decls + "\nvoid main() {\n" + body + "\n}\n"
    spec = translate_shader(src, "test")
    if img is None and images is None:
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, h, w), dtype=np.float32))
    imgs = images if images is not None else {"input_image": img}
    ctx = KernelContext(width=w, height=h, time=t)
    resolved = spec.resolve_params(params or {})
    return spec(ctx, imgs, resolved)["output_image"], imgs.get("input_image")


PASSTHROUGH = """
    vec4 res = imageLoad(input_image, ivec2(gl_GlobalInvocationID.xy));
    imageStore(output_image, ivec2(gl_GlobalInvocationID.xy), res);
"""


class TestBasics:
    def test_passthrough(self):
        out, img = run_shader(PASSTHROUGH)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(img))

    def test_arithmetic_and_swizzle(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            c.rgb = c.bgr * 2.0 + 0.125;
            imageStore(output_image, pos, c);
        """)
        ref = np.asarray(img).copy()
        ref[:3] = ref[[2, 1, 0]] * 2.0 + 0.125
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)

    def test_builtin_functions(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float y = dot(c.rgb, vec3(0.2126, 0.7152, 0.0722));
            float v = clamp(pow(y, 2.2), 0.0, 1.0);
            imageStore(output_image, pos, vec4(v, sqrt(v), mix(0.0, 1.0, v), 1.0));
        """)
        i = np.asarray(img)
        y = 0.2126 * i[0] + 0.7152 * i[1] + 0.0722 * i[2]
        v = np.clip(y ** 2.2, 0, 1)
        np.testing.assert_allclose(np.asarray(out)[0], v, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out)[1], np.sqrt(v), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out)[2], v, atol=1e-5)

    def test_shifted_load_zero_pad(self):
        # GLSL robust OOB semantics: out-of-bounds imageLoad returns 0.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos + ivec2(1, 0));
            imageStore(output_image, pos, c);
        """)
        i = np.asarray(img)
        ref = np.zeros_like(i)
        ref[:, :, :-1] = i[:, :, 1:]
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)

    def test_time_uniform(self):
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            imageStore(output_image, pos, vec4(_rf_time, 0.0, 0.0, 1.0));
        """
        decls = "layout(binding=2) uniform U { float _rf_time; };"
        out, _ = run_shader(body, extra_decls=decls, t=0.75)
        np.testing.assert_allclose(np.asarray(out)[0], 0.75, atol=1e-6)

    def test_define_macro(self):
        src = HEADER + """
#define GAIN 3.0
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, pos, imageLoad(input_image, pos) * GAIN);
}
"""
        spec = translate_shader(src, "macro")
        img = jnp.full((4, 8, 8), 0.25, jnp.float32)
        ctx = KernelContext(width=8, height=8)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        np.testing.assert_allclose(np.asarray(out), 0.75, atol=1e-6)


class TestControlFlow:
    def test_static_loop_conv(self):
        out, img = run_shader(
            """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(input_image);
            vec4 acc = vec4(0.0);
            for (int d = -radius; d <= radius; d++) {
                ivec2 p = clamp(pos + ivec2(d, 0), ivec2(0), size - ivec2(1));
                acc += imageLoad(input_image, p);
            }
            imageStore(output_image, pos, acc / float(2 * radius + 1));
            """,
            extra_decls="layout(binding=2) uniform U { int radius; };",
            params={"radius": 2},
        )
        i = np.pad(np.asarray(img), ((0, 0), (0, 0), (2, 2)), mode="edge")
        ref = sum(i[:, :, k : k + 16] for k in range(5)) / 5.0
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)

    def test_nonuniform_if(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            if (c.r > 0.5) {
                c.g = 1.0;
            } else {
                c.g = 0.0;
            }
            imageStore(output_image, pos, c);
        """)
        i = np.asarray(img)
        ref = i.copy()
        ref[1] = (i[0] > 0.5).astype(np.float32)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)

    def test_nonuniform_early_return(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            if (pos.x < 4) {
                imageStore(output_image, pos, vec4(1.0));
                return;
            }
            imageStore(output_image, pos, c * 0.5);
        """)
        i = np.asarray(img)
        o = np.asarray(out)
        np.testing.assert_allclose(o[:, :, :4], 1.0, atol=1e-6)
        np.testing.assert_allclose(o[:, :, 4:], i[:, :, 4:] * 0.5, atol=1e-6)

    def test_ternary(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r > c.g ? c.r : c.g;
            imageStore(output_image, pos, vec4(v, v, v, 1.0));
        """)
        i = np.asarray(img)
        np.testing.assert_allclose(np.asarray(out)[0], np.maximum(i[0], i[1]), atol=1e-6)

    def test_while_and_break(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            int i = 0;
            float acc = 0.0;
            while (true) {
                if (i >= 4) { break; }
                acc += 0.125;
                i++;
            }
            imageStore(output_image, pos, vec4(acc, 0.0, 0.0, 1.0));
        """)
        np.testing.assert_allclose(np.asarray(out)[0], 0.5, atol=1e-6)

    def test_user_function_with_out_param(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float lo; float hi;
            minmax(c.r, c.g, lo, hi);
            imageStore(output_image, pos, vec4(lo, hi, 0.0, 1.0));
        """, extra_decls="""
            void minmax(float a, float b, out float lo, out float hi) {
                lo = min(a, b);
                hi = max(a, b);
            }
        """)
        i = np.asarray(img)
        np.testing.assert_allclose(np.asarray(out)[0], np.minimum(i[0], i[1]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(out)[1], np.maximum(i[0], i[1]), atol=1e-6)

    def test_function_early_returns(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, vec4(classify(c.r), 0.0, 0.0, 1.0));
        """, extra_decls="""
            float classify(float v) {
                if (v < 0.25) { return 0.0; }
                if (v < 0.75) { return 0.5; }
                return 1.0;
            }
        """)
        i = np.asarray(img)[0]
        ref = np.where(i < 0.25, 0.0, np.where(i < 0.75, 0.5, 1.0))
        np.testing.assert_allclose(np.asarray(out)[0], ref, atol=1e-6)

    def test_array_weights(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(input_image);
            float w[3] = float[](0.25, 0.5, 0.25);
            vec4 acc = vec4(0.0);
            for (int d = -1; d <= 1; d++) {
                ivec2 p = clamp(pos + ivec2(0, d), ivec2(0), size - ivec2(1));
                acc += imageLoad(input_image, p) * w[d + 1];
            }
            imageStore(output_image, pos, acc);
        """)
        i = np.pad(np.asarray(img), ((0, 0), (1, 1), (0, 0)), mode="edge")
        ref = 0.25 * i[:, :-2] + 0.5 * i[:, 1:-1] + 0.25 * i[:, 2:]
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


class TestGather:
    def test_mirror_flip_via_gather(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(input_image);
            vec4 c = imageLoad(input_image, ivec2(size.x - 1 - pos.x, pos.y));
            imageStore(output_image, pos, c);
        """)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(img)[:, :, ::-1], atol=1e-6
        )

    def test_gather_marks_unshardable(self):
        src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    imageStore(output_image, pos,
               imageLoad(input_image, ivec2(size.x - 1 - pos.x, pos.y)));
}
"""
        spec = translate_shader(src, "mirror")
        assert spec.halo_for({}) is None

    def test_shift_halo_reflection(self):
        src = HEADER + """
layout(binding=2) uniform U { int radius; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 acc = vec4(0.0);
    for (int d = -radius; d <= radius; d++) {
        acc += imageLoad(input_image, pos + ivec2(d, 0));
    }
    imageStore(output_image, pos, acc);
}
"""
        spec = translate_shader(src, "blur1d")
        assert spec.halo_for({"radius": 5}) == 5
        assert spec.halo_for({"radius": 9}) == 9

    def test_imagesize_derived_offset_marks_unshardable(self):
        # An offset derived from imageSize() probes small on the fixed
        # reflection grid but is image-scale at real resolution; the probe
        # taints imageSize so such shaders take the gather (halo=None) path
        # instead of silently reading halo padding under --shard.
        src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    imageStore(output_image, pos,
               imageLoad(input_image, pos + ivec2(0, size.y / 2)));
}
"""
        spec = translate_shader(src, "half_shift")
        assert spec.halo_for({}) is None
        # But the shader still executes correctly single-device.
        img = jnp.zeros((4, 8, 8), jnp.float32).at[:, 6, :].set(1.0)
        ctx = KernelContext(width=8, height=8)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        np.testing.assert_allclose(out[:, 2, :], 1.0)


class TestReflection:
    def test_multi_image_bindings(self):
        src = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform readonly image2D input_image2;
layout (binding = 2, rgba32f) uniform writeonly image2D output_image;
layout (binding = 3) uniform Blend { float factor; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    vec4 a = imageLoad(input_image, p);
    vec4 b = imageLoad(input_image2, p);
    imageStore(output_image, p, mix(a, b, factor));
}
"""
        spec = translate_shader(src, "blend2")
        assert spec.images_in == ("input_image", "input_image2")
        assert spec.images_out == ("output_image",)
        assert list(spec.params) == ["factor"]

        a = jnp.zeros((4, 8, 8), jnp.float32)
        b = jnp.ones((4, 8, 8), jnp.float32)
        ctx = KernelContext(width=8, height=8)
        out = spec(ctx, {"input_image": a, "input_image2": b},
                   spec.resolve_params({"factor": 0.25}))["output_image"]
        np.testing.assert_allclose(np.asarray(out), 0.25, atol=1e-6)

    def test_direction_from_usage_without_qualifiers(self):
        src = """
#version 450
layout (local_size_x = 8, local_size_y = 8) in;
layout (binding = 0, rgba8) uniform image2D input_image;
layout (binding = 1, rgba8) uniform image2D output_image;
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, p, imageLoad(input_image, p));
}
"""
        spec = translate_shader(src, "noqual")
        assert spec.images_in == ("input_image",)
        assert spec.images_out == ("output_image",)


class TestErrors:
    def test_uniform_coord_store_scatters(self):
        # Every invocation writing ivec2(0,0) is a scatter with an
        # arbitrary winner; the rest of the image keeps prior contents.
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            imageStore(output_image, ivec2(0, 0), vec4(1.0));
        """)
        got = np.asarray(out)
        assert got[0, 0, 0] == 1.0
        assert (got[:3, 1:, :] == 0.0).all() and (got[:3, 0, 1:] == 0.0).all()

    def test_data_dependent_loop_vectorizes(self):
        # Formerly rejected; now lowers to a per-pixel while_loop.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec4 acc = vec4(0.0);
            for (int i = 0; i < int(c.r * 10.0); i++) { acc += c; }
            imageStore(output_image, pos, acc);
        """)
        got = np.asarray(out)
        im = np.asarray(img)
        counts = (im[0] * 10.0).astype(np.int32).astype(np.float32)
        for ch in range(4):
            np.testing.assert_allclose(got[ch], counts * im[ch], atol=1e-5)

    def test_syntax_error_has_line(self):
        src = HEADER + "void main() {\n    vec4 c = ;\n}\n"
        with pytest.raises(GlslError) as exc:
            translate_shader(src, "bad")
        assert exc.value.line is not None

    def test_unknown_function(self):
        with pytest.raises(GlslError, match="unknown function"):
            run_shader("""
                ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
                imageStore(output_image, pos, bogus(vec4(1.0)));
            """)

    def test_no_output_binding_rejected(self):
        src = """
#version 450
layout (local_size_x = 8, local_size_y = 8) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
void main() { vec4 c = imageLoad(input_image, ivec2(gl_GlobalInvocationID.xy)); }
"""
        with pytest.raises(GlslError, match="never stores"):
            translate_shader(src, "nostore")

    def test_unwritten_writeonly_image_yields_zeros(self):
        # Declared-but-unwritten output image: contents are zeros (the
        # Vulkan analog is undefined contents; zeros is the defined choice).
        src = HEADER + "void main() { vec4 c = vec4(1.0); }\n"
        spec = translate_shader(src, "noop")
        ctx = KernelContext(width=4, height=4)
        img = jnp.ones((4, 4, 4), jnp.float32)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        np.testing.assert_array_equal(np.asarray(out), 0.0)


class TestRealWorldShaders:
    def test_separable_gaussian_two_kernels(self):
        """A realistic two-image shader: gaussian weights computed in-shader."""
        src = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform UBO { float sigma; };

void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    int radius = int(ceil(3.0 * sigma));
    float total = 0.0;
    vec3 acc = vec3(0.0);
    for (int d = -radius; d <= radius; d++) {
        float w = exp(-0.5 * float(d * d) / (sigma * sigma));
        ivec2 p = clamp(pos + ivec2(d, 0), ivec2(0), size - ivec2(1));
        acc += imageLoad(input_image, p).rgb * w;
        total += w;
    }
    imageStore(output_image, pos, vec4(acc / total, 1.0));
}
"""
        spec = translate_shader(src, "gauss_h")
        assert spec.halo_for(spec.resolve_params({"sigma": 2.0})) == 6
        rng = np.random.default_rng(1)
        img = jnp.asarray(rng.random((4, 10, 20), dtype=np.float32))
        ctx = KernelContext(width=20, height=10)
        out = spec(ctx, {"input_image": img}, spec.resolve_params({"sigma": 2.0}))[
            "output_image"
        ]
        # numpy reference
        r = 6
        xs = np.arange(-r, r + 1)
        w = np.exp(-0.5 * xs**2 / 4.0)
        i = np.pad(np.asarray(img)[:3], ((0, 0), (0, 0), (r, r)), mode="edge")
        ref = sum(w[k] * i[:, :, k : k + 20] for k in range(2 * r + 1)) / w.sum()
        np.testing.assert_allclose(np.asarray(out)[:3], ref, atol=1e-5)

    def test_jit_compiles_and_fuses(self):
        """The interpreter output must be jittable end to end."""
        import jax

        src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, pos, 1.0 - c);
}
"""
        spec = translate_shader(src, "inv")
        ctx = KernelContext(width=16, height=12)

        @jax.jit
        def f(img):
            return spec(ctx, {"input_image": img}, {})["output_image"]

        img = jnp.full((4, 12, 16), 0.25, jnp.float32)
        np.testing.assert_allclose(np.asarray(f(img)), 0.75, atol=1e-6)


class TestMatricesAndSamplers:
    def test_mat3_color_matrix(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            mat3 sepia = mat3(
                0.393, 0.349, 0.272,
                0.769, 0.686, 0.534,
                0.189, 0.168, 0.131
            );
            vec3 graded = sepia * c.rgb;
            imageStore(output_image, pos, vec4(graded, c.a));
        """)
        i = np.asarray(img)
        m = np.array([[0.393, 0.769, 0.189],
                      [0.349, 0.686, 0.168],
                      [0.272, 0.534, 0.131]], np.float32)
        ref = np.einsum("ij,jhw->ihw", m, i[:3])
        np.testing.assert_allclose(np.asarray(out)[:3], ref, atol=1e-5)

    def test_mat2_rotation_and_ops(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            mat2 ident = mat2(1.0);
            mat2 twice = ident * 2.0;
            vec2 v = twice * vec2(c.r, c.g);
            mat2 t = transpose(mat2(1.0, 2.0, 3.0, 4.0));
            imageStore(output_image, pos, vec4(v, t[0][1], 1.0));
        """)
        i = np.asarray(img)
        o = np.asarray(out)
        np.testing.assert_allclose(o[0], 2.0 * i[0], atol=1e-6)
        np.testing.assert_allclose(o[1], 2.0 * i[1], atol=1e-6)
        # transpose of column-major [[1,2],[3,4]] -> t[0] = (1,3); t[0][1]=3
        np.testing.assert_allclose(o[2], 3.0, atol=1e-6)

    def test_mat_mat_multiply(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            mat2 a = mat2(1.0, 2.0, 3.0, 4.0);
            mat2 b = mat2(5.0, 6.0, 7.0, 8.0);
            mat2 c = a * b;
            imageStore(output_image, pos, vec4(c[0][0], c[0][1], c[1][0], c[1][1]));
        """)
        o = np.asarray(out)
        # column-major: a = [[1,3],[2,4]] (rows), b = [[5,7],[6,8]]
        # c = a@b = [[23,31],[34,46]] -> cols: c[0]=(23,34), c[1]=(31,46)
        np.testing.assert_allclose(o[0, 0, 0], 23.0, atol=1e-5)
        np.testing.assert_allclose(o[1, 0, 0], 34.0, atol=1e-5)
        np.testing.assert_allclose(o[2, 0, 0], 31.0, atol=1e-5)
        np.testing.assert_allclose(o[3, 0, 0], 46.0, atol=1e-5)

    def test_sampler2d_texture_bilinear(self):
        src = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0) uniform sampler2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = textureSize(input_image, 0);
    vec2 uv = (vec2(pos) + 0.5) / vec2(size);
    imageStore(output_image, pos, texture(input_image, uv));
}
"""
        spec = translate_shader(src, "texid")
        assert spec.images_in == ("input_image",)
        rng = np.random.default_rng(5)
        img = jnp.asarray(rng.random((4, 12, 16), np.float32))
        ctx = KernelContext(width=16, height=12)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        # Sampling at exact pixel centers reproduces the image.
        np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)
        assert spec.halo_for({}) is None  # texture() is a gather

    def test_texture_zoom(self):
        src = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0) uniform sampler2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform U { float zoom; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = textureSize(input_image, 0);
    vec2 uv = (vec2(pos) + 0.5) / vec2(size);
    vec2 centered = (uv - 0.5) / zoom + 0.5;
    imageStore(output_image, pos, texture(input_image, centered));
}
"""
        spec = translate_shader(src, "zoom")
        img = jnp.asarray(np.random.default_rng(0).random((4, 16, 16), np.float32))
        ctx = KernelContext(width=16, height=16)
        out = spec(ctx, {"input_image": img}, spec.resolve_params({"zoom": 2.0}))[
            "output_image"
        ]
        assert np.isfinite(np.asarray(out)).all()


class TestFragmentShaders:
    FRAG = """
#version 450
layout (binding = 0) uniform sampler2D input_image;
layout (location = 0) in vec2 uv;
layout (location = 0) out vec4 out_color;
void main() {
    vec4 c = texture(input_image, uv);
    out_color = vec4(1.0 - c.rgb, c.a);
}
"""

    def test_frag_invert(self):
        spec = translate_shader(self.FRAG, "inv", path="inv.frag")
        assert spec.images_out == ("output_image",)
        assert spec.images_in == ("input_image",)
        img = jnp.asarray(np.random.default_rng(0).random((4, 12, 16), np.float32))
        ctx = KernelContext(width=16, height=12)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        np.testing.assert_allclose(
            np.asarray(out)[:3], 1.0 - np.asarray(img)[:3], atol=1e-5
        )
        np.testing.assert_allclose(np.asarray(out)[3], np.asarray(img)[3], atol=1e-5)

    def test_frag_fragcoord_shifted_load(self):
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
out vec4 color;
void main() {
    ivec2 pos = ivec2(gl_FragCoord.xy);
    color = imageLoad(input_image, pos + ivec2(1, 0));
}
"""
        spec = translate_shader(src, "sh", path="sh.frag")
        img = jnp.asarray(np.random.default_rng(1).random((4, 10, 12), np.float32))
        ctx = KernelContext(width=12, height=10)
        out = np.asarray(spec(ctx, {"input_image": img}, {})["output_image"])
        ref = np.zeros_like(np.asarray(img))
        ref[:, :, :-1] = np.asarray(img)[:, :, 1:]
        np.testing.assert_allclose(out, ref, atol=1e-6)
        # The shifted load stayed on the pad+slice path (finite halo).
        assert spec.halo_for({}) == 1

    def test_frag_in_engine(self, tmp_path):
        (tmp_path / "tint.frag").write_text("""
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
out vec4 color;
void main() {
    vec4 c = imageLoad(input_image, ivec2(gl_FragCoord.xy));
    color = vec4(c.r, c.g * 0.5, c.b * 0.25, c.a);
}
""")
        from reforge_tpu.engine import Engine, RenderInfo

        eng = Engine(RenderInfo(width=16, height=12,
                                shader_file_path=str(tmp_path / "tint.frag"),
                                has_input_image=True))
        rgba = np.random.default_rng(2).integers(0, 256, (12, 16, 4), np.uint8)
        eng.load_input(rgba)
        out = np.asarray(eng.render_frame_blocking(0.0))
        inp = np.asarray(eng._input_planar)
        np.testing.assert_allclose(out[1], inp[1] * 0.5, atol=1e-6)


class TestStructs:
    def test_struct_locals_and_functions(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            Light l = Light(vec3(1.0, 0.5, 0.25), 2.0);
            l.intensity = l.intensity * 0.5;
            vec3 lit = apply(l, c.rgb);
            imageStore(output_image, pos, vec4(lit, c.a));
        """, extra_decls="""
            struct Light { vec3 color; float intensity; };
            vec3 apply(Light l, vec3 base) {
                return base * l.color * l.intensity;
            }
        """)
        i = np.asarray(img)
        ref = i[:3] * np.array([1.0, 0.5, 0.25])[:, None, None] * 1.0
        np.testing.assert_allclose(np.asarray(out)[:3], ref, atol=1e-5)

    def test_struct_masked_assignment(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            P p = P(0.0);
            if (c.r > 0.5) { p.v = 1.0; }
            imageStore(output_image, pos, vec4(p.v, 0.0, 0.0, 1.0));
        """, extra_decls="struct P { float v; };")
        i = np.asarray(img)
        np.testing.assert_allclose(
            np.asarray(out)[0], (i[0] > 0.5).astype(np.float32), atol=1e-6
        )

    def test_nested_ubo_struct_params(self):
        """outer.inner config addressing (pipeline_graph.rs:284-291 analog)."""
        src = HEADER + """
struct Tint { float r; float g; float b; };
layout(binding=2) uniform UBO {
    Tint tint;
    float gain;
};
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, pos,
               vec4(c.r * tint.r * gain, c.g * tint.g * gain, c.b * tint.b * gain, c.a));
}
"""
        spec = translate_shader(src, "tinted")
        assert set(spec.params) == {"tint.r", "tint.g", "tint.b", "gain"}
        img = jnp.full((4, 8, 8), 0.5, jnp.float32)
        ctx = KernelContext(width=8, height=8)
        params = spec.resolve_params({"tint.r": 1.0, "tint.g": 0.5, "tint.b": 0.25,
                                      "gain": 2.0})
        out = np.asarray(spec(ctx, {"input_image": img}, params)["output_image"])
        np.testing.assert_allclose(out[0], 1.0, atol=1e-6)
        np.testing.assert_allclose(out[1], 0.5, atol=1e-6)
        np.testing.assert_allclose(out[2], 0.25, atol=1e-6)

    def test_dotted_params_from_config(self, tmp_path):
        from reforge_tpu.config import parse

        cfg = parse(
            "input -> tinted -> output\n"
            "tinted: tinted { tint.r: 2.0, gain: 1.5 }\n",
            expects_input=True,
        )
        assert cfg.parameters_of("tinted")["tint.r"].value == 2.0

    def test_nested_rf_time(self):
        src = HEADER + """
struct Clock { float _rf_time; };
layout(binding=2) uniform UBO { Clock clk; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, pos, vec4(clk._rf_time, 0.0, 0.0, 1.0));
}
"""
        spec = translate_shader(src, "clocked")
        ctx = KernelContext(width=8, height=8, time=0.625)
        out = spec(ctx, {"input_image": jnp.zeros((4, 8, 8))}, {})["output_image"]
        np.testing.assert_allclose(np.asarray(out)[0], 0.625, atol=1e-6)


class TestSwitchAndDoWhile:
    def test_uniform_switch_modes(self):
        decls = "layout(binding=2) uniform U { int mode; };"
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec3 outc;
            switch (mode) {
                case 0: outc = c.rgb; break;
                case 1: outc = 1.0 - c.rgb; break;
                case 2:
                case 3: outc = c.rgb * 0.5; break;
                default: outc = vec3(1.0, 0.0, 1.0); break;
            }
            imageStore(output_image, pos, vec4(outc, c.a));
        """
        img = jnp.full((4, 8, 8), 0.4, jnp.float32)
        for mode, expect in [(0, 0.4), (1, 0.6), (2, 0.2), (3, 0.2), (9, None)]:
            out, _ = run_shader(body, img=img, h=8, w=8, extra_decls=decls,
                                params={"mode": mode})
            o = np.asarray(out)
            if expect is not None:
                np.testing.assert_allclose(o[0], expect, atol=1e-6)
            else:
                np.testing.assert_allclose(o[0], 1.0, atol=1e-6)  # magenta
                np.testing.assert_allclose(o[1], 0.0, atol=1e-6)

    def test_switch_fallthrough(self):
        decls = "layout(binding=2) uniform U { int mode; };"
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float acc = 0.0;
            switch (mode) {
                case 0: acc += 1.0;
                case 1: acc += 2.0;
                case 2: acc += 4.0; break;
                case 3: acc += 8.0;
            }
            imageStore(output_image, pos, vec4(acc, 0.0, 0.0, 1.0));
        """
        for mode, expect in [(0, 7.0), (1, 6.0), (2, 4.0), (3, 8.0), (5, 0.0)]:
            out, _ = run_shader(body, extra_decls=decls, params={"mode": mode})
            np.testing.assert_allclose(np.asarray(out)[0], expect, atol=1e-6)

    def test_nonuniform_switch_vectorizes(self):
        # Per-pixel selector lowers to a masked if-chain (the reference GPU
        # executes divergent switches natively; command.rs dispatches SIMT).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 4.0)) {
                case 0: v = 0.1; break;
                case 1: v = 0.3; break;
                case 2:
                case 3: v = 0.6; break;
                default: v = 0.9; break;
            }
            imageStore(output_image, pos, vec4(v, c.gba));
        """)
        i = np.asarray(img)
        sel = (i[0] * 4.0).astype(np.int32)
        ref = np.select(
            [sel == 0, sel == 1, (sel == 2) | (sel == 3)],
            [0.1, 0.3, 0.6],
            default=0.9,
        )
        np.testing.assert_allclose(np.asarray(out)[0], ref, atol=1e-6)

    def test_nonuniform_switch_fallthrough(self):
        # No break on case 1: pixels entering there also run case 2's body.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 3.0)) {
                case 0: v += 0.125; break;
                case 1: v += 0.25;
                case 2: v += 0.5; break;
            }
            imageStore(output_image, pos, vec4(v, c.gba));
        """)
        i = np.asarray(img)
        sel = (i[0] * 3.0).astype(np.int32)
        ref = np.select(
            [sel == 0, sel == 1, sel == 2], [0.125, 0.75, 0.5], default=0.0
        )
        np.testing.assert_allclose(np.asarray(out)[0], ref, atol=1e-6)

    def test_nonuniform_switch_midcase_break(self):
        # A non-tail `break` under a per-pixel `if` kills the lane for
        # the switch's remainder only.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 2.0)) {
                case 0:
                    if (c.g > 0.5) { break; }
                    v = 1.0;
                    break;
                default:
                    v = 2.0;
                    break;
            }
            imageStore(output_image, pos, vec4(v, c.gba));
        """)
        a = np.asarray(img)
        case0 = (a[0] * 2.0).astype(np.int32) == 0
        want = np.where(case0, np.where(a[1] > 0.5, 0.0, 1.0), 2.0)
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_nonuniform_switch_midcase_break_fallthrough(self):
        # Broken lanes must not fall through; unbroken lanes of case 0
        # fall into case 1.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 2.0)) {
                case 0:
                    if (c.g > 0.5) { break; }
                    v = 1.0;
                case 1:
                    v += 4.0;
                    break;
            }
            imageStore(output_image, pos, vec4(v, c.gba));
        """)
        a = np.asarray(img)
        sel = (a[0] * 2.0).astype(np.int32)
        broke = (sel == 0) & (a[1] > 0.5)
        want = np.where(
            broke, 0.0,
            np.where(sel == 0, 5.0, np.where(sel == 1, 4.0, 0.0)),
        )
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_nonuniform_switch_return_in_case(self):
        # `return` inside a per-pixel switch case exits the function for
        # those lanes (forwarded through the switch region).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, classify(c));
        """, extra_decls="""
            vec4 classify(vec4 c) {
                switch (int(c.r * 3.0)) {
                    case 0:
                        if (c.g > 0.5) { return vec4(9.0); }
                        break;
                    case 1:
                        return vec4(7.0);
                }
                return vec4(c.r, 0.0, 0.0, 1.0);
            }
        """)
        a = np.asarray(img)
        sel = (a[0] * 3.0).astype(np.int32)
        want = np.where(
            (sel == 0) & (a[1] > 0.5), 9.0,
            np.where(sel == 1, 7.0, a[0]),
        )
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_do_while(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            int i = 0;
            float acc = 0.0;
            do {
                acc += 0.25;
                i++;
            } while (i < 3);
            imageStore(output_image, pos, vec4(acc, 0.0, 0.0, 1.0));
        """)
        np.testing.assert_allclose(np.asarray(out)[0], 0.75, atol=1e-6)

    def test_nested_loop_break_in_masked_switch_case(self):
        # A `break` belonging to a nested static loop inside a per-pixel
        # switch case must bind to the LOOP, not the switch (advisor
        # round-4 high finding: the lane was silently killed for the case
        # remainder, skipping `v += 10.0`).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 2.0)) {
                case 0:
                    for (int i = 0; i < 3; i++) { v = 1.0; break; }
                    v += 10.0;
                    break;
                default:
                    v = 5.0;
                    break;
            }
            imageStore(output_image, pos, vec4(v, 0.0, 0.0, 1.0));
        """)
        a = np.asarray(img)
        sel = (a[0] * 2.0).astype(np.int32)
        want = np.where(sel == 0, 11.0, 5.0)
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_do_once_while_true_in_masked_switch_case(self):
        # The while(true){...break;} do-once idiom inside a per-pixel
        # switch case: the break must terminate the loop after ONE round
        # (the mis-bound version ran to the unroll limit).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            switch (int(c.r * 2.0)) {
                case 0: {
                    int n = 0;
                    while (true) { n += 1; break; }
                    v = float(n);
                    break;
                }
                default:
                    v = 9.0;
                    break;
            }
            imageStore(output_image, pos, vec4(v, 0.0, 0.0, 1.0));
        """)
        a = np.asarray(img)
        sel = (a[0] * 2.0).astype(np.int32)
        want = np.where(sel == 0, 1.0, 9.0)
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)


class TestReviewRegressions:
    def test_store_inside_switch_reflects(self):
        """Reflection must see stores under switch (finding: walker skipped
        tuple-structured Switch.cases)."""
        src = HEADER + """
layout(binding=2) uniform U { int mode; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    switch (mode) {
        default: imageStore(output_image, pos, 1.0 - c); break;
    }
}
"""
        spec = translate_shader(src, "swstore")
        assert spec.images_out == ("output_image",)
        img = jnp.full((4, 8, 8), 0.25, jnp.float32)
        ctx = KernelContext(width=8, height=8)
        out = spec(ctx, {"input_image": img}, spec.resolve_params({"mode": 0}))[
            "output_image"
        ]
        np.testing.assert_allclose(np.asarray(out), 0.75, atol=1e-6)

    def test_ternary_side_effects_masked(self):
        """atomicAdd inside ?: branches must be lane-predicated."""
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1) buffer Bins { float counts[2]; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float u = (c.r > 0.5) ? atomicAdd(counts[0], 1.0) : atomicAdd(counts[1], 1.0);
}
"""
        spec = translate_shader(src, "terncount")
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        ctx = KernelContext(width=8, height=8)
        bins = np.asarray(spec(ctx, {"input_image": img}, {})["Bins"])
        n_hi = int((np.asarray(img)[0] > 0.5).sum())
        assert bins[0] == n_hi
        assert bins[1] == 64 - n_hi

    def test_octal_int_literals(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            int x = 010;           // octal 8
            imageStore(output_image, pos, vec4(float(x) / 16.0, 0.0, 0.0, 1.0));
        """)
        np.testing.assert_allclose(np.asarray(out)[0], 0.5, atol=1e-6)

    def test_bad_octal_literal_diagnostic(self):
        with pytest.raises(GlslError, match="invalid integer literal"):
            run_shader("""
                ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
                int x = 08;
                imageStore(output_image, pos, vec4(float(x)));
            """)


class TestForiLoopLowering:
    """Long uniform loops lower to lax.fori_loop (interp._try_exec_for_scan);
    everything else falls back to unrolling. Reference unrolls on the GPU via
    the driver compiler; this is our compile-time-bounding equivalent."""

    @staticmethod
    def _spy(monkeypatch):
        from reforge_tpu.glsl.interp import Interp

        calls = []
        orig = Interp._try_exec_for_scan

        def wrapper(self, s, scope):
            r = orig(self, s, scope)
            calls.append(r)
            return r

        monkeypatch.setattr(Interp, "_try_exec_for_scan", wrapper)
        return calls

    BODY_SUM = """
        ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, pos);
        float acc = 0.0;
        for (int i = 0; i < 24; i++) {
            acc += sin(c.r + float(i) * 0.1);
        }
        imageStore(output_image, pos, vec4(acc * 0.01, c.gba));
    """

    def test_lowered_matches_unrolled(self, monkeypatch):
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "0")
        unrolled, _ = run_shader(self.BODY_SUM, img=img, h=8, w=8)
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        lowered, _ = run_shader(self.BODY_SUM, img=img, h=8, w=8)
        assert any(calls), "loop was not lowered"
        np.testing.assert_allclose(
            np.asarray(lowered), np.asarray(unrolled), atol=1e-6
        )

    def test_masked_accumulate_stabilizes_carry(self, monkeypatch):
        # The equalize.comp pattern: scalar accumulator becomes (H, W) after
        # the first masked add inside a non-uniform if.
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            int bin = clamp(int(c.r * 15.0), 0, 15);
            float below = 0.0;
            for (int i = 0; i < 16; i++) {
                if (i <= bin) {
                    below += 0.0625;
                }
            }
            imageStore(output_image, pos, vec4(below, c.gba));
        """
        rng = np.random.default_rng(4)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "0")
        unrolled, _ = run_shader(body, img=img, h=8, w=8)
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        lowered, _ = run_shader(body, img=img, h=8, w=8)
        assert any(calls), "loop was not lowered"
        np.testing.assert_allclose(
            np.asarray(lowered), np.asarray(unrolled), atol=1e-6
        )

    def test_pure_callee_in_long_loop_lowers(self, monkeypatch):
        # A pure-compute helper call no longer forces unrolling: the fori
        # lowering admits callees whose effect summary is empty.
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float acc = 0.0;
            for (int i = 0; i < 24; i++) {
                acc += warp(c.r + float(i) * 0.1);
            }
            imageStore(output_image, pos, vec4(acc * 0.01, c.gba));
        """
        decls = "float warp(float x) { return sin(x) * 0.9 + 0.05; }\n"
        rng = np.random.default_rng(9)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "0")
        unrolled, _ = run_shader(body, img=img, h=8, w=8, extra_decls=decls)
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        lowered, _ = run_shader(body, img=img, h=8, w=8, extra_decls=decls)
        assert any(calls), "loop with pure callee was not lowered"
        np.testing.assert_allclose(
            np.asarray(lowered), np.asarray(unrolled), atol=1e-6
        )

    def test_side_effect_callee_in_long_loop_falls_back(self, monkeypatch):
        # A callee with effects (global write) has no fori carry: the
        # lowering must decline (unrolled execution stays correct).
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            g_s = 0.0;
            for (int i = 0; i < 24; i++) {
                bump(c.r);
            }
            imageStore(output_image, pos, vec4(g_s * 0.01, c.gba));
        """
        decls = "float g_s;\nvoid bump(float x) { g_s += x; }\n"
        rng = np.random.default_rng(10)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        out, _ = run_shader(body, img=img, h=8, w=8, extra_decls=decls)
        assert calls and not any(calls), "effectful callee must not lower"
        want = np.asarray(img)[0] * 24 * 0.01
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-5)

    def test_image_store_in_loop_falls_back(self, monkeypatch):
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            for (int i = 0; i < 16; i++) {
                imageStore(output_image, pos, vec4(c.rgb * float(i) / 15.0, c.a));
            }
        """
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        out, img = run_shader(body, h=8, w=8)
        assert calls and not any(calls), "side-effecting loop must unroll"
        np.testing.assert_allclose(
            np.asarray(out)[:3], np.asarray(img)[:3], atol=1e-6
        )

    def test_break_in_loop_falls_back(self, monkeypatch):
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float acc = 0.0;
            for (int i = 0; i < 32; i++) {
                if (i == 10) { break; }
                acc += 0.1;
            }
            imageStore(output_image, pos, vec4(acc, c.gba));
        """
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        out, _ = run_shader(body, h=8, w=8)
        assert calls and not any(calls), "break must force unrolling"
        np.testing.assert_allclose(np.asarray(out)[0], 1.0, atol=1e-6)

    def test_body_local_shadow_not_written_back(self, monkeypatch):
        # `float t` inside the body shadows the outer `t`; the lowered loop
        # must not leak the body-local value into the enclosing scope.
        body = """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float t = 0.25;
            float acc = 0.0;
            for (int i = 0; i < 16; i++) {
                float t = float(i) * 100.0;
                acc += t * 0.001;
            }
            imageStore(output_image, pos, vec4(t, acc * 0.1, 0.0, c.a));
        """
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "8")
        calls = self._spy(monkeypatch)
        out, _ = run_shader(body, h=8, w=8)
        assert any(calls), "loop was not lowered"
        np.testing.assert_allclose(np.asarray(out)[0], 0.25, atol=1e-6)
        np.testing.assert_allclose(np.asarray(out)[1], 1.2, atol=1e-5)

    def test_equalize_shader_matches_both_paths(self, monkeypatch):
        import pathlib

        src = (
            pathlib.Path(__file__).resolve().parent.parent
            / "shaders" / "equalize.comp"
        ).read_text()
        spec = translate_shader(src, "equalize")
        rng = np.random.default_rng(5)
        img = jnp.asarray(rng.random((4, 12, 16), dtype=np.float32))
        hist = jnp.asarray(rng.random(256, dtype=np.float32))
        ctx = KernelContext(width=16, height=12)
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "0")
        unrolled = spec(ctx, {"input_image": img, "Bins": hist}, {})
        monkeypatch.setenv("REFORGE_SCAN_THRESHOLD", "64")
        lowered = spec(ctx, {"input_image": img, "Bins": hist}, {})
        np.testing.assert_allclose(
            np.asarray(lowered["output_image"]),
            np.asarray(unrolled["output_image"]),
            atol=1e-6,
        )


class TestLengthMethod:
    """GLSL .length() method on SSBO arrays, local arrays, vectors, matrices
    (reference compiles via shaderc which accepts it natively; shader.rs:41-59)."""

    def test_lengths(self):
        shader = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) readonly buffer B { float lut[64]; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float arr[3] = float[](0.1, 0.2, 0.3);
    mat3 m3 = mat3(1.0);
    imageStore(output_image, pos, vec4(
        float(lut.length()) / 64.0,
        float(arr.length()) / 3.0,
        float(c.rgb.length()) / 3.0,
        float(m3.length()) / 3.0));
}"""
        spec = translate_shader(shader, "lentest")
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        ctx = KernelContext(width=8, height=8)
        out = np.asarray(
            spec(ctx, {"input_image": img, "B": jnp.zeros(64)}, {})["output_image"]
        )
        np.testing.assert_allclose(out, 1.0, atol=1e-6)

    def test_unknown_method_diagnostic(self):
        with pytest.raises(GlslError, match="unknown method"):
            run_shader("""
                vec4 c = imageLoad(input_image, ivec2(gl_GlobalInvocationID.xy));
                float x = c.rgb.size();
                imageStore(output_image, ivec2(gl_GlobalInvocationID.xy), vec4(x));
            """)


class TestJaxprStructure:
    """Structural (jaxpr-level) guarantees from SURVEY §4: constant-offset
    imageLoads must lower to pad+slice — no gather primitive — because a
    gather at 4K costs far more memory traffic; arbitrary coordinate math
    legitimately gathers."""

    @staticmethod
    def _jaxpr_of(body):
        import jax

        src = HEADER + "\nvoid main() {\n" + body + "\n}\n"
        spec = translate_shader(src, "structure")
        ctx = KernelContext(width=16, height=12)
        img = jnp.zeros((4, 12, 16), jnp.float32)
        return str(jax.make_jaxpr(lambda v: spec(ctx, {"input_image": v}, {}))(img))

    def test_static_shift_is_gather_free(self):
        txt = self._jaxpr_of("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 a = imageLoad(input_image, pos + ivec2(1, 0));
            vec4 b = imageLoad(input_image, pos - ivec2(0, 2));
            imageStore(output_image, pos, a + b);
        """)
        assert "gather" not in txt

    def test_clamped_shift_is_gather_free(self):
        txt = self._jaxpr_of("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(input_image);
            ivec2 p = clamp(pos + ivec2(2, 1), ivec2(0), size - ivec2(1));
            imageStore(output_image, pos, imageLoad(input_image, p));
        """)
        assert "gather" not in txt

    def test_arbitrary_coords_do_gather(self):
        txt = self._jaxpr_of("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(input_image);
            vec4 c = imageLoad(input_image, ivec2(size.x - 1 - pos.x, pos.y));
            imageStore(output_image, pos, c);
        """)
        assert "gather" in txt


class TestUintSemantics:
    """32-bit unsigned semantics: literals above 2^31, wraparound math,
    int<->uint reinterpretation — the PCG-hash idiom every noise shader
    uses (the reference compiles these natively via shaderc)."""

    def test_pcg_hash(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            uint h = uint(pos.x) * 747796405u + 2891336453u;
            h = ((h >> ((h >> 28u) + 4u)) ^ h) * 277803737u;
            h = (h >> 22u) ^ h;
            imageStore(output_image, pos, vec4(float(h & 255u) / 255.0));
        """, h=2, w=16)
        x = np.arange(16, dtype=np.uint32)
        h = x * np.uint32(747796405) + np.uint32(2891336453)
        h = ((h >> ((h >> np.uint32(28)) + np.uint32(4))) ^ h) * np.uint32(277803737)
        h = (h >> np.uint32(22)) ^ h
        np.testing.assert_allclose(
            np.asarray(out)[0, 0, :], (h & 255) / 255.0, atol=1e-6
        )

    def test_wraparound_and_reinterpret(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            uint wrap = 4294967295u + 2u;    // 1
            int neg = int(3000000000u);      // -1294967296
            uint back = uint(-1);            // 4294967295
            imageStore(output_image, pos, vec4(
                float(wrap) / 2.0,
                float(neg < 0),
                float(back == 4294967295u),
                1.0));
        """, h=4, w=4)
        o = np.asarray(out)
        np.testing.assert_allclose(o[0], 0.5, atol=1e-6)
        np.testing.assert_allclose(o[1], 1.0, atol=1e-6)
        np.testing.assert_allclose(o[2], 1.0, atol=1e-6)

    def test_int_uint_mix_promotes(self):
        # GLSL usual conversions: int op uint -> uint.
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            int a = -1;
            uint b = 2u;
            imageStore(output_image, pos,
                       vec4(float((a + b) == 1u), 0.0, 0.0, 1.0));
        """, h=4, w=4)
        np.testing.assert_allclose(np.asarray(out)[0], 1.0, atol=1e-6)


class TestScreenDerivatives:
    """dFdx/dFdy/fwidth as whole-image forward differences (the GPU's
    quad-based derivatives are likewise neighbor differences)."""

    def test_derivatives_match_numpy(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, vec4(
                dFdx(c.r) + 0.5, dFdy(c.r) + 0.5, fwidth(c.r), dFdx(2.0)));
        """)
        i = np.asarray(img)[0]
        gx = np.pad(i[:, 1:], ((0, 0), (0, 1)), mode="edge") - i
        gy = np.pad(i[1:, :], ((0, 1), (0, 0)), mode="edge") - i
        o = np.asarray(out)
        np.testing.assert_allclose(o[0], gx + 0.5, atol=1e-6)
        np.testing.assert_allclose(o[1], gy + 0.5, atol=1e-6)
        np.testing.assert_allclose(o[2], np.abs(gx) + np.abs(gy), atol=1e-6)
        np.testing.assert_allclose(o[3], 0.0, atol=1e-6)  # uniform -> 0

    def test_derivative_registers_halo(self):
        src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, pos, vec4(fwidth(c.r)));
}
"""
        spec = translate_shader(src, "fw")
        assert spec.halo_for({}) == 1  # dFdy crosses the sharded row axis

    def test_vector_derivative(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec3 g = fwidth(c.rgb);
            imageStore(output_image, pos, vec4(g, 1.0));
        """)
        i = np.asarray(img)
        for ch in range(3):
            gx = np.pad(i[ch][:, 1:], ((0, 0), (0, 1)), mode="edge") - i[ch]
            gy = np.pad(i[ch][1:, :], ((0, 1), (0, 0)), mode="edge") - i[ch]
            np.testing.assert_allclose(
                np.asarray(out)[ch], np.abs(gx) + np.abs(gy), atol=1e-6
            )


class TestCPrecedence:
    """C operator-precedence gotchas must parse exactly as a GPU compiler
    would (shift below additive, right-associative ternary, unary binding)."""

    def test_precedence_gotchas(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            int a = 1 << 2 + 3;              // 1 << 5 = 32
            int b = (6 + 2) % 5 * 3;         // ((8 % 5) * 3) = 9
            int c = 2 + 3 << 1;              // (2 + 3) << 1 = 10
            float t = true ? 0.1 : false ? 0.2 : 0.3;  // 0.1
            int d = ~2 + 1;                  // (~2) + 1 = -2
            int f = -3 * 2;                  // -6
            imageStore(output_image, pos, vec4(
                float(a == 32 && b == 9 && c == 10 && d == -2 && f == -6),
                t, float(!false && true), 1.0));
        """, h=4, w=4)
        o = np.asarray(out)
        np.testing.assert_allclose(o[0], 1.0, atol=1e-6)
        np.testing.assert_allclose(o[1], 0.1, atol=1e-6)
        np.testing.assert_allclose(o[2], 1.0, atol=1e-6)


class TestSharedMemory:
    """Workgroup-shared arrays + barrier(): the tile-reduction idiom."""

    HIST_SHARED = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1) buffer Hist { float bins[16]; };
shared float local_hist[16];

void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    if (lid < 16u) {
        local_hist[lid] = 0.0;
    }
    barrier();
    vec4 c = imageLoad(input_image, pos);
    int bin = clamp(int(c.r * 16.0), 0, 15);
    atomicAdd(local_hist[bin], 1.0);
    barrier();
    if (lid < 16u) {
        atomicAdd(bins[lid], local_hist[lid]);
    }
}
"""

    HIST_GLOBAL = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1) buffer Hist { float bins[16]; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int bin = clamp(int(c.r * 16.0), 0, 15);
    atomicAdd(bins[bin], 1.0);
}
"""

    def test_shared_histogram_matches_global(self):
        spec_s = translate_shader(self.HIST_SHARED, "hist_shared")
        spec_g = translate_shader(self.HIST_GLOBAL, "hist_global")
        rng = np.random.default_rng(3)
        h, w = 32, 48  # multiples of local_size: all workgroups full
        img = jnp.asarray(rng.random((4, h, w), dtype=np.float32))
        ctx = KernelContext(width=w, height=h)
        got = np.asarray(spec_s(ctx, {"input_image": img}, {})["Hist"])
        want = np.asarray(spec_g(ctx, {"input_image": img}, {})["Hist"])
        np.testing.assert_array_equal(got, want)
        assert got.sum() == h * w

    def test_shared_plain_store_and_read(self):
        # One invocation per group writes; all invocations read it back.
        src = """
#version 450
layout (local_size_x = 8, local_size_y = 8) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
shared float corner[1];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    if (lid == 0u) {
        corner[0] = imageLoad(input_image, pos).r;
    }
    barrier();
    imageStore(output_image, pos, vec4(corner[0], 0.0, 0.0, 1.0));
}
"""
        spec = translate_shader(src, "corner_fill")
        rng = np.random.default_rng(4)
        img = jnp.asarray(rng.random((4, 16, 16), dtype=np.float32))
        ctx = KernelContext(width=16, height=16)
        out = np.asarray(spec(ctx, {"input_image": img}, {})["output_image"])
        x = np.asarray(img)[0]
        # Every pixel sees its workgroup's (0,0) corner value.
        for ty in range(2):
            for tx in range(2):
                np.testing.assert_allclose(
                    out[0, ty*8:(ty+1)*8, tx*8:(tx+1)*8], x[ty*8, tx*8],
                    atol=1e-6,
                )

    def test_shared_marks_unshardable(self):
        spec = translate_shader(self.HIST_SHARED, "hist_shared2")
        assert spec.halo_for({}) is None

    def test_shared_oob_budget_diagnostic(self):
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
shared float big[1048576];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, pos, vec4(big[0]));
}
"""
        # local_size (1,1): one group per pixel -> budget exceeded.
        spec = translate_shader(src, "big_shared")
        ctx = KernelContext(width=64, height=64)
        img = jnp.zeros((4, 64, 64), jnp.float32)
        with pytest.raises(GlslError, match="lowering budget"):
            spec(ctx, {"input_image": img}, {})


class TestSharedWriteInLoop:
    """Plain (non-atomic) shared-array stores inside data-dependent
    loops: the shared state rides the vectorized while carry exactly
    like atomics, so writes in round k are visible in round k+1 and
    after the loop."""

    HDR = """
#version 450
layout (local_size_x = 4, local_size_y = 4) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""

    @staticmethod
    def _run(src, h=8, w=8, seed=0):
        spec = translate_shader(src, "shm_loop")
        rng = np.random.default_rng(seed)
        img = jnp.asarray(rng.random((4, h, w), dtype=np.float32))
        ctx = KernelContext(width=w, height=h)
        out = spec(ctx, {"input_image": img}, {})["output_image"]
        return np.asarray(out), np.asarray(img)

    @staticmethod
    def _trips(img):
        # int(r * 4.0) + 1 per pixel, matching the shader sources.
        return (img[0] * 4.0).astype(np.int32) + 1

    def test_own_slot_store(self):
        # Each lane writes ONLY its own slot each round; the final value
        # is the lane's own (data-dependent) trip count.
        out, img = self._run(self.HDR + """
shared float mine[16];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        mine[lid] = float(i + 1);
        i++;
    }
    imageStore(output_image, pos, vec4(mine[lid], 0.0, 0.0, 1.0));
}
""")
        np.testing.assert_allclose(out[0], self._trips(img), atol=1e-6)

    def test_single_writer_cross_lane_read(self):
        # Only the group's lane 0 accumulates (plain read-modify-write,
        # masked by lid == 0 AND its loop activation); every lane in the
        # group reads the result after the loop.
        out, img = self._run(self.HDR + """
shared float cnt[1];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        if (lid == 0u) {
            cnt[0] = cnt[0] + 1.0;
        }
        i++;
    }
    barrier();
    imageStore(output_image, pos, vec4(cnt[0], 0.0, 0.0, 1.0));
}
""")
        trips = self._trips(img)
        # Each group's value = the trip count of its top-left lane.
        for ty in range(2):
            for tx in range(2):
                np.testing.assert_allclose(
                    out[0, ty*4:(ty+1)*4, tx*4:(tx+1)*4],
                    float(trips[ty*4, tx*4]), atol=1e-6,
                )

    def test_callee_store(self):
        # The write happens inside a called user function: discovered
        # transitively, same carry.
        out, img = self._run(self.HDR + """
shared float mine[16];
void mark(uint i, float v) {
    mine[i] = v;
}
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        mark(lid, float(i + 1));
        i++;
    }
    imageStore(output_image, pos, vec4(mine[lid], 0.0, 0.0, 1.0));
}
""", seed=1)
        np.testing.assert_allclose(out[0], self._trips(img), atol=1e-6)

    def test_compound_store(self):
        # `+=` on the lane's own slot accumulates across rounds (shared
        # arrays zero-initialize).
        out, img = self._run(self.HDR + """
shared float acc[16];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        acc[lid] += 2.0;
        i++;
    }
    imageStore(output_image, pos, vec4(acc[lid], 0.0, 0.0, 1.0));
}
""", seed=2)
        np.testing.assert_allclose(out[0], 2.0 * self._trips(img), atol=1e-6)

    def test_out_param_store(self):
        # The shared-array write happens through an `out` parameter of a
        # called function: the callee assigns a local param and the
        # caller-side copy-back performs the store, so the write
        # detection must treat the CALL as a shared write (advisor
        # round-4 finding: shm_keys stayed empty and the trace crashed
        # with UnexpectedTracerError).
        out, img = self._run(self.HDR + """
shared float mine[16];
void setv(out float x, float v) {
    x = v;
}
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        setv(mine[lid], float(i + 1));
        i++;
    }
    imageStore(output_image, pos, vec4(mine[lid], 0.0, 0.0, 1.0));
}
""", seed=3)
        np.testing.assert_allclose(out[0], self._trips(img), atol=1e-6)

    def test_mixed_with_atomic(self):
        # A plain store and an atomicAdd on DIFFERENT shared arrays in
        # the same loop body share one carry.
        out, img = self._run(self.HDR + """
shared float mine[16];
shared float total[1];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
        mine[lid] = float(i + 1);
        atomicAdd(total[0], 1.0);
        i++;
    }
    imageStore(output_image, pos, vec4(mine[lid], total[0], 0.0, 1.0));
}
""", seed=3)
        trips = self._trips(img)
        np.testing.assert_allclose(out[0], trips, atol=1e-6)
        # total[0] per group = sum of the group's trip counts.
        for ty in range(2):
            for tx in range(2):
                np.testing.assert_allclose(
                    out[1, ty*4:(ty+1)*4, tx*4:(tx+1)*4],
                    float(trips[ty*4:(ty+1)*4, tx*4:(tx+1)*4].sum()),
                    atol=1e-6,
                )


class TestScatterImageStore:
    """imageStore at computed coordinates: per-pixel scatter."""

    FLIP = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, ivec2(size.x - 1 - pos.x, pos.y), c);
}
"""

    def test_scatter_flip_matches_gather(self):
        spec = translate_shader(self.FLIP, "flip_scatter")
        rng = np.random.default_rng(5)
        h, w = 12, 16
        img = jnp.asarray(rng.random((4, h, w), dtype=np.float32))
        ctx = KernelContext(width=w, height=h)
        got = np.asarray(spec(ctx, {"input_image": img}, {})["output_image"])
        np.testing.assert_array_equal(got, np.asarray(img)[:, :, ::-1])

    def test_scatter_oob_dropped_and_unwritten_kept(self):
        # Only the left half writes (shifted right by 4); the right half
        # writes out of bounds.  Unwritten pixels keep the image's prior
        # contents (zeros, alpha 1).
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    int nx = pos.x < size.x / 2 ? pos.x + 4 : pos.x + size.x * 8;
    imageStore(output_image, ivec2(nx, pos.y), c);
}
"""
        spec = translate_shader(src, "scatter_oob")
        rng = np.random.default_rng(6)
        h, w = 8, 16
        img = np.asarray(rng.random((4, h, w)), np.float32)
        ctx = KernelContext(width=w, height=h)
        got = np.asarray(spec(ctx, {"input_image": jnp.asarray(img)},
                              {})["output_image"])
        # Columns 4..11 hold input columns 0..7; the rest untouched.
        np.testing.assert_array_equal(got[:, :, 4:12], img[:, :, 0:8])
        np.testing.assert_array_equal(got[:3, :, 0:4], 0.0)
        np.testing.assert_array_equal(got[3, :, 0:4], 1.0)
        np.testing.assert_array_equal(got[:3, :, 12:], 0.0)

    def test_scatter_under_condition(self):
        # Conditional scatter: masked-off lanes must not write.
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, pos, c);
    if (c.r > 0.5) {
        imageStore(output_image, ivec2(pos.x, pos.y), vec4(1.0));
    }
}
"""
        spec = translate_shader(src, "scatter_cond")
        rng = np.random.default_rng(7)
        h, w = 8, 16
        img = np.asarray(rng.random((4, h, w)), np.float32)
        ctx = KernelContext(width=w, height=h)
        got = np.asarray(spec(ctx, {"input_image": jnp.asarray(img)},
                              {})["output_image"])
        hot = img[0] > 0.5
        for ch in range(4):
            np.testing.assert_array_equal(got[ch][hot], 1.0)
            np.testing.assert_array_equal(got[ch][~hot], img[ch][~hot])

    def test_scatter_marks_gather(self):
        # Scatter nodes must not be halo-sharded.
        spec = translate_shader(self.FLIP, "flip_scatter2")
        assert spec.halo_for(spec.resolve_params({})) is None


class TestDiscard:
    """Fragment discard: dropped pixels deterministically produce zeros
    (the reference's render pass leaves them undefined: DONT_CARE,
    render_pass.rs:33)."""

    def _run_frag(self, src, h=8, w=16, seed=9):
        spec = translate_shader(src, "frag_discard", stage="fragment")
        rng = np.random.default_rng(seed)
        img = np.asarray(rng.random((4, h, w)), np.float32)
        ctx = KernelContext(width=w, height=h)
        out = spec(ctx, {"input_image": jnp.asarray(img)}, {})["output_image"]
        return np.asarray(out), img

    def test_conditional_discard(self):
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
out vec4 color;
void main() {
    ivec2 pos = ivec2(gl_FragCoord.xy);
    vec4 c = imageLoad(input_image, pos);
    if (c.r > 0.5) {
        discard;
    }
    color = c;
}
"""
        got, img = self._run_frag(src)
        hot = img[0] > 0.5
        for ch in range(4):
            np.testing.assert_array_equal(got[ch][hot], 0.0)
            np.testing.assert_array_equal(got[ch][~hot], img[ch][~hot])

    def test_writes_after_discard_masked(self):
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
out vec4 color;
void main() {
    ivec2 pos = ivec2(gl_FragCoord.xy);
    vec4 c = imageLoad(input_image, pos);
    color = vec4(0.25);
    if (c.r > 0.5) {
        discard;
    }
    color = vec4(1.0);
}
"""
        got, img = self._run_frag(src)
        hot = img[0] > 0.5
        for ch in range(4):
            np.testing.assert_array_equal(got[ch][hot], 0.0)
            np.testing.assert_array_equal(got[ch][~hot], 1.0)

    def test_discard_in_compute_rejected(self):
        with pytest.raises(GlslError, match="fragment"):
            run_shader("""
                ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
                discard;
            """)


class TestDataDependentLoops:
    """Per-pixel loop bounds lower to ONE lax.while_loop (escape-time
    idiom); inactive lanes freeze via the masked-assignment blend."""

    def _oracle(self, img, cap=50):
        v = img[0].astype(np.float64).copy()
        n = np.zeros_like(v, dtype=np.int64)
        active = (v < 1.0) & (n < cap)
        while active.any():
            v2 = v * 1.5 + 0.01
            v = np.where(active, v2, v)
            n = np.where(active, n + 1, n)
            active = (v < 1.0) & (n < cap)
        return v.astype(np.float32), n

    def test_while_escape_time(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            while (v < 1.0 && n < 50) {
                v = v * 1.5 + 0.01;
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """)
        got = np.asarray(out)
        want_v, want_n = self._oracle(np.asarray(img))
        np.testing.assert_allclose(got[0], want_v, atol=1e-5)
        np.testing.assert_array_equal(got[1], want_n.astype(np.float32))

    def test_for_escape_time(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int iters = 0;
            for (int n = 0; v < 1.0 && n < 50; n++) {
                v = v * 1.5 + 0.01;
                iters = n + 1;
            }
            imageStore(output_image, pos, vec4(v, float(iters), 0.0, 1.0));
        """)
        got = np.asarray(out)
        want_v, want_n = self._oracle(np.asarray(img))
        np.testing.assert_allclose(got[0], want_v, atol=1e-5)
        np.testing.assert_array_equal(got[1], want_n.astype(np.float32))

    def test_mandelbrot_runs(self):
        # The canonical escape-time fractal: z <- z^2 + c per pixel.
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(output_image);
            vec2 c = vec2(
                float(pos.x) / float(size.x) * 3.0 - 2.0,
                float(pos.y) / float(size.y) * 2.0 - 1.0);
            vec2 z = vec2(0.0);
            int n = 0;
            while (dot(z, z) < 4.0 && n < 64) {
                z = vec2(z.x * z.x - z.y * z.y, 2.0 * z.x * z.y) + c;
                n++;
            }
            imageStore(output_image, pos, vec4(float(n) / 64.0));
        """, h=16, w=24)
        got = np.asarray(out)
        assert got.min() >= 0.0 and got.max() <= 1.0
        assert len(np.unique(got[0])) > 3  # actual per-pixel variation

    def test_loads_inside_loop(self):
        # Loop-carried gathers lower into the while body (formerly
        # rejected with "hoist loads before the loop").
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            while (v < 1.0 && n < 64) {
                v += imageLoad(input_image, pos).g;
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        act = (v < 1.0) & (n < 64)
        while act.any():
            v = np.where(act, v + a[1], v)
            n = np.where(act, n + 1, n)
            act = (v < 1.0) & (n < 64)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(got[1], n.astype(np.float32))

    def test_loop_inside_nonuniform_if(self):
        # A data-dependent loop under a per-pixel branch: the enclosing
        # lane mask folds into the initial active mask, so lanes outside
        # the branch keep their pre-loop values exactly.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            if (c.g < 0.5) {
                while (v < 1.0 && n < 50) {
                    v = v * 1.5 + 0.01;
                    n++;
                }
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        sel = a[1] < 0.5
        act = sel & (v < 1.0) & (n < 50)
        while act.any():
            v = np.where(act, v * 1.5 + 0.01, v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 50)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(got[1], n.astype(np.float32))

    def test_loop_inside_nonuniform_else_with_gather(self):
        # Else-branch masking + a gather in the loop body, together.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            if (c.g < 0.5) {
                v = 2.0;
            } else {
                int n = 0;
                while (v < 1.0 && n < 32) {
                    v += imageLoad(input_image, pos).b;
                    n++;
                }
            }
            imageStore(output_image, pos, vec4(v));
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        sel = a[1] >= 0.5
        act = sel & (v < 1.0) & (n < 32)
        while act.any():
            v = np.where(act, v + a[2], v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 32)
        v = np.where(a[1] < 0.5, 2.0, v)
        np.testing.assert_allclose(
            np.asarray(out)[0], v.astype(np.float32), atol=1e-5
        )

    def test_return_inside_loop(self):
        # A per-pixel `return` inside the marching loop: the lane leaves
        # the loop AND skips everything after it (the store), keeping the
        # output image's prior contents (zeros, alpha 1).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            while (v < 1.0 && n < 50) {
                if (c.g < 0.3) { return; }
                v = v * 1.5 + 0.01;
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.5, 1.0));
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        runs = a[1] >= 0.3
        act = runs & (v < 1.0) & (n < 50)
        while act.any():
            v = np.where(act, v * 1.5 + 0.01, v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 50)
        # Early-return lanes that entered the loop never store.
        returned = ~runs & (a[0] < 1.0)
        want_v = np.where(returned, 0.0, v)
        want_n = np.where(returned, 0.0, n)
        want_b = np.where(returned, 0.0, 0.5)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], want_v, atol=1e-5)
        np.testing.assert_array_equal(got[1], want_n.astype(np.float32))
        np.testing.assert_allclose(got[2], want_b, atol=1e-6)

    def test_valued_return_from_loop_in_function(self):
        # A VALUED per-pixel `return` inside a data-dependent loop, in a
        # user function: each lane's value rides the while carry out and
        # blends (by disjoint lane masks) with the post-loop return.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float r = steps(c.r);
            imageStore(output_image, pos, vec4(r, 0.0, 0.0, 1.0));
        """, extra_decls="""
            float steps(float x) {
                float v = x;
                int n = 0;
                while (n < 50) {
                    if (v >= 1.0) { return float(n); }
                    v = v * 1.5 + 0.05;
                    n++;
                }
                return -1.0;
            }
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        res = np.full_like(v, np.nan)
        act = np.ones_like(v, bool)
        for _ in range(50):
            hit = act & (v >= 1.0)
            res = np.where(hit, n, res)
            act = act & ~hit
            v = np.where(act, v * 1.5 + 0.05, v)
            n = np.where(act, n + 1, n)
        res = np.where(np.isnan(res), -1.0, res)
        np.testing.assert_allclose(
            np.asarray(out)[0], res.astype(np.float32), atol=1e-6
        )

    def test_valued_vector_return_from_escape_loop(self):
        # Escape-time idiom returning a vec2 from inside a static-bound
        # for (vectorized because of the per-pixel return): both
        # components must come back per-lane.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec2 e = esc(vec2(c.r * 2.0 - 1.5, c.g * 2.0 - 1.0));
            imageStore(output_image, pos, vec4(e.x, e.y, 0.0, 1.0));
        """, extra_decls="""
            vec2 esc(vec2 p) {
                vec2 z = vec2(0.0);
                for (int i = 0; i < 24; i++) {
                    z = vec2(z.x * z.x - z.y * z.y, 2.0 * z.x * z.y) + p;
                    if (dot(z, z) > 4.0) {
                        return vec2(float(i), dot(z, z));
                    }
                }
                return vec2(24.0, dot(z, z));
            }
        """)
        a = np.asarray(img, np.float64).astype(np.float32)
        cx = a[0] * np.float32(2.0) - np.float32(1.5)
        cy = a[1] * np.float32(2.0) - np.float32(1.0)
        zx = np.zeros_like(cx)
        zy = np.zeros_like(cy)
        rx = np.full_like(cx, np.nan)
        ry = np.full_like(cy, np.nan)
        act = np.ones_like(cx, bool)
        for i in range(24):
            nzx = zx * zx - zy * zy + cx
            nzy = np.float32(2.0) * zx * zy + cy
            zx = np.where(act, nzx, zx)
            zy = np.where(act, nzy, zy)
            d = zx * zx + zy * zy
            hit = act & (d > 4.0)
            rx = np.where(hit, np.float32(i), rx)
            ry = np.where(hit, d, ry)
            act = act & ~hit
        d = zx * zx + zy * zy
        rx = np.where(np.isnan(rx), np.float32(24.0), rx)
        ry = np.where(np.isnan(ry), d, ry)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], rx, atol=1e-4)
        np.testing.assert_allclose(got[1], ry, rtol=2e-4, atol=1e-4)

    def test_struct_return_from_loop(self):
        # A struct-valued return out of the data-dependent loop: every
        # field comes back per-lane (the generic tree blend).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            Hit h = march(c.r);
            imageStore(output_image, pos, vec4(h.d, float(h.steps) / 50.0, h.p.y, 1.0));
        """, extra_decls="""
            struct Hit { float d; int steps; vec2 p; };
            Hit march(float x) {
                float v = x;
                int n = 0;
                while (n < 50) {
                    if (v >= 1.0) { return Hit(v, n, vec2(v * 0.5, v - 1.0)); }
                    v = v * 1.5 + 0.05;
                    n++;
                }
                return Hit(-1.0, 50, vec2(0.0));
            }
        """)
        a = np.asarray(img, np.float32)[0]
        v = a.copy()
        n = np.zeros_like(v)
        d = np.full_like(v, np.nan)
        ns = np.zeros_like(v)
        act = np.ones_like(v, bool)
        for _ in range(50):
            hit = act & (v >= 1.0)
            d = np.where(hit, v, d)
            ns = np.where(hit, n, ns)
            act = act & ~hit
            v = np.where(act, v * np.float32(1.5) + np.float32(0.05), v)
            n = np.where(act, n + 1, n)
        ns = np.where(np.isnan(d), 50, ns)
        d = np.where(np.isnan(d), -1.0, d)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], d, atol=1e-6)
        np.testing.assert_allclose(got[1], ns / np.float32(50.0), atol=1e-6)
        np.testing.assert_allclose(
            got[2], np.where(d < 0, 0.0, d - 1.0), atol=1e-6
        )

    def test_function_with_early_return_called_in_loop(self):
        # A user function with its own masked return, called from the
        # loop body: the return binds to the FUNCTION, not the loop.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 50) {
                v = bump(v);
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """, extra_decls="""
            float bump(float x) {
                if (x > 0.6) { return x + 0.3; }
                return x + 0.05;
            }
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        act = (v < 1.0) & (n < 50)
        while act.any():
            v2 = np.where(v > 0.6, v + 0.3, v + 0.05)
            v = np.where(act, v2, v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 50)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(got[1], n.astype(np.float32))

    def test_store_inside_loop_identity_coord(self):
        # imageStore in the body: the written planes ride the loop carry,
        # so per-round identity-coordinate stores accumulate like
        # sequential rounds (lanes that never iterate leave the image
        # untouched — zeros with alpha 1 for a never-written output).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            while (v < 1.0 && n < 50) {
                v = v * 1.5 + 0.01;
                imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
                n++;
            }
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        act = (v < 1.0) & (n < 50)
        while act.any():
            v = np.where(act, v * 1.5 + 0.01, v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 50)
        got = np.asarray(out)
        ever = n > 0
        np.testing.assert_allclose(
            got[0], np.where(ever, v, 0.0).astype(np.float32), atol=1e-5
        )
        np.testing.assert_array_equal(
            got[1], np.where(ever, n - 1, 0.0).astype(np.float32)
        )

    def test_scatter_store_inside_loop(self):
        # Scatter stores in the body (computed coordinates).  Each pixel
        # writes its mirrored column, so every target has exactly one
        # writer and the result is deterministic.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            ivec2 size = imageSize(output_image);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int n = 0;
            while (v < 1.0 && n < 50) {
                v = v * 1.5 + 0.01;
                imageStore(output_image,
                           ivec2(size.x - 1 - pos.x, pos.y),
                           vec4(v, float(n), 0.0, 1.0));
                n++;
            }
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        act = (v < 1.0) & (n < 50)
        while act.any():
            v = np.where(act, v * 1.5 + 0.01, v)
            n = np.where(act, n + 1, n)
            act = act & (v < 1.0) & (n < 50)
        got = np.asarray(out)
        ever = n > 0
        np.testing.assert_allclose(
            got[0], np.where(ever, v, 0.0)[:, ::-1].astype(np.float32),
            atol=1e-5,
        )
        np.testing.assert_array_equal(
            got[1], np.where(ever, n - 1, 0.0)[:, ::-1].astype(np.float32)
        )

    def test_store_then_load_same_image_in_loop(self):
        # Read-modify-write of the stored image across rounds: loads
        # observe the carried contents, so the accumulation is exact.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            int limit = int(c.r * 4.0) + 1;
            int n = 0;
            while (n < limit) {
                vec4 cur = imageLoad(output_image, pos);
                imageStore(output_image, pos,
                           vec4(cur.r + 0.125, 0.0, 0.0, 1.0));
                n++;
            }
        """)
        a = np.asarray(img, np.float64)
        iters = (a[0] * 4.0).astype(np.int64) + 1
        got = np.asarray(out)
        np.testing.assert_allclose(
            got[0], (0.125 * iters).astype(np.float32), atol=1e-6
        )

    def test_atomics_inside_loop(self):
        # atomicAdd in the body rides the loop carry (see test_ssbo.py
        # for the full-counter oracle); the image result is unaffected.
        out, img = run_shader(
            """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            while (v < 1.0) {
                atomicAdd(stats.count[0], 1.0);
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v));
            """,
            extra_decls=(
                "layout(std430, binding = 2) buffer Stats "
                "{ float count[4]; } stats;\n"
            ),
        )
        a = np.asarray(img, np.float32)[0]
        want = a.copy()
        while (want < 1.0).any():
            want = np.where(want < 1.0, want + np.float32(0.25), want)
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_atomic_in_callee_inside_loop(self):
        # A CALLED function touching the SSBO from a loop body: the
        # callee's atomics are discovered transitively and the buffers
        # ride the loop carry, same as a direct atomicAdd.
        out, img = run_shader(
            """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            while (v < 1.0) {
                bump();
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v));
            """,
            extra_decls=(
                "layout(std430, binding = 2) buffer Stats "
                "{ float count[4]; } stats;\n"
                "void bump() { atomicAdd(stats.count[0], 1.0); }\n"
            ),
        )
        a = np.asarray(img, np.float32)[0]
        want = a.copy()
        while (want < 1.0).any():
            want = np.where(want < 1.0, want + np.float32(0.25), want)
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_imagestore_in_callee_inside_loop(self):
        # A called function storing to a global image from a loop body:
        # the stored planes ride the carry exactly as a direct store.
        out, img = run_shader(
            """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 8) {
                put(pos, v);
                v = v * 1.5 + 0.1;
                n++;
            }
            """,
            extra_decls=(
                "void put(ivec2 p, float x) {\n"
                "    imageStore(output_image, p, vec4(x, float(p.x), 0.0, 1.0));\n"
                "}\n"
            ),
        )
        # Oracle: last value stored before the loop exits, per pixel.
        a = np.asarray(img, np.float64)[0]
        h, w = a.shape
        v = a.copy()
        n = np.zeros_like(v)
        last = np.full_like(v, np.nan)
        act = np.ones_like(v, bool)
        for _ in range(8):
            live = act & (v < 1.0) & (n < 8)
            last = np.where(live, v, last)
            v = np.where(live, v * 1.5 + 0.1, v)
            n = np.where(live, n + 1, n)
            act = live
        got = np.asarray(out)
        stored = ~np.isnan(last)
        np.testing.assert_allclose(
            got[0][stored], last[stored].astype(np.float32), atol=1e-6
        )
        xs = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
        np.testing.assert_allclose(got[1][stored], xs[stored], atol=1e-6)
        # Never-stored pixels keep the image's prior contents (zeros).
        np.testing.assert_allclose(got[0][~stored], 0.0, atol=0)

    def test_global_write_in_callee_inside_loop(self):
        # A called function writing a file-scope global from a loop body:
        # the global rides the carry via the globals-dict swap, so the
        # post-loop read observes the per-lane accumulated value.
        out, img = run_shader(
            """
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            g_acc = 0.0;
            while (v < 1.0) {
                accumulate(v);
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v, g_acc, 0.0, 1.0));
            """,
            extra_decls=(
                "float g_acc;\n"
                "void accumulate(float x) { g_acc += x; }\n"
            ),
        )
        a = np.asarray(img, np.float64)[0]
        v = a.copy()
        acc = np.zeros_like(v)
        while (v < 1.0).any():
            live = v < 1.0
            acc = np.where(live, acc + v, acc)
            v = np.where(live, v + 0.25, v)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-6)
        np.testing.assert_allclose(got[1], acc.astype(np.float32), atol=1e-5)

    def test_array_return_from_loop_in_function(self):
        # Array-valued `return` out of a data-dependent loop: the
        # element-wise blend recursion extends to arrays, so the pair
        # (escape value, step count) rides the while carry out.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float r[2] = march(c.r);
            imageStore(output_image, pos, vec4(r[0], r[1], 0.0, 1.0));
        """, extra_decls="""
            float[2] march(float x) {
                float v = x;
                int n = 0;
                while (n < 50) {
                    if (v >= 1.0) { return float[](v, float(n)); }
                    v = v * 1.5 + 0.05;
                    n++;
                }
                return float[](-1.0, -1.0);
            }
        """)
        a = np.asarray(img, np.float64)
        v = a[0].copy()
        n = np.zeros_like(v)
        r0 = np.full_like(v, np.nan)
        r1 = np.full_like(v, np.nan)
        act = np.ones_like(v, bool)
        for _ in range(50):
            hit = act & (v >= 1.0)
            r0 = np.where(hit, v, r0)
            r1 = np.where(hit, n, r1)
            act = act & ~hit
            v = np.where(act, v * 1.5 + 0.05, v)
            n = np.where(act, n + 1, n)
        r0 = np.where(np.isnan(r0), -1.0, r0)
        r1 = np.where(np.isnan(r1), -1.0, r1)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], r0.astype(np.float32), atol=1e-5)
        np.testing.assert_allclose(got[1], r1.astype(np.float32), atol=1e-6)

    def test_array_carried_through_loop(self):
        # A whole-array local reassigned each round rides the carry via
        # the array tree flattening.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float acc[2] = float[](0.0, 1.0);
            while (v < 1.0) {
                acc = float[](acc[0] + v, acc[1] * 0.5);
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v, acc[0], acc[1], 1.0));
        """)
        a = np.asarray(img, np.float64)[0]
        v = a.copy()
        a0 = np.zeros_like(v)
        a1 = np.ones_like(v)
        while (v < 1.0).any():
            live = v < 1.0
            a0 = np.where(live, a0 + v, a0)
            a1 = np.where(live, a1 * 0.5, a1)
            v = np.where(live, v + 0.25, v)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-6)
        np.testing.assert_allclose(got[1], a0.astype(np.float32), atol=1e-5)
        np.testing.assert_allclose(got[2], a1.astype(np.float32), atol=1e-6)

    def test_diamond_call_graph_in_loop(self):
        # f -> g -> u and f -> h -> u (the classic SDF pattern: two
        # distance functions sharing a helper) must qualify — the
        # recursion check tracks the call PATH, not visited functions.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 30) {
                v = f(v);
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """, extra_decls="""
            float u(float x) { return x * 0.5; }
            float g(float x) { return u(x) + 0.3; }
            float h(float x) { return u(x) + 0.1; }
            float f(float x) { return g(x) + h(x); }
        """)
        a = np.asarray(img, np.float64)[0]
        v = a.copy()
        n = np.zeros_like(v)
        for _ in range(30):
            live = (v < 1.0) & (n < 30)
            v = np.where(live, (v * 0.5 + 0.3) + (v * 0.5 + 0.1), v)
            n = np.where(live, n + 1, n)
        np.testing.assert_allclose(
            np.asarray(out)[0], v.astype(np.float32), atol=1e-5
        )

    def test_inout_global_through_nested_call_in_loop(self):
        # A global written via an inout parameter of a NESTED call must
        # be discovered and carried (the copy-back at the call site is
        # the write).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            g_acc = 0.0;
            while (v < 1.0) {
                acc2(v);
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v, g_acc, 0.0, 1.0));
        """, extra_decls="""
            float g_acc;
            void addto(inout float dst, float x) { dst += x; }
            void acc2(float x) { addto(g_acc, x); }
        """)
        a = np.asarray(img, np.float64)[0]
        v = a.copy()
        acc = np.zeros_like(v)
        while (v < 1.0).any():
            live = v < 1.0
            acc = np.where(live, acc + v, acc)
            v = np.where(live, v + 0.25, v)
        got = np.asarray(out)
        np.testing.assert_allclose(got[1], acc.astype(np.float32), atol=1e-5)

    def test_condition_callee_side_effect_in_loop(self):
        # The loop CONDITION re-evaluates each round; a probe() that
        # bumps a global must ride the carry like body effects.  GLSL
        # evaluates the condition once more on the failing check, so the
        # count is iterations + 1 for lanes that entered at least once
        # (and exactly 1 for lanes that never entered).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            g_n = 0.0;
            while (probe(v) < 1.0) {
                v += 0.25;
            }
            imageStore(output_image, pos, vec4(v, g_n, 0.0, 1.0));
        """, extra_decls="""
            float g_n;
            float probe(float x) { g_n += 1.0; return x; }
        """)
        a = np.asarray(img, np.float64)[0]
        v = a.copy()
        iters = np.zeros_like(v)
        while (v < 1.0).any():
            live = v < 1.0
            v = np.where(live, v + 0.25, v)
            iters = np.where(live, iters + 1, iters)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-6)
        np.testing.assert_allclose(
            got[1], (iters + 1.0).astype(np.float32), atol=1e-6
        )

    def test_array_size_mismatch_between_returns_rejected(self):
        with pytest.raises(GlslError, match="array size|cannot convert"):
            run_shader("""
                ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
                float r[2] = bad(imageLoad(input_image, pos).r);
                imageStore(output_image, pos, vec4(r[0], r[1], 0.0, 1.0));
            """, extra_decls="""
                float[2] bad(float x) {
                    float v = x;
                    int n = 0;
                    while (n < 10) {
                        if (v >= 1.0) { return float[](v, 1.0, 2.0); }
                        v = v * 1.5 + 0.1;
                        n++;
                    }
                    return float[](v, 0.0);
                }
            """)

    def test_barrier_in_loop_rejected(self):
        # Divergent barriers are UB in GLSL — the one remaining rejection.
        with pytest.raises(GlslError, match="barrier"):
            run_shader(
                """
                ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
                float v = imageLoad(input_image, pos).r;
                while (v < 1.0) {
                    barrier();
                    v += 0.25;
                }
                imageStore(output_image, pos, vec4(v));
                """
            )

    def test_iterative_warp(self):
        # The iterative-warp idiom: follow a flow field read from the
        # image itself, a data-dependent number of steps per pixel.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec2 uv = (vec2(pos) + 0.5) / vec2(imageSize(input_image));
            float acc = 0.0;
            int n = 0;
            while (acc < 1.0 && n < 16) {
                vec4 s = texture(input_image, uv);
                uv = fract(uv + (s.rg - 0.5) * 0.1);
                acc += s.b * 0.5 + 0.05;
                n++;
            }
            imageStore(output_image, pos, vec4(uv, acc, float(n)));
        """, h=8, w=8)
        got = np.asarray(out)

        a = np.asarray(img, np.float64)
        h, w = a.shape[1], a.shape[2]

        def tex(plane, uv_x, uv_y):
            xf = uv_x * w - 0.5
            yf = uv_y * h - 0.5
            x0 = np.floor(xf)
            y0 = np.floor(yf)
            tx, ty = xf - x0, yf - y0
            x0 = np.clip(x0.astype(int), 0, w - 1)
            x1 = np.clip(x0 + 1, 0, w - 1)
            y0 = np.clip(y0.astype(int), 0, h - 1)
            y1 = np.clip(y0 + 1, 0, h - 1)
            top = plane[y0, x0] * (1 - tx) + plane[y0, x1] * tx
            bot = plane[y1, x0] * (1 - tx) + plane[y1, x1] * tx
            return top * (1 - ty) + bot * ty

        ux, uy = np.meshgrid(
            (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h
        )
        acc = np.zeros((h, w))
        n = np.zeros((h, w))
        act = (acc < 1.0) & (n < 16)
        while act.any():
            r = tex(a[0], ux, uy)
            g = tex(a[1], ux, uy)
            b = tex(a[2], ux, uy)
            nux = (ux + (r - 0.5) * 0.1) % 1.0
            nuy = (uy + (g - 0.5) * 0.1) % 1.0
            ux = np.where(act, nux, ux)
            uy = np.where(act, nuy, uy)
            acc = np.where(act, acc + b * 0.5 + 0.05, acc)
            n = np.where(act, n + 1, n)
            act = (acc < 1.0) & (n < 16)
        np.testing.assert_allclose(got[0], ux, atol=2e-4)
        np.testing.assert_allclose(got[1], uy, atol=2e-4)
        np.testing.assert_allclose(got[2], acc, atol=2e-4)
        np.testing.assert_array_equal(got[3], n)

    def test_raymarch_with_sdf_function_and_texture(self):
        # Texture-sampling raymarch: a user SDF function called in the
        # data-dependent loop, plus a texture read at the hit point.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec2 uv = (vec2(pos) + 0.5) / vec2(imageSize(output_image));
            float t = 0.0;
            int steps = 0;
            for (int i = 0; i < 48 && t < 4.0; i++) {
                vec3 p = vec3(uv * 2.0 - 1.0, t);
                float d = map(p);
                if (d < 0.01) { break; }
                t += d;
                steps = i + 1;
            }
            vec4 albedo = texture(input_image, fract(uv + t * 0.25));
            imageStore(output_image, pos,
                       vec4(albedo.rgb * (1.0 - t * 0.25), float(steps)));
        """, extra_decls="""
            float map(vec3 p) {
                return length(p - vec3(0.0, 0.0, 2.0)) - 0.8;
            }
        """, h=10, w=12)
        got = np.asarray(out)

        a = np.asarray(img, np.float64)
        h, w = got.shape[1], got.shape[2]

        def tex(plane, uv_x, uv_y):
            xf = uv_x * w - 0.5
            yf = uv_y * h - 0.5
            x0 = np.floor(xf)
            y0 = np.floor(yf)
            tx, ty = xf - x0, yf - y0
            x0 = np.clip(x0.astype(int), 0, w - 1)
            x1 = np.clip(x0 + 1, 0, w - 1)
            y0 = np.clip(y0.astype(int), 0, h - 1)
            y1 = np.clip(y0 + 1, 0, h - 1)
            top = plane[y0, x0] * (1 - tx) + plane[y0, x1] * tx
            bot = plane[y1, x0] * (1 - tx) + plane[y1, x1] * tx
            return top * (1 - ty) + bot * ty

        ux, uy = np.meshgrid(
            (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h
        )
        px, py = ux * 2.0 - 1.0, uy * 2.0 - 1.0
        t = np.zeros((h, w))
        steps = np.zeros((h, w))
        hit = np.zeros((h, w), bool)
        for i in range(48):
            act = ~hit & (t < 4.0)
            if not act.any():
                break
            d = np.sqrt(px**2 + py**2 + (t - 2.0) ** 2) - 0.8
            newly_hit = act & (d < 0.01)
            hit |= newly_hit
            adv = act & ~newly_hit
            t = np.where(adv, t + d, t)
            steps = np.where(adv, i + 1, steps)
        sx, sy = (ux + t * 0.25) % 1.0, (uy + t * 0.25) % 1.0
        shade = 1.0 - t * 0.25
        for c in range(3):
            np.testing.assert_allclose(
                got[c], tex(a[c], sx, sy) * shade, atol=2e-4, err_msg=f"ch{c}"
            )
        np.testing.assert_array_equal(got[3], steps)


class TestUboArrays:
    def test_ubo_array_member_reads_zero(self):
        # Legal GLSL; not config-settable (scalar param values), so the
        # array reads as zeros — the reference zero-fills unset UBO
        # memory (render.rs:187-193).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, c + vec4(weightsy[0] + weightsy[3]));
        """, extra_decls="""
layout (binding = 2) uniform U { float gain; float weightsy[4]; };
""")
        np.testing.assert_array_equal(np.asarray(out), np.asarray(img))


class TestVecMatUboMembers:
    def test_vec3_member_settable_per_component(self):
        # Vector UBO members compile (shaderc does; the reference's config
        # grammar has only scalar values, so per-component set is a strict
        # superset; unset components read 0 = reference zero-fill).
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, vec4(c.rgb * tint + vec3(offs, 0.0), gain));
        """, extra_decls="""
layout (binding = 2) uniform U { vec3 tint; float gain; vec2 offs; };
""", params={"tint.x": 0.5, "gain": 2.0, "offs.y": 0.25})
        o = np.asarray(out)
        i = np.asarray(img)
        np.testing.assert_allclose(o[0], i[0] * 0.5, rtol=1e-6)
        np.testing.assert_array_equal(o[1], 0.25)  # tint.y unset=0 + offs.y
        np.testing.assert_array_equal(o[3], 2.0)

    def test_vec_member_rgba_alias(self):
        # ".r" aliases ".x" through resolve_params.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            imageStore(output_image, pos, vec4(tint, 1.0));
        """, extra_decls="""
layout (binding = 2) uniform U { vec3 tint; };
""", params={"tint.r": 0.25, "tint.g": 0.5, "tint.z": 0.75})
        o = np.asarray(out)
        np.testing.assert_array_equal(o[0], 0.25)
        np.testing.assert_array_equal(o[1], 0.5)
        np.testing.assert_array_equal(o[2], 0.75)

    def test_mat_member_reads_zero(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            imageStore(output_image, pos, vec4(c.rgb + color_mat * c.rgb, 1.0));
        """, extra_decls="""
layout (binding = 2) uniform U { mat3 color_mat; };
""")
        np.testing.assert_allclose(
            np.asarray(out)[:3], np.asarray(img)[:3], rtol=1e-6
        )

    def test_struct_vec_field(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            imageStore(output_image, pos, vec4(look.shift, look.amt, 0.0));
        """, extra_decls="""
struct Look { vec2 shift; float amt; };
layout (binding = 2) uniform U { Look look; };
""", params={"look.shift.x": 0.5, "look.amt": 0.75})
        o = np.asarray(out)
        np.testing.assert_array_equal(o[0], 0.5)
        np.testing.assert_array_equal(o[1], 0.0)
        np.testing.assert_array_equal(o[2], 0.75)


class TestSpecConstants:
    DECL = """
layout (constant_id = 0) const int RADIUS = 2;
layout (constant_id = 1) const float GAIN = 1.5;
"""

    BODY = """
        ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
        float acc = 0.0;
        for (int i = -RADIUS; i <= RADIUS; i++)
            acc += imageLoad(input_image, pos + ivec2(i, 0)).r;
        imageStore(output_image, pos, vec4(acc * GAIN / float(2 * RADIUS + 1)));
    """

    def test_defaults_apply(self):
        # The reference creates pipelines with no VkSpecializationInfo
        # (pipeline.rs:44-88): the GLSL default initializer is the value.
        out, img = run_shader(self.BODY, extra_decls=self.DECL)
        i = np.asarray(img)[0]
        pad = np.pad(i, ((0, 0), (2, 2)))  # OOB imageLoad reads zero
        want = sum(pad[:, k:k + i.shape[1]] for k in range(5)) * 1.5 / 5.0
        np.testing.assert_allclose(np.asarray(out)[0], want, rtol=1e-5)

    def test_config_override(self):
        # Beyond the reference: spec constants surface as config params
        # (static at trace time, so the loop still unrolls).
        out, img = run_shader(
            self.BODY, extra_decls=self.DECL,
            params={"RADIUS": 0, "GAIN": 2.0},
        )
        np.testing.assert_allclose(
            np.asarray(out)[0], np.asarray(img)[0] * 2.0, rtol=1e-6
        )

    def test_reflection_defaults(self):
        spec = translate_shader(
            HEADER + self.DECL + "\nvoid main() {\n" + self.BODY + "\n}\n",
            "spec",
        )
        assert spec.params["RADIUS"].default == 2
        assert spec.params["GAIN"].default == 1.5

    def test_non_literal_initializer_rejected(self):
        from reforge_tpu.glsl import GlslError

        with pytest.raises(GlslError, match="literal"):
            translate_shader(
                HEADER
                + "layout (constant_id = 0) const int N = 1 + 1;\n"
                + "void main() { imageStore(output_image, "
                + "ivec2(gl_GlobalInvocationID.xy), vec4(float(N))); }\n",
                "specbad",
            )


class TestNonUniformBreak:
    """break/continue under per-pixel conditions inside the vectorized
    while_loop: break kills the lane for good, continue skips to the
    for-update (GLSL jump semantics)."""

    def test_break_escape_idiom(self):
        # The canonical form: bounded for + data-dependent break.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            float n = 0.0;
            for (int i = 0; i < 50; i++) {
                if (v >= 1.0) { break; }
                v = v * 1.5 + 0.01;
                n += 1.0;
            }
            imageStore(output_image, pos, vec4(v, n, 0.0, 1.0));
        """)
        got = np.asarray(out)
        v = np.asarray(img)[0].astype(np.float64).copy()
        n = np.zeros_like(v)
        for _ in range(50):
            active = v < 1.0
            v = np.where(active, v * 1.5 + 0.01, v)
            n = np.where(active, n + 1, n)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(got[1], n.astype(np.float32))

    def test_while_true_break(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            int guard = 0;
            while (guard < 100) {
                if (v >= 1.0) { break; }
                v = v * 2.0 + 0.001;
                guard++;
            }
            imageStore(output_image, pos, vec4(v));
        """)
        got = np.asarray(out)
        v = np.asarray(img)[0].astype(np.float64).copy()
        for _ in range(100):
            active = v < 1.0
            v = np.where(active, v * 2.0 + 0.001, v)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)

    def test_continue_runs_update(self):
        # continue must still run i++ (GLSL jumps to the update): count
        # only iterations where the accumulator was below the pixel value.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float hits = 0.0;
            for (int i = 0; i < 8; i++) {
                if (float(i) * 0.125 >= c.r) { continue; }
                hits += 1.0;
            }
            imageStore(output_image, pos, vec4(hits / 8.0));
        """)
        got = np.asarray(out)
        r = np.asarray(img)[0].astype(np.float64)
        want = np.zeros_like(r)
        for i in range(8):
            want += (i * 0.125 < r)
        np.testing.assert_allclose(got[0], (want / 8.0).astype(np.float32),
                                   atol=1e-6)

    def test_do_while_data_dependent(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = c.r;
            float n = 0.0;
            do {
                v = v * 1.5 + 0.01;
                n += 1.0;
                if (n >= 50.0) { break; }
            } while (v < 1.0);
            imageStore(output_image, pos, vec4(v, n, 0.0, 1.0));
        """)
        got = np.asarray(out)
        v = np.asarray(img)[0].astype(np.float64).copy()
        n = np.zeros_like(v)
        active = np.ones_like(v, bool)
        while active.any():
            v = np.where(active, v * 1.5 + 0.01, v)
            n = np.where(active, n + 1, n)
            active = active & (n < 50) & (v < 1.0)
        np.testing.assert_allclose(got[0], v.astype(np.float32), atol=1e-5)
        np.testing.assert_array_equal(got[1], n.astype(np.float32))

    def test_discard_inside_data_dependent_loop(self):
        # Raymarch idiom: discard from inside the vectorized loop must
        # not leak a while_loop tracer (it accumulates via the carry).
        src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
out vec4 color;
void main() {
    ivec2 pos = ivec2(gl_FragCoord.xy);
    vec4 c = imageLoad(input_image, pos);
    float v = c.r;
    int n = 0;
    while (v < 1.0 && n < 40) {
        if (c.g > 0.5) { discard; }
        v = v * 1.5 + 0.01;
        n++;
    }
    color = vec4(v);
}
"""
        spec = translate_shader(src, "march_discard", stage="fragment")
        rng = np.random.default_rng(13)
        h, w = 8, 16
        img = np.asarray(rng.random((4, h, w)), np.float32)
        ctx = KernelContext(width=w, height=h)
        got = np.asarray(spec(ctx, {"input_image": jnp.asarray(img)},
                              {})["output_image"])
        # Lanes that entered the loop with g > 0.5 discard (zeros);
        # lanes starting with v >= 1.0 never enter and keep their v.
        entered = img[0] < 1.0
        discarded = entered & (img[1] > 0.5)
        v = img[0].astype(np.float64).copy()
        active = entered & ~discarded
        n = np.zeros_like(v)
        while active.any():
            v = np.where(active, v * 1.5 + 0.01, v)
            n = np.where(active, n + 1, n)
            active = active & (v < 1.0) & (n < 40)
        want = v.astype(np.float32)
        np.testing.assert_array_equal(got[0][discarded], 0.0)
        np.testing.assert_allclose(got[0][~discarded], want[~discarded],
                                   atol=1e-5)


class TestNestedDataDependentLoops:
    """Nested loops inside vectorized data-dependent loops (round 4).

    The reference compiles arbitrary conforming GLSL via shaderc
    (reference: src/vulkan/shader.rs:73-93), including loops in loops.
    Our lowering composes: a static-bound inner For unrolls inline with
    a concrete induction var (so `wts[k]` stays a static index even
    under the outer loop's lane mask), and a per-pixel inner loop
    lowers to its own nested lax.while_loop whose returned lanes
    propagate into the enclosing loop's lane kills."""

    def test_static_inner_unrolls_in_dd_loop(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float wts[4];
            wts[0] = 0.1; wts[1] = 0.2; wts[2] = 0.3; wts[3] = 0.4;
            float acc = 0.0;
            int n = 0;
            while (acc < 1.0 && n < 30) {
                for (int k = 0; k < 4; k++) {
                    acc += v * wts[k];
                }
                n++;
            }
            imageStore(output_image, pos, vec4(acc, float(n), 0.0, 1.0));
        """)
        a = np.asarray(img)[0]
        accs = np.zeros_like(a)
        ns = np.zeros_like(a)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                acc = np.float32(0.0)
                n = 0
                while acc < 1.0 and n < 30:
                    for wt in (0.1, 0.2, 0.3, 0.4):
                        acc = np.float32(acc + v * np.float32(wt))
                    n += 1
                accs[i, j] = acc
                ns[i, j] = n
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], accs, atol=1e-5)
        np.testing.assert_array_equal(got[1], ns)

    def test_true_dd_inner_loop(self):
        # Inner condition per-pixel: a genuine while_loop inside the
        # outer while_loop's body trace.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int total = 0;
            int n = 0;
            while (n < 6) {
                float w = v;
                while (w < 1.0) {
                    w = w * 2.0 + 0.05;
                    total++;
                }
                v = v * 0.7 + 0.01;
                n++;
            }
            imageStore(output_image, pos, vec4(float(total), v, 0.0, 1.0));
        """)
        a = np.asarray(img)[0]
        tot = np.zeros_like(a)
        vs = a.copy()
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                t = 0
                for _ in range(6):
                    w = v
                    while w < 1.0:
                        w = np.float32(w * 2.0 + np.float32(0.05))
                        t += 1
                    v = np.float32(v * np.float32(0.7) + np.float32(0.01))
                tot[i, j] = t
                vs[i, j] = v
        got = np.asarray(out)
        np.testing.assert_array_equal(got[0], tot)
        np.testing.assert_allclose(got[1], vs, atol=1e-5)

    def test_inner_loop_per_pixel_break(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float acc = 0.0;
            int n = 0;
            while (n < 8) {
                int k = 0;
                while (k < 16) {
                    acc += v * 0.01;
                    if (acc > 0.5) break;
                    k++;
                }
                v = v * 1.1;
                n++;
            }
            imageStore(output_image, pos, vec4(acc, v, float(n), 1.0));
        """)
        a = np.asarray(img)[0]
        accs = np.zeros_like(a)
        vs = a.copy()
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                acc = np.float32(0.0)
                for _ in range(8):
                    k = 0
                    while k < 16:
                        acc = np.float32(acc + np.float32(v * np.float32(0.01)))
                        if acc > 0.5:
                            break
                        k += 1
                    v = np.float32(v * np.float32(1.1))
                accs[i, j] = acc
                vs[i, j] = v
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], accs, atol=1e-5)
        np.testing.assert_allclose(got[1], vs, atol=1e-4)

    def test_return_from_inner_of_two_loops(self):
        # The double-loop return idiom (raymarch step + refinement):
        # a lane returning inside the INNER loop must leave the OUTER
        # loop too — its mask propagates into the enclosing boxes.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float d = v;
            for (int i = 0; i < 10; i++) {
                float s = d;
                int k = 0;
                while (s < 2.0 && k < 12) {
                    s = s + d * 0.3;
                    if (s > 1.5) {
                        imageStore(output_image, pos,
                                   vec4(s, float(i), float(k), 1.0));
                        return;
                    }
                    k++;
                }
                d = d * 1.2 + 0.02;
                if (d > 3.0) break;
            }
            imageStore(output_image, pos, vec4(-1.0, d, 0.0, 1.0));
        """)
        a = np.asarray(img)[0]
        want = np.zeros((4,) + a.shape, np.float32)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                d = np.float32(a[i, j])
                hit = False
                for it in range(10):
                    s = d
                    k = 0
                    while s < 2.0 and k < 12:
                        s = np.float32(s + d * np.float32(0.3))
                        if s > 1.5:
                            want[:, i, j] = (s, it, k, 1.0)
                            hit = True
                            break
                        k += 1
                    if hit:
                        break
                    d = np.float32(d * np.float32(1.2) + np.float32(0.02))
                    if d > 3.0:
                        break
                if not hit:
                    want[:, i, j] = (-1.0, d, 0.0, 1.0)
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)

    def test_callee_with_dd_loop_called_from_dd_loop(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float acc = 0.0;
            int n = 0;
            while (acc < 2.0 && n < 10) {
                acc += grow(v);
                v = v * 1.05;
                n++;
            }
            imageStore(output_image, pos, vec4(acc, float(n), 0.0, 1.0));
        """, extra_decls="""
float grow(float x) {
    float s = x;
    while (s < 0.5) { s = s * 3.0 + 0.01; }
    return s;
}
""")
        a = np.asarray(img)[0]
        accs = np.zeros_like(a)
        ns = np.zeros_like(a)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                acc = np.float32(0.0)
                n = 0
                while acc < 2.0 and n < 10:
                    s = v
                    while s < 0.5:
                        s = np.float32(s * 3.0 + np.float32(0.01))
                    acc = np.float32(acc + s)
                    v = np.float32(v * np.float32(1.05))
                    n += 1
                accs[i, j] = acc
                ns[i, j] = n
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], accs, atol=1e-4)
        np.testing.assert_array_equal(got[1], ns)

    def test_imagestore_in_inner_loop(self):
        # A store inside the inner of two dd loops rides both carries.
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 5) {
                float w = v;
                while (w < 0.8) {
                    w = w * 2.0 + 0.1;
                    imageStore(output_image, pos, vec4(w, float(n), 0.0, 1.0));
                }
                v = v + w * 0.3;
                n++;
            }
            if (n == 0) {
                imageStore(output_image, pos, vec4(v, -1.0, 0.0, 1.0));
            }
        """)
        a = np.asarray(img)[0]
        want = np.zeros((4,) + a.shape, np.float32)
        want[3] = 1.0  # unwritten output images read back (0,0,0,1)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                n = 0
                stored = None
                while v < 1.0 and n < 5:
                    w = v
                    while w < 0.8:
                        w = np.float32(w * 2.0 + np.float32(0.1))
                        stored = (w, n, 0.0, 1.0)
                    v = np.float32(v + np.float32(w * np.float32(0.3)))
                    n += 1
                if n == 0:
                    stored = (v, -1.0, 0.0, 1.0)
                if stored is not None:
                    want[:, i, j] = stored
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)

    def test_switch_inside_loop(self):
        """A switch in a data-dependent loop body executes via the masked
        lowering (its tail breaks bind to the switch, not the loop)."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 10) {
                switch (n) {
                case 0: v += 0.1; break;
                default: v += 0.2; break;
                }
                n++;
            }
            imageStore(output_image, pos, vec4(v));
        """)
        a = np.asarray(img)[0]
        want = np.empty_like(a)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v = np.float32(a[i, j])
                n = 0
                while v < 1.0 and n < 10:
                    v = np.float32(
                        v + (np.float32(0.1) if n == 0 else np.float32(0.2))
                    )
                    n += 1
                want[i, j] = v
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_switch_fallthrough_inside_loop(self):
        """Fall-through cases compose with the loop carry."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            int n = 0;
            while (n < int(c.g * 5.0) + 1) {
                switch (n % 3) {
                    case 0: v += 1.0; break;
                    case 1: v += 0.25;
                    case 2: v += 0.0625; break;
                }
                n++;
            }
            imageStore(output_image, pos, vec4(v, 0.0, 0.0, 1.0));
        """)
        g = np.asarray(img)[1]
        trips = (g * 5).astype(int) + 1
        want = np.zeros_like(g)
        for i in range(g.shape[0]):
            for j in range(g.shape[1]):
                for nn in range(trips[i, j]):
                    m = nn % 3
                    want[i, j] += (
                        1.0 if m == 0 else 0.25 + 0.0625 if m == 1 else 0.0625
                    )
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_switch_midcase_break_in_loop(self):
        """A non-tail break inside a switch case, inside a data-dependent
        loop: the break binds to the SWITCH (lane kills scoped to the
        switch's activation region), not the loop."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            int n = 0;
            while (v < 1.0 && n < 10) {
                switch (n) {
                case 0:
                    if (v > 0.5) { break; }
                    v += 0.1;
                    break;
                default: v += 0.2; break;
                }
                n++;
            }
            imageStore(output_image, pos, vec4(v));
        """)
        a = np.asarray(img)[0]
        want = np.zeros_like(a)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v, n = float(a[i, j]), 0
                while v < 1.0 and n < 10:
                    if n == 0:
                        if not v > 0.5:
                            v += 0.1
                    else:
                        v += 0.2
                    n += 1
                want[i, j] = v
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-5)

    def test_continue_through_switch_in_loop(self):
        """`continue` inside a switch case binds to the enclosing
        data-dependent loop (skipping the rest of the switch AND the
        iteration remainder)."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            float v = imageLoad(input_image, pos).r;
            float acc = 0.0;
            int n = 0;
            while (n < 6 && acc < 2.0) {
                n++;
                switch (n % 2) {
                case 0:
                    if (v > 0.5) { continue; }
                    acc += 0.125;
                default:
                    acc += 0.25;
                    break;
                }
                acc += 0.5;
            }
            imageStore(output_image, pos, vec4(acc));
        """)
        a = np.asarray(img)[0]
        want = np.zeros_like(a)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                v, acc, n = float(a[i, j]), 0.0, 0
                while n < 6 and acc < 2.0:
                    n += 1
                    skip = False
                    if n % 2 == 0:
                        if v > 0.5:
                            continue
                        acc += 0.125
                        acc += 0.25  # fall through into default
                    else:
                        acc += 0.25
                    if not skip:
                        acc += 0.5
                want[i, j] = acc
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-5)

    def test_uniform_switch_with_break_under_divergent_if(self):
        """A uniform-selector switch whose cases end in `break` works
        inside per-pixel control flow (routed through the masked
        lowering; previously a hard error)."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float v = 0.0;
            int mode = 1;
            if (c.b > 0.5) {
                switch (mode) {
                    case 0: v = 5.0; break;
                    case 1: v = 7.0; break;
                    default: v = 9.0; break;
                }
            }
            imageStore(output_image, pos, vec4(v, 0.0, 0.0, 1.0));
        """)
        b = np.asarray(img)[2]
        np.testing.assert_allclose(
            np.asarray(out)[0], np.where(b > 0.5, 7.0, 0.0), atol=1e-6
        )


class TestDynamicIndexing:
    """Per-pixel (traced) indices into local arrays, vectors, and matrix
    columns: reads lower to per-lane gathers over stacked element planes,
    writes to one masked merge per element.  Out-of-bounds dynamic
    indices clamp (robustBufferAccess convention; GLSL leaves them
    undefined).  The reference compiles these natively via shaderc
    (shader.rs:73-93)."""

    def test_array_read_per_pixel_lut(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float lut[4] = float[](0.1, 0.3, 0.6, 1.0);
            int i = int(c.r * 4.0);
            imageStore(output_image, pos, vec4(lut[i], c.gba));
        """)
        r = np.asarray(img)[0]
        i = np.clip((r * 4).astype(int), 0, 3)
        want = np.array([0.1, 0.3, 0.6, 1.0], np.float32)[i]
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_array_write_per_pixel(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float acc[3] = float[](0.0, 0.0, 0.0);
            int i = int(c.g * 3.0);
            acc[i] = c.r;
            imageStore(output_image, pos, vec4(acc[0], acc[1], acc[2], 1.0));
        """)
        a = np.asarray(img)
        i = np.clip((a[1] * 3).astype(int), 0, 2)
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(out)[k], np.where(i == k, a[0], 0.0), atol=1e-6
            )

    def test_array_compound_assign_dynamic(self):
        """`arr[i] += v` evaluates as gather + masked merge."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float acc[2] = float[](0.25, 0.5);
            int i = int(c.b * 2.0);
            acc[i] += c.r;
            imageStore(output_image, pos, vec4(acc[0], acc[1], 0.0, 1.0));
        """)
        a = np.asarray(img)
        i = np.clip((a[2] * 2).astype(int), 0, 1)
        base = np.array([0.25, 0.5], np.float32)
        for k in range(2):
            np.testing.assert_allclose(
                np.asarray(out)[k],
                np.where(i == k, base[k] + a[0], base[k]),
                atol=1e-6,
            )

    def test_vector_dynamic_read_write(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            int i = int(c.a * 3.0);
            vec3 v = c.rgb;
            float picked = v[i];
            v[i] = 9.0;
            imageStore(output_image, pos, vec4(picked, v[0], v[1], v[2]));
        """)
        a = np.asarray(img)
        i = np.clip((a[3] * 3).astype(int), 0, 2)
        picked = np.take_along_axis(a[:3], i[None], 0)[0]
        np.testing.assert_allclose(np.asarray(out)[0], picked, atol=1e-6)
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(out)[1 + k], np.where(i == k, 9.0, a[k]), atol=1e-6
            )

    def test_vec_array_dynamic_read(self):
        """Arrays of vectors gather per component."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec2 pal[3] = vec2[](vec2(0.0, 0.5), vec2(0.25, 0.75), vec2(1.0, 0.125));
            int i = int(c.r * 3.0);
            vec2 p = pal[i];
            imageStore(output_image, pos, vec4(p.x, p.y, 0.0, 1.0));
        """)
        a = np.asarray(img)
        i = np.clip((a[0] * 3).astype(int), 0, 2)
        pal = np.array([[0.0, 0.5], [0.25, 0.75], [1.0, 0.125]], np.float32)
        np.testing.assert_allclose(np.asarray(out)[0], pal[i, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(out)[1], pal[i, 1], atol=1e-6)

    def test_matrix_dynamic_column(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            mat2 m = mat2(0.1, 0.2, 0.3, 0.4);
            int i = int(c.g * 2.0);
            vec2 col = m[i];
            imageStore(output_image, pos, vec4(col.x, col.y, 0.0, 1.0));
        """)
        a = np.asarray(img)
        i = np.clip((a[1] * 2).astype(int), 0, 1)
        cols = np.array([[0.1, 0.2], [0.3, 0.4]], np.float32)  # column-major
        np.testing.assert_allclose(np.asarray(out)[0], cols[i, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(out)[1], cols[i, 1], atol=1e-6)

    def test_dynamic_index_clamps_out_of_bounds(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float lut[2] = float[](0.25, 0.75);
            int i = int(c.r * 8.0) - 2;   // ranges well past both ends
            imageStore(output_image, pos, vec4(lut[i], 0.0, 0.0, 1.0));
        """)
        r = np.asarray(img)[0]
        i = np.clip((r * 8).astype(int) - 2, 0, 1)
        want = np.array([0.25, 0.75], np.float32)[i]
        np.testing.assert_allclose(np.asarray(out)[0], want, atol=1e-6)

    def test_dynamic_write_under_divergent_if(self):
        """The element merge composes with the enclosing lane mask."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float acc[2] = float[](0.0, 0.0);
            int i = int(c.g * 2.0);
            if (c.r > 0.5) { acc[i] = 1.0; }
            imageStore(output_image, pos, vec4(acc[0], acc[1], 0.0, 1.0));
        """)
        a = np.asarray(img)
        i = np.clip((a[1] * 2).astype(int), 0, 1)
        on = a[0] > 0.5
        for k in range(2):
            np.testing.assert_allclose(
                np.asarray(out)[k],
                np.where(on & (i == k), 1.0, 0.0),
                atol=1e-6,
            )

    def test_dynamic_index_inside_data_dependent_loop(self):
        """Arrays indexed by loop-carried values ride the while carry."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float hist[4] = float[](0.0, 0.0, 0.0, 0.0);
            int n = 0;
            while (n < int(c.r * 6.0) + 1) {
                hist[(n * 3) % 4] += 0.5;
                n++;
            }
            imageStore(output_image, pos, vec4(hist[0], hist[1], hist[2], hist[3]));
        """)
        a = np.asarray(img)
        trips = (a[0] * 6).astype(int) + 1
        want = np.zeros((4,) + a.shape[1:], np.float32)
        for y in range(a.shape[1]):
            for x in range(a.shape[2]):
                for nn in range(trips[y, x]):
                    want[(nn * 3) % 4, y, x] += 0.5
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-6)

    def test_dynamic_gather_in_loop_condition(self):
        """The loop condition may gather from a carried array."""
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float w[3] = float[](0.4, 0.3, 0.2);
            float v = c.r;
            int n = 0;
            while (v < w[n % 3] + 0.5 && n < 6) {
                v += 0.21;
                n++;
            }
            imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
        """)
        a = np.asarray(img)
        wts = [0.4, 0.3, 0.2]
        wantv = np.empty_like(a[0])
        wantn = np.empty_like(a[0])
        for y in range(a.shape[1]):
            for x in range(a.shape[2]):
                v = np.float32(a[0, y, x])
                n = 0
                while v < np.float32(wts[n % 3] + 0.5) and n < 6:
                    v = np.float32(v + np.float32(0.21))
                    n += 1
                wantv[y, x] = v
                wantn[y, x] = n
        np.testing.assert_allclose(np.asarray(out)[0], wantv, atol=1e-6)
        np.testing.assert_allclose(np.asarray(out)[1], wantn, atol=1e-6)


class TestExtendedBuiltins:
    """GLSL 4.50 builtins added for shaderc parity (reference
    shader.rs:73-93 compiles any conforming GLSL): geometric
    (refract/faceforward), fma/ldexp/modf/frexp, bit casts and bitfield
    ops, pack/unpack, and the non-square-free matrix set."""

    def test_refract_and_faceforward(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec3 i = normalize(vec3(c.r, c.g, -1.0));
            vec3 n = vec3(0.0, 0.0, 1.0);
            vec3 r = refract(i, n, 0.75);
            vec3 f = faceforward(n, i, n);
            imageStore(output_image, pos, vec4(r.x, r.y, r.z, f.z));
        """)
        a = np.asarray(img, np.float64)
        i = np.stack([a[0], a[1], -np.ones_like(a[0])])
        i = i / np.sqrt((i * i).sum(0))
        n = np.stack([np.zeros_like(a[0])] * 2 + [np.ones_like(a[0])])
        d = (n * i).sum(0)
        eta = 0.75
        k = 1.0 - eta * eta * (1.0 - d * d)
        r = np.where(k < 0, 0.0, eta * i - (eta * d + np.sqrt(np.maximum(k, 0))) * n)
        f = np.where(d < 0, 1.0, -1.0)  # faceforward z-component
        got = np.asarray(out)
        np.testing.assert_allclose(got[:3], r, atol=1e-5)
        np.testing.assert_allclose(got[3], f, atol=1e-6)

    def test_fma_ldexp_modf_frexp(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float x = c.r * 20.0 - 10.0;
            float whole;
            float frac = modf(x, whole);
            int e;
            float m = frexp(x, e);
            float back = ldexp(m, e);
            float f = fma(c.g, 2.0, c.b);
            imageStore(output_image, pos, vec4(frac + whole, back, f, float(e)));
        """)
        a = np.asarray(img)
        x = a[0] * np.float32(20.0) - np.float32(10.0)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], x, atol=1e-6)  # modf reassembles
        np.testing.assert_allclose(got[1], x, atol=1e-7)  # frexp/ldexp exact
        np.testing.assert_allclose(got[2], a[1] * 2.0 + a[2], atol=1e-6)
        m, e = np.frexp(x.astype(np.float32))
        np.testing.assert_array_equal(got[3], e.astype(np.float32))

    def test_mix_bool_selector(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec3 sel = mix(vec3(0.0), c.rgb, greaterThan(c.rgb, vec3(0.5)));
            imageStore(output_image, pos, vec4(sel, 1.0));
        """)
        a = np.asarray(img)
        want = np.where(a[:3] > 0.5, a[:3], 0.0)
        np.testing.assert_allclose(np.asarray(out)[:3], want, atol=1e-6)

    def test_bit_casts_roundtrip(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            int bi = floatBitsToInt(c.r);
            uint bu = floatBitsToUint(c.g);
            float r = intBitsToFloat(bi);
            float g = uintBitsToFloat(bu);
            float k = uintBitsToFloat(0x3F800000u);
            imageStore(output_image, pos, vec4(r, g, k, float(bi != 0)));
        """)
        a = np.asarray(img)
        got = np.asarray(out)
        np.testing.assert_array_equal(got[0], a[0])
        np.testing.assert_array_equal(got[1], a[1])
        np.testing.assert_array_equal(got[2], 1.0)

    def test_bit_counts(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            uint v = uint(imageLoad(input_image, pos).r * 4095.0);
            imageStore(output_image, pos, vec4(
                float(bitCount(v)), float(findLSB(v)), float(findMSB(v)),
                float(findMSB(0u))));
        """)
        a = np.asarray(img)
        v = (a[0] * 4095.0).astype(np.uint32)
        got = np.asarray(out)
        pc = np.vectorize(lambda x: bin(x).count("1"))(v)
        lsb = np.vectorize(
            lambda x: int(int(x) & -int(x)).bit_length() - 1 if x else -1
        )(v.astype(np.int64))
        msb = np.vectorize(lambda x: int(x).bit_length() - 1)(v)
        np.testing.assert_array_equal(got[0], pc.astype(np.float32))
        np.testing.assert_array_equal(got[1], lsb.astype(np.float32))
        np.testing.assert_array_equal(got[2], msb.astype(np.float32))
        np.testing.assert_array_equal(got[3], -1.0)

    def test_bitfield_ops(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            uint v = uint(imageLoad(input_image, pos).r * 65535.0);
            uint ext = bitfieldExtract(v, 4, 8);
            uint ins = bitfieldInsert(v, 0xABu, 8, 8);
            uint rev = bitfieldReverse(v);
            int sx = bitfieldExtract(int(v), 4, 8);
            imageStore(output_image, pos, vec4(
                float(ext), float(ins), float(rev >> 16u), float(sx)));
        """)
        a = np.asarray(img)
        v = (a[0] * 65535.0).astype(np.uint32).astype(np.int64)
        got = np.asarray(out)
        ext = (v >> 4) & 0xFF
        ins = (v & ~(0xFF << 8)) | (0xAB << 8)
        rev = np.vectorize(lambda x: int("{:032b}".format(int(x))[::-1], 2))(v)
        sx = (v >> 4) & 0xFF
        sx = np.where(sx >= 0x80, sx - 0x100, sx)
        np.testing.assert_array_equal(got[0], ext.astype(np.float32))
        np.testing.assert_array_equal(got[1], ins.astype(np.float32))
        np.testing.assert_array_equal(got[2], (rev >> 16).astype(np.float32))
        np.testing.assert_array_equal(got[3], sx.astype(np.float32))

    def test_pack_unpack_roundtrips(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            vec4 u8 = unpackUnorm4x8(packUnorm4x8(c));
            vec2 h = unpackHalf2x16(packHalf2x16(c.rg));
            vec2 s16 = unpackSnorm2x16(packSnorm2x16(c.rg * 2.0 - 1.0));
            imageStore(output_image, pos, vec4(u8.r, h.x, s16.x * 0.5 + 0.5, u8.a));
        """)
        a = np.asarray(img)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], a[0], atol=0.5 / 255)
        np.testing.assert_allclose(got[1], a[0].astype(np.float16).astype(np.float32), atol=1e-7)
        np.testing.assert_allclose(got[2], a[0], atol=0.5 / 32767 + 1e-6)
        np.testing.assert_allclose(got[3], a[3], atol=0.5 / 255)

    def test_pack_static_and_snorm8(self):
        out, _ = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            uint p = packUnorm4x8(vec4(1.0, 0.0, 0.5, 1.0));
            vec4 u = unpackUnorm4x8(p);
            vec4 s = unpackSnorm4x8(packSnorm4x8(vec4(-1.0, 1.0, 0.0, -0.5)));
            imageStore(output_image, pos, vec4(u.r, u.b, s.x * -0.5, s.y));
        """)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], 1.0, atol=1e-6)
        np.testing.assert_allclose(got[1], 128.0 / 255.0, atol=1e-6)
        np.testing.assert_allclose(got[2], 0.5, atol=1e-6)
        np.testing.assert_allclose(got[3], 1.0, atol=1e-6)

    def test_matrix_builtins(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            mat3 m = mat3(1.0 + c.r, c.g, 0.2,
                          c.b, 2.0, 0.1,
                          0.3, 0.4, 1.5 + c.a);
            mat3 mi = inverse(m);
            mat3 ident = m * mi;
            float det = determinant(m);
            mat3 cm = matrixCompMult(m, m);
            mat2 op = outerProduct(vec2(c.r, 2.0), vec2(3.0, c.g));
            imageStore(output_image, pos, vec4(
                ident[0][0] + ident[1][1] + ident[2][2],
                ident[0][1] + ident[1][0] + ident[2][1],
                cm[1][1] * 0.25 + op[1][0] - 2.0 * 3.0 + det * 0.0,
                op[0][1] - c.r * c.g + det / det));
        """)
        a = np.asarray(img)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], 3.0, atol=2e-4)   # trace(m*inv)
        np.testing.assert_allclose(got[1], 0.0, atol=2e-4)   # off-diagonals
        # cm[1][1] = 2^2; outerProduct(c, r)[j][i] = c_i * r_j, so
        # op[1][0] = c.r * c.g and op[0][1] = 2 * 3; det/det = 1.
        np.testing.assert_allclose(got[2], 1.0 + a[0] * a[1] - 6.0, atol=1e-5)
        np.testing.assert_allclose(got[3], 6.0 - a[0] * a[1] + 1.0, atol=1e-5)


class TestPreprocessor:
    """Conditional compilation (#ifdef/#if/#elif/#else/#endif, #undef,
    #error) — shaderc runs a full C preprocessor (reference
    shader.rs:73-93); inactive branches must vanish while diagnostic
    line numbers stay stable."""

    def test_if_elif_else_selects_one_branch(self):
        src = HEADER + """
#define MODE 2
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
#if MODE == 1
    c *= 0.0;
#elif MODE == 2
    c *= 2.0;
#else
    c *= 3.0;
#endif
    imageStore(output_image, pos, c);
}
"""
        spec = translate_shader(src, "pp")
        img = jnp.full((4, 8, 8), 0.25, jnp.float32)
        out = spec(KernelContext(width=8, height=8), {"input_image": img}, {})
        np.testing.assert_allclose(np.asarray(out["output_image"]), 0.5)

    def test_ifdef_hides_invalid_tokens_and_nested(self):
        src = HEADER + """
#define QUALITY 3
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
#ifdef UNSET_FLAG
    this is not even valid GLSL $$$;
#else
#if QUALITY > 2 && !defined(UNSET_FLAG)
    c += 0.125;
#endif
#endif
    imageStore(output_image, pos, c);
}
"""
        spec = translate_shader(src, "pp2")
        img = jnp.full((4, 8, 8), 0.25, jnp.float32)
        out = spec(KernelContext(width=8, height=8), {"input_image": img}, {})
        np.testing.assert_allclose(np.asarray(out["output_image"]), 0.375)

    def test_undef_and_error(self):
        src_ok = HEADER + """
#define K 1
#undef K
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
#ifdef K
#error K should be undefined
#endif
    imageStore(output_image, pos, imageLoad(input_image, pos));
}
"""
        translate_shader(src_ok, "pp3")  # must not raise
        src_err = HEADER + """
#define BAD 1
#ifdef BAD
#error deliberate failure
#endif
void main() {}
"""
        with pytest.raises(GlslError, match="deliberate failure"):
            translate_shader(src_err, "pp4")

    def test_unterminated_if_diagnostic(self):
        src = HEADER + "#if 1\nvoid main() {}\n"
        with pytest.raises(GlslError, match="unterminated"):
            translate_shader(src, "pp5")

    def test_line_numbers_survive_inactive_regions(self):
        # A syntax error AFTER a dropped block must carry its true
        # source line (inactive lines blank out, they don't collapse).
        src = HEADER + """
#ifdef NOPE
junk line
junk line
#endif
void main() {
    vec4 c = ;
}
"""
        with pytest.raises(GlslError) as ei:
            translate_shader(src, "pp6")
        assert ei.value.line == src[: src.index("vec4 c = ;")].count("\n") + 1

    def test_function_like_macros(self):
        src = HEADER + """
#define SAT(x) clamp(x, 0.0, 1.0)
#define SCALE(v, k) ((v) * (k))
#define LUMA(c) dot((c).rgb, vec3(0.2126, 0.7152, 0.0722))
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float y = LUMA(c);
    float s = SAT(SCALE(y, 2.0) - 0.25);
    imageStore(output_image, pos, vec4(s, float(__VERSION__ == 450),
                                       SAT(c.b), 1.0));
}
"""
        spec = translate_shader(src, "fmac")
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        out = spec(KernelContext(width=8, height=8), {"input_image": img}, {})
        a = np.asarray(img)
        y = 0.2126 * a[0] + 0.7152 * a[1] + 0.0722 * a[2]
        got = np.asarray(out["output_image"])
        np.testing.assert_allclose(got[0], np.clip(y * 2 - 0.25, 0, 1),
                                   atol=1e-6)
        np.testing.assert_allclose(got[1], 1.0)
        np.testing.assert_allclose(got[2], np.clip(a[2], 0, 1), atol=1e-6)

    def test_function_like_macro_errors(self):
        with pytest.raises(GlslError, match="expects 2"):
            translate_shader(
                HEADER + "#define H(a, b) a+b\n"
                "void main() { float r = H(1.0); }\n", "fm1"
            )
        with pytest.raises(GlslError, match="recursive"):
            translate_shader(
                HEADER + "#define R(x) R(x)\n"
                "void main() { float r = R(1.0); }\n", "fm2"
            )


class TestDeclarationsAndStructArrays:
    """Multi-declarator statements, backslash line continuations, and
    struct array members (all shaderc-conforming GLSL the parser
    previously rejected)."""

    def test_multi_declarator_statement(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            float a = c.r, b = a * 2.0, s = 0.0;
            for (int i = 0, n = 3; i < n; i++) { s += b; }
            imageStore(output_image, pos, vec4(s, a, b, 1.0));
        """)
        a = np.asarray(img)
        got = np.asarray(out)
        np.testing.assert_allclose(got[0], a[0] * 6.0, atol=1e-6)
        np.testing.assert_allclose(got[2], a[0] * 2.0, atol=1e-6)

    def test_line_continuation_in_macro_and_code(self):
        src = HEADER + """
#define SOFT(x) \\
    clamp((x) * 1.5 - \\
          0.25, 0.0, 1.0)
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float v = SOFT(c.r) + \\
              0.0;
    imageStore(output_image, pos, vec4(v, 0.0, 0.0, 1.0));
}
"""
        spec = translate_shader(src, "cont")
        rng = np.random.default_rng(9)
        img = jnp.asarray(rng.random((4, 8, 8), dtype=np.float32))
        out = spec(KernelContext(width=8, height=8), {"input_image": img}, {})
        a = np.asarray(img)
        np.testing.assert_allclose(
            np.asarray(out["output_image"])[0],
            np.clip(a[0] * 1.5 - 0.25, 0, 1), atol=1e-6,
        )

    def test_struct_array_member(self):
        out, img = run_shader("""
            ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
            vec4 c = imageLoad(input_image, pos);
            Ball b;
            b.pos = vec2(c.r, c.r * 2.0);
            b.w[0] = c.r; b.w[1] = c.r + 1.0; b.w[2] = c.r * c.r;
            float s = b.w[0] + b.w[1] + b.w[2] + b.pos.y;
            Ball q = Ball(vec2(0.5), float[](0.1, 0.2, 0.3));
            if (c.g > 0.5) { q.w[1] = 9.0; }
            imageStore(output_image, pos, vec4(s, q.w[1], q.w[2], 1.0));
        """, extra_decls="struct Ball { vec2 pos; float w[3]; };")
        a = np.asarray(img)
        got = np.asarray(out)
        want_s = a[0] + (a[0] + 1.0) + a[0] * a[0] + a[0] * 2.0
        np.testing.assert_allclose(got[0], want_s, atol=1e-5)
        np.testing.assert_allclose(got[1], np.where(a[1] > 0.5, 9.0, 0.2),
                                   atol=1e-6)
        np.testing.assert_allclose(got[2], 0.3, atol=1e-6)

    def test_array_of_arrays_diagnostic(self):
        with pytest.raises(GlslError, match="arrays of arrays"):
            translate_shader(
                HEADER + "void main() { float a[2][3]; }", "aoa"
            )
