"""Kernel library unit tests: reflection, numerics vs NumPy references."""

import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu.kernels import KernelContext, builtin_kernels, lookup_builtin
from reforge_tpu.kernels import ops


def rand_image(h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random((4, h, w), dtype=np.float32))


def ctx_for(img, t=0.0):
    return KernelContext(width=img.shape[2], height=img.shape[1], time=t)


def run(name, images, params=None, t=0.0):
    spec = lookup_builtin(name)
    assert spec is not None, f"builtin kernel {name} missing"
    if isinstance(images, jnp.ndarray):
        images = {"input_image": images}
    some = next(iter(images.values())) if images else None
    h, w = (some.shape[1], some.shape[2]) if some is not None else (16, 24)
    ctx = KernelContext(width=w, height=h, time=t)
    resolved = spec.resolve_params(params or {})
    return spec(ctx, images, resolved)["output_image"]


class TestReflection:
    def test_registry_has_core_kernels(self):
        names = set(builtin_kernels())
        for required in [
            "passthrough", "gaussian", "blur", "sharpen", "sobel", "tonemap",
            "blend", "invert", "grayscale", "bloom", "unsharp", "box_blur",
        ]:
            assert required in names

    def test_binding_reflection(self):
        blend = lookup_builtin("blend")
        assert blend.images_in == ("input_image", "input_image2")
        assert blend.images_out == ("output_image",)
        assert blend.params["factor"].default == 0.5

    def test_param_resolution_warns_on_unknown(self):
        from reforge_tpu import utils

        spec = lookup_builtin("gaussian")
        resolved = spec.resolve_params({"sigma": 2.0, "bogus": 1})
        assert resolved["sigma"] == 2.0
        assert any("bogus" in w for w in utils.recent_warnings())

    def test_param_coercion(self):
        spec = lookup_builtin("gaussian")
        assert spec.resolve_params({"sigma": 3})["sigma"] == 3.0
        assert isinstance(spec.resolve_params({"sigma": 3})["sigma"], float)

    def test_halo_reflection(self):
        g = lookup_builtin("gaussian")
        assert g.halo_for({"sigma": 4.0}) == 12
        p = lookup_builtin("passthrough")
        assert p.halo_for({}) == 0
        sw = lookup_builtin("swirl")
        assert sw.halo_for(sw.resolve_params({})) is None  # gather kernel


class TestNumerics:
    def test_passthrough_identity(self):
        img = rand_image()
        np.testing.assert_array_equal(np.asarray(run("passthrough", img)), img)

    def test_invert(self):
        img = rand_image()
        out = np.asarray(run("invert", img))
        np.testing.assert_allclose(out[:3], 1.0 - np.asarray(img)[:3], rtol=1e-6)
        np.testing.assert_array_equal(out[3], np.asarray(img)[3])

    def test_gaussian_matches_numpy(self):
        img = rand_image(32, 48)
        sigma = 2.0
        out = np.asarray(run("gaussian", img, {"sigma": sigma}))
        w = ops.gaussian_weights(sigma)
        r = (len(w) - 1) // 2
        ref = np.asarray(img)
        ref = np.pad(ref, ((0, 0), (r, r), (0, 0)), mode="edge")
        ref = np.stack(
            [sum(w[i] * ref[:, i : i + 32, :] for i in range(len(w)))], 0
        )[0]
        ref = np.pad(ref, ((0, 0), (0, 0), (r, r)), mode="edge")
        ref = sum(w[i] * ref[:, :, i : i + 48] for i in range(len(w)))
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_gaussian_preserves_constant(self):
        img = jnp.full((4, 20, 30), 0.625, jnp.float32)
        out = np.asarray(run("gaussian", img, {"sigma": 3.0}))
        np.testing.assert_allclose(out, 0.625, atol=1e-5)

    def test_zero_sigma_is_identity(self):
        img = rand_image()
        out = run("gaussian", img, {"sigma": 0.0})
        np.testing.assert_array_equal(np.asarray(out), np.asarray(img))

    def test_box_blur_mean(self):
        img = rand_image(12, 18)
        out = np.asarray(run("box_blur", img, {"radius": 1}))
        # Interior pixel equals 3x3 mean.
        ref = np.asarray(img)[:, 4:7, 4:7].mean(axis=(1, 2))
        np.testing.assert_allclose(out[:, 5, 5], ref, atol=1e-5)

    def test_sobel_flat_is_zero(self):
        img = jnp.full((4, 16, 16), 0.5, jnp.float32)
        out = np.asarray(run("sobel", img))
        np.testing.assert_allclose(out[:3], 0.0, atol=1e-6)

    def test_blend_midpoint(self):
        a = jnp.zeros((4, 8, 8), jnp.float32)
        b = jnp.ones((4, 8, 8), jnp.float32)
        out = np.asarray(
            run("blend", {"input_image": a, "input_image2": b}, {"factor": 0.25})
        )
        np.testing.assert_allclose(out, 0.25, atol=1e-6)

    def test_sepia_matrix(self):
        img = rand_image()
        out = np.asarray(run("sepia", {"input_image": img}, {}))
        a = np.asarray(img, np.float64)
        want_r = np.clip(0.393 * a[0] + 0.769 * a[1] + 0.189 * a[2], 0, 1)
        np.testing.assert_allclose(out[0], want_r, atol=1e-6)
        np.testing.assert_array_equal(out[3], a[3])
        # amount=0 is identity
        out0 = np.asarray(
            run("sepia", {"input_image": img}, {"amount": 0.0})
        )
        np.testing.assert_allclose(out0, np.asarray(img), atol=1e-7)

    def test_motion_blur_horizontal_matches_box(self):
        # angle 0 with n samples spanning length L averages horizontal
        # bilinear taps; on a constant-rows image it is an identity, and
        # on a vertical edge it smears horizontally only.
        img = rand_image()
        rows = np.asarray(img).copy()
        rows[:] = rows[:, :, :1]  # constant along x, varies by row
        out = np.asarray(
            run(
                "motion_blur",
                {"input_image": jnp.asarray(rows)},
                {"length": 8.0, "angle": 0.0},
            )
        )
        # horizontal drag on an x-constant image is an identity away
        # from the clamped left/right borders
        np.testing.assert_allclose(
            out[:3, :, 6:-6], rows[:3, :, 6:-6], atol=1e-5
        )
        cols = np.asarray(img).copy()
        cols[:] = cols[:, :1, :]  # constant along y, varies by column
        out2 = np.asarray(
            run(
                "motion_blur",
                {"input_image": jnp.asarray(cols)},
                {"length": 8.0, "angle": 90.0},
            )
        )
        np.testing.assert_allclose(
            out2[:3, 6:-6, :], cols[:3, 6:-6, :], atol=1e-5
        )

    def test_grayscale_luma(self):
        img = rand_image()
        out = np.asarray(run("grayscale", img))
        ref = (
            0.2126 * np.asarray(img)[0]
            + 0.7152 * np.asarray(img)[1]
            + 0.0722 * np.asarray(img)[2]
        )
        for c in range(3):
            np.testing.assert_allclose(out[c], ref, atol=1e-5)

    def test_median3_flat(self):
        img = jnp.full((4, 10, 10), 0.3, jnp.float32)
        out = np.asarray(run("median3", img))
        np.testing.assert_allclose(out, 0.3, atol=1e-6)

    def test_median3_rejects_salt(self):
        img = np.full((4, 9, 9), 0.5, np.float32)
        img[:3, 4, 4] = 1.0  # single salt pixel disappears under median
        out = np.asarray(run("median3", jnp.asarray(img)))
        np.testing.assert_allclose(out[:3, 4, 4], 0.5, atol=1e-6)

    def test_flip(self):
        img = rand_image()
        out = np.asarray(run("flip", img, {"horizontal": True}))
        np.testing.assert_array_equal(out, np.asarray(img)[:, :, ::-1])

    def test_generators(self):
        spec = lookup_builtin("checkerboard")
        ctx = KernelContext(width=64, height=32)
        out = spec(ctx, {}, spec.resolve_params({"size": 16}))["output_image"]
        assert out.shape == (4, 32, 64)
        v = np.asarray(out)
        assert v[0, 0, 0] != v[0, 0, 16]

    def test_tonemap_bounded(self):
        img = rand_image() * 10.0
        out = np.asarray(run("tonemap", img, {"exposure": 1.0}))
        assert out[:3].min() >= 0.0 and out[:3].max() <= 1.0

    def test_wave_uses_time(self):
        img = rand_image(32, 32, seed=3)
        out0 = np.asarray(run("wave", img, t=0.0))
        out1 = np.asarray(run("wave", img, t=0.37))
        assert not np.allclose(out0, out1)

    def test_swirl_center_fixed(self):
        img = rand_image(33, 33)
        out = np.asarray(run("swirl", img, {"angle": 1.5}))
        np.testing.assert_allclose(
            out[:, 16, 16], np.asarray(img)[:, 16, 16], atol=1e-4
        )

    def test_all_kernels_trace(self):
        """Every builtin kernel traces and returns the right shape."""
        img = rand_image(16, 24)
        for name, spec in builtin_kernels().items():
            images = {}
            for i, desc in enumerate(spec.images_in):
                images[desc] = rand_image(16, 24, seed=i)
            for desc in spec.ssbos_in:
                size = spec.ssbo_sizes.get(desc, 256)
                images[desc] = jnp.linspace(0.0, 1.0, size)
            ctx = KernelContext(width=24, height=16, time=0.5)
            out = spec(ctx, images, spec.resolve_params({}))
            for desc in spec.images_out:
                assert out[desc].shape == (4, 16, 24), name


class TestArtisticKernels:
    def test_posterize_levels(self):
        img = rand_image()
        out = np.asarray(run("posterize", img, {"levels": 4}))
        vals = np.unique(np.round(out[:3] * 3))
        assert len(vals) <= 4

    def test_dither_two_levels(self):
        img = jnp.full((4, 8, 8), 0.5, jnp.float32)
        out = np.asarray(run("dither", img, {"levels": 2}))
        # Mid-gray dithers to a mix of 0s and 1s.
        assert set(np.unique(out[0])) <= {0.0, 1.0}
        assert 0.2 < out[0].mean() < 0.8

    def test_kuwahara_flat_preserved(self):
        img = jnp.full((4, 24, 24), 0.4, jnp.float32)
        out = np.asarray(run("kuwahara", img, {"radius": 3}))
        np.testing.assert_allclose(out[:3], 0.4, atol=1e-4)

    def test_kuwahara_edge_preserving(self):
        # A hard vertical edge must stay sharper than a box blur leaves it.
        img = np.zeros((4, 24, 24), np.float32)
        img[:3, :, 12:] = 1.0
        img[3] = 1.0
        out = np.asarray(run("kuwahara", jnp.asarray(img), {"radius": 3}))
        box = np.asarray(run("box_blur", jnp.asarray(img), {"radius": 3}))
        # Transition width: pixels strictly between 0.1 and 0.9.
        kw = ((out[0] > 0.1) & (out[0] < 0.9)).sum()
        bx = ((box[0] > 0.1) & (box[0] < 0.9)).sum()
        assert kw < bx

    def test_lut1d_identity_curve(self):
        from reforge_tpu.kernels import KernelContext, lookup_builtin

        spec = lookup_builtin("lut1d")
        img = rand_image()
        curve = jnp.linspace(0.0, 255.0 / 255.0, 256)
        # An identity curve maps i/255 -> i/255 only for exact grid values;
        # use a quantized image so lookups are exact.
        imgq = jnp.round(img * 255.0) / 255.0
        ctx = KernelContext(width=24, height=16)
        out = spec(ctx, {"input_image": imgq, "Curve": curve}, {})["output_image"]
        np.testing.assert_allclose(np.asarray(out)[:3], np.asarray(imgq)[:3], atol=1e-6)


class TestColorGradingKernels:
    def test_hue_rotate_360_is_identity(self):
        img = rand_image()
        out = run("hue_saturation", img, {"hue": 360.0})
        np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)

    def test_saturation_zero_is_grayscale(self):
        img = rand_image()
        out = np.asarray(run("hue_saturation", img, {"saturation": 0.0}))
        i = np.asarray(img)
        y = 0.2126 * i[0] + 0.7152 * i[1] + 0.0722 * i[2]
        for c in range(3):
            np.testing.assert_allclose(out[c], y, atol=1e-5)

    def test_levels_remap(self):
        img = rand_image()
        out = np.asarray(run("levels", img, {"in_black": 0.2, "in_white": 0.8}))
        i = np.asarray(img)
        ref = np.clip((i[:3] - 0.2) / 0.6, 0, 1)
        np.testing.assert_allclose(out[:3], ref, atol=1e-5)

    def test_levels_gamma_midpoint(self):
        img = jnp.full((4, 8, 8), 0.25, jnp.float32)
        out = np.asarray(run("levels", img, {"gamma": 2.0}))
        np.testing.assert_allclose(out[:3], 0.5, atol=1e-5)  # 0.25^(1/2)


class TestEdgePreservingKernels:
    def test_bilateral_flat_region_equals_gaussian_norm(self):
        # On a constant image every range weight is 1: output == input.
        img = jnp.full((4, 16, 16), 0.6, jnp.float32)
        out = np.asarray(run("bilateral", img, {"radius": 3}))
        np.testing.assert_allclose(out[:3], 0.6, atol=1e-5)

    def test_bilateral_preserves_step_edge(self):
        # A hard luminance step must survive; a gaussian of the same radius
        # smears it.  Measure the edge-adjacent values.
        i = np.zeros((4, 16, 32), np.float32)
        i[:3, :, 16:] = 1.0
        i[3] = 1.0
        img = jnp.asarray(i)
        bi = np.asarray(run("bilateral", img, {"radius": 3, "sigma_range": 0.08}))
        ga = np.asarray(run("gaussian", img, {"sigma": 2.0}))
        assert bi[0, 8, 15] < 0.05 and bi[0, 8, 16] > 0.95  # edge intact
        assert 0.2 < ga[0, 8, 15] < 0.8  # gaussian smeared it

    def test_bilateral_alpha_passthrough(self):
        img = rand_image()
        out = np.asarray(run("bilateral", img))
        np.testing.assert_allclose(out[3], np.asarray(img)[3], atol=1e-6)


class TestStylizedKernels:
    def test_halftone_black_and_white_extremes(self):
        white = jnp.ones((4, 32, 32), jnp.float32)
        black = jnp.concatenate(
            [jnp.zeros((3, 32, 32)), jnp.ones((1, 32, 32))], 0
        ).astype(jnp.float32)
        ow = np.asarray(run("halftone", white, {"size": 8}))
        ob = np.asarray(run("halftone", black, {"size": 8}))
        assert ow[0].mean() > 0.9   # white page: almost no ink
        assert ob[0].mean() < 0.5   # black page: mostly ink

    def test_radial_blur_center_fixed_point(self):
        img = rand_image(h=33, w=33, seed=2)
        out = np.asarray(run("radial_blur", img, {"strength": 0.3}))
        i = np.asarray(img)
        # The exact center samples itself at every scale.
        np.testing.assert_allclose(out[:3, 16, 16], i[:3, 16, 16], atol=1e-4)
        # Zero strength is identity.
        out0 = np.asarray(run("radial_blur", img, {"strength": 0.0}))
        np.testing.assert_allclose(out0[:3], i[:3], atol=1e-4)
