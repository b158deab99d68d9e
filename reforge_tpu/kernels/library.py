"""Builtin kernel library.

The reference ships a single ``passthrough.comp`` shader and demonstrates
blur/edge/sharpen graphs in its README gifs without shipping them
(reference: shaders/passthrough.comp, README.md:11-23).  This library
provides those filters and more as builtin kernels so stock configs work
out of the box; any of them can be overridden by a same-named ``.comp`` or
``.py`` file in the shader path (semantics.add_file_paths probes files
before the registry).

All kernels operate on linear-light planar ``f32[4, H, W]`` and are pure jnp
— XLA fuses chains of them into single programs.  Separable convolutions go
through ``ops.sep_conv``, which runs the fused CUDA kernel on a GPU.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .base import kernel
from . import ops
from .ops import (
    box_weights,
    conv2d,
    gaussian_blur,
    gaussian_radius,
    gaussian_weights,
    luma,
    map_rgb,
    sample_bilinear,
    sep_conv,
    smoothstep,
)


# ---- identity / color ---------------------------------------------------


@kernel("passthrough", doc="Identity copy (reference: shaders/passthrough.comp).")
def passthrough(ctx, input_image):
    return input_image


@kernel("invert")
def invert(ctx, input_image):
    return map_rgb(input_image, lambda rgb: 1.0 - rgb)


@kernel("grayscale")
def grayscale(ctx, input_image):
    y = luma(input_image)
    return map_rgb(input_image, lambda rgb: jnp.broadcast_to(y[None], rgb.shape))


@kernel("sepia")
def sepia(ctx, input_image, *, amount=1.0):
    """Classic sepia tone matrix, lerped by ``amount``."""
    r, g, b = input_image[0], input_image[1], input_image[2]
    sr = 0.393 * r + 0.769 * g + 0.189 * b
    sg = 0.349 * r + 0.686 * g + 0.168 * b
    sb = 0.272 * r + 0.534 * g + 0.131 * b
    toned = jnp.stack([sr, sg, sb], axis=0)
    rgb = input_image[:3]
    out = rgb + (jnp.clip(toned, 0.0, 1.0) - rgb) * amount
    return ops.with_alpha(out, input_image[3])


@kernel("brightness_contrast")
def brightness_contrast(ctx, input_image, *, brightness=0.0, contrast=1.0):
    return map_rgb(input_image, lambda rgb: (rgb - 0.5) * contrast + 0.5 + brightness)


@kernel("saturation")
def saturation(ctx, input_image, *, amount=1.0):
    y = luma(input_image)[None]
    return map_rgb(input_image, lambda rgb: y + (rgb - y) * amount)


@kernel("gamma")
def gamma(ctx, input_image, *, value=2.2):
    inv = 1.0 / max(value, 1e-6)
    return map_rgb(input_image, lambda rgb: jnp.power(jnp.maximum(rgb, 0.0), inv))


@kernel("exposure")
def exposure(ctx, input_image, *, stops=0.0):
    return map_rgb(input_image, lambda rgb: rgb * (2.0 ** stops))


@kernel("threshold")
def threshold(ctx, input_image, *, value=0.5):
    y = luma(input_image)
    mask = (y > value).astype(input_image.dtype)[None]
    return map_rgb(input_image, lambda rgb: jnp.broadcast_to(mask, rgb.shape))


@kernel("white_balance")
def white_balance(ctx, input_image, *, temperature=0.0, tint=0.0):
    """Simple linear-light white-balance nudge: temperature shifts R/B, tint G."""

    def f(rgb):
        r = rgb[0] * (1.0 + temperature)
        g = rgb[1] * (1.0 + tint)
        b = rgb[2] * (1.0 - temperature)
        return jnp.stack([r, g, b], axis=0)

    return map_rgb(input_image, f)


# ---- tonemapping --------------------------------------------------------


def _aces(rgb: jnp.ndarray) -> jnp.ndarray:
    # Narkowicz 2015 ACES filmic approximation.
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e), 0.0, 1.0)


def _reinhard(rgb: jnp.ndarray) -> jnp.ndarray:
    return rgb / (1.0 + rgb)


@kernel("tonemap")
def tonemap(ctx, input_image, *, exposure=1.0, aces=True):
    f = _aces if aces else _reinhard
    return map_rgb(input_image, lambda rgb: f(rgb * exposure))


# ---- convolutions -------------------------------------------------------


def _sigma_halo(p):
    return gaussian_radius(p["sigma"]) if p["sigma"] > 0 else 0


def _stored_conv(ctx, x, w):
    """Separable conv of a node input at its storage precision.

    Under rgba16f the f32 input was just upcast from bf16 storage, so the
    conv can read the bf16 values (lossless) and halve what it reads; its
    result is rounded to bf16, as the node's own output is."""
    if ctx.fmt == "rgba16f":
        return sep_conv(x.astype(jnp.bfloat16), w, w).astype(jnp.float32)
    return sep_conv(x, w, w)


def _stored_blur(ctx, x, sigma):
    if float(sigma) <= 0.0:
        return x
    return _stored_conv(ctx, x, gaussian_weights(sigma))


@kernel("gaussian", halo=_sigma_halo, doc="Separable gaussian blur.")
def gaussian(ctx, input_image, *, sigma=4.0):
    return _stored_blur(ctx, input_image, sigma)


# "blur" is the name the reference README configs use.
@kernel("blur", halo=_sigma_halo)
def blur(ctx, input_image, *, sigma=4.0):
    return _stored_blur(ctx, input_image, sigma)


@kernel("box_blur", halo=lambda p: max(int(p["radius"]), 0))
def box_blur(ctx, input_image, *, radius=4):
    r = max(int(radius), 0)
    if r == 0:
        return input_image
    return _stored_conv(ctx, input_image, box_weights(r))


@kernel("sharpen", halo=lambda p: 1)
def sharpen(ctx, input_image, *, amount=1.0):
    """Laplacian unsharp: x + amount * (x - local mean)."""
    taps = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float32)
    high = conv2d(input_image, taps)
    return ops.map_rgb(input_image, lambda rgb: rgb + amount * high[:3])


@kernel("unsharp", halo=_sigma_halo)
def unsharp(ctx, input_image, *, sigma=2.0, amount=0.8):
    blurred = _stored_blur(ctx, input_image, sigma)
    return map_rgb(input_image, lambda rgb: rgb + amount * (rgb - blurred[:3]))


@kernel("sobel", halo=lambda p: 1)
def sobel(ctx, input_image, *, amount=1.0):
    """Sobel gradient magnitude of luminance."""
    y = luma(input_image)[None]
    gx = conv2d(y, np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32))
    gy = conv2d(y, np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32))
    mag = jnp.sqrt(gx * gx + gy * gy) * amount
    return map_rgb(input_image, lambda rgb: jnp.broadcast_to(mag, rgb.shape))


@kernel("emboss", halo=lambda p: 1)
def emboss(ctx, input_image, *, amount=1.0):
    taps = np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], dtype=np.float32)
    return map_rgb(input_image, lambda rgb: conv2d(rgb, taps * amount))


@kernel("median3", halo=lambda p: 1)
def median3(ctx, input_image):
    """3x3 median via a 9-element sorting network per pixel (one fused
    pass of shifted slices and 19 compare-exchanges)."""

    def med9(tap):
        v = [tap(dy, dx) for dy in range(3) for dx in range(3)]
        # Batcher-style network for median-of-9 (Smith's 19-exchange network).
        pairs = [
            (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
            (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
            (4, 2), (6, 4), (4, 2),
        ]
        for i, j in pairs:
            v[i], v[j] = jnp.minimum(v[i], v[j]), jnp.maximum(v[i], v[j])
        return v[4]

    med = ops.apply_stencil(input_image, 1, 1, med9)
    return ops.map_rgb(input_image, lambda rgb: med[:3])


@kernel("bloom", halo=lambda p: gaussian_radius(p["sigma"]))
def bloom(ctx, input_image, *, threshold=0.7, sigma=8.0, intensity=0.6):
    y = luma(input_image)
    glow_mask = smoothstep(threshold, threshold + 0.2, y)[None]
    glow = gaussian_blur(input_image[:3] * glow_mask, sigma)
    return map_rgb(input_image, lambda rgb: rgb + intensity * glow)


# ---- multi-input ---------------------------------------------------------


@kernel("mix")
def mix(ctx, input_image, input_image2, *, factor=0.5):
    return input_image + (input_image2 - input_image) * factor


# "blend" is the same kernel under the reference README's name.
import dataclasses as _dc  # noqa: E402

from .base import register_kernel as _register  # noqa: E402

_register(_dc.replace(mix, name="blend"))


@kernel("add")
def add(ctx, input_image, input_image2, *, scale=1.0):
    return map_rgb(input_image, lambda rgb: rgb + scale * input_image2[:3])


@kernel("multiply")
def multiply(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: rgb * input_image2[:3])


@kernel("screen")
def screen(ctx, input_image, input_image2):
    return map_rgb(
        input_image, lambda rgb: 1.0 - (1.0 - rgb) * (1.0 - input_image2[:3])
    )


@kernel("overlay")
def overlay(ctx, input_image, input_image2):
    def f(rgb):
        b = input_image2[:3]
        return jnp.where(rgb < 0.5, 2.0 * rgb * b, 1.0 - 2.0 * (1.0 - rgb) * (1.0 - b))

    return map_rgb(input_image, f)


@kernel("difference")
def difference(ctx, input_image, input_image2):
    return map_rgb(input_image, lambda rgb: jnp.abs(rgb - input_image2[:3]))


# ---- spatial / generative ----------------------------------------------


def _vignette_fade(ctx, strength, radius):
    h, w = ctx.height, ctx.width
    ys, xs = ops.grid_coords(ctx)
    ny = (ys.astype(jnp.float32) / max(h - 1, 1)) * 2.0 - 1.0
    nx = (xs.astype(jnp.float32) / max(w - 1, 1)) * 2.0 - 1.0
    d = jnp.sqrt(nx * nx + ny * ny)
    return 1.0 - strength * smoothstep(radius, 1.42, d)


@kernel("vignette")
def vignette(ctx, input_image, *, strength=0.5, radius=0.75):
    fade = _vignette_fade(ctx, strength, radius)
    return map_rgb(input_image, lambda rgb: rgb * fade[None])


@kernel("pixelate", halo=lambda p: None)
def pixelate(ctx, input_image, *, size=8):
    size = max(int(size), 1)
    ys, xs = ops.grid_coords(ctx)
    return ops.sample_nearest(input_image, (ys // size) * size, (xs // size) * size)


@kernel("chromatic_aberration", halo=lambda p: None)
def chromatic_aberration(ctx, input_image, *, shift=2.0):
    h, w = ctx.height, ctx.width
    ys, xs = ops.grid_coords(ctx)
    yf = ys.astype(jnp.float32)
    xf = xs.astype(jnp.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = (yf - cy) / max(h, 1)
    dx = (xf - cx) / max(w, 1)
    r = sample_bilinear(input_image[0:1], yf + dy * shift, xf + dx * shift)[0]
    b = sample_bilinear(input_image[2:3], yf - dy * shift, xf - dx * shift)[0]
    return jnp.stack([r, input_image[1], b, input_image[3]], axis=0)


@kernel("swirl", halo=lambda p: None)
def swirl(ctx, input_image, *, angle=2.0, radius=0.5):
    h, w = ctx.height, ctx.width
    ys, xs = ops.grid_coords(ctx)
    yf = ys.astype(jnp.float32)
    xf = xs.astype(jnp.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = yf - cy, xf - cx
    dist = jnp.sqrt(dx * dx + dy * dy)
    rad = radius * min(h, w)
    theta = angle * jnp.maximum(0.0, 1.0 - dist / rad) ** 2
    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    sy = cy + dy * cos_t - dx * sin_t
    sx = cx + dy * sin_t + dx * cos_t
    return sample_bilinear(input_image, sy, sx)


@kernel("scanlines")
def scanlines(ctx, input_image, *, period=3, darkness=0.35):
    ys, _ = ops.grid_coords(ctx)
    period = max(int(period), 1)
    fade = jnp.where((ys % period) == 0, 1.0 - darkness, 1.0)
    return map_rgb(input_image, lambda rgb: rgb * fade[None])


@kernel("wave", halo=lambda p: None)
def wave(ctx, input_image, *, amplitude=8.0, frequency=0.02, speed=1.0):
    """Animated horizontal wave distortion driven by _rf_time."""
    ys, xs = ops.grid_coords(ctx)
    yf = ys.astype(jnp.float32)
    xf = xs.astype(jnp.float32)
    phase = ctx.time * speed * 2.0 * math.pi
    offset = amplitude * jnp.sin(yf * (frequency * 2.0 * math.pi) + phase)
    return sample_bilinear(input_image, yf, xf + offset)


@kernel("noise", halo=lambda p: None)
def noise(ctx, input_image, *, amount=0.1, seed=0, animate=False):
    key = jax.random.PRNGKey(int(seed))
    if animate:
        # Fold the frame clock into the key so grain changes per frame.
        key = jax.random.fold_in(key, (ctx.time * 1000.0).astype(jnp.int32))
    grain = jax.random.uniform(
        key, (1,) + ctx.local_shape, minval=-0.5, maxval=0.5
    )
    return map_rgb(input_image, lambda rgb: rgb + amount * grain)


@kernel("checkerboard", images_in=(), doc="Generator: checkerboard test pattern.")
def checkerboard(ctx, *, size=32):
    size = max(int(size), 1)
    ys, xs = ops.grid_coords(ctx)
    v = (((ys // size) + (xs // size)) % 2).astype(jnp.float32)
    v = jnp.broadcast_to(v[None], (3,) + ctx.local_shape)
    return jnp.concatenate([v, jnp.ones((1,) + ctx.local_shape, v.dtype)], axis=0)


@kernel("solid", images_in=(), doc="Generator: constant color.")
def solid(ctx, *, red=0.0, green=0.0, blue=0.0, alpha=1.0):
    shape = ctx.local_shape
    return jnp.stack(
        [jnp.full(shape, c, jnp.float32) for c in (red, green, blue, alpha)], axis=0
    )


@kernel("flip", halo=lambda p: None)
def flip(ctx, input_image, *, horizontal=True, vertical=False):
    out = input_image
    if horizontal:
        out = out[:, :, ::-1]
    if vertical:
        out = out[:, ::-1, :]
    return out


@kernel("posterize")
def posterize(ctx, input_image, *, levels=6):
    """Quantize color channels to N levels."""
    n = max(int(levels), 2)
    return map_rgb(
        input_image,
        lambda rgb: jnp.round(jnp.clip(rgb, 0.0, 1.0) * (n - 1)) / (n - 1),
    )


@kernel("dither")
def dither(ctx, input_image, *, levels=2):
    """Ordered dithering with a 4x4 Bayer matrix."""
    n = max(int(levels), 2)
    bayer = (
        np.array(
            [[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
            np.float32,
        )
        + 0.5
    ) / 16.0
    ys, xs = ops.grid_coords(ctx)
    thresh = jnp.asarray(bayer)[ys % 4, xs % 4]

    def f(rgb):
        scaled = jnp.clip(rgb, 0.0, 1.0) * (n - 1)
        return (jnp.floor(scaled + thresh[None]) ) / (n - 1)

    return map_rgb(input_image, f)


@kernel("kuwahara", halo=lambda p: max(int(p["radius"]), 1))
def kuwahara(ctx, input_image, *, radius=4):
    """Kuwahara filter: per pixel, the mean of the least-variant of the four
    overlapping (r+1)x(r+1) quadrant windows — a classic painterly smoother,
    built from shifted box sums so it fuses like any separable conv."""
    r = max(int(radius), 1)
    half = np.zeros((2 * r + 1,), np.float32)
    half[: r + 1] = 1.0 / (r + 1)
    lead = half[::-1].copy()  # window covering [0, +r]
    lag = half  # window covering [-r, 0]

    y = luma(input_image)[None]
    # One conv per quadrant over a channel-stacked (6, H, W) field
    # (rgba + luma + luma^2): sep_conv treats leading dims as planes, so
    # stacking turns 12 convs into 4 with identical math.
    stacked = jnp.concatenate([input_image, y, y * y], axis=0)
    best_mean = None
    best_var = None
    for wy in (lag, lead):
        for wx in (lag, lead):
            s = sep_conv(stacked, wy, wx)
            m, my, my2 = s[:4], s[4:5], s[5:6]
            var = my2 - my * my
            if best_var is None:
                best_mean, best_var = m, var
            else:
                take = var < best_var
                best_mean = jnp.where(take, m, best_mean)
                best_var = jnp.where(take, var, best_var)
    return map_rgb(input_image, lambda rgb: best_mean[:3])


@kernel("lut1d", ssbos_in=("Curve",), ssbo_sizes={"Curve": 256})
def lut1d(ctx, input_image, Curve):
    """Map channels through a 256-entry tone curve stored in an SSBO."""

    def f(rgb):
        idx = jnp.clip(rgb * 255.0, 0.0, 255.0).astype(jnp.int32)
        return Curve[idx]

    return map_rgb(input_image, f)


# ---- color grading ------------------------------------------------------


def _hue_rotate_matrix(degrees: float) -> np.ndarray:
    """Static 3x3 linear-RGB hue-rotation matrix (the CSS/SVG feColorMatrix
    'hueRotate' formulation — the standard shader idiom for hue shifts)."""
    a = math.radians(float(degrees))
    c, s = math.cos(a), math.sin(a)
    return np.array(
        [
            [0.213 + c * 0.787 - s * 0.213, 0.715 - c * 0.715 - s * 0.715,
             0.072 - c * 0.072 + s * 0.928],
            [0.213 - c * 0.213 + s * 0.143, 0.715 + c * 0.285 + s * 0.140,
             0.072 - c * 0.072 - s * 0.283],
            [0.213 - c * 0.213 - s * 0.787, 0.715 - c * 0.715 + s * 0.715,
             0.072 + c * 0.928 + s * 0.072],
        ],
        dtype=np.float32,
    )


@kernel("hue_saturation")
def hue_saturation(ctx, input_image, *, hue=0.0, saturation=1.0, lightness=0.0):
    """Hue rotation (degrees) + saturation scale + lightness offset."""
    m = jnp.asarray(_hue_rotate_matrix(hue))

    def f(rgb):
        # A 3x3 f32 product: HIGHEST keeps it out of TF32 on the GPU.
        out = jnp.einsum("ij,jhw->ihw", m, rgb,
                         precision=jax.lax.Precision.HIGHEST)
        y = (out[0] * 0.2126 + out[1] * 0.7152 + out[2] * 0.0722)[None]
        out = y + (out - y) * saturation
        return out + lightness

    return map_rgb(input_image, f)


@kernel("levels")
def levels(ctx, input_image, *, in_black=0.0, in_white=1.0, gamma=1.0,
           out_black=0.0, out_white=1.0):
    """Photoshop-style levels: input range remap, gamma, output range."""
    span = max(float(in_white) - float(in_black), 1e-6)

    def f(rgb):
        t = jnp.clip((rgb - in_black) / span, 0.0, 1.0)
        t = t ** (1.0 / max(float(gamma), 1e-6))
        return out_black + t * (float(out_white) - float(out_black))

    return map_rgb(input_image, f)


# ---- edge-preserving / stylized -----------------------------------------


def _bilateral_halo(p):
    return int(p["radius"])


@kernel("bilateral", halo=_bilateral_halo)
def bilateral(ctx, input_image, *, radius=3, sigma_space=2.0, sigma_range=0.15):
    """Edge-preserving bilateral filter.

    Shifted-window formulation: every (dy, dx) tap is an edge-padded shift
    (no gather — stays halo-shardable and XLA-fusable); the range kernel
    weights each shifted neighbor by luminance similarity."""
    r = max(int(radius), 1)
    ss = max(float(sigma_space), 1e-3)
    sr = max(float(sigma_range), 1e-3)
    x = input_image
    y0_full = luma(x)
    inv2ss = 1.0 / (2.0 * ss * ss)
    inv2sr = 1.0 / (2.0 * sr * sr)

    taps_list = []
    spatial = {}
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            ws = math.exp(-((dy - r) ** 2 + (dx - r) ** 2) * inv2ss)
            if ws >= 1e-4:
                taps_list.append((dy, dx))
                spatial[(dy, dx)] = ws

    def tap_fn(tap, center, dy, dx):
        # Channels: r, g, b, luma.  The accumulator carries weighted rgb
        # plus the weight sum; the range weight is luma similarity to the
        # center scaled by the spatial gaussian.
        n = tap(dy, dx)
        wr = jnp.exp(-((n[3] - center[3]) ** 2) * inv2sr) * spatial[(dy, dx)]
        return jnp.concatenate([n[:3] * wr, wr[None]], axis=0)

    def final_fn(acc):
        return acc[:3] / acc[3]

    stacked = jnp.concatenate([x[:3], y0_full[None]], axis=0)

    def reduce_taps(tap):
        center = tap(r, r)
        acc = None
        for dy, dx in taps_list:
            t = tap_fn(tap, center, dy, dx)
            acc = t if acc is None else acc + t
        return final_fn(acc)

    # The taps are shifted slices of one padded array; XLA fuses the chain.
    rgb = ops.apply_stencil(stacked, r, r, reduce_taps)
    return ops.with_alpha(rgb, x[3])


@kernel("halftone", halo=lambda p: None)
def halftone(ctx, input_image, *, size=8, angle=0.0):
    """Newspaper halftone: per-cell luminance controls a round dot."""
    cell = max(int(size), 2)
    ys, xs = ops.grid_coords(ctx)
    a = math.radians(float(angle))
    ca, sa = math.cos(a), math.sin(a)
    # Rotated grid coordinates.
    u = xs * ca + ys * sa
    v = -xs * sa + ys * ca
    cu = jnp.floor(u / cell) * cell + cell / 2.0
    cv = jnp.floor(v / cell) * cell + cell / 2.0
    # Cell center back in image space (gather → not halo-shardable).
    cx = cu * ca - cv * sa
    cy = cu * sa + cv * ca
    sample = ops.sample_bilinear(input_image, cy, cx)
    y = (sample[0] * 0.2126 + sample[1] * 0.7152 + sample[2] * 0.0722)
    dot_r = jnp.sqrt(jnp.clip(1.0 - y, 0.0, 1.0)) * (cell * 0.7)
    d = jnp.sqrt((u - cu) ** 2 + (v - cv) ** 2)
    # Inside the dot (d < r-1.5) ink is 1, easing to 0 at the rim; dark
    # cells grow large black dots on the white page.
    ink = smoothstep(dot_r, dot_r - 1.5, d)
    out = jnp.broadcast_to((1.0 - ink)[None], input_image[:3].shape)
    return ops.with_alpha(out, input_image[3])


@kernel("motion_blur", halo=lambda p: None)
def motion_blur(ctx, input_image, *, length=12.0, angle=0.0, samples=0):
    """Directional blur: average samples along the motion vector.

    ``angle`` in degrees (0 = horizontal drag), ``length`` in pixels
    end-to-end; ``samples`` 0 picks one per pixel of length."""
    L = max(float(length), 0.0)
    if L == 0.0:
        return input_image
    n = int(samples) if int(samples) >= 2 else max(int(L), 2)
    th = float(angle) * np.pi / 180.0
    dy, dx = float(np.sin(th)), float(np.cos(th))
    ys, xs = ops.grid_coords(ctx)
    yf = ys.astype(jnp.float32)
    xf = xs.astype(jnp.float32)
    acc = None
    for i in range(n):
        t = (i / (n - 1) - 0.5) * L
        s = ops.sample_bilinear(input_image, yf + dy * t, xf + dx * t)
        acc = s if acc is None else acc + s
    out = acc / n
    return ops.with_alpha(out[:3], input_image[3])


@kernel("radial_blur", halo=lambda p: None)
def radial_blur(ctx, input_image, *, strength=0.15, samples=12,
                center_x=0.5, center_y=0.5):
    """Zoom blur: average samples along the ray toward the center."""
    n = max(int(samples), 2)
    ys, xs = ops.grid_coords(ctx)
    cy = float(center_y) * (ctx.height - 1)
    cx = float(center_x) * (ctx.width - 1)
    acc = None
    for i in range(n):
        t = 1.0 - float(strength) * (i / (n - 1))
        sy = cy + (ys - cy) * t
        sx = cx + (xs - cx) * t
        s = ops.sample_bilinear(input_image, sy, sx)
        acc = s if acc is None else acc + s
    out = acc / n
    return ops.with_alpha(out[:3], input_image[3])
