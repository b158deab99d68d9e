"""Shared image math for kernels: padding, separable convolution, sampling.

All functions operate on planar ``f32[4, H, W]`` (or ``f32[C, H, W]``)
arrays.  Convolutions are written as static unrolled shifted-adds over
padded arrays: XLA fuses the pad and the tap loop into one loop fusion,
which beats a general conv lowering for the small 1-D kernels typical of
image filters.  Border policy is clamp-to-edge unless a caller asks for
zeros (the visual convention of the reference's demo shaders).

The one hand-written kernel is the fused separable convolution for
Hopper GPUs (``cuda_sepconv.py``); ``sep_conv`` decides when it runs.
"""

from __future__ import annotations

import contextvars
import math

import jax
import jax.numpy as jnp
import numpy as np

def pad_edge(x: jnp.ndarray, rh: int, rw: int) -> jnp.ndarray:
    """Clamp-to-edge padding of the spatial dims of (C, H, W)."""
    if rh == 0 and rw == 0:
        return x
    return jnp.pad(x, ((0, 0), (rh, rh), (rw, rw)), mode="edge")


def _pad_mode(mode: str) -> str:
    if mode not in ("edge", "zero"):
        raise ValueError(f"border mode must be 'edge' or 'zero', got {mode!r}")
    return "edge" if mode == "edge" else "constant"


def conv1d(x: jnp.ndarray, weights: np.ndarray, axis: int,
           mode: str = "edge") -> jnp.ndarray:
    """1-D correlation along ``axis`` with clamp-to-edge (or zero) borders.

    ``weights`` must be a static numpy array of odd length; taps unroll at
    trace time.
    """
    weights = np.asarray(weights, dtype=np.float32)
    r = (len(weights) - 1) // 2
    if r == 0:
        return x * float(weights[0])
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = jnp.pad(x, pad, mode=_pad_mode(mode))
    size = x.shape[axis]
    acc = None
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        tap = jax.lax.slice_in_dim(xp, i, i + size, axis=axis)
        acc = tap * float(w) if acc is None else acc + tap * float(w)
    return acc if acc is not None else jnp.zeros_like(x)


# ---- the custom-kernel capability ------------------------------------------

_plain_only = contextvars.ContextVar("reforge_plain_kernels", default=False)


class plain_kernels:
    """Trace only the plain jnp kernels inside this block.

    Used where a custom call cannot go (GSPMD cannot partition one,
    parallel/spatial.py) and for the reference that the CUDA kernels are
    checked against.  The choice is made while tracing, so a program
    traced inside the block keeps the plain kernels: build a separate
    program for each side.  Thread- and context-local."""

    def __enter__(self):
        self._token = _plain_only.set(True)
        return self

    def __exit__(self, *exc):
        _plain_only.reset(self._token)
        return False


def custom_kernels_ok() -> bool:
    """Whether the hand-written CUDA kernels may be traced here: the
    default backend is a GPU and no ``plain_kernels`` block is active.
    Per-device traces (shard_map bodies, pipeline stages, batch maps) may
    use them."""
    return not _plain_only.get() and jax.default_backend() == "gpu"


SEPCONV_KERNEL_DTYPES = (jnp.float32, jnp.bfloat16)


def use_sepconv_kernel(x: jnp.ndarray, rh: int, rw: int) -> bool:
    """Whether ``sep_conv`` runs the fused CUDA kernel for this call.

    Only where custom kernels may be traced, for f32 or bf16 planes, for a
    real 2-D or 1-D conv, and for radii whose halo-extended tiles fit the
    kernel's shared-memory budget (``cuda_sepconv.fits``).  Larger radii
    run the plain path.  This is a choice made while tracing, not a
    fallback on error."""
    from . import cuda_sepconv

    return (
        custom_kernels_ok()
        and x.ndim >= 2
        and x.dtype in SEPCONV_KERNEL_DTYPES
        and (rh > 0 or rw > 0)
        and cuda_sepconv.fits(rh, rw, x.dtype.itemsize)
    )


def sep_conv(x: jnp.ndarray, wh: np.ndarray, ww: np.ndarray,
             mode: str = "edge") -> jnp.ndarray:
    """Separable 2-D correlation: a 1-D pass along H, then along W.

    The last two dims are (H, W); leading dims are planes.  Sums are f32
    whatever the input dtype, and the result has the input's dtype.  See
    ``use_sepconv_kernel`` for when the fused CUDA kernel runs; otherwise
    the plain jnp passes do."""
    wh = np.asarray(wh, np.float32)
    ww = np.asarray(ww, np.float32)
    _pad_mode(mode)
    if use_sepconv_kernel(x, (len(wh) - 1) // 2, (len(ww) - 1) // 2):
        from . import cuda_sepconv

        return cuda_sepconv.sep_conv(x, wh, ww, mode)
    xf = x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
    out = conv1d(conv1d(xf, wh, x.ndim - 2, mode), ww, x.ndim - 1, mode)
    return out.astype(x.dtype)


def apply_stencil(x: jnp.ndarray, rh: int, rw: int, fn,
                  mode: str = "edge") -> jnp.ndarray:
    """Evaluate a per-pixel neighborhood function over (..., H, W).

    ``fn(tap)`` receives ``tap(dy, dx)`` returning the neighbor shifted by
    ``(dy - rh, dx - rw)`` and must be elementwise in the array it returns
    (same spatial shape as a tap).  Taps are shifted slices of one padded
    array; XLA fuses the pad, the slices and fn into one pass."""
    pad = [(0, 0)] * (x.ndim - 2) + [(rh, rh), (rw, rw)]
    xp = jnp.pad(x, pad, mode=_pad_mode(mode))
    h, w = x.shape[-2], x.shape[-1]

    def tap(dy: int, dx: int):
        start = (0,) * (x.ndim - 2) + (dy, dx)
        size = x.shape[: x.ndim - 2] + (h, w)
        return jax.lax.dynamic_slice(xp, start, size)

    return fn(tap)


def conv2d(x: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """Small dense 2-D correlation (static odd-sized kernel, edge clamp),
    summed in ascending (dy, dx) order."""
    taps = np.asarray(taps, dtype=np.float32)
    rh, rw = taps.shape[0] // 2, taps.shape[1] // 2
    if rh == 0 and rw == 0:
        return x * float(taps[0, 0])

    def weighted_sum(tap):
        acc = None
        for dy in range(taps.shape[0]):
            for dx in range(taps.shape[1]):
                wgt = float(taps[dy, dx])
                if wgt != 0.0:
                    t = tap(dy, dx) * wgt
                    acc = t if acc is None else acc + t
        return acc if acc is not None else tap(rh, rw) * 0.0

    return apply_stencil(x, rh, rw, weighted_sum)


def gaussian_weights(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1-D gaussian taps; radius defaults to ceil(3*sigma)."""
    sigma = max(float(sigma), 1e-6)
    if radius is None:
        radius = gaussian_radius(sigma)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (xs / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


MAX_GAUSSIAN_RADIUS = 96


def gaussian_radius(sigma: float) -> int:
    return int(min(MAX_GAUSSIAN_RADIUS, max(1, math.ceil(3.0 * float(sigma)))))


def gaussian_blur(x: jnp.ndarray, sigma: float) -> jnp.ndarray:
    if float(sigma) <= 0.0:
        return x
    w = gaussian_weights(sigma)
    return sep_conv(x, w, w)


def box_weights(radius: int) -> np.ndarray:
    n = 2 * int(radius) + 1
    return np.full((n,), 1.0 / n, dtype=np.float32)


LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)  # Rec.709, linear light


def luma(x: jnp.ndarray) -> jnp.ndarray:
    """(4,H,W) -> (H,W) relative luminance."""
    r, g, b = x[0], x[1], x[2]
    lr, lg, lb = LUMA_WEIGHTS
    return r * lr + g * lg + b * lb


def with_alpha(rgb: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Stack (3,H,W) color with an (H,W) alpha plane into (4,H,W)."""
    return jnp.concatenate([rgb, alpha[None]], axis=0)


def map_rgb(x: jnp.ndarray, f) -> jnp.ndarray:
    """Apply f to the color planes, passing alpha through unchanged."""
    return jnp.concatenate([f(x[:3]), x[3:4]], axis=0)


def pixel_coords(h: int, w: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(y, x) integer coordinate planes, each (H, W) int32."""
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return ys, xs


def grid_coords(ctx) -> tuple[jnp.ndarray, jnp.ndarray]:
    """GLOBAL (y, x) coordinate planes for the local block of ``ctx``.

    Shard-correct: shapes follow the local block, values follow the global
    image (row_offset may be a traced per-device index inside shard_map).
    """
    h, w = ctx.local_shape
    ys, xs = pixel_coords(h, w)
    off = ctx.row_offset
    if not (isinstance(off, int) and off == 0):
        ys = ys + jnp.asarray(off, jnp.int32)
    return ys, xs


def sample_nearest(x: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Gather pixels at integer coords (clamped to edge).

    ``ys``/``xs`` are (H', W') int arrays; result is (C, H', W').  This is
    the general data-dependent path (swirl, pixelate, ...); kernels using it
    are not halo-shardable and fall back to gathered execution.
    """
    c, h, w = x.shape
    ys = jnp.clip(ys, 0, h - 1)
    xs = jnp.clip(xs, 0, w - 1)
    return x[:, ys, xs]


def sample_bilinear(x: jnp.ndarray, yf: jnp.ndarray, xf: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample at float pixel coords (edge clamp); (C, H', W')."""
    y0 = jnp.floor(yf)
    x0 = jnp.floor(xf)
    ty = yf - y0
    tx = xf - x0
    y0 = y0.astype(jnp.int32)
    x0 = x0.astype(jnp.int32)
    p00 = sample_nearest(x, y0, x0)
    p01 = sample_nearest(x, y0, x0 + 1)
    p10 = sample_nearest(x, y0 + 1, x0)
    p11 = sample_nearest(x, y0 + 1, x0 + 1)
    top = p00 + (p01 - p00) * tx
    bot = p10 + (p11 - p10) * tx
    return top + (bot - top) * ty


def smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
