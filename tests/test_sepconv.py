"""Separable convolution and stencils: the plain jnp path against float64
numpy, the choice between it and the CUDA kernel, and the kernel's FFI
wrapper.  The kernel itself runs only on a GPU (``gpu`` marker; the 4K
comparison is phase 5 of chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu.kernels import cuda_sepconv, ops


def rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32)


def corr1d_f64(x, w, axis, mode):
    """float64 1-D correlation along ``axis`` with edge or zero borders."""
    r = len(w) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="edge" if mode == "edge" else "constant")
    n = x.shape[axis]
    return sum(
        float(wk) * np.take(xp, np.arange(k, k + n), axis=axis)
        for k, wk in enumerate(w)
    )


def sep_conv_f64(x, wh, ww, mode):
    x = np.asarray(x, np.float64)
    return corr1d_f64(corr1d_f64(x, wh, x.ndim - 2, mode), ww, x.ndim - 1, mode)


def taps(r, seed):
    """Asymmetric positive taps summing to 1 (orientation bugs show)."""
    w = np.random.default_rng(seed).uniform(0.1, 1.0, 2 * r + 1)
    return (w / w.sum()).astype(np.float32)


def bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(max(v, 2.0 ** -126))) - 7)


# ---- plain separable conv against float64 ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("radius", [1, 2, 4, 12, 25, 48, 96])
def test_sep_conv_matches_float64(radius, mode, dtype):
    # Ragged shapes: no dim a multiple of 8, H smaller than the radius.
    x = jnp.asarray(rand((3, 37, 53), seed=radius)).astype(dtype)
    wh, ww = taps(radius, 1), taps(max(radius // 2, 1), 2)
    got = ops.sep_conv(x, wh, ww, mode)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = sep_conv_f64(np.asarray(x.astype(jnp.float32)), wh, ww, mode)
    d = np.abs(np.asarray(got.astype(jnp.float32), np.float64) - want).max()
    # f32: summation order only; bf16: the result is rounded to bf16 once.
    tol = 1e-5 if dtype == "float32" else bf16_ulp(np.abs(want).max())
    assert d <= tol, (d, tol)


def test_sep_conv_rejects_unknown_border():
    with pytest.raises(ValueError, match="border mode"):
        ops.sep_conv(jnp.zeros((1, 8, 8)), taps(1, 0), taps(1, 0), "wrap")


# ---- plain stencils ---------------------------------------------------------


def test_conv2d_matches_float64():
    x = rand((4, 50, 90), seed=9)
    k = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
    got = np.asarray(ops.conv2d(jnp.asarray(x), k))
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1)), mode="edge")
    want = sum(
        float(k[dy, dx]) * xp[:, dy:dy + 50, dx:dx + 90]
        for dy in range(3) for dx in range(3)
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_median_network_matches_numpy():
    x = rand((1, 30, 40), seed=10)

    def med9(tap):
        v = [tap(dy, dx) for dy in range(3) for dx in range(3)]
        pairs = [
            (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
            (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
            (2, 5), (4, 7), (4, 2), (6, 4), (4, 2),
        ]
        for i, j in pairs:
            v[i], v[j] = jnp.minimum(v[i], v[j]), jnp.maximum(v[i], v[j])
        return v[4]

    got = np.asarray(ops.apply_stencil(jnp.asarray(x), 1, 1, med9))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1)), mode="edge")
    stack = np.stack([
        xp[:, dy:dy + 30, dx:dx + 40] for dy in range(3) for dx in range(3)
    ])
    np.testing.assert_allclose(got, np.median(stack, axis=0), atol=1e-6)


def test_stencil_zero_mode():
    x = rand((1, 20, 30), seed=11)
    got = np.asarray(ops.apply_stencil(
        jnp.asarray(x), 1, 1, lambda tap: tap(0, 1), mode="zero"
    ))
    # tap(0, 1)[y, x] = x[y - 1, x]: the row above, zero at the top edge.
    want = np.zeros_like(x)
    want[:, 1:, :] = x[:, :-1, :]
    np.testing.assert_array_equal(got, want)


def test_stencil_any_leading_dims():
    x = rand((2, 3, 12, 14), seed=12)
    got = np.asarray(ops.apply_stencil(
        jnp.asarray(x), 2, 1, lambda tap: tap(4, 2) - tap(0, 0)
    ))
    xp = np.pad(x, ((0, 0), (0, 0), (2, 2), (1, 1)), mode="edge")
    want = xp[..., 4:16, 2:16] - xp[..., 0:12, 0:14]
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---- which calls reach the CUDA kernel --------------------------------------


@pytest.fixture
def on_gpu(monkeypatch):
    """Pretend the default backend is a GPU; the kernel call is a spy that
    records its arguments and answers with the plain path."""
    calls = []

    def spy(x, wh, ww, mode="edge"):
        calls.append((x.shape, x.dtype, len(wh), len(ww), mode))
        with ops.plain_kernels():
            return ops.sep_conv(x, wh, ww, mode)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda_sepconv, "sep_conv", spy)
    return calls


def test_kernel_never_chosen_on_cpu():
    assert jax.default_backend() == "cpu"
    assert not ops.custom_kernels_ok()
    assert not ops.use_sepconv_kernel(jnp.zeros((4, 8, 8)), 4, 4)


# (shape, dtype, rh, rw) -> whether the kernel takes the call
KERNEL_CHOICE = {
    "f32_planes": ((4, 64, 64), jnp.float32, 12, 12, True),
    "bf16_planes": ((4, 64, 64), jnp.bfloat16, 12, 12, True),
    "batched_planes": ((2, 6, 64, 64), jnp.float32, 4, 4, True),
    "single_plane": ((64, 64), jnp.float32, 4, 4, True),
    "h_only": ((4, 64, 64), jnp.float32, 3, 0, True),
    "f16_plain": ((4, 64, 64), jnp.float16, 4, 4, False),
    "int_plain": ((4, 64, 64), jnp.int32, 4, 4, False),
    "row_vector_plain": ((64,), jnp.float32, 4, 4, False),
    "no_taps_plain": ((4, 64, 64), jnp.float32, 0, 0, False),
    "f32_max_radius": ((4, 64, 64), jnp.float32, 40, 40, True),
    "f32_over_budget": ((4, 64, 64), jnp.float32, 41, 41, False),
    "bf16_max_radius": ((4, 64, 64), jnp.bfloat16, 64, 64, True),
    "bf16_over_budget": ((4, 64, 64), jnp.bfloat16, 65, 65, False),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CHOICE))
def test_kernel_choice(case, on_gpu):
    shape, dtype, rh, rw, chosen = KERNEL_CHOICE[case]
    x = jnp.zeros(shape, dtype)
    assert ops.use_sepconv_kernel(x, rh, rw) is chosen
    with ops.plain_kernels():
        assert not ops.use_sepconv_kernel(x, rh, rw)


def test_smem_budget_sets_the_radius_limit():
    budget = cuda_sepconv.SMEM_BUDGET
    assert cuda_sepconv.smem_bytes(40, 40, 4) <= budget
    assert cuda_sepconv.smem_bytes(41, 41, 4) > budget
    assert cuda_sepconv.smem_bytes(64, 64, 2) <= budget
    assert cuda_sepconv.smem_bytes(65, 65, 2) > budget


def test_sep_conv_routes_to_kernel(on_gpu):
    x = jnp.asarray(rand((4, 40, 70), seed=3))
    wh, ww = taps(4, 3), taps(2, 4)
    got = jax.jit(lambda a: ops.sep_conv(a, wh, ww, "zero"))(x)
    assert on_gpu == [((4, 40, 70), jnp.float32, 9, 5, "zero")]
    want = sep_conv_f64(np.asarray(x), wh, ww, "zero")
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_over_budget_radius_runs_plain(on_gpu):
    x = jnp.asarray(rand((1, 24, 24), seed=5))
    w = taps(48, 6)
    got = ops.sep_conv(x, w, w)
    assert on_gpu == []
    np.testing.assert_allclose(
        np.asarray(got), sep_conv_f64(np.asarray(x), w, w, "edge"), atol=1e-5
    )


def test_rgba16f_nodes_convolve_in_bf16(on_gpu):
    """Under rgba16f a conv node hands the kernel its bf16 storage values."""
    from reforge_tpu.kernels import KernelContext, lookup_builtin

    spec = lookup_builtin("gaussian")
    x = jnp.asarray(rand((4, 32, 48), seed=7)).astype(jnp.bfloat16)
    for fmt, dtype in (("rgba16f", jnp.bfloat16), ("rgba32f", jnp.float32)):
        ctx = KernelContext(width=48, height=32, fmt=fmt)
        out = spec(ctx, {"input_image": x.astype(jnp.float32)},
                   spec.resolve_params({"sigma": 2.0}))["output_image"]
        assert out.dtype == jnp.float32
        assert on_gpu[-1][1] == dtype


# ---- the FFI wrapper ----------------------------------------------------------


def _custom_calls(fn, *shapes):
    text = (
        jax.jit(fn).trace(*shapes).lower(lowering_platforms=("cuda",)).as_text()
    )
    return [line for line in text.splitlines() if "custom_call" in line]


@pytest.mark.parametrize("dtype, target", [
    (jnp.float32, "reforge_sepconv_f32"),
    (jnp.bfloat16, "reforge_sepconv_bf16"),
])
def test_ffi_call_lowers_for_cuda(dtype, target):
    wh, ww = taps(3, 0), taps(1, 1)
    calls = _custom_calls(
        lambda a: cuda_sepconv.ffi_sep_conv(a, wh, ww, "zero"),
        jax.ShapeDtypeStruct((4, 37, 70), dtype),
    )
    assert len(calls) == 1 and f"@{target}(" in calls[0]
    dt = "f32" if dtype == jnp.float32 else "bf16"
    # input and output keep the planes' shape and dtype; taps are f32
    assert f"(tensor<4x37x70x{dt}>, tensor<7xf32>, tensor<3xf32>) -> tensor<4x37x70x{dt}>" in calls[0]
    assert "zero = 1" in calls[0]


def test_ffi_call_vmaps_into_planes():
    wh = taps(2, 0)
    calls = _custom_calls(
        jax.vmap(lambda a: cuda_sepconv.ffi_sep_conv(a, wh, wh)),
        jax.ShapeDtypeStruct((5, 4, 16, 24), jnp.float32),
    )
    assert len(calls) == 1
    assert "(tensor<5x4x16x24xf32>, tensor<1x5xf32>, tensor<1x5xf32>)" in calls[0]
    assert "zero = 0" in calls[0]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil

    monkeypatch.setattr(cuda_sepconv, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_sepconv.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_sepconv.build()
    assert list(tmp_path.iterdir()) == []  # nothing left behind


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    import subprocess

    monkeypatch.setattr(cuda_sepconv, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(cuda_sepconv, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "bad line 3"),
    )
    with pytest.raises(RuntimeError, match="bad line 3"):
        cuda_sepconv.build()
    assert list(tmp_path.iterdir()) == []  # no half-written library


# ---- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_kernel_matches_plain_on_gpu(gpu_device, mode, dtype):
    x = jnp.asarray(rand((2, 3, 37, 101), seed=1)).astype(dtype)
    wh, ww = taps(5, 1), taps(2, 2)
    got = jax.jit(lambda a: ops.sep_conv(a, wh, ww, mode))(x)
    with ops.plain_kernels():
        want = jax.jit(lambda a: ops.sep_conv(a, wh, ww, mode))(x)
    got = np.asarray(got.astype(jnp.float32))
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else bf16_ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= tol
