"""Fused separable convolution for NVIDIA Hopper, called through ``jax.ffi``.

The kernel is CUDA C++ in ``native/sepconv.cu``: one block per (plane,
32x64 output tile), the tile and its halo copied into shared memory with
``cp.async`` and border addressing applied at load time, the H pass into a
shared f32 intermediate, the W pass from shared memory into registers, one
store.  The library is compiled with ``nvcc`` for ``sm_90a`` on first use,
into ``libreforge_sepconv.so`` beside this file (ignored by git), from the
committed source only.  If it cannot be built or loaded, the call raises;
nothing falls back to the plain path on error.  ``ops.sep_conv`` decides,
while tracing, which calls reach this module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

# Tile geometry and shared-memory opt-in limit; must match native/sepconv.cu.
TILE_H = 32
TILE_W = 64
STAGES = 3  # input tiles in flight per block
SMEM_BUDGET = 232448  # bytes a block may use on sm_90

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "sepconv.cu")
LIBRARY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libreforge_sepconv.so")
TARGETS = {
    jnp.dtype(jnp.float32): ("reforge_sepconv_f32", "ReforgeSepConvF32"),
    jnp.dtype(jnp.bfloat16): ("reforge_sepconv_bf16", "ReforgeSepConvBF16"),
}

_lock = threading.Lock()
_lib = None


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(rh: int, rw: int, itemsize: int) -> int:
    """Shared memory one block needs: the taps (each vector zero-padded to a
    multiple of 8), the f32 intermediate (8 spare columns, odd row stride)
    and STAGES halo-extended input tiles (8 spare rows, rows padded to
    16-byte vectors) in the storage dtype."""
    vec = 16 // itemsize
    in_w = TILE_W + 2 * rw
    shift = (vec - rw % vec) % vec
    in_stride = -(-(in_w + shift) // vec) * vec
    taps = _align16((((2 * rh + 8) & ~7) + ((2 * rw + 8) & ~7)) * 4)
    tmp = _align16(TILE_H * ((in_w + 8) | 1) * 4)
    return taps + tmp + STAGES * (TILE_H + 2 * rh + 8) * in_stride * itemsize


def fits(rh: int, rw: int, itemsize: int) -> bool:
    """Whether radii (rh, rw) fit the shared-memory budget."""
    return smem_bytes(rh, rw, itemsize) <= SMEM_BUDGET


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "cannot build the separable-conv CUDA kernel: nvcc not found "
        "(put the CUDA toolkit's bin directory on PATH)"
    )


def build() -> str:
    """Compile ``native/sepconv.cu`` into ``LIBRARY``; returns its path."""
    nvcc = _nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
    os.close(fd)
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-diag-suppress", "940,2473",
        "-I", jax.ffi.include_dir(),
        "-o", tmp, SOURCE,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to build the separable-conv kernel:\n"
                + proc.stdout + proc.stderr
            )
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def _ensure_registered() -> None:
    global _lib
    with _lock:
        if _lib is not None:
            return
        if (not os.path.exists(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            build()
        lib = ctypes.CDLL(LIBRARY)
        for target, symbol in TARGETS.values():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA",
            )
        _lib = lib


def ffi_sep_conv(x: jnp.ndarray, wh: np.ndarray, ww: np.ndarray,
                 mode: str = "edge") -> jnp.ndarray:
    """The FFI call itself, without building or registering the library.

    The taps travel as f32 device constants.  Every leading dim of ``x`` is
    a plane, so ``vmap`` adds planes (the taps only gain size-1 dims)."""
    target, _ = TARGETS[jnp.dtype(x.dtype)]
    call = jax.ffi.ffi_call(
        target,
        jax.ShapeDtypeStruct(x.shape, x.dtype),
        vmap_method="expand_dims",
    )
    return call(
        x,
        jnp.asarray(np.asarray(wh, np.float32)),
        jnp.asarray(np.asarray(ww, np.float32)),
        zero=np.int32(mode == "zero"),
    )


def sep_conv(x: jnp.ndarray, wh: np.ndarray, ww: np.ndarray,
             mode: str = "edge") -> jnp.ndarray:
    """Separable correlation of (..., H, W) f32 or bf16 planes on the GPU."""
    _ensure_registered()
    return ffi_sep_conv(x, wh, ww, mode)
