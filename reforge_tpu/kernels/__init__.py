"""Kernel layer: specs, reflection, builtin library, and source loaders.

The JAX replacement for the reference's GLSL shader layer
(reference: src/vulkan/shader.rs + shaders/).
"""

from .base import (
    KernelContext,
    KernelSpec,
    ParamDecl,
    ParamKind,
    builtin_kernels,
    kernel,
    lookup_builtin,
    quantize_rgba8,
    register_kernel,
)

__all__ = [
    "KernelContext",
    "KernelSpec",
    "ParamDecl",
    "ParamKind",
    "builtin_kernels",
    "kernel",
    "lookup_builtin",
    "quantize_rgba8",
    "register_kernel",
]
