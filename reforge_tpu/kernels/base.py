"""Kernel specification, registry, and binding reflection.

A *kernel* is this program's analog of one of the reference's GLSL compute
shaders (reference: src/vulkan/shader.rs).  Where the reference compiles GLSL
to SPIR-V and reflects descriptor bindings from the binary
(src/vulkan/shader.rs:106-160), we declare bindings directly on a
``KernelSpec`` (for builtin/py kernels) or recover them from GLSL layout
declarations (glsl/reflect.py).  The graph layer matches config descriptor
names against these bindings exactly like ``synthesize_config``
(src/vulkan/vkutils.rs:140-196).

Data model:
  * Images are planar ``float32[4, H, W]`` (RGBA, channels-leading): every
    kernel works on whole (H, W) planes, rows contiguous, so loads along a
    row coalesce and no lane is spent on the 4-wide channel dim.
  * Pixel values are *linear* light; sRGB conversion happens at the I/O
    boundary (mirroring the reference's sRGB-image blit on load,
    src/render.rs:286-312).
  * Parameters are static Python scalars baked into the jitted program.  In
    the reference, parameter changes only arrive via a config-file edit,
    which triggers a full graph rebuild (src/render.rs:497-519) — so baking
    them costs nothing behaviorally and lets kernels derive static structure
    (tap counts, loop bounds) from them.  The one per-frame dynamic value,
    ``_rf_time``, is threaded through ``KernelContext.time`` as a traced
    scalar (src/render.rs:212-223).
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
from typing import Any, Callable, Mapping, Optional

import jax.numpy as jnp

from ..utils import warnln


class ParamKind(enum.Enum):
    FLOAT = "float"
    INT = "int"
    BOOL = "bool"

    @staticmethod
    def of(value: Any) -> "ParamKind":
        if isinstance(value, bool):
            return ParamKind.BOOL
        if isinstance(value, int):
            return ParamKind.INT
        if isinstance(value, float):
            return ParamKind.FLOAT
        raise TypeError(f"unsupported parameter default {value!r}")


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """One scalar parameter (the analog of a reflected UBO member)."""

    name: str
    kind: ParamKind
    default: Any

    def coerce(self, raw: Any) -> Any:
        """Coerce a config-file value to this parameter's declared type.

        Mirrors the reference's write_to_buffer type dispatch with
        warn-and-zero fallback on conversion failure (src/render.rs:169-186).
        """
        try:
            if self.kind is ParamKind.FLOAT:
                return float(raw)
            if self.kind is ParamKind.INT:
                if isinstance(raw, bool):
                    return int(raw)
                if isinstance(raw, float) and not raw.is_integer():
                    raise ValueError(f"non-integer value {raw!r} for int parameter")
                return int(raw)
            return bool(raw)
        except (TypeError, ValueError) as e:
            warnln(f"Failed to convert: {e}")
            return {ParamKind.FLOAT: 0.0, ParamKind.INT: 0, ParamKind.BOOL: False}[
                self.kind
            ]


@dataclasses.dataclass
class KernelContext:
    """Per-trace execution context passed to every kernel.

    ``width``/``height`` are the GLOBAL image extent — what coordinate math
    (vignette centers, imageSize, checkerboard cells) must use.  Under
    row-sharded execution a kernel sees only a horizontal slab of the
    image: ``local_height`` rows starting at global row ``row_offset``
    (which may be a traced per-device scalar inside shard_map).  On a
    single device ``local_height == height`` and ``row_offset == 0``.
    Kernels should derive pixel coordinates via ops.grid_coords(ctx) and
    shapes via ctx.local_shape so they are shard-correct for free.
    """

    width: int
    height: int
    time: Any = 0.0  # traced f32 scalar: seconds since start (``_rf_time``)
    fmt: str = "rgba32f"  # "rgba8" | "rgba32f"
    row_offset: Any = 0  # global row index of local row 0 (may be traced)
    local_height: Optional[int] = None  # rows in the local block

    @property
    def block_height(self) -> int:
        return self.local_height if self.local_height is not None else self.height

    @property
    def local_shape(self) -> tuple[int, int]:
        return (self.block_height, self.width)

    @property
    def extent(self) -> tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass
class KernelSpec:
    """A graph-node kernel: declared bindings + a jax-traceable function.

    ``fn(ctx, **images, **params)`` returns a single array (bound to the
    first declared output) or a dict of ``descriptor_name -> array``.
    """

    name: str
    fn: Callable[..., Any]
    images_in: tuple[str, ...] = ("input_image",)
    images_out: tuple[str, ...] = ("output_image",)
    # Storage-buffer bindings: 1-D f32 arrays flowing between nodes (the
    # reference reflects SSBO blocks alongside images — shader.rs:144-148 —
    # and sizes each buffer to the max across its users,
    # pipeline_graph.rs:158-175). A written buffer starts zeroed each
    # frame.
    ssbos_in: tuple[str, ...] = ()
    ssbos_out: tuple[str, ...] = ()
    ssbo_sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    params: dict[str, ParamDecl] = dataclasses.field(default_factory=dict)
    # Alternate config spellings for declared params (e.g. GLSL vector
    # UBO members accept "tint.r" for the canonical "tint.x").
    param_aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    # Spatial support radius as a function of (static) params; drives halo
    # exchange in row-sharded execution.  None means data-dependent access
    # (gather kernels) that cannot be halo-sharded.
    halo: Callable[[Mapping[str, Any]], Optional[int]] = lambda params: 0
    # Border convention at the global image edge ("edge" clamp or "zero"),
    # so sharded halo padding reproduces single-device borders exactly.
    # Library kernels clamp (ops.pad_edge); GLSL kernels reflect theirs.
    border: Callable[[Mapping[str, Any]], str] = lambda params: "edge"
    source_path: Optional[str] = None
    doc: str = ""

    # ---- reflection (the SPIR-V descriptor-enumeration analog) ---------

    def image_bindings(self) -> tuple[str, ...]:
        return self.images_in + self.images_out

    @property
    def inputs_all(self) -> tuple[str, ...]:
        return self.images_in + self.ssbos_in

    @property
    def outputs_all(self) -> tuple[str, ...]:
        return self.images_out + self.ssbos_out

    def has_binding(self, descriptor_name: str) -> bool:
        return descriptor_name in self.inputs_all or descriptor_name in self.outputs_all

    def resolve_params(self, config_params: Mapping[str, Any]) -> dict[str, Any]:
        """Match config parameter values against declared parameters by name.

        Unknown names warn (like an unmatched UBO member); unspecified
        declared params take their defaults.  The reference zero-fills
        unspecified members (src/render.rs:187-193); we prefer declared
        defaults — kernels ship sensible defaults the way the reference's
        demo shaders hard-code fallbacks.
        """
        resolved = {name: decl.default for name, decl in self.params.items()}
        for key, raw in config_params.items():
            if key == "_rf_time":
                continue
            key = self.param_aliases.get(key, key)
            decl = self.params.get(key)
            if decl is None:
                warnln(
                    f"Parameter '{key}' not found in kernel '{self.name}' "
                    f"(declared: {', '.join(self.params) or 'none'})"
                )
                continue
            value = raw.value if hasattr(raw, "value") else raw
            resolved[key] = decl.coerce(value)
        return resolved

    def halo_for(self, params: Mapping[str, Any]) -> Optional[int]:
        return self.halo(params)

    def border_for(self, params: Mapping[str, Any]) -> str:
        return self.border(params)

    def __call__(self, ctx: KernelContext, images: Mapping[str, Any], params: Mapping[str, Any]) -> dict[str, Any]:
        out = self.fn(ctx, **images, **params)
        if isinstance(out, dict):
            return out
        return {self.images_out[0]: out}


def kernel(
    name: str,
    *,
    images_in: tuple[str, ...] | None = None,
    images_out: tuple[str, ...] = ("output_image",),
    ssbos_in: tuple[str, ...] = (),
    ssbos_out: tuple[str, ...] = (),
    ssbo_sizes: dict[str, int] | None = None,
    halo: int | Callable[[Mapping[str, Any]], Optional[int]] = 0,
    register: bool = True,
    doc: str = "",
):
    """Decorator declaring a kernel from a plain function.

    Image inputs and parameters are reflected from the signature: parameters
    after ``ctx`` without defaults are image bindings; keyword parameters
    with scalar defaults become ``ParamDecl``s typed by their default.

        @kernel("gaussian", halo=lambda p: gaussian_radius(p["sigma"]))
        def gaussian(ctx, input_image, *, sigma=4.0): ...
    """

    def wrap(fn: Callable[..., Any]) -> KernelSpec:
        sig = inspect.signature(fn)
        names = list(sig.parameters)
        assert names and names[0] == "ctx", f"kernel {name}: first arg must be ctx"
        inferred_images: list[str] = []
        params: dict[str, ParamDecl] = {}
        for pname in names[1:]:
            p = sig.parameters[pname]
            if p.default is inspect.Parameter.empty:
                if pname not in ssbos_in:
                    inferred_images.append(pname)
            else:
                params[pname] = ParamDecl(pname, ParamKind.of(p.default), p.default)
        halo_fn = halo if callable(halo) else (lambda _params, _h=halo: _h)
        spec = KernelSpec(
            name=name,
            fn=fn,
            images_in=tuple(images_in if images_in is not None else inferred_images),
            images_out=images_out,
            ssbos_in=ssbos_in,
            ssbos_out=ssbos_out,
            ssbo_sizes=dict(ssbo_sizes or {}),
            params=params,
            halo=halo_fn,
            doc=doc or (fn.__doc__ or ""),
        )
        if register:
            register_kernel(spec)
        return spec

    return wrap


# ---- builtin registry ---------------------------------------------------

_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> None:
    _REGISTRY[spec.name] = spec


def builtin_kernels() -> dict[str, KernelSpec]:
    # Populate lazily so `import reforge_tpu.kernels.base` alone stays light.
    from . import library  # noqa: F401

    return dict(_REGISTRY)


def lookup_builtin(name: str) -> Optional[KernelSpec]:
    from . import library  # noqa: F401

    return _REGISTRY.get(name)


def quantize_rgba8(x: jnp.ndarray) -> jnp.ndarray:
    """Round-trip through 8-bit UNORM storage precision.

    With ``--shader-format rgba8`` the reference stores every intermediate in
    an rgba8 Vulkan image, quantizing each node's output to 1/255 steps
    (src/main.rs:34-41).  We keep f32 arrays but snap values to the same
    grid so outputs match bit-for-bit after encode.
    """
    return jnp.round(jnp.clip(x, 0.0, 1.0) * 255.0) / 255.0
