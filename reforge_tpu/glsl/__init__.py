"""GLSL-subset -> JAX compiler.

This program's replacement for the reference's shaderc + spirv-reflect path
(reference: src/vulkan/shader.rs): GLSL compute shaders parse to an AST,
``layout`` declarations are reflected into kernel bindings (images, UBO
parameter blocks), and the shader body is vectorized by the interpreter in
interp.py — tracing it under jax.jit yields the compiled XLA program.

``translate_shader(source, name, path)`` is the loader hook used for
``.comp`` files (kernels/loader.py), producing an ordinary KernelSpec that
participates in graph fusion, live reload, and sharding like builtin
kernels.  Halo metadata for spatial sharding is reflected by abstract
interpretation: a dry eval_shape run records the maximum static image-load
shift and whether any data-dependent gather occurred.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp

from . import ast
from .lexer import GlslError
from .parser import parse_shader_source
from .interp import ATOMIC_FUNCS, IMAGE_ATOMIC_FUNCS, Interp
from ..kernels.base import KernelContext, KernelSpec, ParamDecl, ParamKind

__all__ = ["translate_shader", "GlslError", "reflect_bindings"]


def _walk_image_usage(shader: ast.Shader) -> tuple[set, set]:
    """Which images are imageLoad'ed / imageStore'd anywhere in the shader."""
    loaded: set[str] = set()
    stored: set[str] = set()

    def walk(node: Any) -> None:
        # Containers first: Switch.cases holds (values, body) tuples.
        if isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
            return
        if not hasattr(node, "__dataclass_fields__"):
            return
        if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Ident):
            if node.name == "imageLoad":
                loaded.add(node.args[0].name)
            elif node.name == "imageStore" or node.name in IMAGE_ATOMIC_FUNCS:
                # Image atomics RMW the target, but direction-wise the
                # target is an output (the splat idiom accumulates into a
                # fresh image); an explicit imageLoad elsewhere still
                # makes it an input too.
                stored.add(node.args[0].name)
        for field in node.__dataclass_fields__:
            walk(getattr(node, field))

    for fn in shader.functions.values():
        for stmt in fn.body:
            walk(stmt)
    return loaded, stored


def _walk_ssbo_usage(shader: ast.Shader) -> tuple[set, set]:
    """Which SSBO blocks are read / written (stores or atomic RMW ops)."""
    member_to_block = {}
    instance_to_block = {}
    scalar_members = set()  # non-array members: bare-name access
    for ssbo in shader.ssbos:
        for m in ssbo.members:
            member_to_block[m.name] = ssbo.block_name
            if m.array_size is None and not m.runtime_array:
                scalar_members.add(m.name)
        if ssbo.instance_name:
            instance_to_block[ssbo.instance_name] = ssbo.block_name

    def block_of(expr: Any):
        if isinstance(expr, ast.Ident):
            return member_to_block.get(expr.name)
        if isinstance(expr, ast.Member) and isinstance(expr.expr, ast.Ident):
            if expr.expr.name in instance_to_block:
                return instance_to_block[expr.expr.name]
        return None

    read: set[str] = set()
    written: set[str] = set()
    # Index nodes consumed as write targets must not count as reads.
    write_targets: set[int] = set()

    def walk(node: Any) -> None:
        if isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
            return
        if not hasattr(node, "__dataclass_fields__"):
            return
        if isinstance(node, ast.Assign) and isinstance(node.target, ast.Index):
            b = block_of(node.target.expr)
            if b is not None:
                written.add(b)
                write_targets.add(id(node.target))
                if node.op != "=":
                    read.add(b)  # compound assignment reads too
        if isinstance(node, ast.Assign) and not isinstance(node.target, ast.Index):
            # Scalar member store: `count = 0u;` / `inst.count += 1u;`.
            b = block_of(node.target)
            if b is not None:
                written.add(b)
                write_targets.add(id(node.target))
                if node.op != "=":
                    read.add(b)
        if (
            isinstance(node, ast.Call)
            and node.name in ATOMIC_FUNCS
            and node.args
        ):
            tgt = node.args[0]
            b = block_of(tgt.expr) if isinstance(tgt, ast.Index) else (
                block_of(tgt)
                if (isinstance(tgt, ast.Ident) and tgt.name in scalar_members)
                or isinstance(tgt, ast.Member)
                else None
            )
            if b is not None:
                written.add(b)
                write_targets.add(id(tgt))
        if isinstance(node, ast.Index) and id(node) not in write_targets:
            b = block_of(node.expr)
            if b is not None:
                read.add(b)
        if (
            isinstance(node, (ast.Ident, ast.Member))
            and id(node) not in write_targets
            and getattr(node, "name", None) in scalar_members
        ):
            # Bare scalar-member reads (conservative: a shadowing local of
            # the same name still marks the block read).
            b = block_of(node)
            if b is not None:
                read.add(b)
        for field in node.__dataclass_fields__:
            walk(getattr(node, field))

    for fn in shader.functions.values():
        for stmt in fn.body:
            walk(stmt)
    return read, written


def reflect_bindings(shader: ast.Shader) -> dict:
    """Binding reflection: images (with direction) and UBO parameters.

    Direction comes from usage analysis (imageLoad/imageStore call sites),
    falling back to readonly/writeonly qualifiers for unused declarations —
    more robust than qualifiers alone, and equivalent to what the reference
    gets from SPIR-V reflection (shader.rs:106-160).
    """
    loaded, stored = _walk_image_usage(shader)
    images_in: list[str] = []
    images_out: list[str] = []
    if shader.stage == "fragment" and shader.frag_outputs:
        # The frag color output needs no declared image binding — the
        # reference's output_image exemption (vkutils.rs:175-177).
        images_out.append("output_image")
        images_out.extend(shader.frag_outputs[1:])
    for img in sorted(shader.images, key=lambda d: d.binding):
        is_in = img.name in loaded or (
            img.name not in stored and not img.writeonly
        )
        is_out = img.name in stored or (
            img.name not in loaded and img.writeonly
        )
        if is_in:
            images_in.append(img.name)
        if is_out:
            images_out.append(img.name)
    ssbo_read, ssbo_written = _walk_ssbo_usage(shader)
    ssbos_in: list[str] = []
    ssbos_out: list[str] = []
    ssbo_sizes: dict[str, int] = {}
    for ssbo in sorted(shader.ssbos, key=lambda d: d.binding):
        name_ = ssbo.block_name
        if ssbo.members:
            # Block size = summed member element counts (the reference
            # sizes SSBOs by summed reflected member sizes,
            # pipeline_graph.rs:161-170); a runtime-sized trailing array
            # contributes the documented default so single-shader graphs
            # get a usable allocation (interp.DEFAULT_RUNTIME_SSBO_ELEMS).
            from .interp import DEFAULT_RUNTIME_SSBO_ELEMS

            total = 0
            for m in ssbo.members:
                if m.runtime_array:
                    total += DEFAULT_RUNTIME_SSBO_ELEMS
                elif m.array_size is not None:
                    total += int(m.array_size)
                else:
                    total += 1
            ssbo_sizes[name_] = total
        is_written = name_ in ssbo_written or (
            ssbo.writeonly and name_ not in ssbo_read
        )
        is_read = name_ in ssbo_read or (
            ssbo.readonly and name_ not in ssbo_written
        )
        if is_read and not ssbo.writeonly:
            ssbos_in.append(name_)
        if is_written and not ssbo.readonly:
            ssbos_out.append(name_)
        if not is_read and not is_written:
            ssbos_in.append(name_)
    params: dict[str, ParamDecl] = {}
    param_aliases: dict[str, str] = {}
    _SCALAR_KINDS = {
        "float": ParamKind.FLOAT,
        "int": ParamKind.INT,
        "uint": ParamKind.INT,
        "bool": ParamKind.BOOL,
    }
    _VEC_KINDS = {  # vecN family -> (component kind, count)
        **{f"vec{n}": (ParamKind.FLOAT, n) for n in (2, 3, 4)},
        **{f"ivec{n}": (ParamKind.INT, n) for n in (2, 3, 4)},
        **{f"uvec{n}": (ParamKind.INT, n) for n in (2, 3, 4)},
        **{f"bvec{n}": (ParamKind.BOOL, n) for n in (2, 3, 4)},
    }
    _MATS = {"mat2", "mat3", "mat4"}

    def add_param(name: str, type_name: str) -> None:
        if name == "_rf_time" or name.endswith("_rf_time"):
            return
        if type_name in shader.structs:
            # Nested struct members flatten to dotted names, matching the
            # reference's recursive UBO walk (pipeline_graph.rs:284-291).
            for ftype, fname in shader.structs[type_name]:
                add_param(f"{name}.{fname}", ftype)
            return
        if type_name in _VEC_KINDS:
            # Vector members: one parameter per component, canonical
            # ".x/.y/.z/.w", with ".rgba"/".stpq" accepted as aliases.
            kind, n = _VEC_KINDS[type_name]
            default = {
                ParamKind.FLOAT: 0.0, ParamKind.INT: 0, ParamKind.BOOL: False,
            }[kind]
            for i in range(n):
                canon = f"{name}.{'xyzw'[i]}"
                params[canon] = ParamDecl(canon, kind, default)
                param_aliases[f"{name}.{'rgba'[i]}"] = canon
                param_aliases[f"{name}.{'stpq'[i]}"] = canon
            return
        if type_name in _MATS:
            # Matrix members declare fine but aren't settable from the
            # config (values are scalars); they read as zeros — the
            # reference's zero-fill of unset UBO memory.
            return
        kind = _SCALAR_KINDS.get(type_name)
        if kind is None:
            raise GlslError(
                f"UBO member '{name}': only scalar float/int/bool "
                f"parameters (or vectors, matrices, arrays, structs of "
                f"them) are supported (got {type_name})"
            )
        # Unspecified parameters default to zero, matching the reference's
        # zero-fill of unset UBO members (render.rs:187-193).
        default = {ParamKind.FLOAT: 0.0, ParamKind.INT: 0, ParamKind.BOOL: False}[kind]
        params[name] = ParamDecl(name, kind, default)

    for ubo in shader.ubos:
        for m in ubo.members:
            if m.array_size is not None or m.runtime_array:
                # Array members declare fine but aren't settable from the
                # config (values are scalars); they read as zeros — the
                # reference's zero-fill of unset UBO memory.
                continue
            add_param(m.name, m.type)
    for g in shader.globals:
        if getattr(g, "spec_id", None) is None:
            continue
        # Specialization constants surface as config-settable parameters
        # defaulting to their GLSL initializer (the value the reference
        # always uses, since it passes no VkSpecializationInfo —
        # pipeline.rs:44-88).  Changing one retraces, as any param does.
        kind = _SCALAR_KINDS[g.type]
        init = g.init
        neg = False
        if isinstance(init, ast.Unary) and init.op == "-":
            neg, init = True, init.expr
        if isinstance(init, ast.Num):
            default = -init.value if neg else init.value
            default = float(default) if g.type == "float" else int(default)
        elif isinstance(init, ast.BoolLit) and not neg:
            default = bool(init.value)
        else:
            raise GlslError(
                f"specialization constant '{g.name}' initializer must be "
                f"a literal",
                g.line,
            )
        params[g.name] = ParamDecl(g.name, kind, default)
    return {
        "images_in": images_in,
        "images_out": images_out,
        "ssbos_in": ssbos_in,
        "ssbos_out": ssbos_out,
        "ssbo_sizes": ssbo_sizes,
        "params": params,
        "param_aliases": param_aliases,
    }


def translate_shader(
    source: str, name: str, path: Optional[str] = None, stage: Optional[str] = None
) -> KernelSpec:
    # Stage inferred from the file extension, like the reference
    # (shader.rs:33: .frag -> fragment, else compute).
    if stage is None:
        stage = "fragment" if (path or "").endswith(".frag") else "compute"
    shader = parse_shader_source(source, stage=stage)
    bindings = reflect_bindings(shader)
    if not bindings["images_out"] and not bindings["ssbos_out"]:
        raise GlslError(f"shader '{name}' never stores to any image or buffer")

    def run(ctx: KernelContext, **kwargs: Any) -> dict[str, Any]:
        images = {k: v for k, v in kwargs.items() if k in bindings["images_in"]}
        buffers = {k: v for k, v in kwargs.items() if k in bindings["ssbos_in"]}
        params = {
            k: v for k, v in kwargs.items() if k not in images and k not in buffers
        }
        interp = Interp(
            shader,
            height=ctx.block_height,
            width=ctx.width,
            images_in=images,
            params=params,
            time=ctx.time,
            row_offset=ctx.row_offset,
            global_height=ctx.height,
            buffers_in=buffers,
        )
        outputs = interp.run_main()
        # Every declared output gets a value; unwritten ones pass through
        # zeros (matching an unwritten storage image).
        for out_name in bindings["images_out"]:
            if out_name not in outputs:
                outputs[out_name] = jnp.zeros(
                    (4, ctx.block_height, ctx.width), jnp.float32
                )
        for out_name in bindings["ssbos_out"]:
            outputs[out_name] = interp.buffers[out_name]
        return outputs

    @functools.lru_cache(maxsize=64)
    def _reflect_spatial(params_key: tuple) -> tuple:
        """(halo, border) by dry abstract interpretation for given params.

        The shader is probed at TWO different grid extents: a load offset
        derived from imageSize() (e.g. ``pos + ivec2(0, size.y / 2)``)
        probes as a static shift whose magnitude tracks the grid, so if the
        reflected stats differ between extents the halo is size-dependent
        and the shader is demoted to the always-correct gather (halo=None)
        path.  Size-*bounded* offsets (``min(size.x / 2, 5)``) probe
        identically and correctly keep their finite halo.
        """
        params = dict(params_key)

        def dry_stats(h: int, w: int):
            stats = {
                "max_shift": 0, "gather": False,
                "edge_shift": False, "zero_shift": False,
            }

            def dry(time):
                imgs = {
                    n: jnp.zeros((4, h, w), jnp.float32)
                    for n in bindings["images_in"]
                }
                interp = Interp(shader, h, w, imgs, params, time=time,
                                stats=stats)
                interp.run_main()
                return 0

            jax.eval_shape(dry, jax.ShapeDtypeStruct((), jnp.float32))
            return stats

        try:
            stats = dry_stats(64, 64)
            stats2 = dry_stats(96, 80)
        except Exception:
            # conservatively unshardable on dry failure
            return (None, "edge")
        keys = ("max_shift", "gather", "edge_shift", "zero_shift")
        if any(stats[k] != stats2[k] for k in keys):
            return (None, "edge")  # extent-dependent halo: gather path
        if stats["gather"]:
            return (None, "edge")
        if stats["edge_shift"] and stats["zero_shift"]:
            # Mixed border conventions: one halo-pad mode can't represent
            # both, so fall back to the (always-correct) gather path.
            return (None, "edge")
        border = "zero" if stats["zero_shift"] else "edge"
        return (stats["max_shift"], border)

    def halo_of(params_key: tuple) -> Optional[int]:
        return _reflect_spatial(params_key)[0]

    spec = KernelSpec(
        name=name,
        fn=run,
        images_in=tuple(bindings["images_in"]),
        images_out=tuple(bindings["images_out"]),
        ssbos_in=tuple(bindings["ssbos_in"]),
        ssbos_out=tuple(bindings["ssbos_out"]),
        ssbo_sizes=bindings["ssbo_sizes"],
        params=bindings["params"],
        param_aliases=bindings["param_aliases"],
        halo=lambda params: halo_of(tuple(sorted(params.items()))),
        border=lambda params: _reflect_spatial(tuple(sorted(params.items())))[1],
        source_path=path,
        doc=f"GLSL kernel translated from {path or name}",
    )
    return spec
