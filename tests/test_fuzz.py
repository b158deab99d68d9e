"""Seeded random-graph fuzzing: build random DAGs from the builtin kernel
library with randomized parameters, run them end-to-end, and assert the
engine contract — a valid config always renders finite output, in every
storage format, and the fused/unfused/sequenced execution modes agree.

The reference has no tests at all (SURVEY.md §4); this is the adversarial
sweep a production framework needs: kernels are exercised in combinations
and parameter corners no hand-written test enumerates.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from reforge_tpu import utils
from reforge_tpu.config import parse
from reforge_tpu.graph import build_graph, make_program
from reforge_tpu.kernels import builtin_kernels
from reforge_tpu.kernels.base import ParamKind

H, W = 24, 32

# Parameter magnitudes: sane-but-adversarial draws per declared kind.
FLOAT_DRAWS = [-2.0, -0.5, 0.0, 0.3, 1.0, 4.0, 16.0]
INT_DRAWS = [-3, 0, 1, 2, 5, 9]


def _specs():
    ks = builtin_kernels()
    if isinstance(ks, dict):
        return ks
    return {s.name: s for s in ks}


def _single_input_kernels():
    out = {}
    for name, spec in _specs().items():
        if spec.ssbos_in or spec.ssbos_out:
            continue
        if tuple(spec.images_in) == ("input_image",):
            out[name] = spec
    return out


def _two_input_kernels():
    out = {}
    for name, spec in _specs().items():
        if spec.ssbos_in or spec.ssbos_out:
            continue
        if set(spec.images_in) == {"input_image", "input_image2"}:
            out[name] = spec
    return out


def _random_params(spec, rng) -> str:
    parts = []
    for name, decl in spec.params.items():
        if name.endswith("_rf_time"):
            continue
        if rng.random() < 0.4:
            continue  # leave unset: zero-fill path
        if decl.kind is ParamKind.FLOAT:
            v = float(rng.choice(FLOAT_DRAWS)) * float(rng.choice([1, 1, 0.1]))
            parts.append(f"{name}: {v}")
        elif decl.kind is ParamKind.INT:
            parts.append(f"{name}: {int(rng.choice(INT_DRAWS))}")
        else:
            parts.append(f"{name}: {'true' if rng.random() < 0.5 else 'false'}")
    return ", ".join(parts)


def _random_config(rng) -> str:
    """A random linear chain with an optional fan-in branch."""
    singles = sorted(_single_input_kernels())
    twos = sorted(_two_input_kernels())
    n = int(rng.integers(1, 5))
    chain = [str(rng.choice(singles)) for _ in range(n)]
    lines = []
    decls = []
    names = []
    for i, ktype in enumerate(chain):
        inst = f"n{i}"
        names.append(inst)
        spec = _specs()[ktype]
        decls.append(f"{inst}: {ktype} {{ {_random_params(spec, rng)} }}")
    main = "input -> " + " -> ".join(names)
    if twos and rng.random() < 0.5:
        btype = str(rng.choice(twos))
        bspec = _specs()[btype]
        decls.append(f"bl: {btype} {{ {_random_params(bspec, rng)} }}")
        side_type = str(rng.choice(singles))
        decls.append(
            f"side: {side_type} {{ {_random_params(_specs()[side_type], rng)} }}"
        )
        lines.append(main + " -> bl -> output")
        lines.append("input -> side -> bl:input_image2")
    else:
        lines.append(main + " -> output")
    return "\n".join(lines + decls) + "\n"


def _run(cfg_text: str, fmt: str):
    cfg = parse(cfg_text, expects_input=True)
    assert cfg is not None, (cfg_text, utils.recent_warnings())
    graph = build_graph(cfg)
    assert graph is not None, (cfg_text, utils.recent_warnings())
    prog = make_program(graph, W, H, fmt)
    assert prog is not None, cfg_text
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((4, H, W), dtype=np.float32))
    out = np.asarray(prog(img, 0.25), np.float32)
    assert out.shape == (4, H, W), cfg_text
    assert np.isfinite(out).all(), f"non-finite output:\n{cfg_text}"
    return prog, img, out


@pytest.mark.parametrize("seed", range(24))
def test_random_graph_renders(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg_text = _random_config(rng)
    prog, img, fused = _run(cfg_text, "rgba32f")
    # Execution modes agree on the same graph.
    unfused = np.asarray(prog.run_unfused(img, 0.25), np.float32)
    np.testing.assert_allclose(unfused, fused, atol=1e-4, err_msg=cfg_text)
    seq = np.asarray(prog.render_sequence(img, 0.25, 0.016, 1), np.float32)
    np.testing.assert_allclose(seq, fused, atol=1e-4, err_msg=cfg_text)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("fmt", ["rgba8", "rgba16f"])
def test_random_graph_formats(seed, fmt):
    rng = np.random.default_rng(2000 + seed)
    _run(_random_config(rng), fmt)


def _shader_specs():
    import glob

    from reforge_tpu.kernels.loader import load_kernel_file

    out = {}
    for path in sorted(glob.glob("shaders/*.comp")) + sorted(
        glob.glob("shaders/*.frag")
    ):
        spec = load_kernel_file(path)
        assert spec is not None, path
        out[path] = spec
    return out


@pytest.mark.parametrize("seed", range(6))
def test_shader_param_fuzz(seed):
    """Every shipped GLSL shader renders finite output under adversarial
    parameter draws (goldens only pin the defaults)."""
    from reforge_tpu.kernels.base import KernelContext

    rng = np.random.default_rng(3000 + seed)
    imgs = {
        "input_image": jnp.asarray(
            rng.random((4, H, W), dtype=np.float32)
        )
    }
    for path, spec in _shader_specs().items():
        if spec.ssbos_in or spec.ssbos_out:
            continue  # histogram/equalize need wired buffers
        if set(spec.images_in) - {"input_image", "input_image2"}:
            continue
        params = {}
        for name, decl in spec.params.items():
            if name.endswith("_rf_time") or rng.random() < 0.3:
                continue
            if decl.kind is ParamKind.FLOAT:
                params[name] = float(rng.choice(FLOAT_DRAWS))
            elif decl.kind is ParamKind.INT:
                params[name] = int(rng.choice(INT_DRAWS))
            else:
                params[name] = bool(rng.random() < 0.5)
        ins = dict(imgs)
        if "input_image2" in spec.images_in:
            ins["input_image2"] = imgs["input_image"][::-1]
        ctx = KernelContext(width=W, height=H, time=0.5)
        outs = spec(ctx, ins, spec.resolve_params(params))
        for name, v in outs.items():
            arr = np.asarray(v)
            assert np.isfinite(arr).all(), (path, params, name)


@pytest.mark.parametrize("seed", range(6))
def test_random_graph_halo_sharded(seed):
    """Random graphs through the halo-sharded executor match unsharded
    execution (H=24 divides the 8-device mesh)."""
    import jax

    from reforge_tpu.parallel import HaloShardedProgram, make_row_mesh

    assert len(jax.devices()) >= 8
    mesh = make_row_mesh(8)
    rng = np.random.default_rng(4000 + seed)
    cfg_text = _random_config(rng)
    prog, img, fused = _run(cfg_text, "rgba32f")
    sharded = HaloShardedProgram(prog, mesh)
    got = np.asarray(sharded(sharded.shard_input(img), 0.25), np.float32)
    np.testing.assert_allclose(got, fused, atol=1e-4, err_msg=cfg_text)


@pytest.mark.parametrize("seed", range(4))
def test_random_graph_gspmd_sharded(seed):
    """Random graphs under GSPMD auto-partitioning match unsharded."""
    import jax

    from reforge_tpu.parallel import make_row_mesh, shard_program

    assert len(jax.devices()) >= 8
    mesh = make_row_mesh(8)
    rng = np.random.default_rng(5000 + seed)
    cfg_text = _random_config(rng)
    prog, img, fused = _run(cfg_text, "rgba32f")
    sharded = shard_program(prog, mesh)
    got = np.asarray(sharded(sharded.shard_input(img), 0.25), np.float32)
    np.testing.assert_allclose(got, fused, atol=1e-4, err_msg=cfg_text)


# ---- data-dependent loop differential fuzz -------------------------------
#
# The vectorized while_loop lowering (glsl/interp.py::_exec_loop_vectorized)
# threads locals, globals (incl. callee writes), arrays, images, and valued
# returns through the carry.  Each seed generates a random shader from a
# small template grammar together with a NumPy lane-mask oracle of the SAME
# program, and the two must agree — the differential sweep for the carry
# machinery's many interacting paths.

def _loop_case(seed):
    rng = np.random.default_rng(9000 + seed)
    p = {
        "A": round(float(rng.uniform(1.05, 1.6)), 3),
        "B": round(float(rng.uniform(0.02, 0.3)), 3),
        "LIM": round(float(rng.uniform(0.8, 1.5)), 3),
        "MAXN": int(rng.integers(4, 28)),
        "C": round(float(rng.uniform(0.1, 1.0)), 3),
        "D": round(float(rng.uniform(0.5, 0.99)), 3),
        "X": round(float(rng.uniform(1.0, 1.8)), 3),
        "callee_g": bool(rng.integers(0, 2)),
        "use_acc": bool(rng.integers(0, 2)),
        "use_break": bool(rng.integers(0, 2)),
        "use_store": bool(rng.integers(0, 2)),
        "loop_in_fn": bool(rng.integers(0, 2)),
        "use_scatter": bool(rng.integers(0, 2)),
    }
    if p["use_scatter"]:
        p["use_store"] = True  # a final whole-image store would mask it
    return p


def _loop_shader_src(p):
    g_stmt = "addg(v);" if p["callee_g"] else f"g_t += v * {p['C']};"
    decls = "float g_t;\n"
    if p["callee_g"]:
        decls += f"void addg(float x) {{ g_t += x * {p['C']}; }}\n"
    if p["loop_in_fn"]:
        body = f"""
{decls}
float[2] run(float v0) {{
    float v = v0;
    int n = 0;
    while (v < {p['LIM']} && n < {p['MAXN']}) {{
        {g_stmt}
        if (v > {p['X']}) {{ return float[](v * 2.0, float(n)); }}
        v = v * {p['A']} + {p['B']};
        n++;
    }}
    return float[](v, float(n));
}}
void main() {{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    g_t = 0.0;
    float r[2] = run(c.r);
    imageStore(output_image, pos, vec4(r[0], r[1], g_t, 1.0));
}}
"""
        return body
    acc_decl = "float acc[2] = float[](0.0, 1.0);" if p["use_acc"] else ""
    acc_stmt = (
        f"acc = float[](acc[0] + v, acc[1] * {p['D']});"
        if p["use_acc"] else ""
    )
    brk = f"if (v > {p['X']}) {{ break; }}" if p["use_break"] else ""
    acc0 = "acc[0]" if p["use_acc"] else "0.0"
    scat = (
        "imageStore(output_image, pos + ivec2(1, 0), "
        "vec4(v, g_t, 0.0, 2.0));"
        if p["use_scatter"] else ""
    )
    store = (
        f"imageStore(output_image, pos, vec4(v, g_t, {acc0}, float(n)));"
        if p["use_store"] else ""
    )
    final = (
        "" if p["use_store"]
        else f"imageStore(output_image, pos, vec4(v, g_t, {acc0}, float(n)));"
    )
    return f"""
{decls}
void main() {{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageStore(output_image, pos, c);
    float v = c.r;
    int n = 0;
    g_t = 0.0;
    {acc_decl}
    while (v < {p['LIM']} && n < {p['MAXN']}) {{
        {g_stmt}
        {acc_stmt}
        {brk}
        {scat}
        {store}
        v = v * {p['A']} + {p['B']};
        n++;
    }}
    {final}
}}
"""


def _loop_oracle(p, base):
    f32 = np.float32
    A, B, C, D = f32(p["A"]), f32(p["B"]), f32(p["C"]), f32(p["D"])
    LIM, X = f32(p["LIM"]), f32(p["X"])
    v = base[0].astype(f32).copy()
    n = np.zeros_like(v)
    g = np.zeros_like(v)
    if p["loop_in_fn"]:
        ret0 = np.full_like(v, np.nan)
        ret1 = np.full_like(v, np.nan)
        active = np.ones(v.shape, bool)
        for _ in range(p["MAXN"] + 2):
            m = active & (v < LIM) & (n < p["MAXN"])
            if not m.any():
                break
            g = np.where(m, g + v * C, g)
            hit = m & (v > X)
            ret0 = np.where(hit, v * f32(2.0), ret0)
            ret1 = np.where(hit, n, ret1)
            m2 = m & ~hit
            v = np.where(m2, v * A + B, v)
            n = np.where(m2, n + 1, n)
            active = m2
        nr = np.isnan(ret0)
        ret0 = np.where(nr, v, ret0)
        ret1 = np.where(nr, n, ret1)
        return np.stack([ret0, ret1, g, np.ones_like(v)])
    acc0 = np.zeros_like(v)
    acc1 = np.ones_like(v)
    out = base.astype(f32).copy()
    active = np.ones(v.shape, bool)
    for _ in range(p["MAXN"] + 2):
        m = active & (v < LIM) & (n < p["MAXN"])
        if not m.any():
            break
        g = np.where(m, g + v * C, g)
        if p["use_acc"]:
            acc0 = np.where(m, acc0 + v, acc0)
            acc1 = np.where(m, acc1 * D, acc1)
        m2 = m & ~(m & (v > X)) if p["use_break"] else m
        if p.get("use_scatter"):
            # Each active lane writes its right neighbor (OOB dropped),
            # BEFORE the own-pos store in program order.
            for ch, val in zip(
                range(4),
                (v, g, np.zeros_like(v), np.full_like(v, 2.0)),
            ):
                out[ch][:, 1:] = np.where(
                    m2[:, :-1], val[:, :-1], out[ch][:, 1:]
                )
        if p["use_store"]:
            a0 = acc0 if p["use_acc"] else np.zeros_like(v)
            for ch, val in zip(range(4), (v, g, a0, n)):
                out[ch] = np.where(m2, val, out[ch])
        v = np.where(m2, v * A + B, v)
        n = np.where(m2, n + 1, n)
        active = m2
    if not p["use_store"]:
        a0 = acc0 if p["use_acc"] else np.zeros_like(v)
        out = np.stack([v, g, a0, n])
    return out


@pytest.mark.parametrize("seed", range(12))
def test_loop_shader_differential_fuzz(seed, tmp_path):
    from reforge_tpu.glsl import translate_shader
    from reforge_tpu.kernels.base import KernelContext

    p = _loop_case(seed)
    header = (
        "#version 450\n"
        "layout(local_size_x = 16, local_size_y = 16) in;\n"
        "layout(binding = 0, rgba32f) uniform readonly image2D input_image;\n"
        "layout(binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
    )
    src = header + _loop_shader_src(p)
    spec = translate_shader(src, f"loopfuzz{seed}")
    h, w = 10, 12
    rng = np.random.default_rng(100 + seed)
    base = rng.random((4, h, w)).astype(np.float32)
    img = jnp.asarray(base)
    ctx = KernelContext(width=w, height=h, time=0.0)
    got = np.asarray(
        spec(ctx, {"input_image": img}, spec.resolve_params({}))[
            "output_image"
        ]
    )
    want = _loop_oracle(p, base)
    np.testing.assert_allclose(got, want, atol=3e-5, err_msg=str(p))


# ---- general shader differential fuzz (oracle: tests/scalar_ref.py) ------
#
# Random straight-line + branching shaders over a small grammar: swizzle
# reads/writes, compound assignment, nested per-pixel if/else, static
# loops, user functions with out-params, ternaries.  The sequential
# scalar reference executes the same AST per pixel, so no per-template
# hand-written oracle is needed — anything the grammar emits is checked.

def _expr(rng, depth, vars_f, vars_v3):
    """A random float-typed GLSL expression string."""
    if depth <= 0 or rng.random() < 0.3:
        leaf = rng.integers(0, 4)
        if leaf == 0 and vars_f:
            return str(rng.choice(vars_f))
        if leaf == 1 and vars_v3:
            v = rng.choice(vars_v3)
            return f"{v}.{rng.choice(list('xyz'))}"
        if leaf == 2:
            return f"c.{rng.choice(list('rgb'))}"
        return f"{rng.uniform(-1.5, 1.5):.3f}"
    kind = rng.integers(0, 8)
    a = _expr(rng, depth - 1, vars_f, vars_v3)
    b = _expr(rng, depth - 1, vars_f, vars_v3)
    if kind == 0:
        return f"({a} {rng.choice(['+', '-', '*'])} {b})"
    if kind == 1:
        return f"min({a}, {b})" if rng.random() < 0.5 else f"max({a}, {b})"
    if kind == 2:
        t = _expr(rng, 0, vars_f, vars_v3)
        return f"mix({a}, {b}, clamp({t}, 0.0, 1.0))"
    if kind == 3:
        return f"sqrt(abs({a}))"
    if kind == 4:
        return f"({a} > {b} ? {a} : {b})"
    if kind == 5:
        t = _expr(rng, 0, vars_f, vars_v3)
        return f"fma({a}, clamp({b}, -2.0, 2.0), {t})"
    if kind == 6:
        return f"ldexp(clamp({a}, -2.0, 2.0), {int(rng.integers(-3, 4))})"
    return f"clamp({a}, -4.0, 4.0)"


def _stmt(rng, depth, vars_f, vars_v3, lines):
    k = rng.integers(0, 11)
    if k == 0 or not vars_f:
        nm = f"f{len(vars_f)}"
        lines.append(f"float {nm} = {_expr(rng, 2, vars_f, vars_v3)};")
        vars_f.append(nm)
    elif k == 1:
        nm = f"v{len(vars_v3)}"
        es = [_expr(rng, 1, vars_f, vars_v3) for _ in range(3)]
        lines.append(f"vec3 {nm} = vec3({es[0]}, {es[1]}, {es[2]});")
        vars_v3.append(nm)
    elif k == 2:
        v = rng.choice(vars_f)
        op = rng.choice(["=", "+=", "*=", "-="])
        lines.append(f"{v} {op} {_expr(rng, 2, vars_f, vars_v3)};")
    elif k == 3 and vars_v3:
        v = rng.choice(vars_v3)
        sw = rng.choice(["x", "y", "xz", "yx"])
        if len(sw) == 1:
            lines.append(f"{v}.{sw} = {_expr(rng, 1, vars_f, vars_v3)};")
        else:
            a = _expr(rng, 1, vars_f, vars_v3)
            b = _expr(rng, 1, vars_f, vars_v3)
            lines.append(f"{v}.{sw} = vec2({a}, {b});")
    elif k == 4 and depth > 0:
        cond = f"{_expr(rng, 1, vars_f, vars_v3)} > {rng.uniform(-0.5, 0.8):.3f}"
        then, other = [], []
        # Block scope: declarations inside a branch must not escape.
        tf, tv = list(vars_f), list(vars_v3)
        for _ in range(int(rng.integers(1, 3))):
            _stmt(rng, depth - 1, tf, tv, then)
        ef, ev = list(vars_f), list(vars_v3)
        for _ in range(int(rng.integers(0, 2))):
            _stmt(rng, depth - 1, ef, ev, other)
        body = "\n".join(then)
        lines.append(f"if ({cond}) {{\n{body}\n}}" + (
            f" else {{\n" + "\n".join(other) + "\n}" if other else ""
        ))
    elif k == 5:
        v = rng.choice(vars_f)
        n = int(rng.integers(2, 5))
        e = _expr(rng, 1, vars_f, vars_v3)
        lines.append(
            f"for (int i = 0; i < {n}; i++) {{ "
            f"{v} = {v} * 0.7 + {e} * 0.1; }}"
        )
    elif k == 6:
        v = rng.choice(vars_f)
        lines.append(f"{v} = helper({_expr(rng, 1, vars_f, vars_v3)}, {v});")
    elif k == 7:
        # switch on a small per-pixel selector, with one fallthrough and
        # (sometimes) a NON-tail break under a per-pixel guard — the
        # broken lanes must skip the fallthrough case.
        v = rng.choice(vars_f)
        sel = _expr(rng, 1, vars_f, vars_v3)
        e1 = _expr(rng, 1, vars_f, vars_v3)
        e2 = _expr(rng, 1, vars_f, vars_v3)
        mid = ""
        if rng.random() < 0.4:
            g = _expr(rng, 1, vars_f, vars_v3)
            mid = f"if ({g} > {rng.uniform(-0.3, 0.6):.3f}) {{ break; }}\n"
        lines.append(
            f"switch (int(clamp({sel}, 0.0, 1.0) * 2.9)) {{\n"
            f"case 0: {v} += {e1};\n{mid}"
            f"case 1: {v} *= 0.75; break;\n"
            f"default: {v} = {e2};\n}}"
        )
    elif k == 8:
        # mat2 rotation applied to a fresh vec2.
        nm = f"f{len(vars_f)}"
        a = _expr(rng, 1, vars_f, vars_v3)
        b = _expr(rng, 1, vars_f, vars_v3)
        ang = rng.uniform(0.1, 1.4)
        ca, sa = f"{np.cos(ang):.4f}", f"{np.sin(ang):.4f}"
        lines.append(
            f"vec2 p{len(vars_f)} = mat2({ca}, {sa}, -{sa}, {ca}) "
            f"* vec2({a}, {b});"
        )
        lines.append(f"float {nm} = p{len(vars_f)}.x + p{len(vars_f)}.y * 0.5;")
        vars_f.append(nm)
    elif k == 9:
        # Well-conditioned mat2 inverse: diagonally dominant, so the
        # determinant stays far from 0 and f32-vs-f64 drift is bounded.
        nm = f"f{len(vars_f)}"
        a = _expr(rng, 1, vars_f, vars_v3)
        b = _expr(rng, 1, vars_f, vars_v3)
        lines.append(
            f"mat2 q{len(vars_f)} = inverse(mat2("
            f"2.0 + abs({a}), 0.25, -0.25, 2.0 + abs({b})));"
        )
        lines.append(
            f"float {nm} = determinant(q{len(vars_f)}) "
            f"+ q{len(vars_f)}[0][0] + q{len(vars_f)}[1][1];"
        )
        vars_f.append(nm)
    else:
        # uint bit ops: counts are integers, exact on both sides except
        # at f32-vs-f64 truncation boundaries of v (fixed seeds keep
        # this deterministic; the *63.9 scale avoids exact boundaries).
        nm = f"f{len(vars_f)}"
        a = _expr(rng, 1, vars_f, vars_v3)
        lines.append(
            f"uint u{len(vars_f)} = uint(clamp({a}, 0.0, 1.0) * 63.9);"
        )
        lines.append(
            f"float {nm} = float(bitCount(u{len(vars_f)})) * 0.25 "
            f"+ float(findMSB(u{len(vars_f)})) * 0.125;"
        )
        vars_f.append(nm)


def _gen_expr_shader(seed):
    rng = np.random.default_rng(7700 + seed)
    vars_f, vars_v3, lines = [], [], []
    lines.append("float f0 = c.r * 2.0 - 0.5;")
    vars_f.append("f0")
    for _ in range(int(rng.integers(5, 11))):
        _stmt(rng, 2, vars_f, vars_v3, lines)
    r = _expr(rng, 2, vars_f, vars_v3)
    gch = _expr(rng, 2, vars_f, vars_v3)
    bch = f"{rng.choice(vars_v3)}.y" if vars_v3 else "c.b"
    body = "\n    ".join(lines)
    return f"""#version 450
layout(local_size_x = 16, local_size_y = 16) in;
layout(binding = 0, rgba32f) uniform readonly image2D input_image;
layout(binding = 1, rgba32f) uniform writeonly image2D output_image;
float helper(float x, inout float acc) {{
    acc = acc * 0.9 + x * 0.1;
    if (x > 0.5) {{ return x * 0.5; }}
    return x + 0.125;
}}
void main() {{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    {body}
    imageStore(output_image, pos, vec4({r}, {gch}, {bch}, 1.0));
}}
"""


@pytest.mark.parametrize("seed", range(16))
def test_expr_shader_differential_fuzz(seed):
    from reforge_tpu.glsl import translate_shader
    from reforge_tpu.kernels.base import KernelContext

    from scalar_ref import ScalarRef

    src = _gen_expr_shader(seed)
    spec = translate_shader(src, f"exprfuzz{seed}")
    h, w = 9, 11
    rng = np.random.default_rng(300 + seed)
    base = rng.random((4, h, w)).astype(np.float32)
    ctx = KernelContext(width=w, height=h, time=0.0)
    got = np.asarray(
        spec(ctx, {"input_image": jnp.asarray(base)},
             spec.resolve_params({}))["output_image"]
    )
    want = ScalarRef(src, {"input_image": base}).run()["output_image"]
    np.testing.assert_allclose(got, want, atol=5e-4, err_msg=src)


# ---- GLSL tap-sum fuzz ---------------------------------------------------
# Random clamped tap-sum shaders must compute exactly the separable
# correlation they spell out (checked against float64 numpy), and their
# reflected halo must be the tap radius whatever wraps the sum — halo
# exchange under --shard depends on it.


def _conv_shader_src(rng):
    """A random separable tap-sum .comp source + its structure."""
    ry = int(rng.integers(0, 4))
    rx = int(rng.integers(0, 4))
    if ry == 0 and rx == 0:
        rx = 1 + int(rng.integers(0, 3))
    wh = rng.uniform(-0.4, 1.0, 2 * ry + 1)
    ww = rng.uniform(-0.4, 1.0, 2 * rx + 1)
    wh[0] += 0.5
    ww[-1] += 0.5
    scale = float(rng.choice([1.0, 0.5, 2.0]))
    offset = float(rng.choice([0.0, 0.0, 0.25]))
    taps = []
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            w = float(wh[dy + ry] * ww[dx + rx] * scale)
            taps.append(
                f"acc += {w!r} * imageLoad(input_image, clamp(pos + "
                f"ivec2({dx}, {dy}), ivec2(0), hi)).rgb;"
            )
    body = "\n    ".join(taps)
    src = f"""#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 hi = imageSize(input_image) - ivec2(1);
    vec3 acc = vec3(0.0);
    {body}
    imageStore(output_image, pos,
               vec4(acc + vec3({offset!r}), imageLoad(input_image, pos).a));
}}
"""
    return src, (ry, rx), (wh, ww, scale, offset)


NONLINEAR_WRAPS = [
    "acc = min(acc, vec3(0.7));",
    "acc = abs(acc - vec3(0.5));",
    "acc = acc * acc;",
    "acc = clamp(acc * 3.0 - vec3(1.0), vec3(0.0), vec3(1.0));",
]


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_tap_sum_shader_matches_numpy(seed):
    from reforge_tpu.glsl import translate_shader
    from reforge_tpu.kernels.base import KernelContext

    rng = np.random.default_rng(1000 + seed)
    src, (ry, rx), (wh, ww, scale, offset) = _conv_shader_src(rng)
    spec = translate_shader(src, f"fuzzconv{seed}", path=f"fz{seed}.comp")
    params = spec.resolve_params({})
    h, w = 4 * max(ry, rx) + 21, 4 * max(ry, rx) + 27
    img = rng.random((4, h, w), dtype=np.float32)
    ctx = KernelContext(width=w, height=h, time=0.0)
    got = np.asarray(
        spec(ctx, {"input_image": jnp.asarray(img)}, params)["output_image"]
    )
    x = img.astype(np.float64)
    xp = np.pad(x, ((0, 0), (ry, ry), (0, 0)), mode="edge")
    acc = sum(wv * xp[:, i : i + h, :] for i, wv in enumerate(wh))
    accp = np.pad(acc, ((0, 0), (0, 0), (rx, rx)), mode="edge")
    want = scale * sum(wv * accp[:, :, j : j + w] for j, wv in enumerate(ww))
    want[:3] += offset
    want[3] = x[3]
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    assert spec.halo_for(params) == max(ry, rx)
    assert spec.border_for(params) == "edge"


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_wrapped_tap_sum_reflects_radius(seed):
    from reforge_tpu.glsl import translate_shader

    rng = np.random.default_rng(2000 + seed)
    src, (ry, rx), _ = _conv_shader_src(rng)
    wrap = NONLINEAR_WRAPS[seed % len(NONLINEAR_WRAPS)]
    src = src.replace(
        "imageStore(output_image",
        wrap + "\n    imageStore(output_image",
    )
    spec = translate_shader(src, f"fuzznl{seed}", path=f"fznl{seed}.comp")
    params = spec.resolve_params({})
    assert spec.halo_for(params) == max(ry, rx)
    assert spec.border_for(params) == "edge"


def test_fuzz_time_and_coord_dependent_taps_reflect_radius():
    from reforge_tpu.glsl import translate_shader

    time_dep = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform U { float _rf_time; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 hi = imageSize(input_image) - ivec2(1);
    vec3 acc = 0.5 * imageLoad(input_image, pos).rgb
        + (0.5 + 0.1 * _rf_time)
          * imageLoad(input_image, clamp(pos + ivec2(1, 0), ivec2(0), hi)).rgb;
    imageStore(output_image, pos, vec4(acc, 1.0));
}
"""
    coord_dep = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 hi = imageSize(input_image) - ivec2(1);
    float wy = float(pos.y) / float(hi.y);
    vec3 acc = (1.0 - wy) * imageLoad(input_image, pos).rgb
        + wy * imageLoad(input_image, clamp(pos + ivec2(0, 1), ivec2(0), hi)).rgb;
    imageStore(output_image, pos, vec4(acc, 1.0));
}
"""
    for name, src in (("tdep", time_dep), ("cdep", coord_dep)):
        spec = translate_shader(src, name, path=f"{name}.comp")
        params = spec.resolve_params({})
        assert spec.halo_for(params) == 1, name
        assert spec.border_for(params) == "edge", name
