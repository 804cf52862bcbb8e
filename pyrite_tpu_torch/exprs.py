"""Expression compiler: scene IR expression DAGs -> torch functions (PyTorch
port of pyrite_tpu.exprs).

Each expression becomes a function evaluated for a whole wavefront of rays
and all spectral samples at once. Type promotion (number / vector / rgb)
follows the JAX package, which follows compiler.rs:682-968, including the
Burns RGB->spectrum sampling when an RGB value is consumed as a number,
the x*2-1 RGB->vector decode and the bicubic image textures with
wrap-around (texture.rs:88-148).

For the CUDA kernels, every program that reads the ray (textures read the
hit's uv, ``fresnel`` its normal and incident direction) is also lowered
into a postfix code that the kernels interpret (``KernelPrograms``), in
two parts: what depends on no spectral column once per lane, the rest per
column (``split_code``); each largest subtree of it that reads no ray
becomes a leaf, evaluated here once per launch at each lane's wavelengths,
and programs of the wavelength alone are evaluated here whole. The code
has one plain interpreter in PyTorch (``KernelPrograms.run``), which the
tests hold to the compiled closures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import spectra as spectra_mod
from .project import ir

NUMBER = "number"
VECTOR = "vector"
RGB = "rgb"

@dataclass
class ProgramInputs:
    """Runtime inputs for a compiled program.

    ``wavelength``: [N, S] (ray mode, hero at column 0) or [T] (plain mode).
    ``normal`` / ``incident``: [N, 3]; ``uv``: [N, 2]; None in plain mode.
    """

    wavelength: torch.Tensor
    normal: Optional[torch.Tensor] = None
    incident: Optional[torch.Tensor] = None
    uv: Optional[torch.Tensor] = None

    @property
    def ray_mode(self) -> bool:
        return self.normal is not None or self.wavelength.ndim == 2


@dataclass
class CompiledProgram:
    fn: Callable[[ProgramInputs], object]
    output_type: str  # NUMBER or VECTOR
    uses_wavelength: bool
    constant: Optional[float] = None  # set when the program is a plain constant
    # False when the DAG reads only the wavelength (no uv/normal/incident)
    uses_ray_inputs: bool = False
    expr: object = None  # the IR the program was compiled from
    # True when the DAG samples an image texture
    uses_texture: bool = False

    def __call__(self, inputs: ProgramInputs) -> torch.Tensor:
        out = self.fn(inputs)
        if isinstance(out, torch.Tensor):
            return out
        return torch.as_tensor(out, dtype=torch.float32, device=inputs.wavelength.device)


class Resources:
    """Shared spectrum and texture lookups for program compilation.

    Texture data lives in ``store`` (key -> [H, W, 4] or [H, W] float32
    array, keyed "color:<path>:<linear>" or "mono:<path>:<linear>" as the
    JAX package keys it), loaded through ``texture_loader``
    (project.textures.TextureLoader). ``tensors`` holds each texture as a
    torch tensor once a device asks for it (``texture``)."""

    def __init__(self, texture_loader=None):
        self.texture_loader = texture_loader
        self._spectrum_cache: dict[int, object] = {}
        self.store: dict[str, object] = {}
        self.tensors: dict = {}

    def spectrum(self, spec: ir.SpectrumIR):
        cached = self._spectrum_cache.get(id(spec))
        if cached is not None:
            return cached
        if spec.format == "builtin":
            s = spectra_mod.builtin_spectrum(spec.builtin)
        elif spec.format == "array":
            s = spectra_mod.make_array_spectrum(spec.min, spec.max, spec.points)
        else:
            s = spectra_mod.make_curve_spectrum(spec.points)
        self._spectrum_cache[id(spec)] = s
        return s

    def color_texture(self, path: str, linear: bool):
        key = f"color:{path}:{bool(linear)}"
        if key not in self.store:
            self.store[key] = self.texture_loader.load_color(path, linear).data
        return self.store[key]

    def mono_texture(self, path: str, linear: bool):
        key = f"mono:{path}:{bool(linear)}"
        if key not in self.store:
            self.store[key] = self.texture_loader.load_mono(path, linear).data
        return self.store[key]

    def preload(self, expr):
        """Register every texture an expression references, so the store's
        keys are fixed when the scene is packed."""
        for node in _walk(expr):
            if node.kind == "color_texture":
                self.color_texture(node.fields["path"], node.fields["linear"])
            elif node.kind == "mono_texture":
                self.mono_texture(node.fields["path"], node.fields["linear"])

    def texture(self, key, device):
        """The store's texture ``key`` as a float32 tensor on ``device``."""
        cached = self.tensors.get((key, str(device)))
        if cached is None:
            cached = torch.as_tensor(np.ascontiguousarray(self.store[key], np.float32), device=device)
            self.tensors[(key, str(device))] = cached
        return cached


# --- value plumbing -----------------------------------------------------------
#
# In ray mode every value is broadcast-compatible with:
#   numbers: [N, S]    (per-ray-only values are [N, 1]; constants are floats)
#   vec/rgb: [N, S, 4] (per-ray-only values are [N, 1, 4]; constants are (4,))
# In plain (no-ray) mode numbers broadcast with [T] and vec/rgb with [T, 4].


class _Value:
    __slots__ = ("type", "data", "uses_wl")

    def __init__(self, type_, data, uses_wl):
        self.type = type_
        self.data = data
        self.uses_wl = uses_wl


def _per_ray_channels(x, inputs):
    """Lift a per-ray [N, C] array into channel-broadcast form."""
    if inputs.ray_mode:
        return x[:, None, :]
    return x


def _tensor(x, inputs):
    return torch.as_tensor(x, dtype=torch.float32, device=inputs.wavelength.device)


def _splat_rgb(value: _Value, inputs):
    n = value.data
    if isinstance(n, (int, float)):
        return _tensor([n, n, n, 1.0], inputs)
    arr = _tensor(n, inputs)
    return torch.stack([arr, arr, arr, torch.ones_like(arr)], dim=-1)


def _splat_vector(value: _Value, inputs):
    n = value.data
    if isinstance(n, (int, float)):
        return _tensor([n, n, n, n], inputs)
    arr = _tensor(n, inputs)
    return torch.stack([arr, arr, arr, arr], dim=-1)


def _rgb_to_vector(data):
    return data * 2.0 - 1.0


def _rgb_to_number(value: _Value, inputs: ProgramInputs):
    """Burns sampling: dot(rgb, RGB_basis(wavelength)), summed over channels."""
    basis = spectra_mod.rgb_basis().sample(inputs.wavelength)  # [..., 3]
    rgb = value.data[..., :3] if not isinstance(value.data, (int, float)) else value.data
    return torch.sum(rgb * basis, dim=-1)


def _to_number(value: _Value, inputs: ProgramInputs) -> _Value:
    if value.type == NUMBER:
        return value
    if value.type == RGB:
        return _Value(NUMBER, _rgb_to_number(value, inputs), True)
    raise ir.ProjectError("cannot use a vector as a number")


def _promote_pair(lhs: _Value, rhs: _Value, inputs: ProgramInputs):
    """Type promotion for binary/mix ops, mirroring convert_operands."""
    order = {NUMBER: 0, RGB: 1, VECTOR: 2}
    target = max(lhs.type, rhs.type, key=lambda t: order[t])

    def convert(v: _Value) -> _Value:
        if v.type == target:
            return v
        if target == RGB:  # number -> rgb splat (alpha = 1)
            return _Value(RGB, _splat_rgb(v, inputs), v.uses_wl)
        if v.type == NUMBER:
            return _Value(VECTOR, _splat_vector(v, inputs), v.uses_wl)
        return _Value(VECTOR, _rgb_to_vector(v.data), v.uses_wl)  # rgb decode

    return convert(lhs), convert(rhs), target


def _bicubic_1d(v1, v2, v3, v4, t):
    """The reference's cubic (texture.rs:324-334)."""
    a = (v4 - v3) - (v1 - v2)
    b = (v1 - v2) - a
    c = v3 - v1
    return v2 + (c + (b + a * t) * t) * t


def _wrap_indices(floor_idx, size):
    """The four taps around a floor index, wrapped around ``size``: a floor
    modulo (never negative, as jnp.mod), then the neighbours."""
    i2 = torch.remainder(floor_idx.to(torch.int32), size).long()
    i1 = torch.where(i2 == 0, size - 1, i2 - 1)
    i3 = torch.where(i2 == size - 1, 0, i2 + 1)
    i4 = torch.where(i3 == size - 1, 0, i3 + 1)
    return i1, i2, i3, i4


def sample_texture_bicubic(data, uv):
    """Bicubic texture fetch with wrap-around, matching texture.rs:88-148.

    ``data``: [H, W] or [H, W, C]; ``uv``: [N, 2]. Returns [N] or [N, C]:
    the four rows of four taps, each row's cubic along x, then the cubic of
    the rows along y, with y = (1 - v) H - 0.5."""
    height, width = data.shape[0], data.shape[1]
    x = uv[:, 0] * width - 0.5
    x_floor = torch.floor(x)
    y = (1.0 - uv[:, 1]) * height - 0.5
    y_floor = torch.floor(y)
    xs = _wrap_indices(x_floor, width)
    ys = _wrap_indices(y_floor, height)
    tx, ty = x - x_floor, y - y_floor
    if data.ndim == 3:
        tx, ty = tx[:, None], ty[:, None]
    rows = []
    for yi in ys:
        taps = [data[yi, xi] for xi in xs]
        rows.append(_bicubic_1d(taps[0], taps[1], taps[2], taps[3], tx))
    return _bicubic_1d(rows[0], rows[1], rows[2], rows[3], ty)


# --- the compiler -----------------------------------------------------------


def compile_program(
    expr: ir.Expression, resources: Resources, output_type: str = NUMBER
) -> CompiledProgram:
    """Compile an expression DAG into a function of ProgramInputs."""

    if isinstance(expr, float):
        value = expr if output_type == NUMBER else [expr] * 4
        return CompiledProgram(
            fn=lambda inputs, v=value: v,
            output_type=output_type,
            uses_wavelength=False,
            constant=expr,
            expr=expr,
        )

    uses_wl = _expr_uses_wavelength(expr, output_type)
    uses_ray = expr_uses_ray_inputs(expr)
    uses_tex = expr_uses_texture(expr)
    resources.preload(expr)

    def fn(inputs: ProgramInputs):
        cache: dict[int, _Value] = {}
        value = _eval_expr(expr, inputs, resources, cache)
        if output_type == NUMBER:
            return _to_number(value, inputs).data
        if value.type == VECTOR:
            return value.data
        if value.type == RGB:
            return _rgb_to_vector(value.data)
        return _splat_vector(value, inputs)

    return CompiledProgram(
        fn=fn, output_type=output_type, uses_wavelength=uses_wl,
        uses_ray_inputs=uses_ray, expr=expr, uses_texture=uses_tex,
    )


def _walk(expr):
    """Every ComplexExpression node of a DAG, each once (none of a
    constant)."""
    seen = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if not isinstance(node, ir.ComplexExpression) or id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        stack.extend(v for v in node.fields.values() if isinstance(v, ir.ComplexExpression))


def expr_uses_ray_inputs(expr: ir.Expression) -> bool:
    """True when any DAG node reads uv (textures) or normal/incident
    (fresnel), i.e. the program is NOT a pure function of wavelength."""
    return any(n.kind in ("color_texture", "mono_texture", "fresnel") for n in _walk(expr))


def expr_uses_texture(expr: ir.Expression) -> bool:
    """True when any DAG node samples an image texture."""
    return any(n.kind in ("color_texture", "mono_texture") for n in _walk(expr))


def _expr_uses_wavelength(expr: ir.Expression, output_type: str) -> bool:
    """Does evaluating ``expr`` (coerced to ``output_type``) read the
    wavelength? An RGB result read as a number samples the Burns basis at
    the wavelength, so it counts (ProbabilityInput::wavelength_used)."""
    t, uses = _static_type(expr)
    if output_type == NUMBER and t == RGB:
        return True
    return uses


def _static_type(expr: ir.Expression):
    if isinstance(expr, float):
        return NUMBER, False
    kind = expr.kind
    f = expr.fields
    if kind == "vector":
        return VECTOR, any(_number_uses(f[a]) for a in ("x", "y", "z", "w"))
    if kind == "rgb":
        return RGB, any(_number_uses(f[c]) for c in ("red", "green", "blue"))
    if kind in ("binary", "mix"):
        lt, lu = _static_type(f["lhs"])
        rt, ru = _static_type(f["rhs"])
        order = {NUMBER: 0, RGB: 1, VECTOR: 2}
        target = max(lt, rt, key=lambda t: order[t])
        uses = lu or ru
        if kind == "mix":
            uses = uses or _number_uses(f["amount"])
        return target, uses
    if kind == "clamp":
        return NUMBER, (
            _number_uses(f["value"]) or _number_uses(f["min"]) or _number_uses(f["max"])
        )
    if kind == "fresnel":
        return NUMBER, (_number_uses(f["ior"]) or _number_uses(f["env_ior"]))
    if kind in ("blackbody", "spectrum"):
        return NUMBER, True
    if kind == "color_texture":
        return RGB, False
    if kind == "mono_texture":
        return NUMBER, False
    raise ir.ProjectError(f"unknown expression kind {kind!r}")


def _number_uses(expr: ir.Expression) -> bool:
    """Wavelength usage of an expression consumed as a number."""
    t, uses = _static_type(expr)
    return uses or t == RGB


def _eval_expr(expr, inputs, resources, cache) -> _Value:
    if isinstance(expr, float):
        return _Value(NUMBER, expr, False)
    cached = cache.get(id(expr))
    if cached is not None:
        return cached
    value = _eval_complex(expr, inputs, resources, cache)
    cache[id(expr)] = value
    return value


def _eval_number(expr, inputs, resources, cache):
    return _to_number(_eval_expr(expr, inputs, resources, cache), inputs)


def _stack_broadcast(comps, inputs, extra=()):
    datas = [_tensor(c.data, inputs) for c in comps] + list(extra)
    shape = torch.broadcast_shapes(*(d.shape for d in datas))
    return torch.stack([d.expand(shape) for d in datas], dim=-1)


def _eval_complex(expr: ir.ComplexExpression, inputs, resources, cache) -> _Value:
    kind = expr.kind
    f = expr.fields
    if kind == "vector":
        comps = [_eval_number(f[a], inputs, resources, cache) for a in ("x", "y", "z", "w")]
        return _Value(VECTOR, _stack_broadcast(comps, inputs), any(c.uses_wl for c in comps))
    if kind == "rgb":
        comps = [_eval_number(f[c], inputs, resources, cache) for c in ("red", "green", "blue")]
        alpha = _tensor(1.0, inputs)
        return _Value(
            RGB, _stack_broadcast(comps, inputs, extra=(alpha,)), any(c.uses_wl for c in comps)
        )
    if kind == "binary":
        lhs = _eval_expr(f["lhs"], inputs, resources, cache)
        rhs = _eval_expr(f["rhs"], inputs, resources, cache)
        lhs, rhs, target = _promote_pair(lhs, rhs, inputs)
        op = f["operator"]
        a, b = lhs.data, rhs.data
        if op == "add":
            data = a + b
        elif op == "sub":
            data = a - b
        elif op == "mul":
            data = a * b
        else:
            data = a / b
        return _Value(target, data, lhs.uses_wl or rhs.uses_wl)
    if kind == "mix":
        amount = _eval_number(f["amount"], inputs, resources, cache)
        lhs = _eval_expr(f["lhs"], inputs, resources, cache)
        rhs = _eval_expr(f["rhs"], inputs, resources, cache)
        lhs, rhs, target = _promote_pair(lhs, rhs, inputs)
        t = torch.clamp(_tensor(amount.data, inputs), 0.0, 1.0)
        if target != NUMBER and t.ndim > 0:
            t = t[..., None]
        data = lhs.data * (1.0 - t) + rhs.data * t
        return _Value(target, data, amount.uses_wl or lhs.uses_wl or rhs.uses_wl)
    if kind == "clamp":
        value = _eval_number(f["value"], inputs, resources, cache)
        lo = _eval_number(f["min"], inputs, resources, cache)
        hi = _eval_number(f["max"], inputs, resources, cache)
        data = torch.minimum(
            torch.maximum(_tensor(value.data, inputs), _tensor(lo.data, inputs)),
            _tensor(hi.data, inputs),
        )
        return _Value(NUMBER, data, value.uses_wl or lo.uses_wl or hi.uses_wl)
    if kind == "fresnel":
        ior = _eval_number(f["ior"], inputs, resources, cache)
        env_ior = _eval_number(f["env_ior"], inputs, resources, cache)
        value = spectra_mod.fresnel(
            _tensor(ior.data, inputs),
            _tensor(env_ior.data, inputs),
            _per_ray_channels(inputs.normal, inputs),
            _per_ray_channels(inputs.incident, inputs),
        )
        return _Value(NUMBER, value, ior.uses_wl or env_ior.uses_wl)
    if kind == "blackbody":
        temperature = _eval_number(f["temperature"], inputs, resources, cache)
        return _Value(NUMBER, spectra_mod.blackbody(inputs.wavelength, temperature.data), True)
    if kind == "spectrum":
        spectrum = resources.spectrum(f["spectrum"])
        return _Value(NUMBER, spectrum.sample(inputs.wavelength), True)
    if kind == "color_texture":
        data = resources.texture(texture_key("color", f), inputs.wavelength.device)
        rgba = sample_texture_bicubic(data, inputs.uv)  # [N, 4]
        return _Value(RGB, _per_ray_channels(rgba, inputs), False)
    if kind == "mono_texture":
        data = resources.texture(texture_key("mono", f), inputs.wavelength.device)
        luma = sample_texture_bicubic(data, inputs.uv)  # [N]
        return _Value(NUMBER, luma[:, None] if inputs.ray_mode else luma, False)
    raise ir.ProjectError(f"unknown expression kind {kind!r}")


def texture_key(kind, fields):
    """The Resources.store key of a "color" or "mono" texture node's fields."""
    return f"{kind}:{fields['path']}:{bool(fields['linear'])}"


# --- the kernels' program form --------------------------------------------------
#
# The CUDA kernels cannot call a Python closure, so every program that reads
# the ray is lowered to postfix code over a stack of 4-float values: a
# number uses the first float, an rgb or vector all four, and the lowering
# knows each value's type. An instruction is (opcode, value, arg). The
# kernels run a program once per lane and spectral column k (a probability
# or normal program at column 0, the hero wavelength), from the lane's
# normal, incident direction and uv:
#   CONST pushes the number ``value``; VEC the constant vecs[arg];
#   LEAF / LEAF4 push leaf ``arg``'s number / 4-vector at (lane, k): a
#     largest subtree that reads no ray, evaluated once per launch at each
#     lane's wavelengths (KernelPrograms.leaf_values);
#   ADD SUB MUL DIV (lhs, rhs), MIX (lhs, rhs, amount, the amount clamped to
#     [0, 1]) work on all four floats; CLAMP (value, min, max) and FRESNEL
#     (ior, env_ior, with the lane's normal and incident direction) on
#     numbers; all pop their operands in push order and push one result;
#   TEX_COLOR / TEX_MONO sample texture ``arg`` bicubically at the lane's uv;
#   SPLAT_RGB (n, n, n, 1), SPLAT_VEC (n, n, n, n) and RGB_TO_VEC (x 2 - 1)
#     are _promote_pair's conversions; TO_NUMBER is Burns' rgb -> number,
#     the dot of rgb with the basis leaf ``arg`` at (lane, k);
#   RGB (r, g, b, 1) and VECTOR (x, y, z, w) build a value from numbers.
# A probability program made of CONST, the binary ops, MIX, CLAMP and FRESNEL
# alone is the form the simple kernels' instantiations interpret
# (csrc/bounce.cu eval_prob), one stream of code. The kProg instantiations
# (eval_program) run each program in two parts (split_code): only LEAF,
# LEAF4 and TO_NUMBER, and what takes their values, depend on the spectral
# column, so every largest subtree that depends on none of them and does
# some work (a texture, a fresnel, a conversion) is the LANE code, run once
# per lane, whose values stay on the stack as slots 0, 1, ...; the rest is
# the COLUMN code, run per column above the slots, where
#   SLOT pushes slot ``arg`` again.
# The same ops run on the same values, so each value is the one stream's,
# bit for bit, and a texture is sampled once per lane, not once per column.
# The opcodes are mirrored in csrc/bounce.cu. A program has no length or
# depth limit. It is lowered with its operands in the order the expression
# gives them, unless that needs a stack deeper than PROG_STACK_MAX values:
# then in Sethi-Ullman order (Sethi and Ullman, "The generation of optimal
# code for arithmetic expressions", JACM 1970), each node's operands from
# the one that needs the deepest stack to the one that needs the least,
#   SWAP exchanging the top value and the one ``arg`` below it,
# so that every op finds its operands in their order again (ADD and MUL
# take them as they come: an IEEE sum or product does not depend on the
# order): each op gets the same operand values, so each output is
# bit-equal to the expression's order, and the stack grows with the
# logarithm of the program's size. The
# simple instantiations' stack holds PROG_STACK values, the kProg ones'
# the scene's deepest program (KernelPrograms.stack_depth, at least
# PROG_STACK), in shared memory sized per launch.

(OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MIX, OP_CLAMP, OP_FRESNEL, OP_VEC, OP_LEAF,
 OP_LEAF4, OP_TEX_COLOR, OP_TEX_MONO, OP_SPLAT_RGB, OP_SPLAT_VEC, OP_RGB_TO_VEC, OP_TO_NUMBER,
 OP_RGB, OP_VECTOR, OP_SLOT, OP_SWAP) = range(21)
SIMPLE_OPS = frozenset(range(OP_FRESNEL + 1))  # the simple kernels' form
TEXTURE_OPS = frozenset((OP_TEX_COLOR, OP_TEX_MONO))
COLUMN_OPS = frozenset((OP_LEAF, OP_LEAF4, OP_TO_NUMBER))  # read the lane's spectral column
PROG_STACK = 8  # the kernels' least stack depth, values (a program's depth may pass it)
PROG_STACK_MAX = 48  # the deepest stack a program is lowered to (96 KiB of shared memory a block)
# the operands each opcode pops (the others pop none; SWAP moves two)
_POPS = {OP_ADD: 2, OP_SUB: 2, OP_MUL: 2, OP_DIV: 2, OP_MIX: 3, OP_CLAMP: 3, OP_FRESNEL: 2,
         OP_SPLAT_RGB: 1, OP_SPLAT_VEC: 1, OP_RGB_TO_VEC: 1, OP_TO_NUMBER: 1, OP_RGB: 3,
         OP_VECTOR: 4}


def _depth(code, base=0):
    """The deepest stack ``code`` reaches from ``base`` values."""
    sp = deepest = base
    for op, _, _ in code:
        sp += 0 if op == OP_SWAP else 1 - _POPS.get(op, 0)
        deepest = max(deepest, sp)
    return deepest


def _swaps(order):
    """The SWAP arguments that put operands pushed in ``order`` (their
    places in the op's order, bottom first) back in the op's order."""
    cur, top, out = list(order), len(order) - 1, []
    for place in range(top):
        if cur[place] == place:
            continue
        at = cur.index(place)
        for p in ((at,) if at != top else ()) + (place,):
            out.append(top - p)
            cur[top], cur[p] = cur[p], cur[top]
    return out


def split_code(code):
    """One program's postfix ``code`` as (lane code, column code): the
    largest subtrees that depend on no spectral column (COLUMN_OPS) and are
    more than constants, in program order, as long as the slots they leave
    and the column code above them fit PROG_STACK, or the one stream's own
    depth where that is deeper; each replaced by SLOT in the column code."""
    limit = max(PROG_STACK, _depth(code))
    start, column, parent, stack = [], [], [None] * len(code), []
    for i, (op, _, arg) in enumerate(code):
        if op == OP_SWAP:  # part of the op it precedes, never hoisted alone
            stack[-1], stack[-1 - arg] = stack[-1 - arg], stack[-1]
            start.append(i)
            column.append(True)
            continue
        pops = _POPS.get(op, 0)
        operands = stack[len(stack) - pops:] if pops else []
        del stack[len(stack) - len(operands):]
        for j in operands:
            parent[j] = i
        start.append(min(start[j] for j in operands) if operands else i)
        column.append(op in COLUMN_OPS or any(column[j] for j in operands))
        stack.append(i)
    hoisted = []
    for i in range(len(code)):
        top = parent[i] is None or column[parent[i]]
        work = any(code[j][0] not in (OP_CONST, OP_VEC) for j in range(start[i], i + 1))
        if column[i] or not top or not work:
            continue
        trial = hoisted + [i]
        lane = max(j + _depth(code[start[e]:e + 1]) for j, e in enumerate(trial))
        if lane <= limit and _depth(_column_part(code, start, trial), len(trial)) <= limit:
            hoisted = trial
    lane_code = [c for e in hoisted for c in code[start[e]:e + 1]]
    return lane_code, _column_part(code, start, hoisted)


def _column_part(code, start, hoisted):
    """``code`` with the subtree ending at each of ``hoisted`` (in order)
    replaced by SLOT of its place."""
    out, i, slot = [], 0, {start[e]: (n, e) for n, e in enumerate(hoisted)}
    while i < len(code):
        if i in slot:
            n, e = slot[i]
            out.append((OP_SLOT, 0.0, n))
            i = e + 1
        else:
            out.append(code[i])
            i += 1
    return out

_BINARY_OPS = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV}
_PROMOTE = {(NUMBER, RGB): OP_SPLAT_RGB, (NUMBER, VECTOR): OP_SPLAT_VEC, (RGB, VECTOR): OP_RGB_TO_VEC}


def _inline_number(node):
    """Whether a subtree that reads no ray is inlined as code (a number of
    constants, binary, mix and clamp nodes) rather than made a leaf."""
    if isinstance(node, float):
        return True
    if node.kind not in ("binary", "mix", "clamp"):
        return False
    return all(_inline_number(v) for k, v in node.fields.items() if k != "operator")


class KernelPrograms:
    """The program code of a scene's ray-reading programs, laid out for the
    kernels: programs are numbered prob, then color, then normal, then the
    sky (``index``); program g's code is code[off[g]:off[g + 1]], empty for
    a program that reads no ray (its values come per launch: constants,
    bank values). Leaves, vector constants and the textures (in
    resources.store order) are shared by all programs. ``parts[g]`` is
    program g's (lane code, column code) (split_code), laid out for the
    kProg instantiations as ``split`` with ``split_off``: the lane code of
    program g is split[split_off[2g]:split_off[2g + 1]], its column code
    split[split_off[2g + 1]:split_off[2g + 2]]."""

    def __init__(self, scene, resources):
        self.resources = resources
        self.textures = list(resources.store)
        self.code: list[tuple[int, float, int]] = []
        self.vecs: list[tuple[float, float, float, float]] = []
        self.leaves: list[tuple[object, int]] = []  # (expr, width 1 or 4)
        self.leaf_base: list[int] = []  # units of N x S floats
        self._basis = None
        groups = (
            [(p, NUMBER) for p in scene.prob_programs]
            + [(p, NUMBER) for p in scene.color_programs]
            + [(p, VECTOR) for p in scene.normal_programs]
            + [(scene.sky_program, NUMBER)]
        )
        self.counts = (len(scene.prob_programs), len(scene.color_programs),
                       len(scene.normal_programs), 1)
        self.off = [0]
        for prog, out in groups:
            lower = prog.uses_ray_inputs or (out == VECTOR and prog.constant is None)
            if lower:
                self._lower(prog.expr, out)
            elif out == VECTOR:
                self._lower(prog.constant, out)
            self.off.append(len(self.code))
        self.parts = [split_code(self.program_code(g)) for g in range(len(self.off) - 1)]
        # the kProg instantiations' stack: the deepest of every program's
        # lane code and column code above its slots, PROG_STACK at least
        self.stack_depth = max([PROG_STACK] + [
            max(_depth(lane), _depth(column, sum(op == OP_SLOT for op, _, _ in column)))
            for lane, column in self.parts])
        self.split, self.split_off = [], [0]
        for part in (p for lane_col in self.parts for p in lane_col):
            self.split.extend(part)
            self.split_off.append(len(self.split))

    def index(self, group, p):
        """Global number of program ``p`` of ``group`` ("prob", "color",
        "normal", "sky")."""
        start = {"prob": 0, "color": 1, "normal": 2, "sky": 3}[group]
        return sum(self.counts[:start]) + p

    def program_code(self, g):
        return self.code[self.off[g]:self.off[g + 1]]

    @property
    def simple(self):
        """Whether only probability programs of the simple kernels' form,
        within their stack of PROG_STACK values, have code: those
        instantiations run the scene."""
        n_prob = self.counts[0]
        return self.off[n_prob] == len(self.code) and all(
            op in SIMPLE_OPS for op, _, _ in self.code) and all(
            _depth(self.program_code(g)) <= PROG_STACK for g in range(n_prob))

    def _leaf(self, expr, width):
        self.leaf_base.append(sum(w for _, w in self.leaves))
        self.leaves.append((expr, width))
        return len(self.leaves) - 1

    def _basis_leaf(self):
        if self._basis is None:
            self._basis = self._leaf("basis", 4)
        return self.leaf_base[self._basis]

    def _lower(self, expr, output_type):
        """Append ``expr``'s code: its operands in the expression's order,
        or in Sethi-Ullman order where that needs a stack deeper than
        PROG_STACK_MAX values (see the comment above OP_CONST)."""
        code, depth, needs = [], [0, 0], {}

        def push(op, value=0.0, arg=0, pops=0):
            depth[0] += 1 - pops
            depth[1] = max(depth[1], depth[0])
            code.append((op, float(value), int(arg)))

        def leaf(node):
            """Whether ``node`` is one value pushed by one instruction (a
            constant, a leaf, a vector constant, a texture)."""
            return isinstance(node, float) or node.kind in ("color_texture", "mono_texture") or (
                not expr_uses_ray_inputs(node)
                and not (_static_type(node)[0] == NUMBER and _inline_number(node)))

        def operands(node):
            """``node``'s operands in its op's order, each (subtree, emit):
            emit leaves the operand's value as the op takes it."""
            t, f = _static_type(node)[0], node.fields
            if node.kind in ("binary", "mix"):
                out = [(f[side], lambda side=side: convert(f[side], t)) for side in ("lhs", "rhs")]
                return out + ([(f["amount"], lambda: number(f["amount"]))] if node.kind == "mix"
                              else [])
            keys = {"clamp": ("value", "min", "max"), "fresnel": ("ior", "env_ior"),
                    "rgb": ("red", "green", "blue"), "vector": "xyzw"}.get(node.kind)
            if keys is None:
                raise ir.ProjectError(f"unknown expression kind {node.kind!r}")
            return [(f[k], lambda k=k: number(f[k])) for k in keys]

        def need(node, ordered):
            """The stack ``node``'s code reaches, its operands in the
            expression's order or (``ordered``) from the deepest need."""
            key = (id(node), ordered)
            if key not in needs:
                if leaf(node):
                    needs[key] = 1
                else:
                    sub = [need(n, ordered) for n, _ in operands(node)]
                    sub = sorted(sub, reverse=True) if ordered else sub
                    needs[key] = max(n + i for i, n in enumerate(sub))
            return needs[key]

        reorder = need(expr, False) > PROG_STACK_MAX

        def convert(node, t):
            st = _static_type(node)[0]
            emit(node)
            if st != t:
                push(_PROMOTE[(st, t)], pops=1)

        def number(node):
            if emit(node) == RGB:
                push(OP_TO_NUMBER, arg=self._basis_leaf(), pops=1)
            elif _static_type(node)[0] == VECTOR:
                raise ir.ProjectError("cannot use a vector as a number")

        def emit(node):
            """Emit ``node``'s value; returns its type."""
            t = _static_type(node)[0]
            if isinstance(node, float):
                push(OP_CONST, node)
                return NUMBER
            f = node.fields
            kind = node.kind
            if kind in ("color_texture", "mono_texture"):
                key = texture_key("color" if kind == "color_texture" else "mono", f)
                push(OP_TEX_COLOR if kind == "color_texture" else OP_TEX_MONO,
                     arg=self.textures.index(key))
                return t
            if leaf(node):
                if kind in ("rgb", "vector") and all(isinstance(v, float) for v in f.values()):
                    keys = ("red", "green", "blue") if kind == "rgb" else "xyzw"
                    vals = [f[k] for k in keys] + ([1.0] if kind == "rgb" else [])
                    self.vecs.append(tuple(vals))
                    push(OP_VEC, arg=len(self.vecs) - 1)
                else:
                    leaf_id = self._leaf(node, 1 if t == NUMBER else 4)
                    push(OP_LEAF if t == NUMBER else OP_LEAF4, arg=self.leaf_base[leaf_id])
                return t
            ops = operands(node)
            order = list(range(len(ops)))
            if reorder:
                order.sort(key=lambda i: -need(ops[i][0], True))
            for i in order:
                ops[i][1]()
            commutes = kind == "binary" and f["operator"] in ("add", "mul")
            for arg in [] if commutes else _swaps(order):
                push(OP_SWAP, arg=arg, pops=1)  # moves two values, pushes none
            if kind in ("binary", "mix"):
                push(OP_MIX if kind == "mix" else _BINARY_OPS[f["operator"]], pops=len(ops))
            else:
                push({"clamp": OP_CLAMP, "fresnel": OP_FRESNEL, "rgb": OP_RGB,
                      "vector": OP_VECTOR}[kind], pops=len(ops))
            return t

        if output_type == NUMBER:
            number(expr)
        else:
            t = emit(expr)
            if t != VECTOR:
                push(_PROMOTE[(t, VECTOR)], pops=1)
        assert depth[1] == need(expr, reorder) <= PROG_STACK_MAX, (depth[1], need(expr, reorder))
        self.code.extend(code)

    def leaf_values(self, wavelengths):
        """Every leaf at each lane's wavelengths [N, S], flat as the kernels
        read them: leaf i from leaf_base[i] N S floats on, a number's [N, S]
        or a 4-vector's [N, S, 4] (Burns' basis: its three weights, then 0)."""
        n, s = wavelengths.shape
        inputs = ProgramInputs(wavelength=wavelengths)
        parts = []
        for expr, width in self.leaves:
            if isinstance(expr, str):  # the basis
                basis = spectra_mod.rgb_basis().sample(wavelengths)
                val = torch.cat([basis, torch.zeros_like(basis[..., :1])], dim=-1)
            else:
                val = _tensor(_eval_expr(expr, inputs, self.resources, {}).data, inputs)
            parts.append(val.expand((n, s) if width == 1 else (n, s, 4)).reshape(-1))
        if not parts:
            return torch.zeros(1, device=wavelengths.device)
        return torch.cat(parts).contiguous()

    def tables(self, device):
        """The textures as tensors on ``device``, in texture-index order."""
        return [self.resources.texture(key, device) for key in self.textures]

    def run(self, g, k, lanes, n, s, leaves, textures, normal, incident, uv, split=True):
        """The plain interpreter of program g: the value [M, 4] at spectral
        column ``k`` for M points of lanes ``lanes`` [M] (their rows of the
        leaves of an N x S launch), with their normal, incident direction
        [M, 3] and uv [M, 2]; its lane code, then its column code above the
        slots the lane code left (the kProg instantiations' form), or with
        ``split`` False its one stream of code (the simple ones')."""
        ray = (lanes, n, s, leaves, textures, normal, incident, uv)
        if not split:
            stack = self._interpret(self.program_code(g), k, [], *ray)
        else:
            lane_code, column_code = self.parts[g]
            slots = self._interpret(lane_code, k, [], *ray)
            stack = self._interpret(column_code, k, slots, *ray)
        assert len(stack) == 1, "a program leaves one value"
        return stack[0]

    def _interpret(self, code, k, slots, lanes, n, s, leaves, textures, normal, incident, uv):
        """``code`` at column ``k`` on an empty stack (SLOT reads
        ``slots``): the values it leaves, bottom first."""
        m = lanes.shape[0]
        dev = lanes.device
        stack = []

        def leaf(base, width):
            at = base * n * s + (lanes * s + k) * width
            idx = at[:, None] + torch.arange(width, device=dev)[None, :]
            out = leaves[idx]
            return out if width == 4 else out.expand(m, 4)

        for op, value, arg in code:
            if op == OP_CONST:
                stack.append(torch.full((m, 4), value, device=dev))
            elif op == OP_VEC:
                stack.append(torch.tensor(self.vecs[arg], device=dev).expand(m, 4))
            elif op == OP_SLOT:
                stack.append(slots[arg])
            elif op == OP_SWAP:
                stack[-1], stack[-1 - arg] = stack[-1 - arg], stack[-1]
            elif op in (OP_LEAF, OP_LEAF4):
                stack.append(leaf(arg, 1 if op == OP_LEAF else 4))
            elif op == OP_TEX_COLOR:
                stack.append(sample_texture_bicubic(textures[arg], uv))
            elif op == OP_TEX_MONO:
                stack.append(sample_texture_bicubic(textures[arg], uv)[:, None].expand(m, 4))
            elif op in (OP_SPLAT_RGB, OP_SPLAT_VEC, OP_RGB_TO_VEC, OP_TO_NUMBER):
                a = stack.pop()
                x = a[:, :1].expand(m, 3)
                if op == OP_SPLAT_RGB:
                    a = torch.cat([x, torch.ones_like(a[:, :1])], dim=1)
                elif op == OP_SPLAT_VEC:
                    a = a[:, :1].expand(m, 4)
                elif op == OP_RGB_TO_VEC:
                    a = a * 2.0 - 1.0
                else:
                    basis = leaf(arg, 4)
                    a = (a[:, 0] * basis[:, 0] + a[:, 1] * basis[:, 1]
                         + a[:, 2] * basis[:, 2])[:, None].expand(m, 4)
                stack.append(a)
            elif op in (OP_RGB, OP_VECTOR):
                parts = [stack.pop()[:, 0] for _ in range(3 if op == OP_RGB else 4)][::-1]
                if op == OP_RGB:
                    parts.append(torch.ones(m, device=dev))
                stack.append(torch.stack(parts, dim=1))
            elif op in (OP_MIX, OP_CLAMP):
                c, b, a = stack.pop(), stack.pop(), stack.pop()
                if op == OP_MIX:
                    t = torch.clamp(c[:, :1], 0.0, 1.0)
                    stack.append(a * (1.0 - t) + b * t)
                else:
                    stack.append(torch.minimum(torch.maximum(a[:, :1], b[:, :1]),
                                               c[:, :1]).expand(m, 4))
            else:
                b, a = stack.pop(), stack.pop()
                if op == OP_FRESNEL:
                    stack.append(spectra_mod.fresnel(a[:, 0], b[:, 0], normal, incident)[:, None]
                                 .expand(m, 4))
                else:
                    stack.append({OP_ADD: a + b, OP_SUB: a - b, OP_MUL: a * b,
                                  OP_DIV: a / b}[op])
        return stack
