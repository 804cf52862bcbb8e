"""Expression compiler: scene IR expression DAGs -> torch functions (PyTorch
port of pyrite_tpu.exprs).

Each expression becomes a function evaluated for a whole wavefront of rays
and all spectral samples at once. Type promotion (number / vector / rgb)
follows the JAX package, which follows compiler.rs:682-968, including the
Burns RGB->spectrum sampling when an RGB value is consumed as a number and
the x*2-1 RGB->vector decode. Image textures are not ported yet.

For the CUDA bounce kernels, probability programs that read the ray (the
``fresnel`` node reads the normal and the incident direction) are also
lowered into a small postfix code that the kernels interpret per lane
(``lower_ray_program``); programs of the wavelength alone are evaluated here
once per launch and read by the kernels as values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import spectra as spectra_mod
from .project import ir

NUMBER = "number"
VECTOR = "vector"
RGB = "rgb"

TEXTURES_NOT_PORTED = (
    "image textures are not ported to pyrite_tpu_torch yet "
    "(ROADMAP.md queue 1: widening the dense pack gate)"
)


@dataclass
class ProgramInputs:
    """Runtime inputs for a compiled program.

    ``wavelength``: [N, S] (ray mode, hero at column 0) or [T] (plain mode).
    ``normal`` / ``incident``: [N, 3]; None in plain mode. (Texture
    coordinates join when textures are ported.)
    """

    wavelength: torch.Tensor
    normal: Optional[torch.Tensor] = None
    incident: Optional[torch.Tensor] = None

    @property
    def ray_mode(self) -> bool:
        return self.normal is not None or self.wavelength.ndim == 2


@dataclass
class CompiledProgram:
    fn: Callable[[ProgramInputs], object]
    output_type: str  # NUMBER or VECTOR
    uses_wavelength: bool
    constant: Optional[float] = None  # set when the program is a plain constant
    # False when the DAG reads only the wavelength (no normal/incident)
    uses_ray_inputs: bool = False
    expr: object = None  # the IR the program was compiled from

    def __call__(self, inputs: ProgramInputs) -> torch.Tensor:
        out = self.fn(inputs)
        if isinstance(out, torch.Tensor):
            return out
        return torch.as_tensor(out, dtype=torch.float32, device=inputs.wavelength.device)


class Resources:
    """Shared spectrum lookups for program compilation. Texture lookups
    raise: texture programs are not ported yet."""

    def __init__(self):
        self._spectrum_cache: dict[int, object] = {}

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
        raise NotImplementedError(TEXTURES_NOT_PORTED)

    def mono_texture(self, path: str, linear: bool):
        raise NotImplementedError(TEXTURES_NOT_PORTED)


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

    if expr_uses_texture(expr):
        raise NotImplementedError(TEXTURES_NOT_PORTED)
    uses_wl = _expr_uses_wavelength(expr, output_type)
    uses_ray = expr_uses_ray_inputs(expr)

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
        uses_ray_inputs=uses_ray, expr=expr,
    )


def _walk(expr):
    """Every ComplexExpression node of a DAG, each once."""
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
    if kind in ("color_texture", "mono_texture"):
        raise NotImplementedError(TEXTURES_NOT_PORTED)
    raise ir.ProjectError(f"unknown expression kind {kind!r}")


# --- postfix lowering of ray-input probability programs -----------------------
#
# The CUDA kernels cannot call a Python closure, so a probability program
# that reads the ray is lowered to postfix code over a small stack of
# floats: CONST pushes a constant; the binary ops, MIX (lhs, rhs, amount;
# amount clamped to [0, 1]), CLAMP (value, min, max) and FRESNEL (ior,
# env_ior) pop their operands in push order and push one result. FRESNEL
# reads the lane's normal and incident direction as implicit operands (no
# other node reads them). Wavelength-dependent leaves (spectrum, blackbody,
# rgb->number) and vectors are not covered: such a program refuses the pack.
# The opcodes and limits are mirrored in csrc/bounce.cu.

OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MIX, OP_CLAMP, OP_FRESNEL = range(8)
PROG_STACK = 8  # kernel stack depth
PROG_MAX_LEN = 64  # instructions per program

_BINARY_OPS = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV}
RAY_PROGRAMS_NOT_PORTED = "(ROADMAP.md queue 1: widening the dense pack gate)"


def lower_ray_program(expr: ir.Expression) -> list[tuple[int, float]]:
    """Postfix code [(opcode, constant)] of a ray-input probability program.
    Raises NotImplementedError for a node outside the covered form, or code
    longer or deeper than the kernel takes."""
    code: list[tuple[int, float]] = []
    depth = [0, 0]  # current, max

    def push(op, value=0.0, pops=0):
        depth[0] += 1 - pops
        depth[1] = max(depth[1], depth[0])
        code.append((op, float(value)))

    def emit(node):
        if isinstance(node, float):
            push(OP_CONST, node)
            return
        f = node.fields
        if node.kind == "binary":
            emit(f["lhs"])
            emit(f["rhs"])
            push(_BINARY_OPS[f["operator"]], pops=2)
        elif node.kind == "mix":
            emit(f["lhs"])
            emit(f["rhs"])
            emit(f["amount"])
            push(OP_MIX, pops=3)
        elif node.kind == "clamp":
            emit(f["value"])
            emit(f["min"])
            emit(f["max"])
            push(OP_CLAMP, pops=3)
        elif node.kind == "fresnel":
            emit(f["ior"])
            emit(f["env_ior"])
            push(OP_FRESNEL, pops=2)
        else:
            raise NotImplementedError(
                f"a ray-input probability program holds a {node.kind!r} node, which "
                f"the CUDA kernels' program form does not cover {RAY_PROGRAMS_NOT_PORTED}"
            )

    emit(expr)
    if len(code) > PROG_MAX_LEN or depth[1] > PROG_STACK:
        raise NotImplementedError(
            f"a ray-input probability program needs {len(code)} instructions and "
            f"stack depth {depth[1]}; the kernels take {PROG_MAX_LEN} and "
            f"{PROG_STACK} {RAY_PROGRAMS_NOT_PORTED}"
        )
    return code
