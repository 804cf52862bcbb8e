"""pyrite_tpu_torch.exprs against pyrite_tpu.exprs: every program of the
flagship scene and examples/prism.lua, hand-built IR covering the type
promotions and node kinds, and the postfix lowering the CUDA kernels run for
ray-input probability programs. Both sides compute in float32 (rtol 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.exprs as JE
import pyrite_tpu.project.ir as JIR
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.scene import build_scene as jax_build
import pyrite_tpu_torch.exprs as TE
import pyrite_tpu_torch.spectra as TS
from pyrite_tpu_torch.project import ir as TIR
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

N, S = 512, 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    wl = rng.uniform(380.0, 780.0, (N, S)).astype(np.float32)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    incident = rng.normal(size=(N, 3)).astype(np.float32)
    incident /= np.linalg.norm(incident, axis=1, keepdims=True)
    return {"wavelength": wl, "normal": normal, "incident": incident}


def _evaluate(jax_prog, torch_prog, inputs, hero=False):
    wl = inputs["wavelength"][:, :1] if hero else inputs["wavelength"]
    j = np.asarray(jax_prog(JE.ProgramInputs(
        wavelength=jnp.asarray(wl), normal=jnp.asarray(inputs["normal"]),
        incident=jnp.asarray(inputs["incident"]), uv=jnp.zeros((N, 2)),
    )))
    t = torch_prog(TE.ProgramInputs(
        wavelength=torch.as_tensor(wl), normal=torch.as_tensor(inputs["normal"]),
        incident=torch.as_tensor(inputs["incident"]),
    )).numpy()
    shape = np.broadcast_shapes(j.shape, t.shape)
    return np.broadcast_to(j, shape), np.broadcast_to(t, shape)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    paths = chip_smoke.scene_paths(str(tmp_path_factory.mktemp("exprs")))
    return {
        name: (jax_build(jax_load(paths[name])), torch_build(torch_load(paths[name]), "cpu"))
        for name in ("flagship", "prism")
    }


@pytest.mark.parametrize("name", ["flagship", "prism"])
def test_scene_programs(scenes, inputs, name):
    sj, st = scenes[name]
    assert len(sj.color_programs) == len(st.color_programs)
    assert len(sj.prob_programs) == len(st.prob_programs)
    pairs = list(zip(sj.color_programs, st.color_programs)) + [(sj.sky_program, st.sky_program)]
    for pj, pt in pairs:
        j, t = _evaluate(pj, pt, inputs)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    for pj, pt in zip(sj.prob_programs, st.prob_programs):
        assert (pj.uses_wavelength, pj.uses_ray_inputs) == (pt.uses_wavelength, pt.uses_ray_inputs)
        j, t = _evaluate(pj, pt, inputs, hero=True)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def _ir_cases(ir):
    """Hand-built expressions, built with either package's IR module:
    (name, expression, output type)."""
    C = ir.ComplexExpression
    rgb = C("rgb", {"red": 0.2, "green": 0.6, "blue": 0.3})
    vec = C("vector", {"x": 0.5, "y": -1.0, "z": 2.0, "w": 1.0})
    d65 = C("spectrum", {"spectrum": ir.SpectrumIR(format="builtin", builtin="d65")})
    arr = C("spectrum", {"spectrum": ir.SpectrumIR(
        format="array", min=420.0, max=700.0, points=[0.1, 0.9, 0.4, 0.7, 0.2])})
    curve = C("spectrum", {"spectrum": ir.SpectrumIR(
        format="curve", points=[(400.0, 0.0), (500.0, 1.0), (650.0, 0.3), (760.0, 0.8)])})
    bb = C("blackbody", {"temperature": 4500.0})
    fres = C("fresnel", {"ior": 1.5, "env_ior": 1.0})

    def binary(op, lhs, rhs):
        return C("binary", {"operator": op, "lhs": lhs, "rhs": rhs})

    return [
        ("rgb_to_number", rgb, "number"),
        ("number_times_rgb", binary("mul", 0.5, rgb), "number"),
        ("rgb_plus_vector", binary("add", rgb, vec), "vector"),
        ("number_minus_vector", binary("sub", 2.0, vec), "vector"),
        ("rgb_as_vector", rgb, "vector"),
        ("number_as_vector", C("clamp", {"value": d65, "min": 10.0, "max": 90.0}), "vector"),
        ("mix_rgb_spectrum", C("mix", {"lhs": rgb, "rhs": curve, "amount": arr}), "number"),
        ("mix_vectors", C("mix", {"lhs": vec, "rhs": rgb, "amount": 0.3}), "vector"),
        ("clamp", C("clamp", {"value": binary("mul", d65, 0.02), "min": 0.1, "max": 0.9}), "number"),
        ("div", binary("div", binary("mul", bb, 1e-13), binary("add", arr, 0.5)), "number"),
        ("fresnel_times_curve", binary("mul", fres, curve), "number"),
        ("mix_by_fresnel", C("mix", {"lhs": rgb, "rhs": 0.9, "amount": fres}), "number"),
    ]


@pytest.mark.parametrize("case", range(len(_ir_cases(JIR))))
def test_hand_built_programs(inputs, case):
    name, ej, out_type = _ir_cases(JIR)[case]
    _, et, _ = _ir_cases(TIR)[case]
    pj = JE.compile_program(ej, JE.Resources(), out_type)
    pt = TE.compile_program(et, TE.Resources(), out_type)
    assert pj.uses_wavelength == pt.uses_wavelength, name
    assert pj.uses_ray_inputs == pt.uses_ray_inputs, name
    j, t = _evaluate(pj, pt, inputs)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=name)


def run_postfix(code, normal, incident):
    """The kernels' postfix interpreter (csrc/bounce.cu eval_prob),
    written in torch over all lanes at once."""
    n = normal.shape[0]
    stack = []
    for op, value in code:
        if op == TE.OP_CONST:
            stack.append(torch.full((n,), value))
            continue
        if op in (TE.OP_MIX, TE.OP_CLAMP):
            c, b, a = stack.pop(), stack.pop(), stack.pop()
            if op == TE.OP_MIX:
                t = torch.clamp(c, 0.0, 1.0)
                stack.append(a * (1.0 - t) + b * t)
            else:
                stack.append(torch.minimum(torch.maximum(a, b), c))
            continue
        b, a = stack.pop(), stack.pop()
        if op == TE.OP_FRESNEL:
            stack.append(TS.fresnel(a, b, normal, incident))
        else:
            stack.append({TE.OP_ADD: a + b, TE.OP_SUB: a - b, TE.OP_MUL: a * b, TE.OP_DIV: a / b}[op])
    assert len(stack) == 1
    return stack[0]


def _ray_programs(ir):
    C = ir.ComplexExpression

    def fres(ior, env=1.0):
        return C("fresnel", {"ior": ior, "env_ior": env})

    def binary(op, lhs, rhs):
        return C("binary", {"operator": op, "lhs": lhs, "rhs": rhs})

    clamped = C("clamp", {"value": fres(1.5), "min": 0.0, "max": 1.0})
    return [
        clamped,
        binary("sub", 1.0, clamped),
        C("mix", {"lhs": fres(1.2, 1.1), "rhs": fres(2.4), "amount": binary("div", 0.3, 0.5)}),
        binary("mul", fres(binary("add", 1.2, 0.3), 1.33), binary("sub", 2.0, fres(1.7))),
        C("mix", {"lhs": 0.25, "rhs": 0.75, "amount": binary("mul", fres(1.5), 3.0)}),
    ]


@pytest.mark.parametrize("case", range(len(_ray_programs(JIR))))
def test_postfix_lowering_matches_compile_program(inputs, case):
    ej, et = _ray_programs(JIR)[case], _ray_programs(TIR)[case]
    code = TE.lower_ray_program(et)
    normal = torch.as_tensor(inputs["normal"])
    incident = torch.as_tensor(inputs["incident"])
    got = run_postfix(code, normal, incident)
    pj = JE.compile_program(ej, JE.Resources(), JE.NUMBER)
    want = np.asarray(pj(JE.ProgramInputs(
        wavelength=jnp.asarray(inputs["wavelength"][:, :1]),
        normal=jnp.asarray(inputs["normal"]), incident=jnp.asarray(inputs["incident"]),
    )))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, (N, 1))[:, 0], rtol=1e-5, atol=1e-6)


def test_flagship_probability_programs_lower(scenes):
    _, st = scenes["flagship"]
    assert len(st.prob_programs) == 2 and all(p.uses_ray_inputs for p in st.prob_programs)
    assert all(st.dense_pack["code"])


def test_lowering_refuses_wavelength_leaves():
    C = TIR.ComplexExpression
    bb_ior = C("fresnel", {"ior": C("blackbody", {"temperature": 3000.0}), "env_ior": 1.0})
    with pytest.raises(NotImplementedError, match="blackbody"):
        TE.lower_ray_program(bb_ior)
    rgb_scaled = C("binary", {"operator": "mul", "lhs": C("fresnel", {"ior": 1.5, "env_ior": 1.0}),
                              "rhs": C("rgb", {"red": 0.1, "green": 0.2, "blue": 0.3})})
    with pytest.raises(NotImplementedError, match="rgb"):
        TE.lower_ray_program(rgb_scaled)
