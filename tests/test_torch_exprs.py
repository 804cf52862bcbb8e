"""pyrite_tpu_torch.exprs against pyrite_tpu.exprs: every program of the
flagship scene and examples/prism.lua, hand-built IR covering the type
promotions and node kinds, and the program form the CUDA kernels run for
programs that read the ray (exprs.KernelPrograms, through its plain
interpreter). Both sides compute in float32 (rtol 1e-5)."""

import types

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


def run_postfix(expr, normal, incident, wavelength=None):
    """The kernels' program form (exprs.KernelPrograms) of probability
    program ``expr``, run by its plain interpreter over all lanes at the
    hero wavelength: (code, values [N])."""
    prog = TE.compile_program(expr, TE.Resources(), TE.NUMBER)
    scene = types.SimpleNamespace(prob_programs=[prog], color_programs=[], normal_programs=[],
                                  sky_program=TE.compile_program(0.0, TE.Resources()))
    kp = TE.KernelPrograms(scene, TE.Resources())
    n = normal.shape[0]
    wl = torch.full((n, 1), 550.0) if wavelength is None else wavelength[:, :1]
    out = kp.run(0, 0, torch.arange(n), n, 1, kp.leaf_values(wl), kp.tables("cpu"), normal,
                 incident, torch.zeros((n, 2)))
    return kp.program_code(0), kp, out[:, 0]


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
    """Probability programs of the simple form lower to code of its
    opcodes alone (csrc/bounce.cu eval_prob), which the plain interpreter
    runs to the JAX package's values."""
    ej, et = _ray_programs(JIR)[case], _ray_programs(TIR)[case]
    normal = torch.as_tensor(inputs["normal"])
    incident = torch.as_tensor(inputs["incident"])
    code, kp, got = run_postfix(et, normal, incident)
    assert code and kp.simple and all(op in TE.SIMPLE_OPS for op, _, _ in code)
    pj = JE.compile_program(ej, JE.Resources(), JE.NUMBER)
    want = np.asarray(pj(JE.ProgramInputs(
        wavelength=jnp.asarray(inputs["wavelength"][:, :1]),
        normal=jnp.asarray(inputs["normal"]), incident=jnp.asarray(inputs["incident"]),
    )))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, (N, 1))[:, 0], rtol=1e-5, atol=1e-6)


def test_flagship_probability_programs_lower(scenes):
    _, st = scenes["flagship"]
    assert len(st.prob_programs) == 2 and all(p.uses_ray_inputs for p in st.prob_programs)
    programs = st.dense_pack["programs"]
    assert all(programs.program_code(programs.index("prob", p)) for p in range(2))
    assert programs.simple and not st.dense_pack["prog"]


def test_lowering_refuses_wavelength_leaves(inputs):
    """Wavelength-dependent leaves under a node that reads the ray (a
    blackbody ior, an rgb factor read as a number by Burns) lower to the
    kProg form: a leaf evaluated per launch, Burns' TO_NUMBER at the lane's
    wavelength; its plain interpreter gives the JAX package's values (rtol
    1e-5). The old form refused both."""
    C = TIR.ComplexExpression
    CJ = JIR.ComplexExpression
    cases = [
        (C("fresnel", {"ior": C("binary", {"operator": "add", "lhs": 1.0, "rhs": C(
            "binary", {"operator": "mul", "lhs": C("blackbody", {"temperature": 3000.0}),
                       "rhs": 1e-14})}), "env_ior": 1.0}),
         CJ("fresnel", {"ior": CJ("binary", {"operator": "add", "lhs": 1.0, "rhs": CJ(
             "binary", {"operator": "mul", "lhs": CJ("blackbody", {"temperature": 3000.0}),
                        "rhs": 1e-14})}), "env_ior": 1.0}), TE.OP_LEAF),
        (C("binary", {"operator": "mul", "lhs": C("fresnel", {"ior": 1.5, "env_ior": 1.0}),
                      "rhs": C("rgb", {"red": 0.1, "green": 0.2, "blue": 0.3})}),
         CJ("binary", {"operator": "mul", "lhs": CJ("fresnel", {"ior": 1.5, "env_ior": 1.0}),
                       "rhs": CJ("rgb", {"red": 0.1, "green": 0.2, "blue": 0.3})}),
         TE.OP_TO_NUMBER),
    ]
    normal = torch.as_tensor(inputs["normal"])
    incident = torch.as_tensor(inputs["incident"])
    wl = torch.as_tensor(inputs["wavelength"])
    for et, ej, op in cases:
        code, kp, got = run_postfix(et, normal, incident, wl)
        assert op in [c[0] for c in code] and not kp.simple
        pj = JE.compile_program(ej, JE.Resources(), JE.NUMBER)
        want = np.asarray(pj(JE.ProgramInputs(
            wavelength=jnp.asarray(inputs["wavelength"][:, :1]),
            normal=jnp.asarray(inputs["normal"]), incident=jnp.asarray(inputs["incident"]))))
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, (N, 1))[:, 0], rtol=1e-5,
                                   atol=1e-6)
