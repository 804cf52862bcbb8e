"""pyrite_tpu_torch's image textures, normal maps and programs that read the
ray against the JAX package, on the CPU: bicubic sampling and the texture
loader; compiled programs (colour, normal and probability) and the plain
interpreter of the kernels' program form; the frame and uv functions;
surface_data, apply_normal_maps and the lamp sample's uv; bounce_core per
lane on the textures-class scene (chip_smoke.write_textures_scene); the
bidirectional renderer's lamp paths and their prefix products; and the
simple renderer's film, statistically. Each test states its tolerance."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.exprs as JE
import pyrite_tpu.geometry as JG
import pyrite_tpu.project.ir as JIR
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.project.textures import TextureLoader as JaxLoader, load_texture as jax_texture
from pyrite_tpu.renderers import bidirectional as jbd
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.exprs as TE
import pyrite_tpu_torch.geometry as TG
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import convert, kernels_dense as kd
from pyrite_tpu_torch.project import ir as TIR
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.project.textures import TextureLoader, load_texture
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

N, S = 512, 4


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def tex_dir(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("textures"))
    chip_smoke.write_texture_images(directory)
    return directory


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("texture_scenes"))
    return {
        "textures": chip_smoke.write_textures_scene(directory, 32, 24, S, 4, spp=4),
        "textures_bdpt": chip_smoke.write_textures_scene(directory, 24, 16, S, 4, spp=2,
                                                         renderer="bidirectional"),
        "film": chip_smoke.write_textures_scene(directory, 20, 20, S, 3, spp=64),
    }


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    incident = rng.normal(size=(N, 3)).astype(np.float32)
    return {
        "wavelength": rng.uniform(380.0, 780.0, (N, S)).astype(np.float32),
        "normal": normal / np.linalg.norm(normal, axis=1, keepdims=True),
        "incident": incident / np.linalg.norm(incident, axis=1, keepdims=True),
        "uv": rng.uniform(-3.0, 4.0, (N, 2)).astype(np.float32),
    }


# --- bicubic sampling and loading ---------------------------------------------------


@pytest.mark.parametrize("shape", [(23, 37, 4), (41, 29), (7, 11, 4), (13, 19)])
def test_bicubic_matches_jax(shape):
    """Colour and mono data of non-square, non-power-of-two sizes, uv in
    [-3, 4] (the wrap-around on both sides): within 1e-6."""
    rng = np.random.default_rng(shape[0])
    data = rng.random(shape, dtype=np.float32)
    uv = rng.uniform(-3.0, 4.0, (4000, 2)).astype(np.float32)
    want = np.asarray(JE.sample_texture_bicubic(jnp.asarray(data), jnp.asarray(uv)))
    got = TE.sample_texture_bicubic(torch.as_tensor(data), torch.as_tensor(uv)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("name,linear,mono", [
    ("checker.png", False, False), ("checker.png", True, False), ("bumps.png", True, False),
    ("mask.png", False, True), ("lamp.png", True, True),
])
def test_texture_loader_matches_jax(tex_dir, name, linear, mono):
    """The port's loader (its copy of project/textures.py) gives the JAX
    package's arrays, sRGB-decoded and linear: equal."""
    path = f"{tex_dir}/{name}"
    got, want = load_texture(path, linear, mono).data, jax_texture(path, linear, mono).data
    assert got.dtype == np.float32 and got.ndim == (2 if mono else 3)
    np.testing.assert_array_equal(got, want)


# --- programs -----------------------------------------------------------------------


def _program_cases(ir):
    """Programs that read the ray, built with either package's IR: (name,
    expression, output type); colour (number), normal (vector) and
    probability (number, run at the hero wavelength) programs."""
    C = ir.ComplexExpression
    tex = C("color_texture", {"path": "checker.png", "linear": False})
    lin = C("color_texture", {"path": "bumps.png", "linear": True})
    mono = C("mono_texture", {"path": "mask.png", "linear": False})
    rgb = C("rgb", {"red": 0.9, "green": 0.75, "blue": 0.3})
    vec = C("vector", {"x": 1.0, "y": -1.0, "z": 1.0, "w": 0.0})
    d65 = C("spectrum", {"spectrum": ir.SpectrumIR(format="builtin", builtin="d65")})
    curve = C("spectrum", {"spectrum": ir.SpectrumIR(
        format="curve", points=[(400.0, 0.1), (500.0, 0.4), (650.0, 0.2), (760.0, 0.3)])})
    bb = C("blackbody", {"temperature": 4500.0})

    def binary(op, lhs, rhs):
        return C("binary", {"operator": op, "lhs": lhs, "rhs": rhs})

    def fres(ior, env=1.0):
        return C("fresnel", {"ior": ior, "env_ior": env})

    return [
        ("colour_texture", tex, "number"),
        ("mono_texture", mono, "number"),
        ("spectrum_times_texture", binary("mul", binary("mul", d65, tex), 0.01), "number"),
        ("normal_map", binary("mul", lin, vec), "vector"),
        ("texture_as_vector", tex, "vector"),
        ("mix_by_mono", C("mix", {"lhs": rgb, "rhs": tex, "amount": mono}), "number"),
        ("fresnel_colour", binary("mul", rgb, fres(1.8)), "number"),
        ("fresnel_of_spectrum", fres(binary("add", 1.4, binary("mul", curve, 0.5))), "number"),
        ("blackbody_mix", C("mix", {"lhs": binary("mul", bb, 1e-13), "rhs": 0.2,
                                    "amount": fres(1.5)}), "number"),
        ("clamped_rgb", C("clamp", {"value": tex, "min": 0.1, "max": 0.6}), "number"),
        ("rgb_of_numbers", C("rgb", {"red": fres(1.5), "green": mono, "blue": 0.3}), "number"),
        ("vector_of_numbers", C("vector", {"x": mono, "y": fres(1.3), "z": 1.0, "w": 0.0}),
         "vector"),
        ("sky_form", C("mix", {"lhs": 0.03, "rhs": mono, "amount": fres(1.33)}), "number"),
    ]


def _evaluate(prog, pkg, inputs, hero):
    wl = inputs["wavelength"][:, :1] if hero else inputs["wavelength"]
    arrays = dict(inputs, wavelength=wl)
    if pkg is JE:
        out = prog(JE.ProgramInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    else:
        out = prog(TE.ProgramInputs(**{k: torch.as_tensor(v) for k, v in arrays.items()}))
    out = np.asarray(out)
    width = (1 if hero else S) if prog.output_type == "number" else (1, 4)
    if prog.output_type == "number":
        return np.broadcast_to(out, (N, width))
    return np.broadcast_to(out.reshape(N, -1, 4) if out.ndim > 1 else out, (N,) + width)[:, 0]


@pytest.mark.parametrize("case,hero", [
    (name, hero) for name, _, out in _program_cases(TIR) for hero in (False, True)
    if not (hero and out == "vector")
], ids=lambda v: {False: "colour", True: "probability"}.get(v, v) if isinstance(v, bool) else v)
def test_programs_match_jax(tex_dir, inputs, case, hero):
    """The compiled closures, per lane, against the JAX package's
    compile_program: at every wavelength (colour programs, normal maps) or
    the hero's (probability programs), rtol 1e-5 / atol 1e-6."""
    names = [c[0] for c in _program_cases(TIR)]
    _, ej, out = _program_cases(JIR)[names.index(case)]
    _, et, _ = _program_cases(TIR)[names.index(case)]
    pj = JE.compile_program(ej, JE.Resources(JaxLoader(tex_dir)), out)
    pt = TE.compile_program(et, TE.Resources(TextureLoader(tex_dir)), out)
    assert (pj.uses_wavelength, pj.uses_ray_inputs, pj.uses_texture) == (
        pt.uses_wavelength, pt.uses_ray_inputs, pt.uses_texture)
    np.testing.assert_allclose(_evaluate(pt, TE, inputs, hero), _evaluate(pj, JE, inputs, hero),
                               rtol=1e-5, atol=1e-6, err_msg=case)


def test_interpreter_matches_compiled_programs(tex_dir, inputs):
    """The plain interpreter of the kernels' program form
    (exprs.KernelPrograms.run) on every case lowered at once, as a scene's
    programs are (probability, colour, normal, sky; shared leaves, vector
    constants and textures), against the compiled closures at each spectral
    column: rtol 1e-5 / atol 1e-6 (Burns' dot is summed in the kernels'
    order)."""
    resources = TE.Resources(TextureLoader(tex_dir))
    cases = _program_cases(TIR)
    progs = {c[0]: TE.compile_program(c[1], resources, c[2]) for c in cases}
    numbers = [progs[c[0]] for c in cases if c[2] == "number"]
    vectors = [progs[c[0]] for c in cases if c[2] == "vector"]
    scene = types.SimpleNamespace(prob_programs=numbers, color_programs=numbers,
                                  normal_programs=vectors, sky_program=progs["sky_form"])
    kp = TE.KernelPrograms(scene, resources)
    assert not kp.simple and kp.leaves and kp.vecs and kp.textures
    wl = torch.as_tensor(inputs["wavelength"])
    leaves = kp.leaf_values(wl)
    textures = kp.tables("cpu")
    lanes = torch.arange(N)
    ray = {k: torch.as_tensor(inputs[k]) for k in ("normal", "incident", "uv")}
    full = TE.ProgramInputs(wavelength=wl, **ray)
    for group, members in (("prob", numbers), ("color", numbers), ("normal", vectors),
                           ("sky", [progs["sky_form"]])):
        for p, prog in enumerate(members):
            g = kp.index(group, p)
            want = prog(full)
            columns = 1 if group in ("prob", "normal") else S
            for k in range(columns):
                got = kp.run(g, k, lanes, N, S, leaves, textures, **ray)
                if group == "normal":
                    ref = want.reshape(N, -1, 4)[:, 0] if want.ndim > 1 else want.expand(N, 4)
                    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
                else:
                    ref = want.expand(N, S)[:, k]
                    np.testing.assert_allclose(got[:, 0].numpy(), ref.numpy(), rtol=1e-5,
                                               atol=1e-6, err_msg=f"{group} {p} column {k}")


def test_simple_form_keeps_the_simple_kernels(paths, tmp_path):
    """A scene whose only programs that read the ray are probability
    programs of constants, binary, mix, clamp and fresnel nodes (the
    flagship's fresnel mix) runs the simple instantiations; the textures
    scene the kProg ones."""
    flagship = chip_smoke.scene_paths(str(tmp_path))["flagship"]
    st = torch_build(torch_load(flagship), "cpu")
    assert not st.dense_pack["prog"] and st.dense_pack["programs"].simple
    assert kd.kernel_names(st) == ("dense_bounce_kernel", "dense_nee_kernel")
    tt = torch_build(torch_load(paths["textures"]), "cpu")
    assert tt.dense_pack["prog"] and tt.frames
    assert kd.kernel_names(tt) == ("dense_bounce_kernel<prog>", "dense_nee_kernel<prog>")


def test_program_past_the_stack_cap_lowers_in_sethi_ullman_order():
    """A program whose stack passes what the kernels' shared memory holds
    (exprs.PROG_STACK_MAX values) is lowered in Sethi-Ullman order, its
    deepest operand first and SWAPs where an op's operands come out of
    order, within the cap and bit-equal to the expression's order, never a
    silent truncation; one past the old form's 64 instructions lowers
    whole, and a probability program of the simple form keeps the simple
    instantiations at any length."""
    C = TIR.ComplexExpression
    sky = TE.compile_program(0.0, TE.Resources())

    def lowered(expr):
        prog = TE.compile_program(expr, TE.Resources(), TE.NUMBER)
        scene = types.SimpleNamespace(prob_programs=[prog], color_programs=[], normal_programs=[],
                                      sky_program=sky)
        return TE.KernelPrograms(scene, TE.Resources())

    long = C("fresnel", {"ior": 1.5, "env_ior": 1.0})
    for _ in range(40):
        long = C("binary", {"operator": "add", "lhs": long, "rhs": 0.01})
    kp = lowered(long)
    assert len(kp.program_code(0)) > 64 and kp.stack_depth == TE.PROG_STACK and kp.simple
    deep = C("fresnel", {"ior": 1.5, "env_ior": 1.0})
    for _ in range(TE.PROG_STACK_MAX):
        deep = C("binary", {"operator": "sub", "lhs": 0.01, "rhs": deep})
    kp = lowered(deep)
    code = kp.program_code(0)
    assert TE._depth(code) <= TE.PROG_STACK < TE.PROG_STACK_MAX and not kp.simple
    assert sum(op == TE.OP_SWAP for op, _, _ in code) == TE.PROG_STACK_MAX
    n = 16
    gen = torch.Generator().manual_seed(0)
    normal = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    incident = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    args = (torch.arange(n), n, 1, kp.leaf_values(torch.full((n, 1), 550.0)), [], normal,
            incident, torch.zeros(n, 2))
    got = kp.run(0, 0, *args, split=False)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(TE, "PROG_STACK_MAX", 10 ** 6)
        natural = lowered(deep)
    assert TE._depth(natural.program_code(0)) == TE.PROG_STACK_MAX + 2
    assert torch.equal(got, natural.run(0, 0, *args, split=False))


# --- the two-part program form (lane code once per lane, column code per column) -----


@pytest.fixture(scope="module")
def lowered(tex_dir, inputs):
    """Every case of _program_cases lowered at once, as a scene's programs
    are: {case: (global program numbers, compiled program)}, the
    KernelPrograms and the interpreter's arguments."""
    resources = TE.Resources(TextureLoader(tex_dir))
    cases = _program_cases(TIR)
    progs = {c[0]: TE.compile_program(c[1], resources, c[2]) for c in cases}
    numbers = [c[0] for c in cases if c[2] == "number"]
    vectors = [c[0] for c in cases if c[2] == "vector"]
    scene = types.SimpleNamespace(prob_programs=[progs[c] for c in numbers],
                                  color_programs=[progs[c] for c in numbers],
                                  normal_programs=[progs[c] for c in vectors],
                                  sky_program=progs["sky_form"])
    kp = TE.KernelPrograms(scene, resources)
    ids = {c: [kp.index("prob", numbers.index(c)), kp.index("color", numbers.index(c))]
           if c in numbers else [kp.index("normal", vectors.index(c))] for c in progs}
    ids["sky_form"].append(kp.index("sky", 0))
    wl = torch.as_tensor(inputs["wavelength"])
    ray = {k: torch.as_tensor(inputs[k]) for k in ("normal", "incident", "uv")}
    args = (torch.arange(N), N, S, kp.leaf_values(wl), kp.tables("cpu"))
    return {c: (ids[c], progs[c]) for c in progs}, kp, args, ray


CASES = [c[0] for c in _program_cases(TIR)]


@pytest.mark.parametrize("case", CASES)
def test_two_part_form_equals_one_stream(lowered, case):
    """The plain interpreter of the kProg form (lane code, then column code
    above its slots) gives the one stream's value (the form the kernels
    ran whole at every column before the split) bit for bit at every
    spectral column, for each program the case is lowered to."""
    found, kp, args, ray = lowered
    for g in found[case][0]:
        for k in range(S):
            np.testing.assert_array_equal(kp.run(g, k, *args, **ray).numpy(),
                                          kp.run(g, k, *args, **ray, split=False).numpy(),
                                          err_msg=f"{case} program {g} column {k}")


@pytest.mark.parametrize("case", CASES)
def test_two_part_form_matches_jax(tex_dir, inputs, lowered, case):
    """The kProg form's values against the JAX package's compile_program of
    the same expression: a number at every column (a colour or sky
    program), a vector at column 0 (a normal map); rtol 1e-5 / atol 1e-6."""
    found, kp, args, ray = lowered
    names = [c[0] for c in _program_cases(JIR)]
    _, ej, out = _program_cases(JIR)[names.index(case)]
    pj = JE.compile_program(ej, JE.Resources(JaxLoader(tex_dir)), out)
    g = found[case][0][-1]  # the colour, normal or sky program
    if out == "vector":
        np.testing.assert_allclose(kp.run(g, 0, *args, **ray).numpy(),
                                   _evaluate(pj, JE, inputs, False), rtol=1e-5, atol=1e-6)
        return
    want = _evaluate(pj, JE, inputs, False)
    for k in range(S):
        np.testing.assert_allclose(kp.run(g, k, *args, **ray)[:, 0].numpy(), want[:, k], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{case} column {k}")


@pytest.mark.parametrize("case", CASES)
def test_column_code_samples_no_texture(lowered, case):
    """No texture opcode is left in a column code: every texture node of a
    program is in its lane code, sampled once per lane, as often as in the
    one stream; the slots and the column code fit the kernels' stack."""
    found, kp, _, _ = lowered
    count = lambda code: sum(op in TE.TEXTURE_OPS for op, _, _ in code)
    for g in found[case][0]:
        lane_code, column_code = kp.parts[g]
        assert count(column_code) == 0, (case, column_code)
        assert count(lane_code) == count(kp.program_code(g))
        slots = sum(op == TE.OP_SLOT for op, _, _ in column_code)
        assert TE._depth(lane_code) <= TE.PROG_STACK
        assert TE._depth(column_code, slots) <= TE.PROG_STACK


@pytest.mark.parametrize("name", ["textures", "textures_bdpt"])
def test_scene_programs_split_and_textures_align(paths, name):
    """On the textures scenes: every program's two parts give its one
    stream's code back (each SLOT its subtree, the lane code in order); no
    column code samples a texture, so a floor lane (normal map, checker
    colour at S columns) takes 32 taps where the one stream took 112
    (chip_smoke._taps); the pack lays the kProg form out for the kernels and
    starts every texture on a 4-float (16-byte) boundary."""
    scene = torch_build(torch_load(paths[name]), "cpu")
    pack, kp = scene.dense_pack["tensors"], scene.dense_pack["programs"]
    assert scene.dense_pack["prog"]
    for g in range(len(kp.off) - 1):
        lane_code, column_code = kp.parts[g]
        assert not any(op in TE.TEXTURE_OPS for op, _, _ in column_code)
        if kp.program_code(g):
            assert _expand(column_code, _expand(lane_code, [])) == [kp.program_code(g)], g
    assert pack["code_op"].tolist() == [c[0] for c in kp.split]
    assert pack["code_off"].tolist() == kp.split_off
    assert len(kp.split_off) == 2 * (len(kp.off) - 1) + 1
    info = pack["tex_info"].tolist()
    assert all(off % 4 == 0 for off, _, _, _ in info), info
    for t, (off, h, w, c) in zip(kp.tables("cpu"), info):
        assert torch.equal(pack["tex"][off:off + h * w * c], t.reshape(-1))
    a = scene.arrays
    mat = int(a["pla_mat"][0])
    comp = int(a["mat_comp_offset"][mat])
    floor = lambda split: int(
        chip_smoke._taps(scene, "normal", a["mat_normal_prog"][mat:mat + 1].long(), 1, split)
        + chip_smoke._taps(scene, "prob", a["comp_prob"][comp:comp + 1].long(), 1, split)
        + chip_smoke._taps(scene, "color", a["comp_color"][comp:comp + 1].long(), S, split))
    assert S == 4 and (floor(True), floor(False)) == (32, 16 + 4 * 16)


def _expand(code, slots):
    """Postfix ``code`` run on code in place of values: the code of each
    value it leaves, SLOT i pushing ``slots[i]``."""
    stack = []
    for op, value, arg in code:
        if op == TE.OP_SLOT:
            stack.append(slots[arg])
            continue
        pops = TE._POPS.get(op, 0)
        operands = stack[len(stack) - pops:]
        del stack[len(stack) - pops:]
        stack.append([c for o in operands for c in o] + [(op, value, arg)])
    return stack


def test_flagship_code_unchanged():
    """The flagship's two fresnel-mix probability programs lower to the
    simple instantiations' one stream exactly as before the two-part form
    (the code below), and its pack holds that stream, not the kProg form."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        scene = torch_build(torch_load(chip_smoke.scene_paths(tmp)["flagship"]), "cpu")
    kp, pack = scene.dense_pack["programs"], scene.dense_pack["tensors"]
    fresnel_mix = [(0, 1.0, 0), (0, 1.5, 0), (0, 1.0, 0), (7, 0.0, 0), (0, 0.0, 0), (0, 1.0, 0),
                   (6, 0.0, 0)]
    assert kp.code == fresnel_mix + [(2, 0.0, 0)] + fresnel_mix[1:]
    assert kp.off == [0, 8, 14, 14, 14, 14, 14, 14]
    assert kp.simple and not scene.dense_pack["prog"]
    assert pack["code_op"].tolist() == [c[0] for c in kp.code]
    assert pack["code_val"].tolist() == [c[1] for c in kp.code]
    assert pack["code_off"].tolist() == kp.off


# --- geometry -----------------------------------------------------------------------


def test_frames_match_jax():
    """sphere_surface_frame, plane_uv, de_normal_quat and the quaternion
    helpers against the JAX package's, on random inputs: rtol 1e-5 / atol
    1e-6 (acos and atan2 of either library)."""
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 3
    center = rng.normal(size=(N, 3)).astype(np.float32)
    scale = rng.uniform(0.3, 5.0, (N, 2)).astype(np.float32)
    quat = rng.normal(size=(N, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    normal = pos / np.linalg.norm(pos, axis=1, keepdims=True)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)

    for got, want in zip(TG.sphere_surface_frame(T(pos), T(center), T(scale)),
                         JG.sphere_surface_frame(jnp.asarray(pos), jnp.asarray(center),
                                                 jnp.asarray(scale))):
        close(got, want)
    close(TG.plane_uv(T(pos), T(quat), T(scale)),
          JG.plane_uv(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(scale)))
    close(TG.de_normal_quat(T(normal)), JG.de_normal_quat(jnp.asarray(normal)))
    close(TG.quat_rotate(T(quat), T(pos)), JG.quat_rotate(jnp.asarray(quat), jnp.asarray(pos)))
    close(TG.quat_mul(T(quat), T(quat[::-1].copy())),
          JG.quat_mul(jnp.asarray(quat), jnp.asarray(quat[::-1].copy())))
    close(TG.quat_normalize(T(quat * 3)), JG.quat_normalize(jnp.asarray(quat * 3)))
    np.testing.assert_allclose(TG.mat3_cols_to_quat(T(pos), T(center), T(normal)).numpy(),
                               TG.mat3_cols_to_quat(pos, center, normal), rtol=1e-6, atol=1e-6)


# --- the scene, per lane ---------------------------------------------------------------


def _packages(path):
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    sj = jax_build(pj)
    st = torch_build(torch_load(path), "cpu")
    # the JAX scene's texture store, carried into the port (the same files)
    convert.textures_from_numpy(sj.resources.store, st, "cpu")
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    return sj, st, cfg_j, cfg_t, film, JaxCamera.from_ir(pj.project.camera)


def _camera_rays(film, cam, cfg_j, seed=3):
    _, o, d, wl = jax_simple.chunk_rays(film, cam, cfg_j, jax.random.PRNGKey(seed))
    return o, d, wl


def test_surface_data_and_normal_maps_match_jax(paths):
    """surface_data with frames (the frame quaternion, uv and normal of
    each hit), apply_normal_maps and sample_lamp's surf_uv against the JAX
    package's on the textures scene's camera rays, per lane where both
    find the same hit: rtol 1e-4 / atol 1e-5."""
    sj, st, cfg_j, cfg_t, film, cam = _packages(paths["textures"])
    o, d, wl = _camera_rays(film, cam, cfg_j)
    hit_j = JT.intersect_scene(sj, o, d, cfg_j)
    hit_t = TT.intersect_scene(st, T(o), T(d))
    same = (np.asarray(hit_j["kind"]) == hit_t["kind"].numpy()) & (
        np.asarray(hit_j["idx"]) == hit_t["idx"].numpy())
    assert same.mean() > 0.99
    kinds = set(hit_t["kind"][torch.as_tensor(same)].tolist())
    assert {TT.KIND_TRIANGLE, TT.KIND_SPHERE, TT.KIND_PLANE} <= kinds
    pos_j, n_j, q_j, uv_j, mat_j = JT.surface_data(sj, hit_j, o, d, cfg_j)
    pos_t, n_t, q_t, uv_t, mat_t = TT.surface_data(st, hit_t, T(o), T(d), frames=True)
    found = same & (np.asarray(hit_j["kind"]) != 0)

    def close(got, want, what):
        np.testing.assert_allclose(np.asarray(got)[found], np.asarray(want)[found], rtol=1e-4,
                                   atol=1e-5, err_msg=what)

    np.testing.assert_array_equal(mat_t.numpy()[found], np.asarray(mat_j)[found])
    for got, want, what in ((n_t, n_j, "normal"), (q_t, q_j, "quat"), (uv_t, uv_j, "uv")):
        close(got, want, what)
    mapped_j = JT.apply_normal_maps(sj, mat_j, n_j, q_j, JE.ProgramInputs(
        wavelength=wl, normal=n_j, incident=d, uv=uv_j))
    mapped_t = TT.apply_normal_maps(st, mat_t, n_t, q_t, TE.ProgramInputs(
        wavelength=T(wl), normal=n_t, incident=T(d), uv=uv_t))
    moved = np.abs(np.asarray(mapped_j) - np.asarray(n_j)).max(axis=1) > 1e-3
    assert (moved & found).sum() > 50, "few lanes hit a normal-mapped surface"
    close(mapped_t, mapped_j, "mapped normal")

    # the lamp sample's surface uv, toward the hit points
    rng = np.random.default_rng(5)
    u = rng.random((o.shape[0], 4), dtype=np.float32)
    lamp = np.zeros(o.shape[0], np.int32)
    samp_j = JT.sample_lamp(sj, jnp.asarray(lamp), pos_j, jnp.asarray(u))
    samp_t = TT.sample_lamp(st, T(lamp).long(), pos_t, T(u))
    for k in ("surf_uv", "surf_normal", "direction"):
        np.testing.assert_allclose(samp_t[k].numpy(), np.asarray(samp_j[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(np.abs(np.asarray(samp_j["surf_uv"])).max()) > 0.1


def _self_hits(state, prev, bound=10 * JT.DIST_EPSILON):
    """Lanes whose bounce reflected off the surface it had just left,
    within ``bound`` of the previous origin: which side of DIST_EPSILON
    that root falls is decided by one ulp of a dot product (the JAX
    package's jnp.sum against the port's fixed order;
    tests/test_torch_bdpt_jax.py's _self_hits)."""
    moved = np.linalg.norm(np.asarray(state["origin"]) - np.asarray(prev), axis=1)
    return np.asarray(state["alive"]) & (moved < bound)


def test_bounce_core_matches_jax(paths):
    """bounce_core per lane on the textures scene against the JAX
    package's, fed the same draws (convert.draws_from_numpy) and each bounce
    the JAX state, for 3 bounces: flags exact and vectors rtol 1e-4 / atol
    1e-5 on every lane but those that a tie of one ulp decides (a re-hit of
    the surface just left, _self_hits; at most 1 % of the lanes)."""
    sj, st, cfg_j, cfg_t, film, cam = _packages(paths["textures"])
    o, d, wl = _camera_rays(film, cam, cfg_j)
    n, s = wl.shape
    ref = {"origin": o, "direction": d, "brightness": jnp.zeros((n, s)),
           "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
           "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
           "light_events": jnp.zeros(n, jnp.int32)}
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(sj, cfg_j, k, n))
    checked = 0
    for b in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy({k: np.asarray(v) for k, v in draw(key).items()}, "cpu")
        got = TT.bounce_core(st, cfg_t, T(wl), {k: T(v) for k, v in ref.items()}, draws)
        prev = ref["origin"]
        ref = JT.bounce_core(sj, cfg_j, wl, ref, key)[0]
        tied = _self_hits(ref, prev) | _self_hits({k: v.numpy() for k, v in got.items()}, prev)
        assert tied.mean() <= 0.01
        keep = ~tied
        for k in ("alive", "aux_alive", "sample_light", "light_events"):
            np.testing.assert_array_equal(got[k].numpy()[keep], np.asarray(ref[k])[keep],
                                          err_msg=f"bounce {b} {k}")
        for k in ("origin", "direction", "reflectance", "brightness"):
            np.testing.assert_allclose(got[k].numpy()[keep], np.asarray(ref[k])[keep], rtol=1e-4,
                                       atol=1e-5, err_msg=f"bounce {b} {k}")
        checked += int(np.asarray(ref["alive"]).sum())
    assert checked > n // 2  # lanes that reflected, over the bounces


def test_lamp_paths_and_factors_match_jax(paths, monkeypatch):
    """The bidirectional renderer on the textured, fresnel-coloured scene:
    trace_lamp_path with the JAX walk's draws, each lamp bounce from the
    JAX state at its depth (as tests/test_torch_bdpt_jax.py does), uv and
    the vertex fields per lane (flags exact, vectors rtol 1e-4 / atol 1e-5;
    the normal and the BRDF factor 2|n.d| rtol 1e-3 / atol 1e-4, the
    kernels' tolerance: a normal map turns a last-ulp difference of the two
    libraries' acos and atan2 in a sphere's frame into ~1e-4 on a steep
    bump) on the valid slots; then
    _lamp_path_factors on the JAX path (the colours at each vertex's uv,
    normal and reversed incident direction): prefix products rtol 1e-4 /
    atol 1e-5."""
    sj, st, cfg_j, cfg_t, film, cam = _packages(paths["textures_bdpt"])
    _, _, wl = _camera_rays(film, cam, cfg_j)
    n = wl.shape[0]
    light = 4
    key = jax.random.PRNGKey(23)
    want = JT.trace_lamp_path(sj, JT.TraceConfig(light, 0, cfg_j.spectrum_samples), key, wl)
    record = {k: T(v) for k, v in want.items()}
    k_start, k_emis, k_trace = jax.random.split(key, 3)
    k_pick, k_u, _ = jax.random.split(k_start, 3)
    draws = {"start": {"lamp_idx": T(jax.random.randint(k_pick, (n,), 0, sj.num_lamps)),
                       "u_lamp": T(jax.random.uniform(k_u, (n, 4))),
                       "u_emis": T(jax.random.uniform(k_emis, (n,)))},
             "bounces": []}
    for bkey in jax.random.split(k_trace, light):
        _, k_comp, k_scatter = jax.random.split(bkey, 3)
        draws["bounces"].append({"u_comp": T(jax.random.uniform(k_comp, (n,))),
                                 "u_scatter": T(jax.random.uniform(k_scatter, (n, 3)))})
    depth = {"i": 0}
    real = kd.lamp_bounce

    def from_jax_state(scene, cfg, wavelengths, state, draws, bank_vals=None):
        i = depth["i"]
        depth["i"] += 1
        jax_state = {"origin": record["position"][:, i], "direction": record["incident_out"][:, i + 1],
                     "alive": record["valid"][:, i]}
        return real(scene, cfg, wavelengths, jax_state, draws, bank_vals)

    monkeypatch.setattr(kd, "lamp_bounce", from_jax_state)
    got = TT.trace_lamp_path(st, TT.TraceConfig(light, 0, cfg_t.spectrum_samples), draws, T(wl))
    valid = np.asarray(want["valid"])
    assert valid[:, 1].sum() >= 10
    pos = np.asarray(want["position"])
    tied = (valid[:, 1:] & (np.linalg.norm(pos[:, 1:] - pos[:, :-1], axis=-1)
                            < 10 * JT.DIST_EPSILON)).any(axis=1)
    assert tied.mean() < 0.02
    np.testing.assert_array_equal(got["valid"].numpy()[~tied], valid[~tied])
    both = valid & ~tied[:, None]
    for k in ("is_diffuse", "dispersed", "color_prog"):
        np.testing.assert_array_equal(got[k].numpy()[both], np.asarray(want[k])[both], err_msg=k)
    for k in ("uv", "position", "normal", "probability", "brdf"):
        tol = dict(rtol=1e-3, atol=1e-4) if k in ("normal", "brdf") else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy()[both], np.asarray(want[k])[both], err_msg=k,
                                   **tol)
    assert float(np.abs(np.asarray(want["uv"])[both]).max()) > 0.1

    bank = kd.precompute_bank_values(st, T(wl))
    pp_j, aux_j, spec_j, inc_j = jbd._lamp_path_factors(sj, want, wl, cfg_j)
    pp_t, aux_t, spec_t, inc_t = bd._lamp_path_factors(st, record, T(wl), bank)
    np.testing.assert_array_equal(aux_t.numpy(), np.asarray(aux_j))
    np.testing.assert_array_equal(spec_t.numpy(), np.asarray(spec_j))
    np.testing.assert_allclose(pp_t.numpy(), np.asarray(pp_j), rtol=1e-4, atol=1e-5)
    assert any(p.uses_ray_inputs for p in st.color_programs)


def test_film_matches_jax_statistically(paths, monkeypatch):
    """A 20 x 20 render of the textures scene, BATCHES independent films
    of BATCH_SPP samples from each package (the port through path
    regeneration, its default; the JAX package through its one-shot
    wavefront): the means over the pixels JAX lights (> 0.005 in the mean
    of its 4-spp films: over a third of this dim scene's) agree within 4 combined
    standard errors (as tests/test_torch_bdpt_jax.py holds the BDPT film),
    and so does each of at least 97 % of those pixels."""
    batches, batch_spp = 12, 4
    path = paths["film"]
    pj = jax_load(path)
    sj = jax_build(pj)
    r, im = pj.project.renderer, pj.project.image
    film_j = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    step = jax_simple.make_render_step(sj, film_j, JaxCamera.from_ir(pj.project.camera),
                                       JT.TraceConfig(r.bounces, r.light_samples,
                                                      r.spectrum_samples))
    data = sj.device_data()
    jax_images = []
    for b in range(batches):
        acc, wt = film_j.new_buffers()
        for key in jax.random.split(jax.random.PRNGKey(200 + b), batch_spp):
            acc, wt = step(acc, wt, key, data)
        jax_images.append(np.asarray(film_j.develop(acc, wt)).mean(axis=2))
    pt = torch_load(path)
    st = torch_build(pt, "cpu")
    port_images = []
    for b in range(batches):
        film, acc, wt = simple.render(pt, st, seed=200 + b, max_samples=batch_spp)
        port_images.append(film.develop(acc, wt).mean(dim=2).numpy())
    lit = np.mean(jax_images, axis=0) > 0.005
    assert lit.sum() > 100
    mj = np.asarray([img[lit].mean() for img in jax_images])
    mp = np.asarray([img[lit].mean() for img in port_images])
    se = np.sqrt(mj.var(ddof=1) / batches + mp.var(ddof=1) / batches)
    assert abs(mp.mean() - mj.mean()) < 4 * se, (mp.mean(), mj.mean(), se)
    pj_, pp_ = np.asarray(jax_images), np.asarray(port_images)
    se_px = np.sqrt(pj_.var(axis=0, ddof=1) / batches + pp_.var(axis=0, ddof=1) / batches)
    z = np.abs(pp_.mean(axis=0) - pj_.mean(axis=0)) / np.maximum(se_px, 1e-9)
    assert (z[lit] < 4).mean() >= 0.97, (z[lit] < 4).mean()


@pytest.mark.parametrize("scheduler", ["one-shot", "regen", "bidirectional"])
def test_textures_count_in_the_wavefront_budget(scheduler):
    """A scene's textures take from the device memory a wavefront may hold:
    with texture bytes that leave room for two samples' lanes (one-shot),
    two planes (regen) or half the film's rows (a BDPT chunk), the batch
    drops to that, and past the budget to one (exact integers)."""
    from pyrite_tpu_torch.film import Film

    film = Film(256, 192, 64, (380.0, 780.0))
    lanes = film.width * film.height * simple.LANE_BYTES
    cases = {
        # (pick, budget, bytes of the room left, full batch, batch in that room)
        "one-shot": (lambda tb: simple.pick_sample_batch(film, tb), simple.WAVEFRONT_BYTES,
                     2 * lanes, 4, 2),
        "regen": (lambda tb: simple._regen_planes(film, tb), simple.WAVEFRONT_BYTES, 2 * lanes,
                  simple.REGEN_MAX_PLANES, 2),
        # a row of a 4 + 4 bounce chunk at S = 6 takes 256 x 5 x (160 + 20 x 6) bytes
        "bidirectional": (lambda tb: bd.pick_rows_per_chunk(film, 4, 6, tb), bd._STEP_BYTES,
                          96 * 256 * 5 * (160 + 20 * 6), 192, 96),
    }
    pick, budget, room, full, fits = cases[scheduler]
    assert pick(0) == full
    assert pick(budget - room) == fits
    assert pick(budget + 1) == 1
