"""The scenes the port's gate refused last, held to the JAX package on the CPU.

- Planes alone (chip_smoke.write_planes_scene: a ground plane and a tilted
  plane, a point lamp, a directional lamp and a D65 sky; no finite
  primitive and no DE shape, which the JAX package sweeps in XLA):
  tracer.bounce_core per lane against the JAX package's with the JAX draws
  shared, and the CLI to PNG through regeneration, one-shot and the
  bidirectional renderer.
- Programs of any depth (exprs.KernelPrograms): right-nested add chains
  and nested mixes whose stack in the expression's order needs 48
  (exprs.PROG_STACK_MAX), 49, 73 and 200 values; past the cap the lowering
  takes Sethi-Ullman order, whose values equal the expression's order bit
  for bit; the values per lane against the JAX package's evaluation of the
  same expression; bounce_core per lane on textures-class scenes whose
  fresnel sphere's colour is that deep; the CLI to PNG past the cap; and
  every program of chip_smoke's scenes lowered to the code it had before
  the Sethi-Ullman form (its digest).
- 2,411 DE shapes (one past the 2,410 that a block's shared memory held
  when the march kernel staged them): the small Julia repeated 2,411 times
  in one place renders the film of the shape once, bit for bit (the keyed
  draws do not depend on the shape count, and the closest hit is always
  the first copy).
- The wavefront's sizing: renderers.simple.lane_bytes, bidirectional's and
  the photon renderer's lane bytes grow by the march passes' t rows, and
  the photon walk traces a pass's photons in chunks where their rows pass
  its budget, the same photons bit for bit.

Tolerances: bounce_core per lane as tests/test_torch_gate_lamps.py's on the
planes (flags exact, vectors rtol 1e-3 / atol 1e-4, brightness with < 1.5 %
divergent lanes, energy within 0.5 %) and as tests/test_torch_textures.py's
on the textures scenes (flags exact, vectors rtol 1e-4 / atol 1e-5 but for
lanes that a one-ulp tie decides); program values against JAX rtol 1e-5 /
atol 1e-6 (the textures' bicubic taps, Burns' dot and the wavelength leaves
summed in another order); Sethi-Ullman against the expression's order, the
code's digests and the 2,411-shape film exact."""

import contextlib
import copy
import hashlib
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.exprs as JE
import pyrite_tpu.project.ir as JIR
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.project.textures import TextureLoader as JaxLoader
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.exprs as TE
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli, convert, kernels_dense as kd
from pyrite_tpu_torch.project import ir as TIR
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.project.textures import TextureLoader
from pyrite_tpu_torch.renderers import bidirectional as bd, photon as ph, simple
from pyrite_tpu_torch.rng import KeyedDraws
from pyrite_tpu_torch.scene import LAMP_DIRECTIONAL, LAMP_POINT, build_scene as torch_build

torch.set_num_threads(2)

N, S = 256, 4
# the stack each deep program needs in the expression's order: one past
# exprs.PROG_STACK_MAX (48, the deepest lowered in that order), and further
DEPTHS = (49, 73, 200)
# the DE shapes past the 2,410 that a block's shared memory held staged
MANY_SHAPES = 2411


def T(x):
    return torch.as_tensor(np.array(x))


@contextlib.contextmanager
def _deep_recursion():
    """Both packages parse and evaluate an expression recursively, a few
    Python frames a level: 200 levels of nesting need more than the
    default limit."""
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20000))
    try:
        yield
    finally:
        sys.setrecursionlimit(limit)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("gate_last"))
    out = {
        "planes": chip_smoke.write_planes_scene(directory, 16, 12, S, 3, spp=2),
        "planes_bdpt": chip_smoke.write_planes_scene(directory, 24, 16, S, 3, spp=1,
                                                     renderer="bidirectional"),
    }
    for depth in DEPTHS:
        # deep_expression's core needs 3 values, each level of nesting one more
        out[f"textures_{depth}"] = chip_smoke.write_textures_scene(
            os.path.join(directory, f"deep_{depth}"), 16, 12, S, 3, spp=1, deep=depth - 3)
    out["textures_80_bdpt"] = chip_smoke.write_textures_scene(
        os.path.join(directory, "deep_80_bdpt"), 16, 12, S, 3, spp=1, deep=77,
        renderer="bidirectional", light_bounces=2)
    chip_smoke.write_texture_images(directory)
    out["images"] = directory
    return out


# --- planes alone -------------------------------------------------------------------


def test_planes_bounce_core_matches_jax(paths):
    """tracer.bounce_core per lane on the planes-only scene against the JAX
    package's, fed the same state and the JAX draws, for two bounces from
    the camera (each from the JAX state): the plane sweep, the sky and the
    directional lamp on a miss, NEE toward the point and directional
    lamps. The port packs the scene (no primitive rows, no DE table); the
    JAX package keeps it out of its dense pack."""
    pj = jax_load(paths["planes"])
    sj, st = jax_build(pj), torch_build(torch_load(paths["planes"]), "cpu")
    assert sj.num_primitives == 0 and sj.dense_pack is None and not sj.de_shapes
    meta = st.dense_pack["meta"]
    assert (meta["n_prims"], meta["n_planes"], meta["n_de"]) == (0, 2, 0)
    assert {LAMP_POINT, LAMP_DIRECTIONAL} <= set(st.lamp_types)
    r, im = pj.project.renderer, pj.project.image
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, oj, dj, wj = jax_simple.chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg_j,
                                          jax.random.PRNGKey(11))
    n, s = wj.shape
    ref = {"origin": oj, "direction": dj, "brightness": jnp.zeros((n, s)),
           "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
           "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
           "light_events": jnp.zeros(n, jnp.int32)}
    lit = misses = 0.0
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy(
            {k: np.asarray(v) for k, v in JT.draw_bounce_uniforms(sj, cfg_j, key, n).items()},
            "cpu")
        got = TT.bounce_core(st, cfg_t, T(wj), {k: T(v) for k, v in ref.items()}, draws)
        new = {k: np.asarray(v) for k, v in JT.bounce_core(sj, cfg_j, wj, ref, key)[0].items()}
        got = {k: v.numpy() for k, v in got.items()}
        for k in ("alive", "aux_alive", "sample_light", "light_events"):
            np.testing.assert_array_equal(got[k], new[k], err_msg=f"bounce {b} {k}")
        for k in ("origin", "direction", "reflectance"):
            np.testing.assert_allclose(got[k], new[k], rtol=1e-3, atol=1e-4,
                                       err_msg=f"bounce {b} {k}")
        rb, kb = new["brightness"], got["brightness"]
        lane_bad = (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1)
        assert lane_bad.mean() < 0.015, f"bounce {b}: {lane_bad.sum()} divergent lanes"
        assert abs(rb.sum() - kb.sum()) < 0.005 * max(rb.sum(), 1e-6) + 1e-3
        lit += float(rb.sum() - np.asarray(ref["brightness"]).sum())
        misses += float((np.asarray(ref["alive"]) & ~new["alive"]).sum())
        ref = {k: jnp.asarray(v) for k, v in new.items()}
    assert lit > 0 and misses > 0  # lamps seen, and rays that leave for the sky


@pytest.mark.parametrize("which", ["regen", "one-shot", "bidirectional"])
def test_planes_cli_renders(paths, tmp_path, which):
    """The planes-only scene from .lua to PNG on the CPU through
    regeneration, one-shot and the bidirectional renderer, every bounce
    through bounce_core, with a pixel that is not black."""
    out = str(tmp_path / f"planes_{which}.png")
    before = TT.launches["bounce_core"]
    if which == "bidirectional":
        assert cli.main([paths["planes_bdpt"], "--device", "cpu", "--output", out]) == 0
    else:
        with chip_smoke.scheduler(which):
            assert cli.main([paths["planes"], "--device", "cpu", "--samples", "2",
                             "--output", out]) == 0
    assert TT.launches["bounce_core"] > before
    with Image.open(out) as img:
        assert np.asarray(img).max() > 0


# --- programs of any depth ------------------------------------------------------------


def _deep_program(ir, kind, depth):
    """A number program that reads the ray and whose stack in the
    expression's order needs ``depth`` values: a right-nested chain of adds
    ("add"), each left operand a constant or a wavelength leaf, or of mixes
    ("mix") of a constant or leaf and the rest, by a fresnel, around a
    mono texture times a fresnel (3 values)."""
    C = ir.ComplexExpression
    d65 = C("binary", {"operator": "mul", "lhs": C("spectrum", {
        "spectrum": ir.SpectrumIR(format="builtin", builtin="d65")}), "rhs": 0.002})
    expr = C("binary", {"operator": "mul",
                        "lhs": C("mono_texture", {"path": "mask.png", "linear": False}),
                        "rhs": C("fresnel", {"ior": 1.5, "env_ior": 1.0})})
    for i in range(depth - 3):
        lhs = d65 if i % 3 == 0 else 0.01 * (1 + i % 7)
        if kind == "add":
            expr = C("binary", {"operator": "add", "lhs": lhs, "rhs": expr})
        else:
            expr = C("mix", {"lhs": lhs, "rhs": expr,
                             "amount": C("fresnel", {"ior": 1.2 + 0.01 * (i % 5), "env_ior": 1.0})})
    return expr


@pytest.mark.parametrize("depth", (48,) + DEPTHS)
@pytest.mark.parametrize("kind", ["add", "mix"])
def test_deep_programs_match_jax(paths, kind, depth, monkeypatch):
    """A program of each depth lowers without refusal: in the expression's
    order within exprs.PROG_STACK_MAX (its stack the depth itself), in
    Sethi-Ullman order past it (a stack of a few values; SWAPs that restore
    the operand order of each mix, none for the adds, whose IEEE sums do not
    depend on it). Its two-part form (lane code, then column
    code) and one stream give the same values bit for bit, past the cap
    also the code lowered in the expression's order; the values per lane
    and spectral column match the JAX package's compile_program of the same
    expression (rtol 1e-5 / atol 1e-6)."""
    rng = np.random.default_rng(depth)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    incident = rng.normal(size=(N, 3)).astype(np.float32)
    inputs = {"wavelength": rng.uniform(380.0, 780.0, (N, S)).astype(np.float32),
              "normal": normal / np.linalg.norm(normal, axis=1, keepdims=True),
              "incident": incident / np.linalg.norm(incident, axis=1, keepdims=True),
              "uv": rng.uniform(-3.0, 4.0, (N, 2)).astype(np.float32)}
    images = paths["images"]
    with _deep_recursion():
        resources = TE.Resources(TextureLoader(images))
        prog = TE.compile_program(_deep_program(TIR, kind, depth), resources, TE.NUMBER)
        sky = TE.compile_program(0.0, TE.Resources())
        scene = types.SimpleNamespace(prob_programs=[], color_programs=[prog], normal_programs=[],
                                      sky_program=sky)
        kp = TE.KernelPrograms(scene, resources)
        with monkeypatch.context() as m:
            m.setattr(TE, "PROG_STACK_MAX", 10 ** 6)
            natural = TE.KernelPrograms(scene, resources)
        pj = JE.compile_program(_deep_program(JIR, kind, depth), JE.Resources(JaxLoader(images)),
                                "number")
        want = np.broadcast_to(np.asarray(pj(JE.ProgramInputs(
            **{k: jnp.asarray(v) for k, v in inputs.items()}))), (N, S))
    g = kp.index("color", 0)
    code = kp.program_code(g)
    assert TE._depth(natural.program_code(g)) == depth
    swaps = sum(op == TE.OP_SWAP for op, _, _ in code)
    if depth <= TE.PROG_STACK_MAX:
        assert code == natural.program_code(g) and swaps == 0
        assert TE.PROG_STACK < kp.stack_depth <= depth  # the two-part form's stack may be less
    else:
        assert kp.stack_depth <= TE.PROG_STACK and (swaps > 0) == (kind == "mix")
    wl = torch.as_tensor(inputs["wavelength"])
    ray = {k: torch.as_tensor(inputs[k]) for k in ("normal", "incident", "uv")}
    args = (torch.arange(N), N, S, kp.leaf_values(wl), kp.tables("cpu"))
    nat_args = (torch.arange(N), N, S, natural.leaf_values(wl), natural.tables("cpu"))
    for k in range(S):
        got = kp.run(g, k, *args, **ray)
        assert torch.equal(got, kp.run(g, k, *args, **ray, split=False))
        assert torch.equal(got, natural.run(g, k, *nat_args, **ray, split=False))
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{kind} {depth} column {k}")


def _self_hits(state, prev, bound=10 * JT.DIST_EPSILON):
    """Lanes that re-hit the surface they had just left, within ``bound``
    of the previous origin: which side of DIST_EPSILON that root falls is
    decided by one ulp (tests/test_torch_textures.py's _self_hits)."""
    moved = np.linalg.norm(np.asarray(state["origin"]) - np.asarray(prev), axis=1)
    return np.asarray(state["alive"]) & (moved < bound)


@pytest.mark.parametrize("depth", DEPTHS)
def test_deep_textures_bounce_core_matches_jax(paths, depth):
    """bounce_core per lane on the textures scene whose fresnel sphere's
    colour program needs ``depth`` values in the expression's order, against
    the JAX package's, fed the same draws and each bounce the JAX state, for
    3 bounces; the scene runs the kProg instantiations at the stack its
    lowering needs (the depth within exprs.PROG_STACK_MAX, Sethi-Ullman's
    past it)."""
    with _deep_recursion():
        pj = jax_load(paths[f"textures_{depth}"])
        sj = jax_build(pj)
        st = torch_build(torch_load(paths[f"textures_{depth}"]), "cpu")
    pack = st.dense_pack
    assert pack["prog"] and pack["stack"] <= (depth if depth <= TE.PROG_STACK_MAX else TE.PROG_STACK)
    assert max(pack["smem"].values()) <= kd.SMEM_PER_BLOCK
    convert.textures_from_numpy(sj.resources.store, st, "cpu")
    r, im = pj.project.renderer, pj.project.image
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, o, d, wl = jax_simple.chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg_j,
                                        jax.random.PRNGKey(3))
    n, s = wl.shape
    ref = {"origin": o, "direction": d, "brightness": jnp.zeros((n, s)),
           "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
           "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
           "light_events": jnp.zeros(n, jnp.int32)}
    checked = 0
    with _deep_recursion():
        for b in range(3):
            key = jax.random.fold_in(jax.random.PRNGKey(5), b)
            draws = convert.draws_from_numpy(
                {k: np.asarray(v) for k, v in JT.draw_bounce_uniforms(sj, cfg_j, key, n).items()},
                "cpu")
            got = TT.bounce_core(st, cfg_t, T(wl), {k: T(v) for k, v in ref.items()}, draws)
            prev = ref["origin"]
            ref = JT.bounce_core(sj, cfg_j, wl, ref, key)[0]
            tied = _self_hits(ref, prev) | _self_hits({k: v.numpy() for k, v in got.items()}, prev)
            assert tied.mean() <= 0.02
            keep = ~tied
            for k in ("alive", "aux_alive", "sample_light", "light_events"):
                np.testing.assert_array_equal(got[k].numpy()[keep], np.asarray(ref[k])[keep],
                                              err_msg=f"bounce {b} {k}")
            for k in ("origin", "direction", "reflectance", "brightness"):
                np.testing.assert_allclose(got[k].numpy()[keep], np.asarray(ref[k])[keep],
                                           rtol=1e-4, atol=1e-5, err_msg=f"bounce {b} {k}")
            checked += int(np.asarray(ref["alive"]).sum())
    assert checked > n // 2


@pytest.mark.parametrize("name", ["textures_200", "textures_80_bdpt"])
def test_deep_textures_cli_renders(paths, tmp_path, name):
    """A textures scene whose colour program needs a stack past
    exprs.PROG_STACK_MAX from .lua to PNG on the CPU, through the simple
    renderer and the bidirectional one."""
    out = str(tmp_path / f"{name}.png")
    with _deep_recursion():
        assert cli.main([paths[name], "--device", "cpu", "--samples", "1", "--output", out]) == 0
    with Image.open(out) as img:
        assert np.asarray(img).max() > 0


# program code of chip_smoke's scenes as the parent lowered it (every program
# within the parent's cap): sha256 of the code, offsets, two-part form, vector
# constants, leaves and stack, first 16 hex digits
PARENT_DIGESTS = {
    "flagship": "1ff804845c0c37fb", "flagship_photon": "1ff804845c0c37fb",
    "many_materials": "6b346447c8d4ad92", "prism": "d2780b0ea8fa9827",
    "textures": "c441d3831a9a125a", "textures_512": "c441d3831a9a125a",
    "textures_bdpt": "c441d3831a9a125a", "textures_deep": "62ef3bf729a8c43f",
    "textures_photon": "c441d3831a9a125a", "tri_lamp": "25a7b1746cd07184",
    "untextured": "7c64ddcaa59ca595", "untextured_bdpt": "7c64ddcaa59ca595",
}


def _code_digest(kp):
    text = repr((kp.code, kp.off, kp.split, kp.split_off, kp.vecs, [w for _, w in kp.leaves],
                 kp.leaf_base, kp.stack_depth))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def test_chip_smoke_programs_keep_their_code(tmp_path):
    """Every program of chip_smoke's scenes (the dense scenes, the textures
    scenes but the 1k one, whose programs are the textures scene's, the
    deep one and the photon projects) needs no more than the parent's 48
    values and lowers to the parent's code: its digest is the one the
    parent's lowering gave."""
    directory = str(tmp_path)
    found = dict(chip_smoke.scene_paths(directory))
    found.update({k: v for k, v in chip_smoke.texture_paths(os.path.join(directory, "tex")).items()
                  if k != "textures_1k"})
    found["textures_deep"] = chip_smoke.write_textures_scene(os.path.join(directory, "deep"), 256,
                                                             192, 6, 4, spp=16, deep=True)
    found.update(chip_smoke.photon_scene_paths(os.path.join(directory, "photon"), small=True))
    got = {}
    for name, path in found.items():
        kp = torch_build(torch_load(path), "cpu").dense_pack["programs"]
        assert kp.stack_depth <= 48 and not any(op == TE.OP_SWAP for op, _, _ in kp.code), name
        got[name] = _code_digest(kp)
    assert got == PARENT_DIGESTS


# --- DE shapes past the old ceiling -----------------------------------------------------


def test_de_shapes_past_the_old_ceiling_render_the_one_shape_film(tmp_path):
    """The small cubic Julia of chip_smoke.write_de_many_scene repeated
    MANY_SHAPES = 2,411 times in one place (write_de_repeated_scene: one
    object, one material) and once, each from .lua through the CLI on the
    CPU (8 x 4, 1 spp, 2 bounces): the keyed draws do not depend on the
    shape count and the closest hit is always the first copy, so the two
    films (the checkpoints' acc and wt) are equal bit for bit."""
    count = MANY_SHAPES
    films = {}
    for shapes in (1, count):
        path = chip_smoke.write_de_repeated_scene(str(tmp_path), shapes)
        scene = torch_build(torch_load(path), "cpu")
        assert len(scene.de_shapes) == shapes
        check = str(tmp_path / f"{shapes}.npz")
        out = str(tmp_path / f"{shapes}.png")
        assert cli.main([path, "--device", "cpu", "--samples", "1", "--output", out,
                         "--checkpoint", check, "--preview-interval", "0"]) == 0
        with np.load(check) as ck:
            films[shapes] = (ck["acc"], ck["wt"])
        with Image.open(out) as img:
            assert np.asarray(img).max() > 0
    np.testing.assert_array_equal(films[count][1], films[1][1])
    np.testing.assert_array_equal(films[count][0], films[1][0])
    assert films[1][0].sum() > 0


def test_lane_bytes_grow_with_the_de_shapes(tmp_path):
    """A lane's bytes grow by the march passes' t, 4 bytes a DE shape for
    the bounce ray and each shadow ray (simple.lane_bytes), and in the
    bidirectional renderer for each lamp slot's query ray too
    (bidirectional.lane_bytes); the photon renderer's camera lanes take
    simple.lane_bytes at S + G columns. The julia scene at 1 and at 2,411
    shapes, so the rows (~19 KB a lane at 2,411 shapes, one light sample)
    cut the wavefront where LANE_BYTES alone would not."""
    st = torch_build(torch_load(chip_smoke.write_julia_scene(str(tmp_path), 8, 4)), "cpu")
    many = copy.copy(st)
    many.de_shapes = list(st.de_shapes) * MANY_SHAPES
    cfg = TT.TraceConfig(3, 2, S)
    extra = 4 * (MANY_SHAPES - 1)
    assert simple.lane_bytes(many, S, 2) - simple.lane_bytes(st, S, 2) == extra * 3
    assert simple.lane_bytes(many, S, 1) - simple.lane_bytes(st, S, 1) == extra * 2
    assert bd.lane_bytes(many, cfg, 3) - bd.lane_bytes(st, cfg, 3) == extra * (3 + 4)
    assert simple.lane_budget(0, simple.lane_bytes(many, S, 1)) < simple.lane_budget(
        0, simple.LANE_BYTES) // 8
    spec = types.SimpleNamespace(spectrum_samples=S, g_bins=8, exact=False, bins=16)
    settings = types.SimpleNamespace(light_samples=2, bounces=3)
    assert ph.lane_bytes(many, settings, spec) - ph.lane_bytes(st, settings, spec) == extra * 3


def test_photon_walk_takes_chunks_past_its_budget(tmp_path, monkeypatch):
    """The photon walk's march passes hold a t a DE shape for each photon
    traced at once, so photon.photon_chunk traces fewer photons at once as
    the shapes grow (all of a pass's without DE shapes or at a few, under a
    million at 7,233); shoot_photons in chunks gives the whole batch's
    photons bit for bit (the draws are keyed by photon index), on the
    repeated Julia as a photon-mapping project (600 photons of 3 bounces,
    8 x 4)."""
    path = chip_smoke.write_de_repeated_scene(str(tmp_path), 3)
    with open(path) as fh:
        text = fh.read()
    text = text.replace("renderer.simple {", "renderer.photon_mapping {\n        " + (
        chip_smoke.PHOTON_EXTRA % (600, 3, 1, "0.5")), 1)
    path = str(tmp_path / "de_photon.lua")
    with open(path, "w") as fh:
        fh.write(text)
    pd = torch_load(path)
    st = torch_build(pd, "cpu")
    settings = pd.project.renderer
    _, _, _, photon_cfg, spec, *_, bin_centers = ph._build_parts(pd, st)
    many = copy.copy(st)
    many.de_shapes = list(st.de_shapes) * MANY_SHAPES
    big = types.SimpleNamespace(photons=10 ** 7)
    planes = copy.copy(st)
    planes.de_shapes = []
    assert ph.photon_chunk(st, settings) == settings.photons
    assert ph.photon_chunk(planes, big, held=ph._STEP_BYTES) == big.photons
    assert ph.photon_chunk(many, big) < 10 ** 6 < ph.photon_chunk(st, big) == big.photons
    assert ph.photon_chunk(many, big, held=ph._STEP_BYTES) == ph._MIN_WALK
    draws = KeyedDraws(3, sample0=2)
    whole = ph.shoot_photons(st, photon_cfg, draws, settings.photons, spec, bin_centers,
                             settings.photons)
    chunks = ph.shoot_photons(st, photon_cfg, draws, settings.photons, spec, bin_centers, 137)
    assert whole.keys() == chunks.keys() and int(whole["valid"].sum()) > 0
    for k, v in whole.items():
        assert torch.equal(chunks[k], v), k
