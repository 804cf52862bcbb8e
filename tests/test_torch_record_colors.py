"""The plain versions of the bidirectional and photon renderers' kernels A
(the bounce kernels' kRecord instantiations) and D (program_colors_kernel)
against the JAX package, on the CPU, where the card's redesign of either
changed what their blocks hold:

- D: kernels_dense.vertex_colors_plain on chip_smoke.color_edge_batches
  (every slot invalid, every slot valid, a valid prefix of each length,
  programs -1 and out of range, a program with code beside one without),
  on a small textures_bdpt project with and without a baked table, against
  the colours the JAX package's _lamp_path_factors computes (its
  eval_color_bank on the flattened vertices): rtol 1e-5 / atol 1e-6, and
  exact zeros where a slot is invalid or its program out of range;
- A: tracer.bounce_core(record=True)'s chain factors on a small
  textures_photon project in interpolation mode, at its camera walk's S + G
  = 70 columns, against the JAX package's, fed the same draws;
- A's shared memory: kernels_dense.record_smem_bytes, the mirror of the
  kRecord launchers' RECORD_SMEM (csrc/bounce.cu), at S = 6, 16, 17, 70
  and 102, and its constants against the source."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.scene as JS
import pyrite_tpu.tracer as JT
from pyrite_tpu.exprs import ProgramInputs as JaxInputs
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.scene as TS
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import convert, kernels_dense as kd
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

LANES, SLOTS, S = 96, 5, 6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("record_colors"))
    return {
        "textures_bdpt": chip_smoke.write_textures_scene(directory, 24, 16, S, 4, spp=2,
                                                         renderer="bidirectional"),
        "textures_photon": chip_smoke.photon_scene_paths(
            os.path.join(directory, "photon"), small=True)["textures_photon"],
    }


def _packages(path):
    """(JAX scene, port scene) of a project, the port's texture store the
    JAX scene's (the same files)."""
    sj = jax_build(jax_load(path))
    st = torch_build(torch_load(path), "cpu")
    convert.textures_from_numpy(sj.resources.store, st, "cpu")
    return sj, st


@pytest.fixture(scope="module", params=[False, True], ids=["bank", "table"])
def color_scenes(request, paths):
    """The textures_bdpt project's scenes as built (no baked table: too few
    wavelength-only colour programs) and with a baked table (both
    packages' BANK_TABLE_MIN lowered to 1 while they build)."""
    saved = JS.BANK_TABLE_MIN, TS.BANK_TABLE_MIN
    if request.param:
        JS.BANK_TABLE_MIN = TS.BANK_TABLE_MIN = 1
    try:
        sj, st = _packages(paths["textures_bdpt"])
    finally:
        JS.BANK_TABLE_MIN, TS.BANK_TABLE_MIN = saved
    assert (st.color_bank_bakeable is not None) == request.param
    assert (sj.color_bank_bakeable is not None) == request.param
    return sj, st


@pytest.mark.parametrize("case", ["all_invalid", "all_valid", "prefixes", "bad_programs",
                                  "code_beside_none"])
def test_vertex_colors_match_jax(color_scenes, case):
    """D's plain version on a hand-built batch against the JAX package's
    lamp-vertex colours (as _lamp_path_factors evaluates them): rtol 1e-5 /
    atol 1e-6, and 0 exactly where a slot is invalid or its program is -1
    or out of range."""
    sj, st = color_scenes
    batch = chip_smoke.color_edge_batches(st, LANES, SLOTS, seed=4)[case]
    prog, valid, normal, incident, uv = batch
    wl = np.random.default_rng(9).uniform(380.0, 780.0, (LANES, S)).astype(np.float32)
    got = _np(kd.vertex_colors_plain(st, *batch, torch.as_tensor(wl)))
    flat = lambda x: jnp.asarray(_np(x).reshape((LANES * SLOTS,) + tuple(x.shape[2:])))  # noqa: E731
    inputs = JaxInputs(wavelength=jnp.repeat(jnp.asarray(wl)[:, None, :], SLOTS, axis=1).reshape(
        LANES * SLOTS, S), normal=flat(normal), incident=flat(incident), uv=flat(uv))
    want = np.asarray(JT.eval_color_bank(sj, flat(prog), inputs, active=flat(valid))).reshape(
        LANES, SLOTS, S)
    p, v = _np(prog), _np(valid)
    zero = ~v | (p < 0) | (p >= len(st.color_programs))
    assert (got[zero] == 0.0).all() and (want[zero] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if case not in ("all_invalid", "bad_programs"):
        assert np.abs(got[~zero]).max() > 0.01, "no colour to compare"


def test_record_chain_factors_past_16_columns_match_jax(paths):
    """The plain record bounce with the photon renderer's chain factors
    (reflected, color_prob, color_prog, path_prob) and the camera vertex
    on the small textures_photon project in interpolation mode, at its
    camera walk's width (S + G = 70 columns: the camera wavelengths, then
    the G grid centres), against the JAX package's bounce_core(record=True)
    for two bounces, fed the JAX draws and each bounce the JAX state (the
    JAX bounce run eagerly, as tests/test_torch_textures.py runs it: jitted,
    XLA's fused texture and fresnel ops part from the port's on ~0.2 % of
    color_prob's words by up to 5e-3 relative): flags exact, and color_prob, path_prob,
    position and normal within rtol 1e-4 / atol 1e-5 on the lanes that
    reflect, on every lane but those where the two packages part on the hit
    (a grazing or self hit decided by one ulp; at most 2 % of the lanes,
    as tests/test_torch_photon_film.py holds the narrower scenes)."""
    path = paths["textures_photon"]
    sj, st = _packages(path)
    proj = jax_load(path).project
    r, im = proj.renderer, proj.image
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    _, oj, dj, wj = jax_simple.chunk_rays(film, JaxCamera.from_ir(proj.camera), cfg_j,
                                          jax.random.PRNGKey(3))
    n = wj.shape[0]
    widths = st.photon_widths
    assert widths is not None and not widths["exact"] and widths["camera"] == 70
    g = widths["camera"] - r.spectrum_samples
    lo, hi = r.spectrum_span
    centres = jnp.asarray([lo + (i + 0.5) * (hi - lo) / g for i in range(g)], jnp.float32)
    wide = jnp.concatenate([wj, jnp.broadcast_to(centres[None, :], (n, g))], axis=1)
    s = wide.shape[1]
    state = {"origin": oj, "direction": dj, "brightness": jnp.zeros((n, s)),
             "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
             "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
             "light_events": jnp.zeros(n, jnp.int32)}
    jax_bounce = lambda st_, k: JT.bounce_core(sj, cfg_j, wide, st_, k)  # noqa: E731
    reflecting = 0
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy(
            {k: np.asarray(v) for k, v in JT.draw_bounce_uniforms(sj, cfg_j, key, n).items()}, "cpu")
        _, got = TT.bounce_core(st, cfg_t, torch.as_tensor(np.array(wide)),
                                {k: torch.as_tensor(np.array(v)) for k, v in state.items()}, draws,
                                record=True)
        state, info = jax_bounce(state, key)
        want = {k: np.asarray(v) for k, v in info.items()}
        got = {k: _np(v) for k, v in got.items()}
        gp, wp = got["position"], want["position"]
        finite = np.isfinite(gp).all(1) & np.isfinite(wp).all(1)
        apart = (got["miss"] != want["miss"]) | (
            np.isfinite(gp).all(1) != np.isfinite(wp).all(1)) | (
            finite & (np.linalg.norm(np.where(finite[:, None], gp - wp, 0.0), axis=1) > 1e-3))
        assert apart.mean() < 0.02, apart.mean()
        keep = ~apart
        for k in ("reflected", "is_diffuse", "dispersed", "recorded", "miss"):
            np.testing.assert_array_equal(got[k][keep], want[k][keep], err_msg=f"bounce {b} {k}")
        refl = want["reflected"] & keep
        np.testing.assert_array_equal(got["color_prog"][refl], want["color_prog"][refl])
        assert got["color_prob"].shape == (n, 70)
        for k in ("color_prob", "path_prob", "position", "normal"):
            np.testing.assert_allclose(got[k][refl], want[k][refl], rtol=1e-4, atol=1e-5,
                                       err_msg=f"bounce {b}: {k}")
        reflecting += int(refl.sum())
    assert reflecting > 100


_SOURCE = os.path.join(os.path.dirname(kd.__file__), "csrc", "bounce.cu")


def test_record_smem_mirror_follows_the_source():
    """record_smem_bytes' constants are the source's: a RowOp is a pointer
    and five 4-byte fields (32 bytes, 8-aligned), and the kRecord launchers
    pass stream_smem_bytes, with each lane's own colour row on a kProg
    scene (OWN_FLOATS: S floats at S <= 16, a chunk's slot of RECORD_STRIDE
    = 129 past it)."""
    with open(_SOURCE) as fh:
        src = fh.read()
    fields = re.search(r"struct RowOp \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"^\s+const float\* src;", fields, re.M)) == 1
    assert len(re.findall(r"^\s+(?:float|int) \w+;", fields, re.M)) == 5
    assert kd._ROW_OP_FLOATS * 4 == 32
    assert ("#define RECORD_SMEM stream_smem_bytes(n_de > 0, form == FORM_PROG ? "
            "OWN_FLOATS(RECORD_STRIDE) : 0)") in src
    assert "#define OWN_FLOATS(STRIDE) (WIDE ? (STRIDE) : s)" in src and "#define WIDE (s > MAX_ROW)" in src
    for chunk, stride, n in (("ROW_CHUNK", "OWN_STRIDE", 16), ("RECORD_CHUNK", "RECORD_STRIDE", 128)):
        assert f"constexpr int {chunk} = {n};" in src and f"constexpr int {stride} = {chunk} + 1;" in src
    assert (kd._OWN_STRIDE, kd._RECORD_STRIDE, kd.GATHER_ROW) == (17, 129, 16)
    assert "return sizeof(float) * ((size_t)BLOCK * (12 + ROW_OP_FLOATS + own) +" in src


# S: bytes of a kRecord block (the kProg camera walk with a program stack of
# 8 and no DE shapes; the gate form with DE shapes; the simple form)
_RECORD_SMEM = {s: (4 * 128 * (12 + 8 + (s if s <= 16 else 129)) + 16 * 128 * 8,
                    4 * 128 * 20 + 5120, 4 * 128 * 20)
                for s in (6, 16, 17, 70, 102)}


@pytest.mark.parametrize("s", sorted(_RECORD_SMEM))
def test_record_smem_bytes(s):
    """A's shared memory a block at S columns: every form streams its
    rows, [BLOCK, 12 + 8] floats (vectors and a row op a lane), 5,120 B of
    DE probe slots where the scene has DE shapes, and the kProg camera walk
    one own colour row a lane beside its program stack, whole at S <= 16
    ([BLOCK, 12 + 8 + S]) and past it a chunk's slot of 129 floats. At S +
    G = 70 the kProg block takes 92,672 B, as at any S past 16, where whole
    own rows took 62,464 B and the staged form 165,888 B."""
    prog, gate_de, simple = _RECORD_SMEM[s]
    assert kd._DE_SLOT_BYTES == 5120
    assert kd.record_smem_bytes(s, False, kd.FORM_PROG, 8) == prog
    assert kd.record_smem_bytes(s, True, kd.FORM_GATE, 0) == gate_de
    assert kd.record_smem_bytes(s, False, kd.FORM_SIMPLE, 0) == simple
    if s == 70:
        assert prog == 92672 == kd.record_smem_bytes(512, False, kd.FORM_PROG, 8)
    assert prog <= kd.SMEM_PER_BLOCK
