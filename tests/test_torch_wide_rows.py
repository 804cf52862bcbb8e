"""Spectral widths past the kernels' old shared-memory ceilings in the port,
held to the JAX package on the CPU.

- tracer.bounce_core per lane against the JAX package's, fed the JAX
  draws, on the textures scene (textures, a normal map and programs that
  read the ray: the kProg form, whose kernels make their own colour rows in
  chunks past 16 columns) at S = 128 and 512, and on the flagship at S =
  512 (the streamed gate form): the plain version the kernels are held to
  on the card.
- The photon renderer in interpolation mode at 128 film bins (a camera
  walk of S + G = 132 columns, a lamp walk of 129) against the JAX
  package's photon.render, statistically.
- The CLI from .lua to PNG at S = 512 (textures) and at 512 film bins
  (textures_photon at its small size: 518 camera and 513 lamp columns).
- The gate's measures (kernels_dense.launch_smem, the launchers' own):
  none grows with S past its bound, and the gate refuses no spectral width.

Tolerances: bounce_core per lane as tests/test_torch_textures.py's (flags
exact, vectors rtol 1e-4 / atol 1e-5 on the textures scene but the lanes
that a one-ulp re-hit decides, at most 1 % of them; on the flagship as
tests/test_torch_gate_rows.py's, vectors rtol 1e-3 / atol 1e-4, brightness
with < 1.5 % divergent lanes and its total within 0.5 %); the photon film's
lit mean within 4 of the JAX render's own spread over seeds."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import photon as jph
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli, convert, kernels_dense as kd, rng
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import photon as ph
from pyrite_tpu_torch.scene import build_scene as torch_build
from test_torch_photon_film import SPHERES
from test_torch_textures import _self_hits

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("wide_rows"))
    small = chip_smoke.photon_scene_paths(os.path.join(directory, "photon"), small=True)
    flagship = chip_smoke.scene_paths(directory, 16, 8, 512, 3)["flagship"]
    spheres = os.path.join(directory, "spheres_128.lua")
    with open(spheres, "w") as fh:
        fh.write(SPHERES.replace("radius = 0.4", "radius = 0.4, spectrum_resolution = 128"))
    return {
        "textures_s128": chip_smoke.write_textures_scene(os.path.join(directory, "t128"), 16, 12,
                                                         128, 3, spp=1),
        "textures_s512": chip_smoke.write_textures_scene(os.path.join(directory, "t512"), 16, 12,
                                                         512, 3, spp=1),
        "flagship_s512": flagship,
        "textures_photon_512": chip_smoke.photon_bins_scene(small["textures_photon"], 512),
        "spheres_128": spheres,
    }


def T(x):
    """A JAX (or numpy) array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(x))


def _packages(path):
    """Both packages' scenes (the JAX scene's texture store carried into the
    port's), configs, film and camera."""
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    sj = jax_build(pj)
    st = torch_build(torch_load(path), "cpu")
    convert.textures_from_numpy(sj.resources.store, st, "cpu")
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    return sj, st, cfg_j, cfg_t, film, JaxCamera.from_ir(pj.project.camera)


@pytest.mark.parametrize("name", ["textures_s128", "textures_s512", "flagship_s512"])
def test_bounce_core_matches_jax(paths, name):
    """bounce_core per lane against the JAX package's for two bounces from
    the camera, fed the JAX draws (convert.draws_from_numpy), each bounce
    from the JAX state: the textures scene runs the kProg form (the port's
    pack says so), the flagship the gate form; the JAX bounce runs
    eagerly."""
    sj, st, cfg_j, cfg_t, film, cam = _packages(paths[name])
    _, o, d, wl = jax_simple.chunk_rays(film, cam, cfg_j, jax.random.PRNGKey(3))
    n, s = wl.shape
    textured = name.startswith("textures")
    assert s == int(name.split("_s")[1])
    assert st.dense_pack["form"] == (kd.FORM_PROG if textured else kd.FORM_GATE)
    ref = {"origin": o, "direction": d, "brightness": jnp.zeros((n, s)),
           "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
           "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
           "light_events": jnp.zeros(n, jnp.int32)}
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(sj, cfg_j, k, n))
    checked = 0
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy({k: np.asarray(v) for k, v in draw(key).items()}, "cpu")
        got = {k: v.numpy() for k, v in TT.bounce_core(
            st, cfg_t, T(wl), {k: T(v) for k, v in ref.items()}, draws).items()}
        prev = ref["origin"]
        ref = JT.bounce_core(sj, cfg_j, wl, ref, key)[0]
        want = {k: np.asarray(v) for k, v in ref.items()}
        keep = slice(None)
        if textured:
            tied = _self_hits(want, prev) | _self_hits(got, prev)
            assert tied.mean() <= 0.01
            keep = ~tied
        for k in ("alive", "aux_alive", "sample_light", "light_events"):
            np.testing.assert_array_equal(got[k][keep], want[k][keep], err_msg=f"{name} {b}: {k}")
        rtol, atol = (1e-4, 1e-5) if textured else (1e-3, 1e-4)
        for k in ("origin", "direction", "reflectance") + (("brightness",) if textured else ()):
            np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=rtol, atol=atol,
                                       err_msg=f"{name} {b}: {k}")
        if not textured:
            rb, kb = want["brightness"], got["brightness"]
            assert (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1).mean() < 0.015
            assert abs(rb.sum() - kb.sum()) < 0.005 * max(rb.sum(), 1e-6) + 1e-3
        checked += int(want["alive"].sum())
    assert checked > n // 2 and float(np.asarray(ref["brightness"]).sum()) > 0


# The JAX render's mean over the pixels its seed-0 render lights (above
# 0.05) spreads with the seed: standard deviation 0.0151 over seeds 0-15
# (mean 0.2613, 211 pixels), measured with the JAX package on the CPU on
# this project (tests/test_torch_photon_film.py's spheres at 128 film bins)
# in interpolation mode at its 4 samples.
JAX_SPREAD_128 = 0.0151


def test_photon_interpolation_128_bins_matches_jax_statistically(paths, monkeypatch):
    """renderers.photon.render in interpolation mode at 128 film bins (S +
    G = 132 camera columns, 129 lamp columns: past the 110 the gate took
    before) against the JAX package's photon.render at 4 samples, seed 0
    each (their draws differ): the means over the pixels the JAX render
    lights agree within 4 JAX_SPREAD_128."""
    monkeypatch.setenv("PYRITE_TPU_PHOTON_EXACT", "0")
    path = paths["spheres_128"]
    pj = jax_load(path)
    film_j, acc_j, wt_j = jph.render(pj, jax_build(pj), seed=0, max_samples=4)
    img_j = np.asarray(film_j.develop(acc_j, wt_j)).mean(axis=2)
    pt = torch_load(path)
    st = torch_build(pt, "cpu")
    assert st.photon_widths == {"exact": False, "camera": 132, "lamp": 129, "bins": 128}
    film_t, acc_t, wt_t = ph.render(pt, st, seed=0, max_samples=4)
    img_t = film_t.develop(acc_t, wt_t).numpy().mean(axis=2)
    lit = img_j > 0.05
    assert lit.sum() > 100 and np.isfinite(img_t).all()
    assert abs(img_t[lit].mean() - img_j[lit].mean()) < 4 * JAX_SPREAD_128, (
        img_t[lit].mean(), img_j[lit].mean())


@pytest.mark.parametrize("name", ["textures_s512", "textures_photon_512"])
def test_cli_renders_past_the_old_ceilings(paths, tmp_path, name):
    """The CLI from .lua to PNG on the CPU: the textures scene at S = 512
    (the kProg form, whose parent's gate took 102 columns) and
    textures_photon at 512 film bins (interpolation mode: 518 camera and
    513 lamp columns; the gather's 2 B bins a warp's row)."""
    st = torch_build(torch_load(paths[name]), "cpu")
    if name == "textures_photon_512":
        assert st.photon_widths == {"exact": False, "camera": 518, "lamp": 513, "bins": 512}
    out = str(tmp_path / f"{name}.png")
    assert cli.main([paths[name], "--device", "cpu", "--samples", "1", "--output", out]) == 0
    with Image.open(out) as img:
        pixels = np.asarray(img)
    assert pixels.shape[2] == 3 and pixels.max() > 0


# (measure, its arguments past S) and the S from which it is flat: the
# simple renderer's bounce (staged at S <= 16), the NEE and the kRecord
# bounce in each form, the draws' camera rows (staged at S <= 87) and the
# gather's fresh wavelengths (a row of K sums at K <= 64)
_FLAT = {
    "bounce kProg": (lambda s: kd.bounce_smem_bytes(s, False, kd.FORM_PROG, 8), 17),
    "bounce gate DE": (lambda s: kd.bounce_smem_bytes(s, True, kd.FORM_GATE, 0), 17),
    "nee kProg": (lambda s: kd.nee_smem_bytes(s, kd.FORM_PROG, 48), 17),
    "record kProg DE": (lambda s: kd.record_smem_bytes(s, True, kd.FORM_PROG, 12), 17),
    "record gate": (lambda s: kd.record_smem_bytes(s, False, kd.FORM_GATE, 0), 1),
    "draws": (rng.draws_smem_bytes, 88),
    "gather": (lambda k: kd.gather_smem_bytes(512, k), 65),
}


@pytest.mark.parametrize("name", list(_FLAT))
def test_gate_measure_is_flat_past_its_bound(name):
    """Each launcher's dynamic shared memory, as the gate mirrors it, is
    the same at every S from its bound on (up to 8,192 columns) and within
    a block's; it never falls below a narrower width's by more than the
    staged rows it no longer holds."""
    measure, flat = _FLAT[name]
    at = {s: measure(s) for s in list(range(1, 300)) + [512, 1000, 4096, 8192]}
    assert len({v for s, v in at.items() if s >= flat}) == 1, name
    assert max(at.values()) <= kd.SMEM_PER_BLOCK


def test_gate_refuses_no_spectral_width(paths):
    """The gate takes every S: the textures scene (kProg, a program stack
    of 8) at S = 128 and 512 and the flagship at S = 512 build, their packs'
    shared memory (launch_smem) the flat measures'; the pack names no most
    S."""
    for name in ("textures_s128", "textures_s512", "flagship_s512"):
        st = torch_build(torch_load(paths[name]), "cpu")
        pack = st.dense_pack
        assert "max_s" not in pack
        form, stack = pack["form"], pack["stack"]
        assert pack["smem"]["bounce"] == kd.bounce_smem_bytes(17, False, form, stack)
        assert pack["smem"]["nee"] == kd.nee_smem_bytes(17, form, stack)
        assert max(pack["smem"].values()) <= kd.SMEM_PER_BLOCK
