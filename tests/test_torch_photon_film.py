"""The photon renderer's camera walk and film against the JAX package's on
the CPU: bounce_core(record=True)'s chain factors (reflected, color_prob,
color_prog, path_prob) per lane with the JAX draws on a dense, a mesh and a
DE scene (flags exact, vectors rtol 1e-4 / atol 1e-6), and a whole
renderers.photon.render against the JAX package's photon.render,
statistically, on the three-sphere scene of tests/test_renderers.py."""

import os

import numpy as np
import pytest
import torch

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
from pyrite_tpu_torch import convert
from pyrite_tpu_torch import kernels_dense as kd
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import photon as ph
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

SPHERES = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.photon_mapping {
        pixel_samples = 4, spectrum_samples = 4, bounces = 4,
        light_samples = 2, photons = 1500, photon_bounces = 4, radius = 0.4
    },
    world = {
        objects = {
            shape.sphere {
                radius = 50, position = vector(0, -50, 0),
                material = {surface = material.diffuse {color = 0.7}},
            },
            shape.sphere {
                radius = 1, position = vector(0, 3, 0),
                material = {surface = material.emissive {color = 2}},
            },
            shape.sphere {
                radius = 0.8, position = vector(1.5, 0.8, 0),
                material = {surface = material.diffuse {color = 0.4}},
            },
        },
    },
}
"""


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("photon_film"))
    spheres = os.path.join(directory, "spheres.lua")
    with open(spheres, "w") as fh:
        fh.write(SPHERES)
    dense = chip_smoke.scene_paths(directory, width=24, height=12, spectrum_samples=4, bounces=4)
    return {
        "spheres": spheres,
        "flagship": dense["flagship"],
        "terrain_24": chip_smoke.terrain_paths(directory, cells=(24,), width=24, height=12)["terrain_24"],
        "julia": chip_smoke.write_julia_scene(directory, 16, 16, 4, 3),
    }


def T(x):
    """A JAX (or numpy) array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(x))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _scenes(path):
    return jax_build(jax_load(path)), torch_build(torch_load(path), "cpu")


def _film_camera_cfg(sj, path):
    r = jax_load(path).project
    rr, im = r.renderer, r.image
    return (JaxFilm(im.width, im.height, rr.spectrum_bins, rr.spectrum_span),
            JaxCamera.from_ir(r.camera), JT.TraceConfig(rr.bounces, rr.light_samples, rr.spectrum_samples))


@pytest.mark.parametrize("name", ["flagship", "terrain_24", "julia"])
def test_bounce_record_chain_factors_match_jax(paths, name):
    """bounce_core(record=True)'s reflected, color_prob, color_prog and
    path_prob per lane against the JAX info for two camera bounces, fed the
    JAX draws, each from the JAX state (the JAX bounce jitted whole, as
    tests/test_torch_kernels_dense.py runs it on a mesh scene): reflected
    exact, color_prog exact and color_prob and path_prob within rtol 1e-4 /
    atol 1e-6 on the lanes that reflect, on every lane but those where the
    two packages part on the hit (one finds it and the other misses, or
    their positions lie more than 1e-3 apart: a grazing or self hit decided
    by one ulp, at most 2 % of the lanes)."""
    sj, st = _scenes(paths[name])
    film_j, cam_j, cfg_j = _film_camera_cfg(sj, paths[name])
    _, oj, dj, wj = jax_simple.chunk_rays(film_j, cam_j, cfg_j, jax.random.PRNGKey(3))
    n, s = wj.shape
    cfg_t = TT.TraceConfig(cfg_j.bounces, cfg_j.light_samples, cfg_j.spectrum_samples)
    state = {"origin": oj, "direction": dj, "brightness": jnp.zeros((n, s)),
             "reflectance": jnp.ones((n, s)), "alive": jnp.ones(n, bool),
             "aux_alive": jnp.ones(n, bool), "sample_light": jnp.ones(n, bool),
             "light_events": jnp.zeros(n, jnp.int32)}
    jax_bounce = jax.jit(lambda st_, k: JT.bounce_core(sj, cfg_j, wj, st_, k))
    reflecting = 0
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy(_np(JT.draw_bounce_uniforms(sj, cfg_j, key, n)), "cpu")
        _, got = TT.bounce_core(st, cfg_t, T(wj), {k: T(v) for k, v in state.items()}, draws,
                                record=True)
        state, info = jax_bounce(state, key)
        want = _np(info)
        gp, wp = got["position"].numpy(), want["position"]
        finite = np.isfinite(gp).all(1) & np.isfinite(wp).all(1)
        apart = (got["miss"].numpy() != want["miss"]) | (
            np.isfinite(gp).all(1) != np.isfinite(wp).all(1)) | (
            finite & (np.linalg.norm(np.where(finite[:, None], gp - wp, 0.0), axis=1) > 1e-3))
        assert apart.mean() < 0.02, apart.mean()
        keep = ~apart
        np.testing.assert_array_equal(got["reflected"].numpy()[keep], want["reflected"][keep])
        refl = want["reflected"] & keep
        np.testing.assert_array_equal(got["color_prog"].numpy()[refl], want["color_prog"][refl])
        for k in ("color_prob", "path_prob"):
            np.testing.assert_allclose(got[k].numpy()[refl], want[k][refl], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} bounce {b}: {k}")
        reflecting += int(refl.sum())
    assert reflecting > 20


@pytest.mark.parametrize("name", ["flagship", "terrain_24"])
def test_record_camera_vertices_match_jax(paths, name, monkeypatch):
    """renderers.photon._record_camera_vertices against the JAX package's
    walk, both fed the JAX draws of each bounce (jax.random.split of the
    walk's key, as its while_loop takes them) and the chain counted (exact
    mode): every bounce's vertex, whose partialR, counts and scalar carry
    the chain's factors across bounces, on the lanes where the two packages
    have agreed on every hit so far (valid flags equal, positions both
    finite or not, and within 1e-3: a grazing or self hit decided by one
    ulp parts the walks for the rest of the lane, at most 2 % of the lanes
    by the last bounce). dispersed and counts exact; partialR and scalar
    within rtol 1e-4 / atol 1e-6 (as the chain factors' test)."""
    sj, st = _scenes(paths[name])
    film_j, cam_j, cfg_j = _film_camera_cfg(sj, paths[name])
    _, oj, dj, wj = jax_simple.chunk_rays(film_j, cam_j, cfg_j, jax.random.PRNGKey(3))
    n = wj.shape[0]
    m = len(sj.color_programs)
    assert len(st.color_programs) == m
    key = jax.random.PRNGKey(9)
    _, want = jax.jit(lambda k: jph._record_camera_vertices(sj, cfg_j, k, oj, dj, wj, chain_m=m))(key)
    want = _np(want)
    keys = jax.random.split(key, cfg_j.bounces)

    def jax_draws(scene, cfg, count, draws, bounce, device):
        return convert.draws_from_numpy(_np(JT.draw_bounce_uniforms(sj, cfg_j, keys[bounce], count)),
                                        device)

    monkeypatch.setattr(TT, "draw_bounce_uniforms", jax_draws)
    cfg_t = TT.TraceConfig(cfg_j.bounces, cfg_j.light_samples, cfg_j.spectrum_samples)
    wt = T(wj)
    _, got = ph._record_camera_vertices(st, cfg_t, None, T(oj), T(dj), wt,
                                        kd.precompute_bank_values(st, wt), chain_m=m)
    assert len(got) >= 2
    apart = np.zeros(n, bool)
    compared = chained = 0
    for b, vertex in enumerate(got):
        g = {k: v.numpy() for k, v in vertex.items()}
        w = {k: v[:, b] for k, v in want.items()}
        gp, wp = g["position"], w["position"]
        finite = np.isfinite(gp).all(1) & np.isfinite(wp).all(1)
        apart |= (g["valid"] != w["valid"]) | (np.isfinite(gp).all(1) != np.isfinite(wp).all(1)) | (
            finite & (np.linalg.norm(np.where(finite[:, None], gp - wp, 0.0), axis=1) > 1e-3))
        assert apart.mean() < 0.02, (b, apart.mean())
        keep = ~apart
        what = f"{name} bounce {b}"
        np.testing.assert_array_equal(g["dispersed"][keep], w["dispersed"][keep], err_msg=what)
        np.testing.assert_array_equal(g["counts"][keep], w["counts"][keep], err_msg=what)
        for k in ("partialR", "scalar"):
            np.testing.assert_allclose(g[k][keep], w[k][keep], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what}: {k}")
        compared += int((keep & w["valid"]).sum())
        chained += int((keep & (w["counts"].sum(1) > 1)).sum())  # a factor past its own
    assert compared > 50 and chained > 20, (compared, chained)


# The JAX render's mean over the pixels its seed-0 render lights (above
# 0.05) spreads with the seed: standard deviation 0.0224 over seeds 0-15
# (mean 0.4155, 216 pixels), measured with the JAX package on the CPU on
# this project at its 4 samples.
JAX_SPREAD = 0.0224


def test_render_matches_jax_statistically(paths):
    """renderers.photon.render against the JAX package's photon.render at 4
    samples, seed 0 each (their draws differ: threefry against keyed
    Philox): the means over the pixels the JAX render lights agree within
    4 JAX_SPREAD, the JAX render's own spread over seeds."""
    path = paths["spheres"]
    pj = jax_load(path)
    film_j, acc_j, wt_j = jph.render(pj, jax_build(pj), seed=0, max_samples=4)
    img_j = np.asarray(film_j.develop(acc_j, wt_j)).mean(axis=2)
    pt = torch_load(path)
    film_t, acc_t, wt_t = ph.render(pt, torch_build(pt, "cpu"), seed=0, max_samples=4)
    img_t = film_t.develop(acc_t, wt_t).numpy().mean(axis=2)
    lit = img_j > 0.05
    assert lit.sum() > 100 and np.isfinite(img_t).all()
    assert abs(img_t[lit].mean() - img_j[lit].mean()) < 4 * JAX_SPREAD, (
        img_t[lit].mean(), img_j[lit].mean())
