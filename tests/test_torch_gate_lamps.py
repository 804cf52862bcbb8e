"""Directional lamps in the port, held to the JAX package on the CPU.

A directional lamp (the reference's directional_light: a direction toward
the lamp, a width that is the cosine of its cone's half-angle, a colour)
lights a miss and is sampled in NEE. On a miss the first directional lamp
whose direction . ray >= width, while the lane samples lamps, gives the
colour in place of the sky (tracer.py:1617-1638 there); in NEE
sample_lamp draws a cone sample about its direction (width > 0) or takes
the direction itself (width 0), at an infinite distance and weight 1; it
starts no lamp path (sample_lamp_ray's valid).

The scenes are the flagship with chip_smoke.SUN (a 1.8-degree cone) and
chip_smoke.FILL (width 0, whose hemisphere holds the sun: the first match
wins), with two wide overlapping suns, the terrain mesh under both (the wide BVH's
unbounded any-hit walk), and the julia DE scene under SUN (its shadow
march runs only as far as each shape's bounds). Tolerances are those of
tests/test_torch_kernels_dense.py: flags exact, vectors rtol 1e-3 / atol
1e-4, brightness with < 1.5 % divergent lanes and energy within 0.5 %; the
DE shadow rule's blocked flags on >= 99 % of rays, t rtol 1e-3 / atol 1e-4
where both block, and the blocked share within one percentage point; the lamp
starts' flags exact and vectors rtol 1e-4 / atol 1e-5."""

import functools
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
from pyrite_tpu.renderers.simple import chunk_rays as jax_chunk_rays
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli, convert
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.scene import LAMP_DIRECTIONAL, build_scene as torch_build

torch.set_num_threads(2)

LANES = 1024
# two wide suns whose cones overlap: rays into the overlap take the first
TWO_SUNS = [
    '{type = "directional_light", direction = vector(0.2, 0.3, 0.9327), width = 0.9, '
    'color = rgb(1.5, 0.8, 0.4)},',
    '{type = "directional_light", direction = vector(-0.1, 0.2, 0.9747), width = 0.85, '
    'color = rgb(0.3, 0.6, 1.2)},',
]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("lamps"))
    flagship = chip_smoke.scene_paths(directory, 64, 32, 4, 4)["flagship"]
    julia = chip_smoke.write_julia_scene(directory, 48, 32)
    return {
        "sun_fill": chip_smoke.add_objects(flagship, [chip_smoke.SUN, chip_smoke.FILL], "sun_fill"),
        "two_suns": chip_smoke.add_objects(flagship, TWO_SUNS, "two_suns"),
        "sunlit_terrain": chip_smoke.write_sunlit_terrain_scene(
            directory, cells=24, width=64, height=32, spectrum_samples=4, spp=2),
        # the floor below the Julia (the scene builder mirrors a plane's
        # origin through the world's, as the reference does)
        "sunlit_julia": chip_smoke.add_objects(
            julia, [chip_smoke.SUN], "sunlit_julia",
            [("origin = vector(0, -1.3, 0)", "origin = vector(0, 1.3, 0)")]),
        "sunlit_bdpt": chip_smoke.add_objects(
            flagship, [chip_smoke.SUN, chip_smoke.FILL], "sunlit_bdpt",
            [("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 3,"),
             ("pixel_samples = 256", "pixel_samples = 2")]),
    }


@functools.lru_cache(maxsize=None)
def _scenes(path):
    """(JAX project, JAX scene, port scene) of ``path``, built once: the
    tests of one scene share them."""
    pj = jax_load(path)
    return pj, jax_build(pj), torch_build(torch_load(path), "cpu")


def _setup(path, key, middle=False):
    """Both packages' scenes and configs, and the same primary rays (from
    the top of the film, or with ``middle`` from its middle rows)."""
    pj, sj, st = _scenes(path)
    r, im = pj.project.renderer, pj.project.image
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    rows = max(1, LANES // im.width)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, oj, dj, wj = jax_chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg_j, key,
                                   row0=(im.height - rows) // 2 if middle else 0, rows=rows)
    return sj, st, cfg_j, cfg_t, (oj, dj, wj)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_close(ref, got, what):
    for k in ("alive", "aux_alive", "sample_light", "light_events"):
        if k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")
    for k in ("origin", "direction", "reflectance"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-4, err_msg=f"{what}: {k}")
    rb, kb = ref["brightness"], got["brightness"]
    lane_bad = (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1)
    assert lane_bad.mean() < 0.015, f"{what}: {lane_bad.sum()} divergent lanes"
    assert abs(rb.sum() - kb.sum()) < 0.005 * max(rb.sum(), 1e-6) + 1e-3, (
        f"{what}: energy {rb.sum():.4f} vs {kb.sum():.4f}")


@pytest.mark.parametrize("name", ["sun_fill", "two_suns", "sunlit_terrain"])
def test_bounce_core_matches_jax(paths, name):
    """tracer.bounce_core per lane against the JAX package's, fed the same
    state and the JAX draws, for two bounces from the camera (each from
    the JAX state): the misses that take a directional lamp's colour and the
    NEE toward it. The JAX bounce runs eagerly on the dense scenes and
    jitted on the mesh (tests/test_torch_kernels_dense.py says why)."""
    sj, st, cfg_j, cfg_t, (oj, dj, wj) = _setup(paths[name], jax.random.PRNGKey(11))
    assert st.directional_lamps and LAMP_DIRECTIONAL in st.lamp_types
    n, s = wj.shape
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(sj, cfg_j, k, n))
    ref = {
        "origin": oj, "direction": dj,
        "brightness": jnp.zeros((n, s)), "reflectance": jnp.ones((n, s)),
        "alive": jnp.ones(n, bool), "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool), "light_events": jnp.zeros(n, jnp.int32),
    }
    jax_bounce = lambda st_, k: JT.bounce_core(sj, cfg_j, wj, st_, k)[0]  # noqa: E731
    if sj.use_clusters:
        jax_bounce = jax.jit(jax_bounce)
    wl = torch.as_tensor(np.array(wj))
    lit = 0.0
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy(_np(draw(key)), "cpu")
        got = TT.bounce_core(st, cfg_t, wl, {k: torch.as_tensor(np.array(v)) for k, v in ref.items()},
                             draws)
        new = jax_bounce(ref, key)
        _assert_close(_np(new), {k: v.numpy() for k, v in got.items()}, f"{name} bounce {b}")
        lit += float(np.asarray(new["brightness"]).sum() - np.asarray(ref["brightness"]).sum())
        ref = new
    assert lit > 0


def _first_hits(sj, cfg_j, oj, dj):
    """The camera rays' first hits in the JAX package: (diffuse hit lanes,
    position, shading normal)."""
    hit = JT.intersect_scene(sj, oj, dj, cfg_j)
    position, normal, _, _, mat = JT.surface_data(sj, hit, oj, dj, cfg_j)
    comp = np.asarray(sj.arrays["mat_comp_offset"])[np.asarray(mat)]
    diffuse = (np.asarray(hit["kind"]) != JT.KIND_NONE) & (
        np.asarray(sj.arrays["comp_bsdf"])[comp] == JT.BSDF_DIFFUSE)
    return diffuse, position, normal


@pytest.mark.parametrize("name", ["sun_fill", "sunlit_terrain"])
def test_trace_direct_matches_jax(paths, name):
    """tracer.trace_direct alone against the JAX package's on the camera
    rays' diffuse first hits, with the JAX draws shared: the directional
    lamps' cone samples, their unbounded shadow rays (the wide BVH's
    any-hit walk on the terrain) and their colours. The JAX NEE is jitted
    on the mesh (tests/test_torch_kernels_dense.py says why)."""
    sj, st, cfg_j, cfg_t, (oj, dj, wj) = _setup(paths[name], jax.random.PRNGKey(3), middle=True)
    n, s = wj.shape
    diffuse, position, normal = _first_hits(sj, cfg_j, oj, dj)
    assert diffuse.mean() > 0.2
    key = jax.random.PRNGKey(21)
    k_nee = jax.random.split(key, 4)[3]
    refl = jnp.full((n, s), 0.5)
    aux = jnp.ones(n, bool)
    direct = lambda *args: JT.trace_direct(sj, cfg_j, k_nee, *args)  # noqa: E731
    if sj.use_clusters:  # jitted on the mesh, as test_bounce_core_matches_jax's bounce
        direct = jax.jit(direct)
    want = direct(jnp.asarray(diffuse), position, normal, dj, wj, refl, aux)
    draws = convert.draws_from_numpy(_np(JT.draw_bounce_uniforms(sj, cfg_j, key, n)), "cpu")
    T = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    got = TT.trace_direct(st, cfg_t, draws, T(diffuse), T(position), T(normal), T(dj), T(wj),
                          T(refl), T(aux))
    want = np.asarray(want)
    assert (want.sum(axis=1) > 0).mean() > 0.02  # lanes lit by a lamp
    lamp = np.asarray(sj.arrays["lamp_type"])[np.asarray(draws["lamp_idx"])]
    assert (want[lamp == JT.LAMP_DIRECTIONAL].sum(axis=1) > 0).any()
    _assert_close({"brightness": want}, {"brightness": got.numpy()}, f"{name} NEE")


def test_de_shadow_rule_matches_jax(paths):
    """Unbounded shadow rays toward a directional lamp from the julia
    scene's floor and from the Julia itself: the DE march runs only as far
    as the shape's bounds (t_cap inf). Ray by ray, the port blocks the same
    rays as the JAX package (on at least 99 % of them) at the same t
    (rtol 1e-3 / atol 1e-4 where both block), and the same share of rays
    within one percentage point."""
    path = paths["sunlit_julia"]
    pj, sj, st = _scenes(path)
    r, im = pj.project.renderer, pj.project.image
    cfg = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, oj, dj, _ = jax_chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg,
                                  jax.random.PRNGKey(7))
    hit = JT.intersect_scene(sj, oj, dj, cfg)
    found = np.isfinite(np.asarray(hit["t"]))
    position = (np.asarray(oj) + np.asarray(dj) * np.asarray(hit["t"])[:, None])[found]
    sun = np.array([0.3714, 0.7428, 0.5571], np.float32)
    direction = np.broadcast_to(sun, position.shape).astype(np.float32)
    inf = np.full(position.shape[0], np.inf, np.float32)
    want = JT.intersect_shadow(sj, jnp.asarray(position), jnp.asarray(direction), cfg,
                               max_dist=jnp.asarray(inf), block_below=jnp.asarray(inf))
    got = TT.intersect_shadow(st, torch.as_tensor(position), torch.as_tensor(direction),
                              torch.as_tensor(inf), torch.as_tensor(inf))
    t_j, t_t = np.asarray(want), got.numpy()
    blocked_j, blocked_t = np.isfinite(t_j), np.isfinite(t_t)
    assert 0.02 < blocked_j.mean() < 0.98
    assert (blocked_j == blocked_t).mean() >= 0.99
    both = blocked_j & blocked_t
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=1e-3, atol=1e-4)
    assert abs(blocked_j.mean() - blocked_t.mean()) <= 0.01


def test_sample_lamp_ray_skips_directional_lamps(paths):
    """sample_lamp_ray against the JAX package's on the sunlit terrain (two
    directional lamps and a sphere lamp): a pick of a directional lamp is
    not valid, and every field agrees."""
    _, sj, st = _scenes(paths["sunlit_terrain"])
    n = 900
    key = jax.random.PRNGKey(17)
    k_pick, k_u, _ = jax.random.split(jax.random.split(key, 3)[0], 3)
    want = JT.sample_lamp_ray(sj, jax.random.split(key, 3)[0], n)
    lamp_idx = torch.as_tensor(np.array(jax.random.randint(k_pick, (n,), 0, sj.num_lamps)))
    got = TT.sample_lamp_ray(st, lamp_idx, torch.as_tensor(np.array(jax.random.uniform(k_u, (n, 4)))))
    valid = got["valid"].numpy()
    directional = np.asarray(sj.arrays["lamp_type"])[lamp_idx.numpy()] == JT.LAMP_DIRECTIONAL
    assert directional.any() and valid.any()
    np.testing.assert_array_equal(valid, ~directional)
    for k in ("valid", "is_shape", "surf_mat", "color_prog"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("position", "direction", "normal", "weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["regen", "pool", "one-shot", "bidirectional"])
def test_cli_renders_directional_lamps(paths, tmp_path, which):
    """The sunlit flagship from .lua to PNG on the CPU through each of the
    simple renderer's schedulers and through the bidirectional renderer
    (the CLI case tests/test_torch_slice.py refused before)."""
    from PIL import Image

    out = tmp_path / f"{which}.png"
    before = dict(TT.launches)
    if which == "bidirectional":
        steps = bd.counters["steps"]
        assert cli.main([paths["sunlit_bdpt"], "--device", "cpu", "--output", str(out)]) == 0
        assert bd.counters["steps"] > steps
    else:
        with chip_smoke.scheduler(which, stage=2, cont=1):
            assert cli.main([paths["sun_fill"], "--samples", "2", "--device", "cpu", "--output",
                             str(out)]) == 0
    assert TT.launches["bounce_core"] > before["bounce_core"]
    with Image.open(out) as img:
        pixels = np.asarray(img)
    assert pixels.shape == (32, 64, 3) and pixels.max() > 0
