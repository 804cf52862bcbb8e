"""The march passes' plain version (kernels_dense.march_pass / shadow_pass on
CPU tensors, tracer.de_hits): each DE shape's t along a bounce's rays and
along its NEE shadow rays, which the CUDA bounce and NEE kernels take after
the primitives. Held two ways:

- applied shape by shape as the kernels apply it (a closest hit beyond
  DIST_EPSILON and strictly nearer; a shadow t lowered by any hit), on top of
  the scene without its DE shapes, it gives tracer.intersect_scene /
  intersect_shadow's results bit for bit;
- its t agrees with the JAX package's _intersect_de on the same
  numpy-seeded rays, to the tolerances of tests/test_torch_de.py's march
  test (libm against XLA: hit flags on 99.5 % of rays, t within rtol 1e-3 on
  all but 0.1 % of the rays both hit)."""

import copy
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.scene import DEShape as JaxDEShape
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import geometry as geom, kernels_dense as kd
from pyrite_tpu_torch.scene import DEShape

torch.set_num_threads(2)


def _scene_path(directory, name):
    if name == "fractal":
        return chip_smoke.write_fractal_scene(directory, 32, 32, 4, 3)
    if name == "two_de":
        return chip_smoke.write_two_de_scene(directory, 32, 24)
    return chip_smoke.write_terrain_de_scene(directory)


def _without_de(scene):
    bare = copy.copy(scene)
    bare.de_shapes = []
    return bare


def _camera_state(directory, name, seed=0):
    """The scene, its config, one sample of camera rays over the whole film
    (keyed draws of ``seed``) with a random quarter of the lanes dead
    (numpy), and the wavefront's rng.KeyedDraws."""
    scene, film, camera, cfg = chip_smoke.load_scene(_scene_path(directory, name), "cpu")
    origin, direction, wl, keyed = chip_smoke._wavefront(
        film, camera, cfg, seed, film.width * film.height, device="cpu")
    state = TT.initial_state(origin, direction, wl.shape[1])
    state["alive"] = torch.as_tensor(np.random.default_rng(seed).random(origin.shape[0]) >= 0.25)
    return scene, cfg, state, keyed


@pytest.mark.parametrize("name", ["fractal", "terrain_de", "two_de"])
def test_march_pass_in_shape_order_matches_intersect_scene(tmp_path, name):
    scene, cfg, state, _ = _camera_state(str(tmp_path), name)
    o, d, alive = state["origin"], state["direction"], state["alive"]
    t_de = kd.march_pass(scene, cfg, state)
    assert t_de.shape == (len(scene.de_shapes), o.shape[0]) and t_de.dtype == torch.float32
    assert bool(torch.isinf(t_de[:, ~alive]).all())
    got = TT.intersect_scene(_without_de(scene), o, d)
    for j, t in enumerate(t_de):  # bounce.cu apply_de_closest
        take = (t > TT.DIST_EPSILON) & (t < got["t"])
        got["t"] = torch.where(take, t, got["t"])
        got["kind"] = torch.where(take, TT.KIND_DE, got["kind"])
        got["idx"] = torch.where(take, j, got["idx"])
    want = TT.intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    for k in ("t", "kind", "idx", "u", "v"):
        assert torch.equal(got[k][alive], want[k][alive]), k
    assert bool((want["kind"][alive] == TT.KIND_DE).any())


@pytest.mark.parametrize("name", ["fractal", "terrain_de", "two_de"])
def test_shadow_pass_in_shape_order_matches_intersect_shadow(tmp_path, name):
    scene, cfg, state, keyed = _camera_state(str(tmp_path), name)
    o, d = state["origin"], state["direction"]
    n = o.shape[0]
    draws = TT.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cpu")
    hit = TT.intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    position, normal, _ = TT.surface_data(scene, hit, o, d)
    flip = torch.where((geom.dot(d, normal) < 0.0)[:, None], normal, -normal)
    out = {"origin": position}
    ctx = {"flip": flip, "nee": state["alive"] & (hit["kind"] != TT.KIND_NONE)}
    t_de = kd.shadow_pass(scene, cfg, out, ctx, draws)
    assert t_de.shape == (len(scene.de_shapes), cfg.light_samples, n)
    assert bool(torch.isfinite(t_de).any())
    for j in range(cfg.light_samples):
        direction, dist, cast = kd.shadow_rays(scene, out, ctx, draws, j)
        assert bool(cast.any()) and bool(torch.isinf(t_de[:, j, ~cast]).all())
        got = TT.intersect_shadow(_without_de(scene), position, direction, dist)
        for t in t_de[:, j]:  # bounce.cu apply_de_shadow
            got = torch.minimum(got, t)
        want = TT.intersect_shadow(scene, position, direction, dist, de_steps=cfg.max_de_steps)
        assert torch.equal(got[cast], want[cast])


# examples/fractal.lua's Mandelbulb in its box, and the julia scene's cubic
# Julia in its sphere
SHAPES = {
    "mandelbulb": (
        {"kind": "mandelbulb", "iterations": 12, "threshold": 4.0, "power": 8.0, "constant": None},
        "box", np.full(3, -1.3, np.float32), np.full(3, 1.3, np.float32),
    ),
    "julia_cubic": (
        {"kind": "quaternion_julia", "iterations": 25, "threshold": 4.0,
         "constant": np.array([-0.45, -0.0375, -0.4, -0.025], np.float32),
         "slice_plane": 0.0, "variant": "cubic"},
        "sphere", np.zeros(3, np.float32), np.array([1.5, 0.0, 0.0], np.float32),
    ),
}


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("source", ["bounce", "shadow"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pass_matches_jax(monkeypatch, name, source, mode):
    """Rays from around examples/fractal.lua's eye toward [-1, 1]^3, a
    random quarter of them without a ray; shadow rays capped at a random
    lamp distance. JAX's march in XLA, or through its Pallas march kernel in
    interpret mode."""
    monkeypatch.setenv("PYRITE_TPU_PALLAS", "0" if mode == "xla" else "interpret")
    monkeypatch.setenv("PYRITE_TPU_DE_OMEGA", str(TT.DE_OMEGA))
    est, kind, a, b = SHAPES[name]
    rng = np.random.default_rng(7)
    n = 4096
    origin = (np.array([2.4, 1.6, 2.4]) + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    direction = rng.uniform(-1.0, 1.0, (n, 3)) - origin
    direction = (direction / np.linalg.norm(direction, axis=1, keepdims=True)).astype(np.float32)
    live = rng.uniform(size=n) >= 0.25
    cap = rng.uniform(2.5, 5.0, n).astype(np.float32) if source == "shadow" else None
    ok_j, t_j, _ = JT._intersect_de(
        JaxDEShape(est, kind, a, b, 0), jnp.asarray(origin), jnp.asarray(direction), 200,
        t_cap=None if cap is None else jnp.asarray(cap),
    )
    ok_j, t_j = np.asarray(ok_j) & live, np.where(live, np.asarray(t_j), np.inf)
    scene = types.SimpleNamespace(de_shapes=[DEShape(est, kind, a, b, 0)])
    cfg = TT.TraceConfig(bounces=1, light_samples=1, spectrum_samples=1)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    if source == "bounce":
        t_t = kd.march_pass(scene, cfg, {"origin": o, "direction": d, "alive": torch.as_tensor(live)})
    else:
        t_t = TT.de_hits(scene, o, d, cfg.max_de_steps, t_cap=torch.as_tensor(cap),
                         live=torch.as_tensor(live))
    t_t = t_t[0].numpy()
    ok_t = np.isfinite(t_t)
    assert (ok_j == ok_t).mean() >= 0.995
    both = ok_j & ok_t
    assert both.sum() > 100
    rel = np.abs(t_t[both] - t_j[both]) / np.abs(t_j[both])
    assert (rel > 1e-3).mean() <= 0.001, np.sort(rel)[-5:]
    assert np.isinf(t_t[~live]).all()
