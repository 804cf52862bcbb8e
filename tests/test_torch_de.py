"""The port's distance-estimated shapes against the JAX package's: the
estimators, the sphere-traced march (JAX in XLA and through its Pallas march
kernel in interpret mode, as tests/test_geometry.py runs it), the shadow rule
and the march wrapper's routing.

Tolerances come from the estimators being chaotic maps: libm and XLA differ
in the last ulp, and where that moves a point's escape to another iteration
the distance differs by a lot. So the estimator is held to rtol 1e-3 on
99 % of points; the march, which only stops where the distance is below
DIST_EPSILON, to hit flags equal on 99.5 % of rays and t within rtol 1e-3
on all but 0.1 % of the rays both hit: a Mandelbulb ray that grazes the set
can stop one estimator escape earlier or later."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers.simple import chunk_rays as jax_chunk_rays
from pyrite_tpu.scene import CameraModel as JaxCamera, DEShape as JaxDEShape, build_scene as jax_build
from pyrite_tpu.film import Film as JaxFilm
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import kernels, kernels_dense
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.scene import DEShape, build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# examples/fractal.lua's Mandelbulb and cornell's cubic Julia
# (tools/tpu_de_bench.py:22-29), and their variants
MANDELBULB = {"kind": "mandelbulb", "iterations": 12, "threshold": 4.0, "power": 8.0, "constant": None}
JULIA = {
    "kind": "quaternion_julia", "iterations": 25, "threshold": 4.0,
    "constant": np.array([-0.45, -0.0375, -0.4, -0.025], np.float32),
    "slice_plane": 0.0, "variant": "cubic",
}
ESTIMATORS = {
    "mandelbulb": MANDELBULB,
    "mandelbulb_constant": dict(MANDELBULB, constant=np.array([0.1, -0.2, 0.3], np.float32)),
    "julia_regular": dict(JULIA, variant="regular", constant=np.array([-0.2, 0.8, 0.0, 0.0], np.float32)),
    "julia_cubic": JULIA,
    "julia_bicomplex": dict(JULIA, variant="bicomplex"),
}
BOUNDS = {
    "box": ("box", np.full(3, -1.3, np.float32), np.full(3, 1.3, np.float32)),
    "sphere": ("sphere", np.zeros(3, np.float32), np.array([1.5, 0.0, 0.0], np.float32)),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimator_matches_jax(name):
    est = ESTIMATORS[name]
    p = np.random.default_rng(0).uniform(-1.3, 1.3, (20000, 3)).astype(np.float32)
    want = np.asarray(JT._de_distance(est, jnp.asarray(p)))
    got = TT.de_distance(est, torch.as_tensor(p)).numpy()
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert (rel <= 1e-3).mean() >= 0.99, np.quantile(rel, 0.99)


def _rays(n=4096, seed=1):
    """Rays from around examples/fractal.lua's eye (2.4, 1.6, 2.4) toward
    points of [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    origin = np.array([2.4, 1.6, 2.4]) + rng.normal(scale=0.05, size=(n, 3))
    direction = rng.uniform(-1.0, 1.0, (n, 3)) - origin
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return origin.astype(np.float32), direction.astype(np.float32)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("omega", [1.6, 1.0])
@pytest.mark.parametrize("bounds", ["box", "sphere"])
@pytest.mark.parametrize("name", ["mandelbulb", "julia_cubic"])
def test_march_matches_jax(monkeypatch, name, bounds, omega, mode):
    kind, a, b = BOUNDS[bounds]
    est = ESTIMATORS[name]
    monkeypatch.setenv("PYRITE_TPU_PALLAS", "0" if mode == "xla" else "interpret")
    monkeypatch.setenv("PYRITE_TPU_DE_OMEGA", str(omega))
    origin, direction = _rays()
    ok_j, t_j, _ = JT._intersect_de(
        JaxDEShape(est, kind, a, b, 0), jnp.asarray(origin), jnp.asarray(direction), 200
    )
    ok_j, t_j = np.asarray(ok_j), np.asarray(t_j)
    ok_t, t_t = TT.intersect_de(
        DEShape(est, kind, a, b, 0), torch.as_tensor(origin), torch.as_tensor(direction), 200, omega
    )
    ok_t, t_t = ok_t.numpy(), t_t.numpy()
    assert (ok_j == ok_t).mean() >= 0.995
    both = ok_j & ok_t
    assert both.sum() > 100
    rel = np.abs(t_t[both] - t_j[both]) / np.abs(t_j[both])
    assert (rel > 1e-3).mean() <= 0.001, np.sort(rel)[-5:]
    assert np.isinf(t_t[~ok_t]).all()


def test_march_wrapper_takes_the_plain_version_on_cpu():
    kind, a, b = BOUNDS["box"]
    shape = DEShape(MANDELBULB, kind, a, b, 0)
    origin, direction = (torch.as_tensor(x) for x in _rays(256))
    hit, tmin, tmax, center = TT._de_bounds(shape, origin, direction)
    t0 = torch.where(hit, tmin, torch.inf)
    before = dict(kernels.launches)
    args = (MANDELBULB, origin - center, direction, t0, tmax, hit, 200)
    total, dist = kernels.march_de(*args)
    assert kernels.launches == before
    want_total, want_dist = TT.march_de_plain(*args)
    assert torch.equal(total, want_total) and torch.equal(dist, want_dist)
    ok, t = TT.intersect_de(shape, origin, direction, 200, march=kernels.march_de)
    assert torch.equal(t, torch.where(hit & (total <= tmax), total, torch.inf))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels.march_de(*(x.to("meta") if isinstance(x, torch.Tensor) else x for x in args))


def test_march_stops_at_max_steps_and_tmax():
    """A lane leaves the march at max_steps, or on reaching tmax; the
    relaxed step never leaps past tmax."""
    kind, a, b = BOUNDS["sphere"]
    shape = DEShape(JULIA, kind, a, b, 0)
    origin, direction = (torch.as_tensor(x) for x in _rays(512, seed=4))
    hit, tmin, tmax, center = TT._de_bounds(shape, origin, direction)
    t0 = torch.where(hit, tmin, torch.inf)
    one, _ = TT.march_de_plain(JULIA, origin - center, direction, t0, tmax, hit, 1)
    assert torch.equal(one[~hit], t0[~hit])
    assert bool((one[hit] > t0[hit]).all())
    full, dist = TT.march_de_plain(JULIA, origin - center, direction, t0, tmax, hit, 200)
    stopped = hit & (dist < TT.DIST_EPSILON)
    assert bool((full[stopped] <= tmax[stopped]).all()) and int(stopped.sum()) > 50


def test_pack_takes_a_de_scene_without_primitives(tmp_path):
    """The julia scene has planes and a DE shape only: the pack lays the
    shape's fields out in its DE rows, as DE_FIELDS orders them."""
    scene = torch_build(torch_load(chip_smoke.write_julia_scene(str(tmp_path), 32, 32)), "cpu")
    assert scene.num_primitives == 0 and len(scene.de_shapes) == 1 and scene.num_planes == 1
    pack = scene.dense_pack
    meta, sheet = pack["meta"], pack["sheet"]
    assert meta["n_prims"] == 0 and meta["n_de"] == 1
    shape = scene.de_shapes[0]
    fields = dict(zip(kernels_dense.DE_FIELDS, sheet[[meta["de_" + f] for f in kernels_dense.DE_FIELDS], 0]))
    assert fields["kind"] == 1 and fields["variant"] == 1 and fields["iterations"] == 25
    assert fields["thr2"] == 16.0 and fields["bounds_kind"] == 1 and fields["bx"] == 1.5
    np.testing.assert_array_equal([fields[f"c{i}"] for i in range(4)], shape.estimator["constant"])
    np.testing.assert_array_equal([fields[f"c{c}"] for c in "xyz"], shape.center)
    assert fields["mat"] == shape.material_id
    np.testing.assert_array_equal(kernels_dense.de_fields(shape), list(fields.values()))


def test_shadow_rule_matches_jax_self_occlusion():
    """On examples/fractal.lua, shadow rays from the Mandelbulb toward the
    lamp are blocked by the Mandelbulb itself in the JAX package (its
    shadow march takes hits at any t, from the surface on); the port
    reproduces the blocked share within one percentage point."""
    path = os.path.join(ROOT, "examples", "fractal.lua")
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    sj, st = jax_build(pj), torch_build(torch_load(path), "cpu")
    cfg = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, oj, dj, _ = jax_chunk_rays(
        film, JaxCamera.from_ir(pj.project.camera), cfg, jnp.asarray([0, 5], jnp.uint32),
        row0=im.height // 2 - 4, rows=8,
    )
    hit = JT.intersect_scene(sj, oj, dj, cfg)
    de = np.asarray(hit["kind"]) == JT.KIND_DE
    assert de.sum() > 1000
    o, d, t = np.asarray(oj)[de], np.asarray(dj)[de], np.asarray(hit["t"])[de]
    position = o + d * t[:, None]
    lamp = np.asarray(sj.arrays["sph_center"])[0]
    to_lamp = lamp - position
    distance = np.linalg.norm(to_lamp, axis=1)
    direction = (to_lamp / distance[:, None]).astype(np.float32)
    max_dist = (distance - float(np.asarray(sj.arrays["sph_radius"])[0])).astype(np.float32)

    def blocked(t_hit):
        t_hit = np.asarray(t_hit)
        return np.isfinite(t_hit) & (t_hit * t_hit < max_dist * max_dist - TT.DIST_EPSILON)

    want = blocked(JT.intersect_shadow(
        sj, jnp.asarray(position), jnp.asarray(direction), cfg, max_dist=jnp.asarray(max_dist)
    ))
    got = blocked(TT.intersect_shadow(
        st, torch.as_tensor(position), torch.as_tensor(direction), torch.as_tensor(max_dist)
    ))
    assert want.mean() > 0.9  # the reference's self-occlusion (ROADMAP.md queue 3)
    assert abs(want.mean() - got.mean()) <= 0.01
