"""The port's schedulers held statistically to the JAX package's, at the JAX
package's own thresholds (tests/test_renderers.py:507-610): port regen
against JAX regen on the small three-sphere scene (50 spp) and on a mesh
scene (terrain_24 at 24x12, 8 spp), port pool against the JAX one-shot
wavefront on the same scene at 20 bounces (48 spp). Exact total film weight
(no dispersive material), median relative difference of the lit pixels
below 0.15 and their mean within rtol 0.05 (0.2 and 0.08 on the mesh
scene). The draws differ (threefry against keyed Philox), so no test here
asks for bits."""

import os
import sys

import numpy as np
import torch

from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import build_scene as jax_build
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.simple {
        pixel_samples = %(spp)d, spectrum_samples = 4, bounces = %(bounces)d,
        light_samples = 2
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


def _write(tmp_path, spp, bounces):
    path = tmp_path / f"spheres_{bounces}.lua"
    path.write_text(SCENE % {"spp": spp, "bounces": bounces})
    return str(path)


def _jax_image(monkeypatch, path, spp, seed, regen):
    monkeypatch.setattr(jax_simple, "regen_enabled", lambda: regen)
    monkeypatch.setattr(jax_simple, "regen_clusters_enabled", lambda: True)
    monkeypatch.setattr(jax_simple, "POOL_MIN_BOUNCES", 10**6)
    pd = jax_load(path)
    film, acc, wt = jax_simple.render(pd, jax_build(pd), seed=seed, max_samples=spp)
    return np.asarray(film.develop(acc, wt)).mean(axis=2), float(np.asarray(wt).sum())


def _port_image(monkeypatch, path, spp, seed, regen):
    monkeypatch.setattr(simple, "regen_enabled", lambda: regen)
    monkeypatch.setattr(simple, "regen_clusters_enabled", lambda: True)
    pd = torch_load(path)
    before = dict(simple.counters)
    film, acc, wt = simple.render(pd, torch_build(pd, device="cpu"), seed=seed, max_samples=spp)
    ran = {k: simple.counters[k] - before[k] for k in before}
    return film.develop(acc, wt).mean(dim=2).numpy(), float(wt.sum()), ran


def _hold(img_port, img_jax, median, mean_rtol):
    lit = img_jax > 0.02
    assert lit.sum() > 40
    rel = np.abs(img_port - img_jax)[lit] / img_jax[lit]
    assert np.median(rel) < median, f"median rel {np.median(rel):.3f}"
    np.testing.assert_allclose(img_port[lit].mean(), img_jax[lit].mean(), rtol=mean_rtol)


def test_port_regen_matches_jax_regen(tmp_path, monkeypatch):
    path = _write(tmp_path, 50, 4)
    img_j, wt_j = _jax_image(monkeypatch, path, 50, 5, regen=True)
    img_t, wt_t, ran = _port_image(monkeypatch, path, 50, 5, regen=True)
    assert ran["regen_launches"] > 0
    expect_wt = 50 * 20 * 20 * 4
    assert wt_j == expect_wt and wt_t == expect_wt
    _hold(img_t, img_j, 0.15, 0.05)


def test_port_pool_matches_jax_one_shot(tmp_path, monkeypatch):
    path = _write(tmp_path, 48, 20)
    img_j, wt_j = _jax_image(monkeypatch, path, 48, 3, regen=False)
    img_t, wt_t, ran = _port_image(monkeypatch, path, 48, 3, regen=False)
    assert ran["pool_stages"] == 48 and ran["pool_flushes"] > 0
    expect_wt = 48 * 20 * 20 * 4
    assert wt_j == expect_wt and wt_t == expect_wt
    _hold(img_t, img_j, 0.15, 0.05)


def test_port_regen_matches_jax_regen_on_mesh(tmp_path, monkeypatch):
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene

    path = terrain_scene(str(tmp_path), cells=24, width=24, height=12, spp=8, bounces=3)[0]
    img_j, wt_j = _jax_image(monkeypatch, path, 8, 2, regen=True)
    img_t, wt_t, ran = _port_image(monkeypatch, path, 8, 2, regen=True)
    assert ran["regen_launches"] > 0
    s = torch_load(path).project.renderer.spectrum_samples
    expect_wt = 8 * 24 * 12 * s
    np.testing.assert_allclose(wt_j, expect_wt, rtol=1e-6)
    assert wt_t == expect_wt
    _hold(img_t, img_j, 0.2, 0.08)
