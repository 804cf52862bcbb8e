"""The widened scene gate on the CPU: scenes of 129 to 1024 finite
primitives take the clustered wide BVH, whose closest hit is held per lane to
the JAX package's brute-force sweep (tracer.py:350-353 there); those scenes
and the textures-class scene (chip_smoke.write_textures_scene: image
textures, normal maps, a fresnel colour, a textured lamp, a ray-reading
sky) render from .lua to PNG under the simple renderer's three schedulers
and the bidirectional renderer. What stays refused is checked by
tests/test_torch_slice.py::test_cli_refuses_what_is_not_ported."""

import os
import sys

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import bidirectional as bd, simple
from pyrite_tpu_torch.scene import CLUSTER_THRESHOLD, build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("gate"))
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene

    return {
        "terrain_162": terrain_scene(directory, cells=9, width=32, height=16, spp=2)[0],
        "spheres_300": chip_smoke.write_spheres_scene(directory, 300),
        "textures": chip_smoke.write_textures_scene(directory, 24, 16, 4, 3, spp=2),
        "textures_512": chip_smoke.write_textures_scene(directory, 24, 16, 4, 3, spp=2,
                                                        tiles=(16, 16)),
        "textures_bdpt": chip_smoke.write_textures_scene(directory, 24, 16, 4, 3, spp=2,
                                                         renderer="bidirectional"),
    }


@pytest.mark.parametrize("name,prims", [("terrain_162", 163), ("spheres_300", 301)])
def test_mid_size_closest_hit_matches_jax_sweep(paths, name, prims):
    """The wide BVH's closest hit (the plain walk, tracer.cluster_traverse)
    against the JAX package's brute-force sweep of the same scene, per lane
    on the camera rays and on random rays through the scene: kind and index
    equal and t within rtol 1e-6 on every lane but exact ties (two hits
    whose t agree within that rtol, which either order may take)."""
    st = torch_build(torch_load(paths[name]), "cpu")
    pj = jax_load(paths[name])
    sj = jax_build(pj)
    assert st.num_primitives == prims > CLUSTER_THRESHOLD and st.use_clusters
    assert not sj.use_clusters  # the JAX package sweeps up to 1024 brute force
    r, im = pj.project.renderer, pj.project.image
    cfg = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, o, d, _ = jax_simple.chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg,
                                        jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    ro = np.asarray(o)[rng.integers(0, o.shape[0], 2000)] + rng.normal(size=(2000, 3)).astype(
        np.float32)
    rd = rng.normal(size=(2000, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    origin = np.concatenate([np.asarray(o), ro]).astype(np.float32)
    direction = np.concatenate([np.asarray(d), rd]).astype(np.float32)
    want = JT.intersect_scene(sj, jax.numpy.asarray(origin), jax.numpy.asarray(direction), cfg)
    got = TT.intersect_scene(st, torch.as_tensor(origin), torch.as_tensor(direction))
    t_j, t_t = np.asarray(want["t"]), got["t"].numpy()
    hit = np.isfinite(t_j)
    np.testing.assert_array_equal(np.isfinite(t_t), hit)
    assert hit.mean() > 0.15
    same = (np.asarray(want["kind"]) == got["kind"].numpy()) & (
        np.asarray(want["idx"]) == got["idx"].numpy())
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=1e-6)
    # where the two take another primitive, its t must tie the other's:
    # both primitives are hit at the same t (rtol 1e-6)
    assert (~same[hit]).mean() < 0.01, (~same[hit]).sum()


@pytest.mark.parametrize("name", ["terrain_162", "spheres_300", "textures", "textures_512"])
@pytest.mark.parametrize("which", ["regen", "pool", "one-shot"])
def test_cli_renders_to_png(paths, tmp_path, name, which):
    """The CLI from .lua to PNG on the CPU through each of the simple
    renderer's schedulers (chip_smoke.scheduler), every bounce iteration by
    the plain version (bounce_core)."""
    from PIL import Image

    out = tmp_path / f"{name}.png"
    before = dict(TT.launches)
    stages = simple.counters["pool_stages"]
    with chip_smoke.scheduler(which, stage=2, cont=1):
        assert cli.main([paths[name], "--samples", "2", "--device", "cpu", "--output", str(out)]) == 0
    bounces = TT.launches["bounces"] - before["bounces"]
    if which == "pool":
        assert simple.counters["pool_stages"] > stages
        assert TT.launches["bounce_core"] > before["bounce_core"]
    else:
        assert bounces > 0 and TT.launches["bounce_core"] - before["bounce_core"] == bounces
    with Image.open(out) as img:
        pixels = np.asarray(img)
    assert pixels.shape[2] == 3 and pixels.max() > 0


def test_cli_renders_textures_bidirectional(paths, tmp_path):
    """The textures scene through the bidirectional renderer: its lamp
    walk, connections and splats by the plain versions on the CPU, the
    lamp vertices' colours at their uv (the scene's lamp is textured)."""
    from PIL import Image

    out = tmp_path / "textures_bdpt.png"
    before = dict(TT.launches)
    steps = bd.counters["steps"]
    assert cli.main([paths["textures_bdpt"], "--device", "cpu", "--output", str(out)]) == 0
    assert bd.counters["steps"] > steps
    assert TT.launches["lamp_bounce_step"] > before["lamp_bounce_step"]
    with Image.open(out) as img:
        assert img.size == (24, 16) and np.asarray(img).max() > 0
