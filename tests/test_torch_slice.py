"""The slices end to end on the CPU: trace_paths and one render step of both
packages with identical draws, and the port's CLI from .lua to PNG, on dense
scenes, on scenes with distance-estimated shapes (examples/fractal.lua and
the julia scene at 32x32, S = 4, 3 bounces) and on mesh scenes (terrain_24:
1152 triangles and a sphere lamp; tri_lamp_24: 1154 triangles, two of them
the lamp; terrain_de_24: terrain_24 with a small Mandelbulb), which take the
clustered wide BVH.

trace_paths runs 4 bounces with the JAX side jitted, where fused float
association flips the odd boundary lane and the flip cascades over the
bounces; the tolerances are those of tests/test_kernels_dense.py:133-139
(< 5 % divergent lanes, energy within 1 %, aux_alive agreeing on > 98 %)."""

import os
import subprocess
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
from pyrite_tpu_torch import cli, convert
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.film import Film as TorchFilm
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.renderers import simple as torch_simple
from pyrite_tpu_torch.scene import CameraModel as TorchCamera, build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("slice"))
    return dict(
        chip_smoke.scene_paths(directory),
        **chip_smoke.terrain_paths(directory, cells=(24,), width=48, height=24, spp=2),
        tri_lamp_24=chip_smoke.write_tri_lamp_scene(directory, width=48, height=24, cells=24),
        fractal=chip_smoke.write_fractal_scene(directory, 32, 32, 4, 3),
        julia=chip_smoke.write_julia_scene(directory, 32, 32, 4, 3),
        terrain_de_24=chip_smoke.write_terrain_de_scene(directory),
    )


def _packages(path):
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    film_j = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    film_t = TorchFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    jax_side = (jax_build(pj), film_j, JaxCamera.from_ir(pj.project.camera), cfg_j)
    torch_side = (
        torch_build(torch_load(path), "cpu"), film_t, TorchCamera.from_ir(pj.project.camera), cfg_t
    )
    return jax_side, torch_side


def _bounce_draws(scene, cfg, key, n):
    """The per-bounce draws JAX's trace_paths makes from ``key``."""
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(scene, cfg, k, n))
    return [
        convert.draws_from_numpy(
            {k: np.asarray(v) for k, v in draw(jax.random.fold_in(key, i)).items()}, "cpu")
        for i in range(cfg.bounces)
    ]


@pytest.mark.parametrize(
    "name", ["flagship", "tri_lamp", "terrain_24", "tri_lamp_24", "fractal", "julia", "terrain_de_24"]
)
def test_trace_paths_matches_jax(paths, name):
    (sj, film_j, cam_j, cfg_j), (st, _, _, _) = _packages(paths[name])
    assert st.use_clusters == sj.use_clusters == name.endswith("_24")
    _, oj, dj, wj = jax_simple.chunk_rays(film_j, cam_j, cfg_j, jax.random.PRNGKey(3))
    n = oj.shape[0]
    key = jax.random.PRNGKey(9)
    trace = jax.jit(lambda k, o, d, wl: JT.trace_paths(sj, cfg_j, k, o, d, wl))
    rb, aux_ref = (np.asarray(x) for x in trace(key, oj, dj, wj))
    kb, aux = TT.trace_paths(
        st, TT.TraceConfig(cfg_j.bounces, cfg_j.light_samples, cfg_j.spectrum_samples),
        _bounce_draws(sj, cfg_j, key, n),
        torch.as_tensor(np.array(oj)), torch.as_tensor(np.array(dj)), torch.as_tensor(np.array(wj)),
    )
    kb = kb.numpy()
    lane_bad = (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1)
    assert lane_bad.mean() < 0.05, f"{lane_bad.sum()} divergent lanes"
    assert abs(rb.sum() - kb.sum()) < 0.01 * max(rb.sum(), 1e-6) + 1e-3
    assert (aux_ref == aux.numpy()).mean() > 0.98


@pytest.mark.parametrize("name", ["flagship", "prism", "terrain_24", "fractal", "julia"])
def test_render_step_matches_jax(paths, name):
    (sj, film_j, cam_j, cfg_j), (st, film_t, cam_t, cfg_t) = _packages(paths[name])
    # A DE scene's step covers the whole 32x32 film: a DE normal is a central
    # difference of the estimator, a few ulps off between the packages, and
    # in a 4-row window the one mirror path it turns onto the lamp carries
    # a few percent of the energy
    rows = film_j.height if sj.de_shapes else 4
    n, s = rows * film_j.width, cfg_j.spectrum_samples
    key = jax.random.PRNGKey(21)
    row0 = 0 if sj.de_shapes else film_j.height // 2
    step_j = jax_simple.make_render_step(sj, film_j, cam_j, cfg_j, rows=rows)
    acc_j, wt_j = step_j(*film_j.new_buffers(), key, sj.device_data(), row0)

    fixed = torch_simple.FixedDraws(
        u=[torch.as_tensor(np.array(jax.random.uniform(key, (n, s + 5))))],
        bounces=_bounce_draws(sj, cfg_j, jax.random.fold_in(key, 7), n),
    )
    step_t = torch_simple.make_render_step(st, film_t, cam_t, cfg_t, rows=rows)
    acc_t, wt_t = step_t(*film_t.new_buffers("cpu"), fixed, row0)
    np.testing.assert_array_equal(wt_t.numpy(), np.asarray(wt_j))
    aj, at = np.asarray(acc_j), acc_t.numpy()
    assert abs(aj.sum() - at.sum()) < 0.01 * aj.sum()
    pixel_bad = (np.abs(aj - at) > 1e-4 + 1e-3 * np.abs(aj)).any(axis=2)
    assert pixel_bad.mean() < 0.05


def test_cli_renders_png(paths, tmp_path):
    from PIL import Image

    out = tmp_path / "x.png"
    proc = subprocess.run(
        [sys.executable, "-m", "pyrite_tpu_torch", paths["flagship"], "--samples", "2",
         "--device", "cpu", "--output", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Throughput:" in proc.stdout and "Mrays/s" in proc.stdout
    with Image.open(out) as img:
        assert img.size == (64, 32) and img.mode == "RGB"
        assert np.asarray(img).max() > 0


def test_cli_renders_mesh_png(paths, tmp_path):
    from PIL import Image

    out = tmp_path / "terrain.png"
    before = dict(TT.launches)
    assert cli.main([paths["terrain_24"], "--samples", "2", "--device", "cpu", "--output", str(out)]) == 0
    # path regeneration (the default): every bounce iteration by the plain
    # version
    bounces = TT.launches["bounces"] - before["bounces"]
    assert bounces > 0 and TT.launches["bounce_core"] - before["bounce_core"] == bounces
    with Image.open(out) as img:
        assert img.size == (48, 24) and img.mode == "RGB"
        pixels = np.asarray(img)
    assert pixels.max() > 0 and pixels.mean() > 10


def test_cli_renders_fractal_png(paths, tmp_path):
    """examples/fractal.lua (at 32x32, S = 4, 3 bounces) from .lua to PNG,
    every bounce by the plain version on the CPU."""
    from PIL import Image

    out = tmp_path / "fractal.png"
    before = dict(TT.launches)
    assert cli.main([paths["fractal"], "--samples", "2", "--device", "cpu", "--output", str(out)]) == 0
    bounces = TT.launches["bounces"] - before["bounces"]
    assert bounces > 0 and TT.launches["bounce_core"] - before["bounce_core"] == bounces
    with Image.open(out) as img:
        assert img.size == (32, 32) and img.mode == "RGB"
        assert np.asarray(img).max() > 0


def test_cli_refuses_what_is_not_ported(paths, tmp_path, monkeypatch):
    # --multi-device across several CUDA devices spawns one rank per device
    # (tests/test_torch_cli.py::test_multi_device_is_not_ported,
    # tests/test_torch_parallel.py); without CUDA it raises, and nothing
    # spawns or renders elsewhere; on one device, or on the CPU, it renders
    # as without the flag
    # (tests/test_torch_cli.py::test_multi_device_on_one_device_renders)
    from pyrite_tpu_torch import parallel

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 2)
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(parallel, "spawn", lambda *a, **k: pytest.fail("spawned without CUDA"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([paths["flagship"], "--multi-device"])
    # directional lamps and more than 128 materials render now
    # (tests/test_torch_gate_lamps.py::test_cli_renders_directional_lamps,
    # tests/test_torch_gate_rows.py::test_cli_renders_what_the_gate_refused)
    text = open(paths["flagship"]).read()
    # photon mapping renders now (tests/test_torch_photon.py), and so does
    # bidirectional rendering at 16 camera bounces with path regeneration on
    # (the JAX package's regen BDPT; tests/test_torch_regen_bdpt.py)
    photon = tmp_path / "photon.lua"
    photon.write_text(text.replace("renderer.simple", "renderer.photon_mapping").replace(
        "bounces = 4,", "bounces = 4, photons = 500, photon_bounces = 2,"))
    out = tmp_path / "photon.png"
    assert cli.main([str(photon), "--device", "cpu", "--samples", "1", "--output", str(out)]) == 0
    assert out.exists()
    regen_bdpt = tmp_path / "regen_bdpt.lua"
    regen_bdpt.write_text(text.replace("renderer.simple", "renderer.bidirectional").replace(
        "bounces = 4,", "bounces = 16,"))
    from PIL import Image

    out = tmp_path / "regen_bdpt.png"
    before = bd.counters["regen_bdpt_walks"]
    assert cli.main([str(regen_bdpt), "--device", "cpu", "--samples", "1", "--output", str(out)]) == 0
    assert bd.counters["regen_bdpt_walks"] > before
    with Image.open(out) as img:
        assert img.size == (64, 32) and np.asarray(img).max() > 0


def test_cli_never_moves_to_the_cpu_on_its_own(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([paths["flagship"], "--samples", "1"])
