"""The port's bidirectional renderer on its own, on the CPU
(pyrite_tpu_torch/renderers/bidirectional.py).

Its invariants: the two-phase step (lamp slots compacted to the
connectable ones) equals the fused step (rtol 1e-4 / atol 1e-5, as
tests/test_renderers.py:81-127 holds the JAX package's); the film does not
depend on the rows per chunk (wt equal, acc within rtol 1e-5); a render
checkpointed by the CLI and resumed equals the straight render; with the
splats switched off the camera side tracks the simple renderer (the check
of tests/test_renderers.py:57-72). Also: the keyed draws of the lamp paths
and splats, the CLI from a renderer.bidirectional project to PNG, and
renders of a mesh scene and of the Cornell-class scene (a triangle lamp,
dispersive glass and a DE shape) with every step by the plain version."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu_torch import cli, rng, tracer
from pyrite_tpu_torch.film import Film
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import CameraModel, build_scene
from pyrite_tpu_torch.tracer import TraceConfig

torch.set_num_threads(2)

SCENE = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.%(algo)s {
        pixel_samples = %(spp)d, spectrum_samples = 4, bounces = 4,
        light_samples = 2%(extra)s
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


def _write(tmp_path, algo="bidirectional", spp=4, light_bounces=4, name=None):
    extra = f", light_bounces = {light_bounces}" if algo == "bidirectional" else ""
    path = tmp_path / (name or f"{algo}_{light_bounces}.lua")
    path.write_text(SCENE % {"algo": algo, "spp": spp, "extra": extra})
    return str(path)


def _render(path, spp, seed=3):
    pd = load_project(path)
    return bd.render(pd, build_scene(pd, "cpu"), seed=seed, max_samples=spp)


def _image(film, acc, wt):
    return film.develop(acc, wt).mean(dim=2).numpy()


def test_lamp_and_splat_draws_are_keyed():
    """The new purposes' layout: a splat slot k takes words 0-1 of block k,
    a lamp bounce's draws at depth d are its own (not the camera bounce
    d's), and the words do not depend on the wavefront they ride in."""
    keyed = rng.KeyedDraws(9, sample0=2, samples=1)
    n = 12
    splat = rng.splat_draws(keyed, n, 5, "cpu")
    words = rng.purpose_uniforms(keyed, n, 0, rng.SPLAT, 20, "cpu")
    assert torch.equal(splat, words.view(n, 5, 4)[:, :, :2])
    lamp = rng.lamp_bounce_draws(keyed, n, 1, "cpu")
    camera = rng.bounce_draws(keyed, n, 1, 0, 0, "cpu")
    assert not torch.equal(lamp["u_comp"], camera["u_comp"])
    assert torch.equal(lamp["u_scatter"], rng.purpose_uniforms(keyed, n, 1, rng.LAMP_BOUNCE, 4, "cpu")[:, 1:])
    start = rng.lamp_start_draws(keyed, n, 3, "cpu")
    assert start["words"].shape == (n, 6) and int(start["lamp_idx"].max()) <= 2
    # lanes 4..7 of a shifted window draw what lanes 4..7 of the whole do
    window = rng.lamp_start_draws(rng.KeyedDraws(9, sample0=2, samples=1, pixel0=4), 4, 3, "cpu")
    assert torch.equal(window["words"], start["words"][4:8])


def test_bdpt_runs_and_produces_light(tmp_path):
    before = dict(tracer.launches)
    film, acc, wt = _render(_write(tmp_path, spp=6), 6)
    img = _image(film, acc, wt)
    assert img.max() > 0.05 and np.isfinite(img).all()
    ran = {k: tracer.launches[k] - before[k] for k in before}
    # every step by the plain version on the CPU: 6 starts, bounces, shadow queries
    assert ran["lamp_start"] == 6 and ran["lamp_bounce_step"] == ran["lamp_bounces"] > 0
    assert ran["bounce_core"] > 0 and ran["intersect_shadow"] > 0


def test_two_phase_matches_fused(tmp_path):
    """The two-phase step against the fused one at light_bounces = 24: the
    same keyed draws, connections and splats; only the slot layout
    differs."""
    pd = load_project(_write(tmp_path, light_bounces=24))
    scene = build_scene(pd, "cpu")
    r, im = pd.project.renderer, pd.project.image
    film = Film(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    camera = CameraModel.from_ir(pd.project.camera)
    cfg = TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    draws = rng.KeyedDraws(7, sample0=0, samples=1)

    fused = bd.make_render_step(scene, film, camera, cfg, 24)
    acc_a, wt_a = fused(*film.new_buffers("cpu"), draws)
    lamp_step, cam_step = bd.make_render_step(scene, film, camera, cfg, 24, two_phase=True)
    conn, count, prepared = lamp_step(draws)
    assert int(count) < 25  # a deep budget, short actual paths
    conn_c = bd._compact_connections(conn, max(4, int(count)))
    acc_b, wt_b = cam_step(*film.new_buffers("cpu"), draws, conn_c, 0, prepared)
    assert float(wt_a.sum()) > 0
    torch.testing.assert_close(acc_b, acc_a, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(wt_b, wt_a, rtol=1e-4, atol=1e-5)


def test_render_takes_the_two_phase_step_for_deep_lamp_paths(tmp_path, monkeypatch):
    calls = []
    real = bd._compact_connections
    monkeypatch.setattr(bd, "_compact_connections", lambda conn, k: calls.append(k) or real(conn, k))
    _render(_write(tmp_path, light_bounces=4), 1)
    assert calls == []
    _render(_write(tmp_path, light_bounces=24), 2)
    assert len(calls) == 2 and all(k in (4, 8, 16, 25) for k in calls)


@pytest.mark.parametrize("rows", [5, 4])
def test_film_does_not_depend_on_rows_per_chunk(tmp_path, monkeypatch, rows):
    path = _write(tmp_path)
    _, acc_a, wt_a = _render(path, 3)
    monkeypatch.setattr(bd, "pick_rows_per_chunk", lambda film, light_bounces, s, texture_bytes=0, lane_bytes=0: rows)
    _, acc_b, wt_b = _render(path, 3)
    assert torch.equal(wt_b, wt_a) and float(wt_a.sum()) > 0
    torch.testing.assert_close(acc_b, acc_a, rtol=1e-5, atol=0.0)


def test_rows_per_chunk_fit_the_budget():
    film = Film(512, 512, 50, (380.0, 780.0))
    assert bd.pick_rows_per_chunk(film, 4, 10) == 512  # the Cornell class in one chunk
    rows = bd.pick_rows_per_chunk(film, 255, 16)
    assert 512 % rows == 0 and 1 <= rows < 512
    assert rows * 512 * 256 * (160 + 20 * 16) <= bd._STEP_BYTES


class _Stop(Exception):
    pass


def _cli(monkeypatch, path, *args, stop_after=None):
    """cli.main on the CPU; returns (acc, wt) of its render. ``stop_after``
    n: raise after the n-th progress callback (its checkpoint is written)."""
    render = bd.render
    seen = {"calls": 0}

    def recording(*a, on_progress=None, **k):
        def progress(p):
            on_progress(p)
            seen["calls"] += 1
            if seen["calls"] == stop_after:
                raise _Stop

        film, acc, wt = render(*a, on_progress=progress, **k)
        seen["film"] = (acc.clone(), wt.clone())
        return film, acc, wt

    monkeypatch.setattr(bd, "render", recording)
    out = os.path.join(os.path.dirname(path), "out.png")
    assert cli.main([path, "--device", "cpu", "--output", out, "--preview-interval", "0", *args]) == 0
    return seen["film"]


def test_resumed_render_equals_straight(tmp_path, monkeypatch):
    path = _write(tmp_path)
    straight = _cli(monkeypatch, path, "--samples", "3")
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(_Stop):
        _cli(monkeypatch, path, "--samples", "3", "--checkpoint", ck, stop_after=1)
    with np.load(ck) as f:
        assert int(f["samples_done"]) == 1 and f["lane_samples"].min() == 1
    resumed = _cli(monkeypatch, path, "--samples", "3", "--checkpoint", ck)
    assert torch.equal(resumed[1], straight[1]) and float(straight[1].sum()) > 0
    torch.testing.assert_close(resumed[0], straight[0], rtol=1e-5, atol=0.0)


def test_camera_side_tracks_simple_without_splats(tmp_path, monkeypatch):
    """With the splats off, connections and camera samples still carry
    their own weights, so the films differ per pixel at low spp; but the
    BDPT camera-side transport must track the simple renderer: median
    relative difference of the lit pixels below 0.25 at 250 spp (the JAX
    package's check, tests/test_renderers.py:57-72)."""
    pd = load_project(_write(tmp_path, algo="simple", spp=250))
    monkeypatch.setattr(simple, "regen_enabled", lambda: False)
    film, acc, wt = simple.render(pd, build_scene(pd, "cpu"), seed=3, max_samples=250)
    simple_img = _image(film, acc, wt)
    monkeypatch.setattr(bd, "_light_splats", lambda scene, film, camera, cfg, conn, wl, acc, wt: (acc, wt))
    bdpt_img = _image(*_render(_write(tmp_path, spp=250), 250))
    lit = simple_img > 0.02
    assert lit.sum() > 100
    rel = np.abs(simple_img - bdpt_img)[lit] / simple_img[lit]
    assert np.median(rel) < 0.25


def test_cli_renders_bidirectional_png(tmp_path):
    from PIL import Image

    out = tmp_path / "bdpt.png"
    assert cli.main([_write(tmp_path), "--samples", "2", "--device", "cpu", "--output", str(out)]) == 0
    with Image.open(out) as img:
        assert img.size == (20, 20) and img.mode == "RGB"
        assert np.asarray(img).max() > 0


def test_mesh_scene_renders(tmp_path):
    """terrain_24 (1,152 triangles, a sphere lamp; the wide BVH) through
    bidirectional rendering, every ray by the plain version."""
    import sys

    sys.path.insert(0, chip_smoke.ROOT)
    from tools.synthetic import terrain_scene

    path = terrain_scene(str(tmp_path), cells=24, width=24, height=12, spp=2, bounces=3)[0]
    text = open(path).read().replace("renderer.simple", "renderer.bidirectional")
    bdpt = tmp_path / "terrain_bdpt.lua"
    bdpt.write_text(text.replace("bounces = 3,", "bounces = 3, light_bounces = 3,"))
    pd = load_project(str(bdpt))
    scene = build_scene(pd, "cpu")
    assert scene.use_clusters
    before = dict(bd.counters)
    film, acc, wt = bd.render(pd, scene, seed=2, max_samples=2)
    img = _image(film, acc, wt)
    assert np.isfinite(img).all() and img.max() > 0
    assert int(bd.counters["connection_rays"] - before["connection_rays"]) > 0
    assert int(bd.counters["splat_rays"] - before["splat_rays"]) > 0


def test_cornell_class_renders(tmp_path):
    """The Cornell-class scene (chip_smoke.write_cornell_scene: a triangle
    lamp, dispersive glass, a quaternion Julia) at 8 x 8, S = 4, one
    sample: finite, lit, and its DE shape reached by the lamp walk and the
    connection batches."""
    path = chip_smoke.write_cornell_scene(str(tmp_path), 8, 8, 4, spp=1)
    pd = load_project(path)
    scene = build_scene(pd, "cpu")
    assert scene.de_shapes and not scene.use_clusters and scene.num_triangles == 12
    film, acc, wt = bd.render(pd, scene, seed=1, max_samples=1)
    img = _image(film, acc, wt)
    assert np.isfinite(img).all() and img.max() > 0
    assert float(wt.sum()) >= 8 * 8  # every pixel's hero sample at least
