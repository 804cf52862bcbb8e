"""The port's schedulers on the CPU (pyrite_tpu_torch/renderers/simple.py):
path regeneration and the survivor pool against the one-shot wavefront,
and the indexed draws they take (rng.LaneKeys).

A path draws by its (pixel, sample, bounce, purpose) whichever lane and
wavefront trace it, so regeneration and the pool trace the one-shot
wavefront's paths: their films have wt bit-equal to the one-shot film's and
acc within rtol 1e-5 (float summation order), on a dense scene (flagship, 8
bounces), a 16-bounce scene (examples/prism.lua at 48x27), a mesh scene
(terrain_24) and a DE scene (examples/fractal.lua at 16x16); and the regen
film does not depend on the quota per launch, the soft tail or the lanes per
pixel. adaptive_quotas is held equal to the JAX package's."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu_torch import rng
from pyrite_tpu_torch.film import Film, expose_pixels
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_small_prism(directory, width=48, height=27):
    """examples/prism.lua (16 bounces, one spectrum sample, dispersive
    glass) at ``width`` x ``height``."""
    with open(os.path.join(ROOT, "examples", "prism.lua")) as fh:
        src = fh.read()
    src = src.replace("image = {width = 512, height = 288}",
                      f"image = {{width = {width}, height = {height}}}")
    path = os.path.join(directory, "prism_small.lua")
    with open(path, "w") as fh:
        fh.write(src)
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("schedulers"))
    paths = {
        "flagship": chip_smoke.scene_paths(directory, width=32, height=16, spectrum_samples=4,
                                           bounces=8)["flagship"],
        "prism": write_small_prism(directory),
        "terrain_24": chip_smoke.terrain_paths(directory, cells=(24,), width=32, height=16,
                                               spp=2)["terrain_24"],
        "fractal": chip_smoke.write_fractal_scene(directory, 16, 16, 4, 3),
    }
    out = {}
    for name, path in paths.items():
        project_data = load_project(path)
        out[name] = (project_data, build_scene(project_data, device="cpu"))
    return out


def _render(monkeypatch, scheduler, project_data, scene, spp, seed=3, **kwargs):
    """A render through ``scheduler``: "one-shot", "regen" or "pool"
    (render's own dispatch, with the switches set)."""
    monkeypatch.setattr(simple, "regen_enabled", lambda: scheduler == "regen")
    monkeypatch.setattr(simple, "regen_clusters_enabled", lambda: True)
    monkeypatch.setattr(simple, "POOL_MIN_BOUNCES", 1 if scheduler == "pool" else 10**6)
    _, acc, wt = simple.render(project_data, scene, seed=seed, max_samples=spp, **kwargs)
    return acc, wt


def assert_same_film(got, want):
    """wt bit-equal (sums of ones), acc within rtol 1e-5 (summation order)."""
    (acc, wt), (acc_w, wt_w) = got, want
    assert float(wt.sum()) > 0
    assert torch.equal(wt, wt_w), f"wt differs in {int((wt != wt_w).sum())} bins"
    torch.testing.assert_close(acc, acc_w, rtol=1e-5, atol=0.0)


SPP = {"flagship": 6, "prism": 3, "terrain_24": 3, "fractal": 3}


@pytest.mark.parametrize("scheduler", ["regen", "pool"])
@pytest.mark.parametrize("name", ["flagship", "prism", "terrain_24", "fractal"])
def test_scheduler_film_equals_one_shot(scenes, monkeypatch, name, scheduler):
    """Regeneration and the pool trace the one-shot wavefront's paths. The
    pool runs here with a 2-bounce stage and 3-bounce continuations, so that
    every scene takes its flushes and, on the 16-bounce prism, its shrink
    ladder."""
    project_data, scene = scenes[name]
    monkeypatch.setattr(simple, "STAGE_BOUNCES", 2)
    monkeypatch.setattr(simple, "CONT_BOUNCES", 3)
    one_shot = _render(monkeypatch, "one-shot", project_data, scene, SPP[name])
    before = dict(simple.counters)
    got = _render(monkeypatch, scheduler, project_data, scene, SPP[name])
    key = "regen_launches" if scheduler == "regen" else "pool_flushes"
    assert simple.counters[key] > before[key]
    assert_same_film(got, one_shot)


def test_pool_takes_the_shrink_ladder(scenes, monkeypatch):
    """The prism's pool (16 bounces, 2-bounce stage) shrinks at least once
    and keeps the one-shot film (test above); here the rungs are counted."""
    project_data, scene = scenes["prism"]
    monkeypatch.setattr(simple, "STAGE_BOUNCES", 2)
    monkeypatch.setattr(simple, "CONT_BOUNCES", 3)
    widths = []
    make = simple.make_pooled_steps

    def counting(*args, **kwargs):
        stage, empty_pool, flush_step, shrink, expose_pool = make(*args, **kwargs)

        def counted_shrink(acc, wt, pool, width_to):
            widths.append((pool["valid"].shape[0], width_to))
            return shrink(acc, wt, pool, width_to)

        return stage, empty_pool, flush_step, counted_shrink, expose_pool

    monkeypatch.setattr(simple, "make_pooled_steps", counting)
    _render(monkeypatch, "pool", project_data, scene, 2)
    assert widths and all(to == w // 4 for w, to in widths)


@pytest.mark.parametrize("planes, spp_chunk, tail", [
    (1, None, None), (4, None, None), (8, 4, None), (8, None, 0), (8, 2, 40)],
    ids=["planes1", "planes4", "chunk4", "tail0", "chunk2-tail40"])
def test_regen_film_independent_of_schedule(scenes, monkeypatch, planes, spp_chunk, tail):
    """Lanes per pixel, the quota per launch and the soft tail change which
    launch traces which sample, never the samples: the film stays the
    one-shot film."""
    project_data, scene = scenes["flagship"]
    one_shot = _render(monkeypatch, "one-shot", project_data, scene, SPP["flagship"])
    render_regen = simple._render_regen
    make_step = simple.make_regen_step

    def with_tail(*args, **kwargs):
        step = make_step(*args, **kwargs)
        return step if tail is None else (lambda acc, wt, e, q, _: step(acc, wt, e, q, tail))

    monkeypatch.setattr(simple, "make_regen_step", with_tail)
    monkeypatch.setattr(simple, "_render_regen", lambda *a, **k: render_regen(
        *a, spp_chunk=spp_chunk, planes=planes))
    before = simple.counters["regen_launches"]
    got = _render(monkeypatch, "regen", project_data, scene, SPP["flagship"])
    assert simple.counters["regen_launches"] > before
    assert_same_film(got, one_shot)


def test_regen_same_seed_same_film(scenes, monkeypatch):
    project_data, scene = scenes["terrain_24"]
    first = _render(monkeypatch, "regen", project_data, scene, 2, seed=5)
    again = _render(monkeypatch, "regen", project_data, scene, 2, seed=5)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    other = _render(monkeypatch, "regen", project_data, scene, 2, seed=6)
    assert not torch.equal(first[0], other[0])


def test_regen_counts_lanes(scenes, monkeypatch):
    """A launch's counters: executed = iterations x lanes, live <=
    executed, and live > 0."""
    project_data, scene = scenes["flagship"]
    from pyrite_tpu_torch import tracer

    before = dict(tracer.lane_bounces), dict(simple.counters)
    _render(monkeypatch, "regen", project_data, scene, 4)
    live = tracer.lane_bounces["live"] - before[0]["live"]
    executed = tracer.lane_bounces["executed"] - before[0]["executed"]
    iterations = simple.counters["regen_iterations"] - before[1]["regen_iterations"]
    lanes = 32 * 16 * simple._regen_planes(Film(32, 16, 64, (380.0, 780.0)))
    assert executed == iterations * lanes and 0 < live <= executed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_quotas_matches_jax(seed):
    r = np.random.default_rng(seed)
    rem = r.integers(0, 40, 5000).astype(np.int32)
    rate = r.gamma(2.0, 0.1, 5000).astype(np.float32)
    for target in (4, 20, 160):
        np.testing.assert_array_equal(simple.adaptive_quotas(rem, None, target),
                                      jax_simple.adaptive_quotas(rem, None, target))
        got = simple.adaptive_quotas(rem, rate, target)
        np.testing.assert_array_equal(got, jax_simple.adaptive_quotas(rem, rate, target))
        assert got.dtype == np.int32


@pytest.mark.parametrize("bounce", [0, 3])
def test_indexed_draws_equal_affine(bounce):
    """LaneKeys fed the affine wavefront's indices give its draws bit for
    bit: the camera draws, a bounce's draws at one bounce for all lanes and
    at each lane's own depth, and lane_draws (camera draws on a mask, zeros
    elsewhere)."""
    n_pix, samples, seed = 48, 3, (9 << 32) + 4
    keyed = rng.KeyedDraws(seed, sample0=5, samples=samples, pixel0=16)
    n = n_pix * samples
    lane = torch.arange(n, dtype=torch.int32)
    pixel, sample = 16 + lane % n_pix, 5 + lane // n_pix
    depth = torch.full((n,), bounce, dtype=torch.int32)
    cpu = torch.device("cpu")
    want_cam = rng.camera_uniforms(keyed, n, 6, cpu)
    want = rng.bounce_draws(keyed, n, bounce, 2, 3, cpu)
    assert torch.equal(rng.camera_uniforms(rng.LaneKeys(seed, pixel, sample, depth), n, 6, cpu), want_cam)
    for keys in (rng.LaneKeys(seed, pixel, sample), rng.LaneKeys(seed, pixel, sample, depth)):
        got = rng.bounce_draws(keys, n, bounce, 2, 3, cpu)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    mask = torch.from_numpy(np.random.default_rng(bounce).random(n) < 0.4)
    cam, got = rng.lane_draws(rng.LaneKeys(seed, pixel, sample, depth), 6, 2, 3, mask, cpu)
    assert torch.equal(cam[mask], want_cam[mask]) and not cam[~mask].any()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # a lane's draws are its own: permuted lanes draw permuted rows
    perm = torch.from_numpy(np.random.default_rng(7).permutation(n))
    moved = rng.bounce_draws(rng.LaneKeys(seed, pixel[perm], sample[perm], depth[perm]), n, 0, 2, 3, cpu)
    assert torch.equal(moved["u_scatter"], want["u_scatter"][perm])
    assert torch.equal(moved["u_nee"], want["u_nee"][:, perm])


def test_expose_by_position_and_by_pixel():
    """Film.expose (the JAX package's, keyed by the view position) against
    expose_pixels with the pixel a pool lane carries. Where the position
    stays in its pixel they agree sample for sample. f32 rounding of
    pixel_to_view and back moves a jitter near 1 into the next pixel, or
    off the film: no sample of 20 random jitters per pixel here, but most
    pixels at the largest 24-bit jitter (1 - 2^-24)."""
    film = Film(48, 27, 16, (380.0, 780.0))
    pix = film.width * film.height
    r = np.random.default_rng(0)
    pixel = torch.arange(21 * pix) % pix
    u = torch.from_numpy(r.random((21 * pix, 2), dtype=np.float32))
    u[20 * pix :] = 1.0 - 2.0**-24
    positions = film.pixel_to_view(pixel % film.width + u[:, 0], pixel // film.width + u[:, 1])
    px, py, valid = film.view_to_pixel(positions)
    moved = (py * film.width + px != pixel) | ~valid
    assert not moved[: 20 * pix].any()
    assert int(moved[20 * pix :].sum()) > pix // 2
    step = (px - pixel % film.width).abs() + (py - pixel // film.width).abs()
    assert int(step[valid].max()) <= 2
    n = pixel.shape[0]
    wl = torch.from_numpy(r.uniform(380.0, 780.0, (n, 3)).astype(np.float32))
    bright = torch.from_numpy(r.random((n, 3), dtype=np.float32))
    ones, mask = torch.ones_like(bright), torch.ones_like(bright, dtype=torch.bool)
    keep = ~moved
    acc_p, wt_p = film.expose(*film.new_buffers("cpu"), positions[keep], wl[keep], bright[keep],
                              ones[keep], mask[keep])
    acc_i, wt_i = expose_pixels(film, *film.new_buffers("cpu"), pixel, keep, wl, bright, ones, mask)
    assert torch.equal(wt_p, wt_i)
    torch.testing.assert_close(acc_p, acc_i, rtol=1e-6, atol=0.0)
    _, wt_all = film.expose(*film.new_buffers("cpu"), positions, wl, bright, ones, mask)
    assert float(wt_all.sum()) == 3.0 * int(valid.sum())


def test_resume_counts():
    """Lane counts from a checkpoint: the writer's own planes as they are;
    a prefix of every pixel's samples spread over other planes; a JAX
    package checkpoint's samples_done for every pixel; a non-prefix raises."""
    film = Film(4, 2, 8, (380.0, 780.0))
    pix = 8
    assert (simple.resume_counts(None, 3, film) == 0).all()
    jax_file = {"samples_done": 5}
    np.testing.assert_array_equal(simple.resume_counts(jax_file, 1, film), np.full(pix, 5))
    # 5 samples over 3 planes: samples 0, 3 / 1, 4 / 2
    np.testing.assert_array_equal(simple.resume_counts(jax_file, 3, film).reshape(3, pix),
                                  np.repeat([[2], [2], [1]], pix, axis=1))
    lanes = np.zeros((3, 2, 4), np.int64)
    lanes[:, 0, 0] = (3, 2, 2)  # samples 0, 3, 6 / 1, 4 / 2, 5: the first 7
    lanes[:, 1, 3] = (1, 1, 0)
    port_file = {"samples_done": 0, "lane_samples": lanes}
    np.testing.assert_array_equal(simple.resume_counts(port_file, 3, film), lanes.reshape(-1))
    counts = simple.resume_counts(port_file, 2, film).reshape(2, pix)
    np.testing.assert_array_equal(counts.sum(axis=0), lanes.reshape(3, pix).sum(axis=0))
    assert tuple(counts[:, 0]) == (4, 3) and tuple(counts[:, 7]) == (1, 1)
    lanes[:, 1, 1] = (1, 2, 0)  # samples 0 and 1, 4: not a prefix
    with pytest.raises(ValueError, match="not the first ones"):
        simple.resume_counts(port_file, 2, film)
    assert simple._uniform_start({"samples_done": 4}, film) == 4
    with pytest.raises(ValueError, match="path regeneration"):
        simple._uniform_start({"samples_done": 0, "lane_samples": lanes[:1]}, film)
