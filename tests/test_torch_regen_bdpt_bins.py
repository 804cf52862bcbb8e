"""The regen BDPT films at the film's default 64 spectral bins on the CPU:
why tests/test_torch_regen_bdpt_jax.py holds the port's regen film to the
JAX package's regen film on a film of 4 bins.

The JAX package's _render_regen_bdpt sub-stratifies a launch's wavelengths
over its rounds ((r + u) / R), which fills more of a pixel's 64 bins with
its wavelengths than independent strata do, and a developed film reads an
empty bin as 0: its regen film's lit mean reads above its own one-shot
film's (a known deviation, ROADMAP.md queue 3). The port's regen draws are
its one-shot draws, so its regen film holds to the JAX package's one-shot
film at 64 bins. The statistic of
tests/test_torch_bdpt_jax.py::test_bdpt_film_matches_jax_statistically:
16 batches of 4 samples a film, the lit means within 4 combined standard
errors and at least 97 % of the lit pixels within 4 per pixel; the JAX
package's regen film is beyond 4 from its one-shot film. ``pytest -s``
prints each film's lit mean and standard error and each comparison's z."""

import jax
import numpy as np
import torch

from pyrite_tpu.tracer import TraceConfig as JaxConfig
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.scene import build_scene
from test_torch_regen_bdpt_jax import (BATCH_SPP, BATCHES, SPHERES, JaxCamera, JaxFilm, jax_build,
                                       jax_load, jbd)

torch.set_num_threads(2)


def _jax_films(path, monkeypatch):
    """BATCHES developed films (mean over RGB) of the JAX package's one-shot
    step and of its _render_regen_bdpt, seeds 100 + b."""
    pj = jax_load(path)
    sj = jax_build(pj)
    r, im = pj.project.renderer, pj.project.image
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    camera = JaxCamera.from_ir(pj.project.camera)
    cfg = JaxConfig(r.bounces, r.light_samples, r.spectrum_samples)
    data = sj.device_data()
    step = jbd.make_render_step(sj, film, camera, cfg, r.light_bounces, film.height)
    one_shot, regen = [], []
    for b in range(BATCHES):
        acc, wt = film.new_buffers()
        for key in jax.random.split(jax.random.PRNGKey(100 + b), BATCH_SPP):
            acc, wt = step(acc, wt, key, data)
        one_shot.append(np.asarray(film.develop(acc, wt)).mean(axis=2))
    steps = jbd.make_regen_bdpt_steps(sj, film, camera, cfg, r.light_bounces, im.height,
                                      rounds=BATCH_SPP)
    monkeypatch.setattr(jbd, "make_regen_bdpt_steps", lambda *a, **k: steps)  # one set for all
    for b in range(BATCHES):
        acc, wt = film.new_buffers()
        _, acc, wt = jbd._render_regen_bdpt(sj, film, camera, cfg, r.light_bounces, im.height, acc,
                                            wt, data, 100 + b, 0, BATCH_SPP, None)
        regen.append(np.asarray(film.develop(acc, wt)).mean(axis=2))
    return np.asarray(one_shot), np.asarray(regen)


def _compare(a, b, lit):
    """(z of the lit means, the share of lit pixels beyond 4 SE)."""
    ma, mb = a[:, lit].mean(axis=1), b[:, lit].mean(axis=1)
    z = (ma.mean() - mb.mean()) / np.sqrt(ma.var(ddof=1) / BATCHES + mb.var(ddof=1) / BATCHES)
    se_pix = np.sqrt(a.var(axis=0, ddof=1) / BATCHES + b.var(axis=0, ddof=1) / BATCHES)
    z_pix = np.abs(a.mean(axis=0) - b.mean(axis=0))[lit] / np.maximum(se_pix[lit], 1e-12)
    return float(z), float((z_pix > 4.0).mean())


def test_regen_film_at_64_bins_holds_to_jax_one_shot(tmp_path, monkeypatch):
    path = str(tmp_path / "spheres.lua")
    with open(path, "w") as fh:
        fh.write(SPHERES % "")
    jax_one_shot, jax_regen = _jax_films(path, monkeypatch)

    pt = load_project(path)
    assert pt.project.renderer.spectrum_bins == 64
    st = build_scene(pt, "cpu")
    monkeypatch.setattr(bd, "REGEN_BDPT_MIN_BOUNCES", 1)
    before = bd.counters["regen_bdpt_walks"]
    port = []
    for b in range(BATCHES):
        film, acc, wt = bd.render(pt, st, seed=100 + b, max_samples=BATCH_SPP)
        port.append(film.develop(acc, wt).mean(dim=2).numpy())
    assert bd.counters["regen_bdpt_walks"] - before == BATCHES
    port = np.asarray(port)

    lit = jax_one_shot.mean(axis=0) > 0.02
    assert lit.sum() > 100
    films = {"JAX one-shot": jax_one_shot, "JAX regen": jax_regen, "port regen": port}
    for name, f in films.items():
        m = f[:, lit].mean(axis=1)
        print(f"{name}: lit mean {m.mean():.5f}, SE {m.std(ddof=1) / np.sqrt(BATCHES):.5f} "
              f"({lit.sum()} lit pixels, {BATCHES} batches of {BATCH_SPP} samples)")
    z, share = _compare(port, jax_one_shot, lit)
    print(f"port regen against JAX one-shot: z = {z:.2f}, {share:.4f} of lit pixels beyond 4 SE")
    assert abs(z) < 4.0 and share < 0.03, (z, share)
    z, share = _compare(jax_regen, jax_one_shot, lit)
    print(f"JAX regen against JAX one-shot: z = {z:.2f}, {share:.4f} of lit pixels beyond 4 SE")
    assert z > 4.0, (z, share)
