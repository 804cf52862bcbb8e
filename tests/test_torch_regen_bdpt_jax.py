"""The port's camera-regeneration BDPT scheduler against the JAX package's
on the CPU (pyrite_tpu_torch/renderers/bidirectional.py, make_regen_launch;
pyrite_tpu/renderers/bidirectional.py, _render_regen_bdpt).

Per function on the same inputs: _accumulate_lane_sums (rtol 1e-6) and
stack_rounds' padding of compacted rounds (exactly, the 3/4 rule included).
The films statistically, as tests/test_torch_bdpt_jax.py holds the one-shot
films: 16 batches of 4 samples a package (their draws differ: threefry
against keyed Philox), their lit means within 4 combined standard errors,
per pixel at least 97 % of the lit pixels within 4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import bidirectional as jbd
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
from pyrite_tpu.tracer import TraceConfig as JaxConfig
from pyrite_tpu_torch.film import Film
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.scene import build_scene

torch.set_num_threads(2)

# the three-sphere scene of tests/test_torch_bdpt.py
SPHERES = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.bidirectional {
        pixel_samples = 64, spectrum_samples = 4, bounces = 4,
        light_samples = 2, light_bounces = 4%s
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
    """The scene with the default 64 spectral bins, and with 4."""
    directory = tmp_path_factory.mktemp("regen_bdpt_jax")
    out = {}
    for name, extra in (("spheres", ""), ("spheres_4_bins", ", spectrum_resolution = 4")):
        out[name] = str(directory / (name + ".lua"))
        with open(out[name], "w") as fh:
            fh.write(SPHERES % extra)
    return out


def test_accumulate_lane_sums_matches_jax():
    gen = np.random.default_rng(4)
    n, s, bins = 64, 6, 40
    span = (380.0, 780.0)
    wl = gen.uniform(*span, (n, s)).astype(np.float32)
    v, w = gen.uniform(0, 2, (2, n, s)).astype(np.float32)
    acc_l, wt_l = gen.uniform(0, 1, (2, n, bins)).astype(np.float32)
    got = bd._accumulate_lane_sums(Film(8, 8, bins, span), *map(torch.from_numpy, (acc_l, wt_l, wl, v, w)))
    want = jbd._accumulate_lane_sums(JaxFilm(8, 8, bins, span), *map(jnp.asarray, (acc_l, wt_l, wl, v, w)))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("widths, k_max", [((2, 3, 1), 3), ((2, 7), 8)])
def test_stack_rounds_matches_jax(paths, widths, k_max):
    """Compacted rounds of 7 lamp bounces (8 slots) padded to the widest,
    or to all 8 once the widest passes 6 (the 3/4 rule)."""
    gen = np.random.default_rng(2)
    n, s, lb = 5, 4, 7
    rounds = []
    for k in widths:
        rounds.append({"position": gen.normal(size=(n, k, 3)), "normal": gen.normal(size=(n, k, 3)),
                       "pp": gen.uniform(size=(n, k, s)), "aux_ok": gen.uniform(size=(n, k)) < 0.5,
                       "conn_ok": gen.uniform(size=(n, k)) < 0.5,
                       "splat_ok": gen.uniform(size=(n, k)) < 0.5,
                       "splat_u": gen.uniform(size=(n, k, 2)),
                       "length": gen.integers(1, k + 1, size=n).astype(np.int32)})
        rounds[-1] = {f: (x.astype(np.float32) if x.dtype == np.float64 else x)
                      for f, x in rounds[-1].items()}
    wls = [gen.uniform(380, 780, (n, s)).astype(np.float32) for _ in widths]
    got, got_wl = bd.stack_rounds([{f: torch.from_numpy(x) for f, x in r.items()} for r in rounds],
                                  [torch.from_numpy(x) for x in wls], lb)
    pj = jax_load(paths["spheres"])
    r, im = pj.project.renderer, pj.project.image
    steps = jbd.make_regen_bdpt_steps(
        jax_build(pj), JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span),
        JaxCamera.from_ir(pj.project.camera), JaxConfig(r.bounces, r.light_samples, s), lb,
        im.height, rounds=len(widths), jit=False)
    want, want_wl = steps["stack"]([{f: jnp.asarray(x) for f, x in r.items()} for r in rounds],
                                   [jnp.asarray(x) for x in wls])
    assert set(got) == set(want) and got["conn_ok"].shape[2] == k_max
    for f in want:
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    assert np.array_equal(got_wl.numpy(), np.asarray(want_wl))


BATCHES = 16
BATCH_SPP = 4


def _lit_means(images, lit):
    return np.asarray([img[lit].mean() for img in images])


def test_regen_film_matches_jax_statistically(paths, monkeypatch):
    """Each package renders BATCHES independent films of BATCH_SPP samples
    through its regen scheduler (the JAX package's _render_regen_bdpt, its
    step set made once and reused across the batches): the statistic of
    tests/test_torch_bdpt_jax.py::test_bdpt_film_matches_jax_statistically,
    on a film of 4 spectral bins, one a wavelength stratum (S = 4). The JAX
    package sub-stratifies a launch's wavelengths over its rounds, which
    fills more of a pixel's 64 bins with 16 wavelengths than the port's
    independent strata do, and a developed film reads an empty bin as 0:
    at 64 bins its regen film's lit mean lies several standard errors above
    its own one-shot film's on this scene, while the port's regen film holds
    to that one-shot film (tests/test_torch_regen_bdpt_bins.py). With a bin
    a stratum neither package leaves a bin empty, and only the estimator is
    compared."""
    pj = jax_load(paths["spheres_4_bins"])
    sj = jax_build(pj)
    r, im = pj.project.renderer, pj.project.image
    film_j = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    cfg_j = JaxConfig(r.bounces, r.light_samples, r.spectrum_samples)
    made = {}
    real = jbd.make_regen_bdpt_steps

    def once(*a, rounds, **k):
        if rounds not in made:
            made[rounds] = real(*a, rounds=rounds, **k)
        return made[rounds]

    monkeypatch.setattr(jbd, "make_regen_bdpt_steps", once)
    data = sj.device_data()
    jax_images = []
    for b in range(BATCHES):
        acc, wt = film_j.new_buffers()
        _, acc, wt = jbd._render_regen_bdpt(sj, film_j, JaxCamera.from_ir(pj.project.camera), cfg_j,
                                            r.light_bounces, im.height, acc, wt, data, 100 + b, 0,
                                            BATCH_SPP, None)
        jax_images.append(np.asarray(film_j.develop(acc, wt)).mean(axis=2))
    assert list(made) == [BATCH_SPP]

    pt = load_project(paths["spheres_4_bins"])
    st = build_scene(pt, "cpu")
    monkeypatch.setattr(bd, "REGEN_BDPT_MIN_BOUNCES", 1)
    before = bd.counters["regen_bdpt_walks"]
    port_images = []
    for b in range(BATCHES):
        film, acc, wt = bd.render(pt, st, seed=100 + b, max_samples=BATCH_SPP)
        port_images.append(film.develop(acc, wt).mean(dim=2).numpy())
    assert bd.counters["regen_bdpt_walks"] - before == BATCHES

    jax_mean = np.mean(jax_images, axis=0)
    lit = jax_mean > 0.02
    assert lit.sum() > 100
    mj, mp = _lit_means(jax_images, lit), _lit_means(port_images, lit)
    se = np.sqrt(mj.var(ddof=1) / BATCHES + mp.var(ddof=1) / BATCHES)
    z = (mp.mean() - mj.mean()) / se
    assert abs(z) < 4.0, f"lit mean {mp.mean():.5f} against {mj.mean():.5f}, z = {z:.2f}"
    pj_img, pp_img = np.asarray(jax_images), np.asarray(port_images)
    se_pix = np.sqrt(pj_img.var(axis=0, ddof=1) / BATCHES + pp_img.var(axis=0, ddof=1) / BATCHES)
    z_pix = np.abs(pp_img.mean(axis=0) - pj_img.mean(axis=0))[lit] / np.maximum(se_pix[lit], 1e-12)
    assert (z_pix > 4.0).mean() < 0.03, f"{(z_pix > 4.0).sum()} of {lit.sum()} pixels beyond 4 SE"
