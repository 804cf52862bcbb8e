"""The port's bidirectional renderer against the JAX package's on the CPU.

Per lane, on the same inputs through both packages: camera_inverse_project
(also with a lens aperture), expose_sums, the lamp-path factors and
connection arrays, their compaction, a camera bounce's connection query and
fold, and the light-tracing splats given the same shadow-ray t. Per lane
with the JAX package's draws fed in (reproduced by the same jax.random
calls): sample_lamp_ray and trace_lamp_path, on dense scenes (sphere,
triangle and point lamps; the flagship's fresnel mix and dispersive glass),
on a mesh scene (terrain_24, against the jitted JAX walk: ROADMAP.md queue
3, sphere lamps shadow themselves in the eager JAX cluster traversal) and
on the julia scene (a DE shape). Flags and lengths must be exact (a lamp
path's but where it re-hits the surface it just left, see
test_trace_lamp_path_matches_jax); lamp-path vectors within rtol 1e-4 /
atol 1e-5, everything else within rtol 1e-5 / atol 1e-6.

Statistically: the port's BDPT film against the JAX package's on the 20 x
20, S = 4 three-sphere scene of tests/test_renderers.py, each rendered as 16
independent batches of 4 samples (their own seeds: the packages' draws
differ, threefry against keyed Philox). The batches give each film's
standard error; the tolerance is stated below from those errors."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm, expose_sums as jax_expose_sums
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import bidirectional as jbd
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
from pyrite_tpu.scene import camera_inverse_project as jax_inverse_project
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import kernels_dense as kd
from pyrite_tpu_torch.film import Film as TorchFilm, expose_sums
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.scene import CameraModel as TorchCamera, build_scene as torch_build
from pyrite_tpu_torch.scene import camera_inverse_project

torch.set_num_threads(2)

SPHERES = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.bidirectional {
        pixel_samples = 64, spectrum_samples = 4, bounces = 4,
        light_samples = 2, light_bounces = 4
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
    directory = str(tmp_path_factory.mktemp("bdpt_jax"))
    spheres = os.path.join(directory, "spheres.lua")
    with open(spheres, "w") as fh:
        fh.write(SPHERES)
    dense = chip_smoke.scene_paths(directory, width=24, height=12, spectrum_samples=4, bounces=4)
    return {
        "spheres": spheres,
        "flagship": dense["flagship"],
        "tri_lamp": dense["tri_lamp"],
        "terrain_24": chip_smoke.terrain_paths(directory, cells=(24,), width=24, height=12)["terrain_24"],
        "julia": chip_smoke.write_julia_scene(directory, 16, 16, 4, 3),
    }


def T(x):
    """A JAX (or numpy) array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(x))


def _packages(path):
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    jax_side = (jax_build(pj), JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span),
                JaxCamera.from_ir(pj.project.camera),
                JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples))
    torch_side = (torch_build(torch_load(path), "cpu"),
                  TorchFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span),
                  TorchCamera.from_ir(pj.project.camera),
                  TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples))
    return jax_side, torch_side


def _close(got, want, rtol=1e-5, atol=1e-6, where=None, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[np.asarray(where)], want[np.asarray(where)]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _exact(got, want, where=None, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[np.asarray(where)], want[np.asarray(where)]
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("aperture", [0.0, 0.15])
def test_camera_inverse_project_matches_jax(paths, aperture):
    cam_j = JaxCamera.from_ir(jax_load(paths["spheres"]).project.camera)
    cam_j = dataclasses.replace(cam_j, aperture=aperture, focus_distance=5.5)
    cam_t = TorchCamera(cam_j.transform, cam_j.view_plane, cam_j.focus_distance, aperture)
    rng = np.random.default_rng(11)
    targets = rng.uniform([-4, -1, -4], [4, 5, 8], (500, 3)).astype(np.float32)
    u1, u2 = rng.random((2, 500), dtype=np.float32)
    want = jax_inverse_project(cam_j, jnp.asarray(targets), jnp.asarray(u1), jnp.asarray(u2))
    got = camera_inverse_project(cam_t, T(targets), T(u1), T(u2))
    _exact(got[4], want[4], what="ok")
    assert 0 < int(got[4].sum()) < 500
    for k, name in enumerate(("view_xy", "world_origin", "direction", "distance")):
        _close(got[k], want[k], what=name)


def test_expose_sums_matches_jax():
    film_j = JaxFilm(20, 12, 8, (380.0, 780.0))
    film_t = TorchFilm(20, 12, 8, (380.0, 780.0))
    rng = np.random.default_rng(5)
    n, s = 300, 4
    positions = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    wl = rng.uniform(380.0, 780.0, (n, s)).astype(np.float32)
    values = rng.random((n, s), dtype=np.float32)
    weights = rng.random((n, s), dtype=np.float32)
    mask = rng.random((n, s)) < 0.8
    acc_j, wt_j = jax_expose_sums(film_j, *film_j.new_buffers(), jnp.asarray(positions),
                                  jnp.asarray(wl), jnp.asarray(values), jnp.asarray(weights),
                                  jnp.asarray(mask))
    acc_t, wt_t = expose_sums(film_t, *film_t.new_buffers("cpu"), T(positions), T(wl), T(values),
                              T(weights), T(mask))
    assert float(wt_t.sum()) > 0 and float(wt_t.sum()) < float(weights[mask].sum())
    _close(acc_t, acc_j, what="acc")
    _close(wt_t, wt_j, what="wt")


def _start_draws(scene_j, key, n):
    """sample_lamp_ray's and trace_lamp_path's start draws, made from
    ``key`` as the JAX package makes them (tracer.py:1812-1815,
    :1919-1925), for the port: {lamp_idx, u_lamp, u_emis}."""
    k_start, k_emis, _ = jax.random.split(key, 3)
    k_pick, k_u, _ = jax.random.split(k_start, 3)
    return {
        "lamp_idx": T(jax.random.randint(k_pick, (n,), 0, max(scene_j.num_lamps, 1))),
        "u_lamp": T(jax.random.uniform(k_u, (n, 4))),
        "u_emis": T(jax.random.uniform(k_emis, (n,))),
    }


def _lamp_draws(scene_j, key, n, bounces):
    """All of trace_lamp_path's draws from ``key`` (tracer.py:1953-1981)."""
    keys = jax.random.split(jax.random.split(key, 3)[2], bounces)
    steps = []
    for i in range(bounces):
        _, k_comp, k_scatter = jax.random.split(keys[i], 3)
        steps.append({"u_comp": T(jax.random.uniform(k_comp, (n,))),
                      "u_scatter": T(jax.random.uniform(k_scatter, (n, 3)))})
    return {"start": _start_draws(scene_j, key, n), "bounces": steps}


def _wavelengths(film_j, cam_j, cfg_j, seed=3):
    _, _, _, wl = jax_simple.chunk_rays(film_j, cam_j, cfg_j, jax.random.PRNGKey(seed))
    return wl


@pytest.mark.parametrize("name", ["spheres", "tri_lamp", "julia"])
def test_sample_lamp_ray_matches_jax(paths, name):
    (sj, _, _, _), (st, _, _, _) = _packages(paths[name])
    n = 600
    key = jax.random.PRNGKey(17)
    want = JT.sample_lamp_ray(sj, jax.random.split(key, 3)[0], n)
    draws = _start_draws(sj, key, n)
    got = TT.sample_lamp_ray(st, draws["lamp_idx"], draws["u_lamp"])
    for k in ("valid", "is_shape", "surf_mat", "color_prog", "lamp_idx"):
        _exact(got[k], want[k], what=k)
    assert float(got["pick_prob"]) == pytest.approx(float(want["pick_prob"]))
    for k in ("position", "direction", "normal", "weight"):
        _close(got[k], want[k], 1e-4, 1e-5, what=k)


def _jax_path(sj, cfg, key, wl, jit):
    fn = lambda k, w: JT.trace_lamp_path(sj, cfg, k, w)  # noqa: E731
    return (jax.jit(fn) if jit else fn)(key, wl)


def _self_hits(path):
    """[N] flags of the lanes whose lamp path re-hits the surface it just
    left: a valid vertex within 10 DIST_EPSILON of the previous one. Such a
    hit exists only because the ray's root near t = 0 lies above
    DIST_EPSILON by rounding (a ray leaving the radius-50 floor sphere has
    one root at 0, whose f32 error reaches ~1e-4 at shallow angles), and
    which side of DIST_EPSILON it falls on is decided by the last ulp of a
    dot product: the JAX package's dot is a reduction (jnp.sum), the
    port's a fixed ((x + y) + z) (pyrite_tpu_torch/geometry.dot)."""
    pos = np.asarray(path["position"])
    step = np.linalg.norm(pos[:, 1:] - pos[:, :-1], axis=-1)
    return (np.asarray(path["valid"])[:, 1:] & (step < 10 * JT.DIST_EPSILON)).any(axis=1)


@pytest.mark.parametrize("name", ["spheres", "flagship", "tri_lamp", "terrain_24", "julia"])
def test_trace_lamp_path_matches_jax(paths, name, monkeypatch):
    """The port's trace_lamp_path with the JAX walk's draws. Each lamp
    bounce starts from the JAX walk's state at its depth, which the JAX
    record holds (the previous vertex's position, the arriving direction,
    the previous slot's validity): the packages' libm calls (sin, cos,
    arccos of the sampled directions) may differ in a last ulp, and carried
    to the next bounce that ulp could move a hit. The rest of
    trace_lamp_path (start, early end, stacking, padding, brdf_limit,
    length) runs as it is. Flags and lengths are exact on every lane but
    one where either package re-hits the surface it just left
    (_self_hits, at most 2 % of the lanes), where one ulp decides the hit;
    vectors on the other lanes' valid slots."""
    (sj, film_j, cam_j, cfg_j), (st, _, _, _) = _packages(paths[name])
    assert st.use_clusters == (name == "terrain_24")
    light_bounces = 4
    cfg_jl = JT.TraceConfig(light_bounces, 0, cfg_j.spectrum_samples)
    cfg_tl = TT.TraceConfig(light_bounces, 0, cfg_j.spectrum_samples)
    wl = _wavelengths(film_j, cam_j, cfg_j)
    n = wl.shape[0]
    key = jax.random.PRNGKey(23)
    want = _jax_path(sj, cfg_jl, key, wl, jit=st.use_clusters)
    record = {k: T(v) for k, v in want.items()}
    depth = {"i": 0}
    real = kd.lamp_bounce

    def from_jax_state(scene, cfg, wavelengths, state, draws, bank_vals=None):
        i = depth["i"]
        depth["i"] += 1
        jax_state = {"origin": record["position"][:, i], "direction": record["incident_out"][:, i + 1],
                     "alive": record["valid"][:, i]}
        return real(scene, cfg, wavelengths, jax_state, draws, bank_vals)

    monkeypatch.setattr(kd, "lamp_bounce", from_jax_state)
    got = TT.trace_lamp_path(st, cfg_tl, _lamp_draws(sj, key, n, light_bounces), T(wl))
    assert depth["i"] > 1
    parted = _self_hits(want) | _self_hits({k: v.numpy() for k, v in got.items()})
    assert parted.mean() < 0.02
    kept = ~parted
    valid = np.asarray(want["valid"])
    _exact(got["valid"], valid, where=kept, what="valid")
    _exact(got["length"], want["length"], where=kept, what="length")
    assert valid[:, 1].sum() >= 10, "few lamp paths reach a surface"
    both = valid & got["valid"].numpy() & kept[:, None]
    for k in ("is_diffuse", "dispersed", "color_prog"):
        _exact(got[k], want[k], where=both, what=k)
    for k in ("position", "normal", "probability", "brdf"):
        _close(got[k], want[k], 1e-4, 1e-5, where=both, what=k)
    _close(got["incident_out"], want["incident_out"], 1e-4, 1e-5, where=both, what="incident_out")
    last = both[:, -1]
    _close(got["brdf_limit"], want["brdf_limit"], 1e-4, 1e-5, where=last, what="brdf_limit")


def _port_path(path_j):
    return {k: T(v) for k, v in path_j.items()}


def _port_conn(conn_j):
    return {k: T(v) for k, v in conn_j.items()}


@pytest.mark.parametrize("name", ["spheres", "flagship"])
def test_lamp_path_factors_and_compaction_match_jax(paths, name):
    (sj, film_j, cam_j, cfg_j), (st, _, _, _) = _packages(paths[name])
    light_bounces = 6
    wl = _wavelengths(film_j, cam_j, cfg_j)
    key = jax.random.PRNGKey(29)
    path_j = _jax_path(sj, JT.TraceConfig(light_bounces, 0, cfg_j.spectrum_samples), key, wl, False)
    path_t = _port_path(path_j)
    bank = kd.precompute_bank_values(st, T(wl))

    pp_j, aux_j, spec_j, inc_j = jbd._lamp_path_factors(sj, path_j, wl, cfg_j)
    pp_t, aux_t, spec_t, inc_t = bd._lamp_path_factors(st, path_t, T(wl), bank)
    _close(pp_t, pp_j, what="pp")
    _exact(aux_t, aux_j, what="aux_ok")
    _exact(spec_t, spec_j, what="is_specular")
    _close(inc_t, inc_j, what="incident")

    conn_j = jbd._connection_arrays(sj, path_j, wl, cfg_j, jax.random.PRNGKey(31))
    conn_t = bd._connection_arrays(st, path_t, T(wl), T(conn_j["splat_u"]), bank)
    for k in ("aux_ok", "conn_ok", "splat_ok", "length"):
        _exact(conn_t[k], conn_j[k], what=k)
    for k in ("position", "normal", "pp", "splat_u"):
        _close(conn_t[k], conn_j[k], what=k)

    count = int(jbd.connectable_count(conn_j))
    assert int(bd.connectable_count(conn_t)) == count and count > 1
    comp_j = jbd._compact_connections(conn_j, count)
    comp_t = bd._compact_connections(_port_conn(conn_j), count)
    for k in ("aux_ok", "conn_ok", "splat_ok", "length"):
        _exact(comp_t[k], comp_j[k], what=k)
    ok = np.asarray(comp_j["conn_ok"])
    for k in ("position", "normal", "pp", "splat_u"):
        _close(comp_t[k], comp_j[k], where=ok, what=k)


def _camera_bounce(sj, film_j, cam_j, cfg_j):
    """One JAX camera bounce from the camera rays: (new state, info)."""
    _, origin, direction, wl = jax_simple.chunk_rays(film_j, cam_j, cfg_j, jax.random.PRNGKey(3))
    n, s = wl.shape
    state = {
        "origin": origin, "direction": direction,
        "brightness": jnp.zeros((n, s)), "reflectance": jnp.ones((n, s)),
        "alive": jnp.ones(n, bool), "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool), "light_events": jnp.zeros(n, jnp.int32),
    }
    return JT.bounce_core(sj, cfg_j, wl, state, jax.random.PRNGKey(37)), wl


@pytest.mark.parametrize("name", ["spheres", "flagship"])
def test_connections_match_jax(paths, name):
    """_conn_query and, given the JAX package's shadow t, _conn_blocked and
    _conn_fold of one camera bounce against a lamp path's slots."""
    (sj, film_j, cam_j, cfg_j), (st, _, _, _) = _packages(paths[name])
    (new_state, info), wl = _camera_bounce(sj, film_j, cam_j, cfg_j)
    path_j = _jax_path(sj, JT.TraceConfig(4, 0, cfg_j.spectrum_samples), jax.random.PRNGKey(41),
                       wl, False)
    conn_j = jbd._connection_arrays(sj, path_j, wl, cfg_j, jax.random.PRNGKey(43))
    n, slots = conn_j["conn_ok"].shape
    query_j, pack_j = jbd._conn_query(info, conn_j["position"], conn_j["normal"], conn_j["conn_ok"])
    t_hit = JT.intersect_shadow(sj, query_j["origin"], query_j["direction"], cfg_j,
                                max_dist=query_j["max_dist"], block_below=query_j["block_below"])
    blocked_j = jbd._conn_blocked(t_hit, query_j, n, slots)
    zeros = jnp.zeros_like(new_state["brightness"])
    vsum_j, cnt_j = jbd._conn_fold(new_state, info, pack_j, blocked_j, conn_j["pp"],
                                   conn_j["aux_ok"], zeros, zeros)

    info_t = {k: T(v) for k, v in info.items()}
    state_t = {k: T(v) for k, v in new_state.items()}
    conn_t = _port_conn(conn_j)
    query_t, pack_t = bd._conn_query(info_t, conn_t["position"], conn_t["normal"], conn_t["conn_ok"])
    good = np.asarray(query_j["contributes"])
    _exact(query_t["contributes"], good, what="contributes")
    assert good.sum() >= 10
    for k in ("origin", "direction", "max_dist", "block_below"):
        _close(query_t[k], query_j[k], where=good, what=k)
    blocked_t = bd._conn_blocked(T(t_hit), query_t, n, slots)
    _exact(blocked_t.reshape(-1)[T(good)], np.asarray(blocked_j).reshape(-1)[good], what="blocked")
    z = torch.zeros_like(state_t["brightness"])
    vsum_t, cnt_t = bd._conn_fold(state_t, info_t, pack_t, blocked_t, conn_t["pp"], conn_t["aux_ok"],
                                  z, z)
    assert float(cnt_t.sum()) > 0
    _close(cnt_t, cnt_j, what="conn_cnt")
    _close(vsum_t, vsum_j, what="conn_vsum")


@pytest.mark.parametrize("name", ["spheres", "flagship"])
def test_light_splats_match_jax(paths, name, monkeypatch):
    """_light_splats on the same connection arrays, each package's shadow
    query answered with the t the JAX package computes for its splat
    batch."""
    (sj, film_j, cam_j, cfg_j), (st, film_t, cam_t, cfg_t) = _packages(paths[name])
    wl = _wavelengths(film_j, cam_j, cfg_j)
    path_j = _jax_path(sj, JT.TraceConfig(4, 0, cfg_j.spectrum_samples), jax.random.PRNGKey(47),
                       wl, False)
    conn_j = jbd._connection_arrays(sj, path_j, wl, cfg_j, jax.random.PRNGKey(53))
    seen = {}
    real = jbd.intersect_shadow

    def recording(*args, **kwargs):
        seen["t"] = real(*args, **kwargs)
        return seen["t"]

    monkeypatch.setattr(jbd, "intersect_shadow", recording)
    acc_j, wt_j = jbd._light_splats(sj, film_j, cam_j, cfg_j, conn_j, wl, *film_j.new_buffers())
    monkeypatch.setattr(kd, "shadow_query", lambda *a: T(seen["t"]))
    acc_t, wt_t = bd._light_splats(st, film_t, cam_t, cfg_t, _port_conn(conn_j), T(wl),
                                   *film_t.new_buffers("cpu"))
    assert float(wt_t.sum()) > 0
    _close(wt_t, wt_j, what="wt")
    _close(acc_t, acc_j, what="acc")


# --- the films, statistically ---------------------------------------------------

BATCHES, BATCH_SPP = 16, 4


def _lit_means(images, lit):
    return np.asarray([img[lit].mean() for img in images])


def test_bdpt_film_matches_jax_statistically(paths):
    """Each package renders BATCHES independent films of BATCH_SPP samples.
    Their per-batch means over the pixels JAX lights (> 0.02) give each
    package's mean and its standard error (std over batches / sqrt of their
    number); the means must agree within 4 combined standard errors (a
    two-sided t with 30 degrees of freedom passes that at p > 0.999). Per
    pixel, the same statistic must stay within 4 standard errors on at
    least 97 % of the lit pixels (the per-pixel errors of 16 batches are
    themselves noisy; an unbiased estimator exceeds 4 on ~0.1 %)."""
    pj = jax_load(paths["spheres"])
    sj = jax_build(pj)
    r, im = pj.project.renderer, pj.project.image
    film_j = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    step = jbd.make_render_step(sj, film_j, JaxCamera.from_ir(pj.project.camera),
                                JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples),
                                r.light_bounces, film_j.height)
    data = sj.device_data()
    jax_images = []
    for b in range(BATCHES):
        acc, wt = film_j.new_buffers()
        for key in jax.random.split(jax.random.PRNGKey(100 + b), BATCH_SPP):
            acc, wt = step(acc, wt, key, data)
        jax_images.append(np.asarray(film_j.develop(acc, wt)).mean(axis=2))

    pt = torch_load(paths["spheres"])
    st = torch_build(pt, "cpu")
    port_images = []
    for b in range(BATCHES):
        film, acc, wt = bd.render(pt, st, seed=100 + b, max_samples=BATCH_SPP)
        port_images.append(film.develop(acc, wt).mean(dim=2).numpy())

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
