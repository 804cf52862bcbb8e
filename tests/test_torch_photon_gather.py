"""The photon renderer's photon batches and gather against the JAX
package's on the CPU, on the three-sphere scene of tests/test_renderers.py
as a photon project: photon_batch from the JAX walk's lamp-path draws and
wavelengths (flags exact, vectors rtol 1e-4 / atol 1e-5, as the lamp paths
of tests/test_torch_bdpt_jax.py), and the gather with its three exposures
from the same recorded camera vertices, photons and fresh wavelengths (the
film at rtol 1e-5 / atol 1e-7), in exact and interpolation modes. The JAX
photons are made once per mode and shared by the two tests."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import bidirectional as jbd
from pyrite_tpu.renderers import photon as jph
from pyrite_tpu.renderers import simple as jax_simple
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import kernels_dense as kd
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import photon as ph
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

# the three-sphere scene of tests/test_renderers.py as a photon project
SPHERES = """
return {
    image = {width = 20, height = 20},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.photon_mapping {
        pixel_samples = 4, spectrum_samples = 4, bounces = 4,
        light_samples = 2, photons = 1500, photon_bounces = 4, radius = 0.4
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
    spheres = os.path.join(str(tmp_path_factory.mktemp("photon_gather")), "spheres.lua")
    with open(spheres, "w") as fh:
        fh.write(SPHERES)
    return {"spheres": spheres}


def T(x):
    """A JAX (or numpy) array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(x))


def _scenes(path):
    return jax_build(jax_load(path)), torch_build(torch_load(path), "cpu")


def _film_camera_cfg(sj, path):
    r = jax_load(path).project
    rr, im = r.renderer, r.image
    return (JaxFilm(im.width, im.height, rr.spectrum_bins, rr.spectrum_span),
            JaxCamera.from_ir(r.camera), JT.TraceConfig(rr.bounces, rr.light_samples, rr.spectrum_samples))


def _lamp_draws(sj, key, n, bounces):
    """trace_lamp_path's draws from ``key`` as the JAX package makes them
    (tracer.py:1812-1815, :1919-1925, :1953-1981), for the port."""
    k_start, k_emis, k_walk = jax.random.split(key, 3)
    k_pick, k_u, _ = jax.random.split(k_start, 3)
    steps = []
    for k in jax.random.split(k_walk, bounces):
        _, k_comp, k_scatter = jax.random.split(k, 3)
        steps.append({"u_comp": T(jax.random.uniform(k_comp, (n,))),
                      "u_scatter": T(jax.random.uniform(k_scatter, (n, 3)))})
    start = {"lamp_idx": T(jax.random.randint(k_pick, (n,), 0, max(sj.num_lamps, 1))),
             "u_lamp": T(jax.random.uniform(k_u, (n, 4))), "u_emis": T(jax.random.uniform(k_emis, (n,)))}
    return {"start": start, "bounces": steps}


_PHOTONS = {}


def _jax_photons(sj, path_j, exact, count, key):
    """The JAX package's photon_batch (photon.py:580-631), made from its own
    functions, its lamp walk jitted: (the photons, the lamp path, its
    wavelengths, the walk's key); made once per mode and shared by the
    tests below."""
    if exact not in _PHOTONS:
        _PHOTONS[exact] = _make_jax_photons(sj, path_j, exact, count, key)
    return _PHOTONS[exact]


def _make_jax_photons(sj, path_j, exact, count, key):
    pd = jax_load(path_j)
    r = pd.project.renderer
    lo, hi = r.spectrum_span
    b = r.spectrum_bins
    photon_cfg = JT.TraceConfig(r.photon_bounces, 0, r.spectrum_samples)
    k_wl, k_path = jax.random.split(key)
    lam_p = jax.random.uniform(k_wl, (count, 1), minval=lo, maxval=hi)
    centers = jnp.asarray([lo + (i + 0.5) * (hi - lo) / b for i in range(b)])
    wl = lam_p if exact else jnp.concatenate([lam_p, jnp.broadcast_to(centers[None], (count, b))], 1)
    path = jax.jit(lambda k, w: JT.trace_lamp_path(sj, photon_cfg, k, w))(k_path, wl)
    slots = path["valid"].shape[1]
    pp, _, _, inc = jbd._lamp_path_factors(sj, path, wl, photon_cfg)
    power = path["probability"][:, :, None] * jnp.concatenate([jnp.ones_like(pp[:, :1]), pp[:, :-1]], 1)
    flat = lambda x: x.reshape((count * slots,) + x.shape[2:])  # noqa: E731
    out = {"position": flat(path["position"]), "incident": flat(inc),
           "power": power.reshape(count * slots, wl.shape[1]),
           "wavelength": flat(jnp.broadcast_to(lam_p, (count, slots))),
           "valid": flat(path["valid"] & path["is_diffuse"]), "dispersed": flat(path["dispersed"]),
           "darkness_denom": float(r.bounces * r.photon_passes)}
    if exact:
        counts, ps = jph._lamp_chain_counts(sj, path, len(sj.color_programs))
        out["counts"], out["scalar"] = flat(counts), flat(path["probability"] * ps)
    return out, path, lam_p, k_path


PHOTONS = 1500  # the photons of a batch, as the spheres project asks


def _self_hits(path):
    """Lanes whose lamp path re-hits the surface it just left (within 10
    DIST_EPSILON): there one ulp decides the hit (tests/test_torch_bdpt_jax.py)."""
    pos = np.asarray(path["position"])
    step = np.linalg.norm(pos[:, 1:] - pos[:, :-1], axis=-1)
    return (np.asarray(path["valid"])[:, 1:] & (step < 10 * JT.DIST_EPSILON)).any(axis=1)


@pytest.mark.parametrize("exact", [True, False])
def test_photon_batch_matches_jax(paths, exact, monkeypatch):
    """photon_batch from the JAX walk's draws and wavelengths: each lamp
    bounce from the JAX walk's state at its depth (as
    tests/test_torch_bdpt_jax.py::test_trace_lamp_path_matches_jax, which
    says why; the JAX walk jitted), every photon's valid and dispersed flags exact and its power
    (all columns in interpolation mode), counts, scalar, position and
    incident direction within rtol 1e-4 / atol 1e-5, but the lanes where either package re-hits the surface it
    just left."""
    monkeypatch.setenv("PYRITE_TPU_PHOTON_EXACT", "1" if exact else "0")
    path = paths["spheres"]
    sj, st = _scenes(path)
    count = PHOTONS
    want, path_j, lam_p, k_path = _jax_photons(sj, path, exact, count, jax.random.PRNGKey(43))
    record = {k: T(v) for k, v in path_j.items()}
    depth = {"i": 0}
    real = kd.lamp_bounce

    def from_jax_state(scene, cfg, wavelengths, state, draws, bank_vals=None):
        i = depth["i"]
        depth["i"] += 1
        return real(scene, cfg, wavelengths, {"origin": record["position"][:, i],
                                              "direction": record["incident_out"][:, i + 1],
                                              "alive": record["valid"][:, i]}, draws, bank_vals)

    monkeypatch.setattr(kd, "lamp_bounce", from_jax_state)
    spec, parts = _spec(st, path)
    assert spec.exact == exact
    photon_cfg = TT.TraceConfig(4, 0, 4)
    got = ph.photon_batch(st, photon_cfg, _lamp_draws(sj, k_path, count, 4), T(lam_p), spec, parts[-1])
    slots = photon_cfg.bounces + 1
    port_path = {"position": got["position"].numpy().reshape(count, slots, 3),
                 "valid": got["valid"].numpy().reshape(count, slots)}
    keep = np.repeat(~(_self_hits(path_j) | _self_hits(port_path)), slots)
    assert keep.mean() > 0.98
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy()[keep], valid[keep])
    both = valid & keep
    assert both.sum() > 100
    np.testing.assert_array_equal(got["dispersed"].numpy()[both], np.asarray(want["dispersed"])[both])
    keys = ("power", "wavelength", "position", "incident") + (("counts", "scalar") if exact else ())
    for k in keys:
        np.testing.assert_allclose(got[k].numpy()[both], np.asarray(want[k])[both], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _spec(st, path):
    parts = ph._build_parts(torch_load(path), st)
    return parts[4], parts


@pytest.mark.parametrize("exact", [True, False])
def test_gather_matches_jax(paths, exact, monkeypatch):
    """The gather and its three exposures (photon.py:310-517) from the same
    inputs: the JAX package's recorded camera vertices and photons, and its
    fresh wavelengths (its jax.random draws handed over); the film's acc
    and wt at rtol 1e-5 / atol 1e-7: the same adds in the same order, the
    chains' exp and log from two libms."""
    monkeypatch.setenv("PYRITE_TPU_PHOTON_EXACT", "1" if exact else "0")
    path = paths["spheres"]
    sj, st = _scenes(path)
    film_j, cam_j, cfg_j = _film_camera_cfg(sj, path)
    spec, parts = _spec(st, path)
    film_t = parts[0]
    r = jax_load(path).project.renderer
    s, b = r.spectrum_samples, r.spectrum_bins
    g = spec.g_bins
    assert g == (0 if exact else 64)
    key = jax.random.PRNGKey(41)
    positions, origin, direction, wl = jax_simple.chunk_rays(film_j, cam_j, cfg_j, key)
    n = wl.shape[0]
    lo, hi = r.spectrum_span
    grid = jnp.asarray([lo + (i + 0.5) * (hi - lo) / g for i in range(g)])
    wl_ext = wl if exact else jnp.concatenate([wl, jnp.broadcast_to(grid[None], (n, g))], 1)
    _, cam = jph._record_camera_vertices(sj, cfg_j, jax.random.fold_in(key, 3), origin, direction,
                                         wl_ext, chain_m=len(sj.color_programs) if exact else None)
    photons, _, _, _ = _jax_photons(sj, path, exact, PHOTONS, jax.random.PRNGKey(43))
    k_lam = jax.random.PRNGKey(47)
    prob = 1.0 / (r.bounces * r.photon_bounces * r.photon_passes)
    gather = jax.jit(lambda cam, photons, acc, wt: jph._gather(
        sj, film_j, cfg_j, r.radius, prob, cam, wl_ext, (s, g), k_lam, photons, acc, wt, positions,
        exact=exact))
    acc_j, wt_j = gather(cam, photons, *film_j.new_buffers())

    def fresh(i):
        kb = jax.random.fold_in(k_lam, i)
        return (T(jax.random.uniform(kb, (n, s), minval=lo, maxval=hi)),
                T(jax.random.uniform(jax.random.fold_in(kb, 1), (n, s + 1), minval=lo, maxval=hi)))

    cam_t = {k: T(v) for k, v in cam.items()}
    vertices = [{k: v[:, i] for k, v in cam_t.items()} for i in range(cfg_j.bounces)]
    pm = ph.build_map(st, {k: T(v) for k, v in photons.items() if k != "darkness_denom"}, spec)
    acc_t, wt_t = ph._gather(st, film_t, spec, prob, photons["darkness_denom"], vertices, T(wl_ext),
                             fresh, pm, *film_t.new_buffers("cpu"), T(positions))
    assert float(wt_t.sum()) > 0 and float((acc_t > 0).sum()) > 20
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5, atol=1e-7)


def _jax_edge_gather(spec, photons, q):
    """The gather of a hand-built map by the JAX package's own enumeration:
    (num_neighbors, fresh_cnt, acc_bins, cnt_bins, fresh_psum).

    Taken from the JAX package: the slots, grid_prepare then grid_scan_slot
    over its 27 x _CELL_CAP steps (pyrite_tpu/renderers/photon.py:266-289);
    the chain values, interp_cols and _chain_eval; the film bin,
    Film.wavelength_to_bin. Written out again here in float32 numpy, as the
    body of the JAX package's _gather (:395-452) does it, since that body is
    a closure over a scene and a film and takes no hand-built map: each
    pair's geometry weight and its adds in step order. One rule is the
    port's and not the JAX package's: the factors come in the port's
    encoding (log |f|, a sign flag and a zero flag), where the JAX package
    clamps |f| to 1e-37 and has no zero flag, so a chain with a zero
    factor is set to exactly 0, as the port's _chain_eval sets it."""
    P = {k: np.asarray(v) for k, v in photons.items()}
    Q = {k: np.asarray(v) for k, v in q.items()}
    n, b, k_fresh, g = Q["position"].shape[0], spec.bins, spec.spectrum_samples, spec.g_bins
    film = JaxFilm(1, 1, b, spec.span)
    f32 = np.float32
    order, sorted_keys, starts, ckeys = jph.grid_prepare(P["position"], P["valid"], Q["position"],
                                                         spec.radius)
    scan = jax.jit(jph.grid_scan_slot)
    valid, cam_disp = Q["valid"], Q["dispersed"]
    nrm = Q["normal"]

    def dot(x, y):
        return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]

    def chain(counts, scalar, log_f, neg_f, zero_f):
        value = np.asarray(jph._chain_eval(counts, scalar, log_f, neg_f))
        return np.where((counts * zero_f).sum(-1) > 0, f32(0), value)

    cos_cam = np.maximum(dot(Q["incident"], -nrm), f32(0))
    num = np.zeros(n, np.int64)
    fresh_cnt = np.zeros(n, np.int64)
    acc, cnt = np.zeros((n, b), f32), np.zeros((n, b), f32)
    fresh = np.zeros((n, k_fresh), f32)
    lanes = np.arange(n)
    for step in range(27 * jph._CELL_CAP):
        pj, match = (np.asarray(x) for x in scan(step, order, sorted_keys, starts, ckeys, P["valid"],
                                                 P["position"], Q["position"], spec.radius))
        match = match & valid
        num += match
        p_disp = P["dispersed"][pj]
        pair = match & ~(cam_disp & p_disp)
        clear = pair & ~cam_disp & ~p_disp
        exit_dir = -P["incident"][pj]
        w_geom = np.maximum(dot(exit_dir, nrm), f32(0)) * cos_cam / f32(np.pi)
        gw = f32(2) * np.abs(dot(nrm, exit_dir)) * w_geom
        row = P["power"][pj]
        lam_p = P["wavelength"][pj]
        if spec.exact:
            r_sel = np.where(cam_disp, Q["partialR"][:, 0], chain(
                Q["counts"], Q["scalar"], P["log_f"][pj], P["neg_f"][pj], P["zero_f"][pj]))
            p_sel = np.where(cam_disp, chain(P["counts"][pj], P["scalar"][pj], Q["log_f0"],
                                             Q["neg_f0"], Q["zero_f0"]), row[:, 0])
            p_f = chain(P["counts"][pj][:, None], P["scalar"][pj][:, None], Q["log_ff"],
                        Q["neg_ff"], Q["zero_ff"])
        else:
            s = spec.spectrum_samples
            r_grid = Q["partialR"][:, s:s + g]
            r_sel = np.where(cam_disp, Q["partialR"][:, 0],
                             np.asarray(jph.interp_cols(r_grid, spec.span, lam_p)))
            p_sel = np.where(cam_disp, np.asarray(jph.interp_cols(row[:, 1:], spec.span, Q["lam0"])),
                             row[:, 0])
            p_f = np.asarray(jph.interp_cols(row[:, 1:], spec.span, Q["lam_f"]))
        lam_sel = np.where(cam_disp, Q["lam0"], lam_p)
        j = np.asarray(film.wavelength_to_bin(lam_sel))
        acc[lanes[pair], j[pair]] += (r_sel * p_sel * gw)[pair]
        cnt[lanes[pair], j[pair]] += f32(1)
        fresh[clear] += p_f[clear] * gw[clear][:, None]
        fresh_cnt += clear
    return num, fresh_cnt, acc, cnt, fresh


@pytest.mark.parametrize("name", chip_smoke.EDGE_MAPS)
def test_gather_edge_maps_match_jax(name):
    """gather_plain (photon_gather's CPU path, the kernel's reference on the
    card) on the hand-built maps of chip_smoke.gather_edge_maps, against
    the JAX package's grid enumeration of the same photons and queries:
    num_neighbors and fresh_cnt equal, acc_bins, cnt_bins and fresh_psum
    within test_gather_matches_jax's rtol 1e-5 / atol 1e-7. Each map shows
    the edge it is made for: the scan's clipped duplicates of the last
    photon counted (all_valid), the cap of _CELL_CAP photons a cell
    (over_cap), cells with wrapped key products (negative), photons at
    exactly the radius counted and one ulp past it not (at_radius), and a
    512-bin film in exact mode (bins_512)."""
    spec, photons, q = chip_smoke.gather_edge_maps()[name]
    got = ph.gather_plain(spec, chip_smoke.sorted_map(photons, spec), q)
    num, fresh_cnt, acc, cnt, fresh = _jax_edge_gather(spec, photons, q)
    np.testing.assert_array_equal(got["num_neighbors"].numpy(), num)
    np.testing.assert_array_equal(got["fresh_cnt"].numpy(), fresh_cnt)
    for key, want in (("acc_bins", acc), ("cnt_bins", cnt), ("fresh_psum", fresh)):
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-5, atol=1e-7, err_msg=key)
    assert cnt.sum() > 100 and (fresh_cnt > 0).any()
    # what each map is made for, counted by brute force over the photons
    pos, q_pos = photons["position"].numpy(), q["position"].numpy()
    d2 = ((pos[None] - q_pos[:, None]) ** 2).sum(-1)
    inside = ((d2 <= spec.radius ** 2) & photons["valid"].numpy()[None]).sum(1)
    inside = np.where(q["valid"].numpy(), inside, 0)
    if name == "all_valid":
        assert (num > inside).any(), "no query counted the clipped duplicates"
    elif name == "over_cap":
        assert (num < inside).any(), "no query met the cap"
    elif name == "at_radius":
        assert (num > 0).sum() > 30 and np.array_equal(num, inside)
        assert (np.abs(d2 - 0.25) < 1e-12).sum() >= 40
    elif name == "negative":
        cells = np.floor(q_pos / spec.radius)
        assert (cells < -29).any() and (num[cells.min(1) < -29] > 0).any()
    else:
        assert spec.exact and spec.bins == 512
