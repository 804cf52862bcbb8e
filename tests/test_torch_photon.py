"""The port's photon renderer (pyrite_tpu_torch/renderers/photon.py)
against the JAX package's (pyrite_tpu/renderers/photon.py) on the CPU.

On the same numpy inputs through both packages: the hash grid
(grid_sort_photons, grid_query, grid_scan_slot) exactly, where the cell
keys' products wrap, photons lie on cell walls and a cell holds more than
_CELL_CAP photons; the exact chains (_log_factors, _chain_eval,
_lamp_chain_counts) at rtol 1e-4, the bound of the JAX package's own test
(tests/test_renderers.py:348). The port's own: the grid against a
brute-force radius search, resume, row chunks, the CLI and the scene gate.
tests/test_torch_photon_gather.py holds photon_batch and the gather to the
JAX package, tests/test_torch_photon_film.py bounce_core(record=True)'s
chain factors per lane and the whole render statistically."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers import photon as jph
from pyrite_tpu.scene import build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli, kernels_dense as kd
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
        pixel_samples = %(spp)d, spectrum_samples = 4, bounces = 4,
        light_samples = 2, photons = 1500, photon_bounces = 4, radius = 0.4%(extra)s
    },
    world = {
        objects = {
            shape.sphere {
                radius = 50, position = vector(0, -50, 0),
                material = {surface = material.diffuse {color = %(floor)s}},
            },
            shape.sphere {
                radius = 1, position = vector(0, 3, 0),
                material = {surface = material.emissive {color = 2}},
            },
            shape.sphere {
                radius = 0.8, position = vector(1.5, 0.8, 0),
                material = {surface = material.diffuse {color = %(ball)s}},
            },
        },
    },
}
"""


def _write(directory, name, spp=4, extra="", floor="0.7", ball="0.4"):
    path = os.path.join(directory, name + ".lua")
    with open(path, "w") as fh:
        fh.write(SPHERES % {"spp": spp, "extra": extra, "floor": floor, "ball": ball})
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("photon"))
    dense = chip_smoke.scene_paths(directory, width=24, height=12, spectrum_samples=4, bounces=4)
    return {
        "spheres": _write(directory, "spheres"),
        # a colour of 0 over 400-450 nm: a chain factor that is 0
        "zero": _write(directory, "zero", ball='spectrum {format = "array", min = 400, max = 700, '
                                             "points = {0, 0, 0.5, 0.9}}"),
        "flagship": dense["flagship"],
    }


def T(x):
    """A JAX (or numpy) array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(x))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _scenes(path):
    return jax_build(jax_load(path)), torch_build(torch_load(path), "cpu")


# --- the hash grid ------------------------------------------------------------------


def _grid_case(case):
    """(photon positions, valid, query positions, radius) of one case, f32."""
    rng = np.random.default_rng({"wrap": 3, "walls": 5, "crowded": 7}[case])
    p, n = 600, 96
    if case == "wrap":  # cells near +-2^22: every key's products wrap in int32
        radius = 0.01
        p_pos = rng.uniform(-4.0e4, 4.0e4, (p, 3))
        q_pos = p_pos[rng.integers(0, p, n)] + rng.uniform(-0.02, 0.02, (n, 3))
    elif case == "walls":  # on cell walls: positions k x radius
        radius = 0.1
        p_pos = rng.integers(-6, 6, (p, 3)) * radius
        q_pos = rng.integers(-6, 6, (n, 3)) * radius
    else:  # 40 photons in one cell, more than the cap of 32
        radius = 0.5
        p_pos = rng.uniform(-2.0, 2.0, (p, 3))
        p_pos[:40] = rng.uniform(0.01, 0.49, (40, 3))
        q_pos = np.concatenate([rng.uniform(0.0, 0.5, (n // 2, 3)), rng.uniform(-2, 2, (n // 2, 3))])
    valid = rng.random(p) > 0.15
    valid[:40] |= case == "crowded"
    return p_pos.astype(np.float32), valid, q_pos.astype(np.float32), radius


@pytest.mark.parametrize("case", ["wrap", "walls", "crowded"])
def test_hash_grid_matches_jax(case):
    """grid_sort_photons, grid_query and every step of grid_scan_slot equal
    the JAX package's (array_equal): the int32 keys whose products wrap,
    the f32 division of a position on a cell wall, and the stable sort that
    decides which 32 of a crowded cell's photons a query takes."""
    p_pos, valid, q_pos, radius = _grid_case(case)
    order_j, keys_j = jph.grid_sort_photons(jnp.asarray(p_pos), jnp.asarray(valid), radius)
    order_t, keys_t = ph.grid_sort_photons(T(p_pos), T(valid), radius)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    starts_j, ckeys_j = jph.grid_query(keys_j, jnp.asarray(q_pos), radius)
    starts_t, ckeys_t = ph.grid_query(keys_t, T(q_pos), radius)
    np.testing.assert_array_equal(ckeys_t.numpy(), np.asarray(ckeys_j))
    np.testing.assert_array_equal(starts_t.numpy(), np.asarray(starts_j))
    found = 0
    scan = jax.jit(lambda k: jph.grid_scan_slot(k, order_j, keys_j, starts_j, ckeys_j,
                                                jnp.asarray(valid), jnp.asarray(p_pos),
                                                jnp.asarray(q_pos), radius))
    for k in range(27 * ph._CELL_CAP):
        pj_j, m_j = scan(k)
        pj_t, m_t = ph.grid_scan_slot(k, order_t, keys_t, starts_t, ckeys_t, T(valid), T(p_pos),
                                      T(q_pos), radius)
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j), err_msg=f"step {k}")
        np.testing.assert_array_equal(pj_t.numpy(), np.asarray(pj_j), err_msg=f"step {k}")
        found += int(m_t.sum())
    assert found > 0
    if case == "wrap":
        assert np.abs(np.floor(p_pos / radius)).max() > 2**21
    if case == "crowded":
        biggest, _, over = ph.cell_occupancy(keys_t)
        assert int(biggest) == 40 and int(over) == 1


def _photon_map(p_pos, valid, values, radius):
    """A photon map of one power column ``values`` in exact mode on a scene
    of no color program, in cell order as build_map makes it."""
    spec = ph.GatherSpec(radius=radius, span=(380.0, 780.0), bins=8, spectrum_samples=1, g_bins=0,
                         exact=True, power_cols=1)
    p = p_pos.shape[0]
    order, keys = ph.grid_sort_photons(T(p_pos), T(valid), radius)
    photons = {"position": T(p_pos), "valid": T(valid), "incident": torch.zeros((p, 3)),
               "power": T(values)[:, None], "wavelength": torch.full((p,), 550.0),
               "dispersed": torch.zeros(p, dtype=torch.bool), "counts": torch.zeros((p, 0)),
               "scalar": torch.ones(p), "log_f": torch.zeros((p, 0)), "neg_f": torch.zeros((p, 0)),
               "zero_f": torch.zeros((p, 0))}
    return spec, dict({k: v[order] for k, v in photons.items()}, keys=keys)


@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_hash_grid_gather_matches_brute_force(route):
    """The port's copy of tests/test_renderers.py:391: the 27-cell scan
    takes exactly the photons within the radius of each query (against an
    O(N P) search) when no cell holds more than the cap; through
    grid_scan_slot ("plain") or kernels_dense.photon_gather on CPU tensors
    ("wrapper", its num_neighbors; the plain version gather_plain)."""
    rng = np.random.default_rng(17)
    p, n, radius = 500, 128, 0.35
    p_pos = rng.uniform(-3, 3, (p, 3)).astype(np.float32)
    valid = rng.random(p) > 0.2
    q_pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    values = rng.random(p).astype(np.float32)
    d2 = ((p_pos[None] - q_pos[:, None]) ** 2).sum(-1)
    in_r = (d2 <= radius * radius) & valid[None]
    _, cell_counts = np.unique(np.floor(p_pos[valid] / radius).astype(int), axis=0,
                               return_counts=True)
    assert cell_counts.max() <= ph._CELL_CAP
    if route == "plain":
        order, keys = ph.grid_sort_photons(T(p_pos), T(valid), radius)
        starts, ckeys = ph.grid_query(keys, T(q_pos), radius)
        total, count = torch.zeros(n), torch.zeros(n, dtype=torch.int64)
        for k in range(27 * ph._CELL_CAP):
            pj, match = ph.grid_scan_slot(k, order, keys, starts, ckeys, T(valid), T(p_pos), T(q_pos),
                                          radius)
            total += torch.where(match, T(values)[pj], 0.0)
            count += match
        np.testing.assert_array_equal(count.numpy(), in_r.sum(1))
        np.testing.assert_allclose(total.numpy(), (values[None] * in_r).sum(1), rtol=1e-5)
        return
    spec, pm = _photon_map(p_pos, valid, values, radius)
    q = {"position": T(q_pos), "normal": torch.zeros((n, 3)), "incident": torch.zeros((n, 3)),
         "valid": torch.ones(n, dtype=torch.bool), "dispersed": torch.zeros(n, dtype=torch.bool),
         "partialR": torch.ones((n, 1)), "lam0": torch.full((n,), 550.0), "lam_f": torch.full((n, 1), 550.0),
         "counts": torch.zeros((n, 0)), "scalar": torch.ones(n), "log_f0": torch.zeros((n, 0)),
         "neg_f0": torch.zeros((n, 0)), "zero_f0": torch.zeros((n, 0)),
         "log_ff": torch.zeros((n, 1, 0)), "neg_ff": torch.zeros((n, 1, 0)),
         "zero_ff": torch.zeros((n, 1, 0))}
    out = kd.photon_gather(spec, pm, q)
    np.testing.assert_array_equal(out["num_neighbors"].numpy(), in_r.sum(1))
    np.testing.assert_array_equal(out["fresh_cnt"].numpy(), in_r.sum(1))


# --- exact chains ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["spheres", "flagship"])
def test_factors_and_chains_match_jax(paths, name):
    """_log_factors at random wavelengths, _chain_eval of random counts and
    _lamp_chain_counts of a lamp path of random slots, against the JAX
    package at rtol
    1e-4 (its own test's bound, tests/test_renderers.py:348); the sign
    flags exactly. Every factor of these scenes is non-zero."""
    sj, st = _scenes(paths[name])
    rng = np.random.default_rng(21)
    m = len(st.color_programs)
    assert m == len(sj.color_programs) > 1
    lam = rng.uniform(380.0, 780.0, (200, 3)).astype(np.float32)
    log_j, neg_j = jph._log_factors(sj, jnp.asarray(lam))
    log_t, neg_t, zero_t = ph._log_factors(st, T(lam))
    assert not bool(zero_t.any())
    np.testing.assert_allclose(log_t.numpy(), np.asarray(log_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(neg_t.numpy(), np.asarray(neg_j))
    counts = rng.integers(0, 4, (200, 3, m)).astype(np.float32)
    scalar = rng.uniform(0.1, 2.0, (200, 3)).astype(np.float32)
    want = jph._chain_eval(jnp.asarray(counts), jnp.asarray(scalar), log_j, neg_j)
    got = ph._chain_eval(T(counts), T(scalar), log_t, neg_t, zero_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # the photon side, on a lamp path of random slots
    slots = 5
    path = {"valid": rng.random((200, slots)) > 0.3,
            "probability": rng.uniform(0.05, 3.0, (200, slots)).astype(np.float32),
            "brdf": rng.uniform(0.0, 2.0, (200, slots)).astype(np.float32),
            "brdf_limit": rng.uniform(0.0, 2.0, 200).astype(np.float32),
            "color_prog": rng.integers(-1, m, (200, slots)).astype(np.int32)}
    want_c, want_s = jph._lamp_chain_counts(sj, {k: jnp.asarray(v) for k, v in path.items()}, m)
    got_c, got_s = ph._lamp_chain_counts(st, {k: T(v) for k, v in path.items()}, m)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4)
    assert np.asarray(want_c).sum() > 0


def test_zero_factor_gives_a_zero_chain(paths):
    """The ball's colour is 0 below 450 nm. The port flags the zero factor
    (log 0, zero flag 1): a chain that holds it (count > 0) is exactly 0,
    one that does not keeps its value. The JAX package clamps |f| to 1e-37
    and gives 1e-37 x the rest for such a chain, not 0 (ROADMAP.md queue 3,
    "Low"); where the factor is absent both agree at rtol 1e-4."""
    sj, st = _scenes(paths["zero"])
    m = len(st.color_programs)
    ball = next(i for i in range(m) if float(st.color_programs[i](
        TT.ProgramInputs(wavelength=torch.tensor([420.0])))) == 0.0)
    lam = torch.tensor([420.0, 600.0])
    log_t, neg_t, zero_t = ph._log_factors(st, lam)
    assert zero_t[0, ball] == 1.0 and zero_t[1, ball] == 0.0 and log_t[0, ball] == 0.0
    counts = torch.zeros((2, 2, m))
    counts[:, 0, ball] = 1.0  # the chain holds the ball once; the other chain does not
    counts[:, 1, (ball + 1) % m] = 2.0
    scalar = torch.full((2, 2), 0.5)
    got = ph._chain_eval(counts, scalar, log_t[:, None], neg_t[:, None], zero_t[:, None])
    assert float(got[0, 0]) == 0.0 and float(got[1, 0]) > 0.0
    log_j, neg_j = jph._log_factors(sj, jnp.asarray(lam.numpy()))
    want = np.asarray(jph._chain_eval(jnp.asarray(counts.numpy()), jnp.asarray(scalar.numpy()),
                                      log_j[:, None], neg_j[:, None]))
    assert 0.0 < want[0, 0] < 1e-30  # the clamp's residue
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, 1], rtol=1e-4)
    np.testing.assert_allclose(got[1, 0].numpy(), want[1, 0], rtol=1e-4)


# --- the renderer ------------------------------------------------------------------------


def test_resumed_render_equals_straight_one_and_chunks_do_not_matter(paths, monkeypatch):
    """Sample by sample the draws are keyed by (seed, sample, pass, photon
    or pixel): a render resumed after its first sample equals the straight
    one (wt bit-equal, acc too: the same adds in the same order), and so
    does a render in chunks of 5 rows."""
    path = paths["spheres"]
    pd = torch_load(path)
    st = torch_build(pd, "cpu")
    film, acc, wt = ph.render(pd, st, seed=7, max_samples=2)
    _, acc1, wt1 = ph.render(pd, st, seed=7, max_samples=1)
    resume = {"acc": acc1.numpy(), "wt": wt1.numpy(), "samples_done": 1}
    _, acc2, wt2 = ph.render(pd, st, seed=7, max_samples=2, resume=resume)
    assert float(wt.sum()) > float(wt1.sum()) > 0
    assert torch.equal(wt2, wt) and torch.equal(acc2, acc)
    monkeypatch.setattr(ph, "pick_rows_per_chunk", lambda *a: 4)
    _, acc3, wt3 = ph.render(pd, st, seed=7, max_samples=2)
    assert torch.equal(wt3, wt) and torch.equal(acc3, acc)


def test_cli_renders_a_photon_project(paths, tmp_path):
    from PIL import Image

    out = tmp_path / "photon.png"
    assert cli.main([paths["spheres"], "--device", "cpu", "--samples", "1", "--output", str(out)]) == 0
    with Image.open(out) as img:
        pixels = np.asarray(img)
    assert pixels.shape == (20, 20, 3) and pixels.max() > 0


def test_gate_refuses_photon_rows_past_shared_memory(paths, tmp_path, monkeypatch):
    """The gate no longer refuses photon mapping's rows: at S = 6 and 128
    film bins, interpolation mode's camera walk takes S + G = 134 columns
    and its lamp walk 129, past the 110 the kernels' shared memory held
    before, and the scene builds in the kGate form (past 16 columns its
    kernels stream their rows), every kernel's shared memory as at 64 bins'
    70 columns but the gather's (its 2 B bins); exact mode (S = 6, one lamp
    column) builds in the simple form."""
    text = open(paths["spheres"]).read().replace("spectrum_samples = 4", "spectrum_samples = 6")
    wide = tmp_path / "wide.lua"
    wide.write_text(text.replace("radius = 0.4", "radius = 0.4, spectrum_resolution = 128"))
    monkeypatch.setenv("PYRITE_TPU_PHOTON_EXACT", "0")
    st_wide = torch_build(torch_load(str(wide)), "cpu")
    assert st_wide.photon_widths == {"exact": False, "camera": 134, "lamp": 129, "bins": 128}
    assert st_wide.dense_pack["form"] == kd.FORM_GATE
    narrow = tmp_path / "narrow.lua"
    narrow.write_text(text)
    st = torch_build(torch_load(str(narrow)), "cpu")
    assert st.photon_widths == {"exact": False, "camera": 70, "lamp": 65, "bins": 64}
    assert st.dense_pack["form"] == kd.FORM_GATE
    held = {k: v for k, v in st.dense_pack["smem"].items() if k != "gather"}
    assert {k: v for k, v in st_wide.dense_pack["smem"].items() if k != "gather"} == held
    assert st_wide.dense_pack["smem"]["gather"] == kd.gather_smem_bytes(128, 6)
    monkeypatch.setenv("PYRITE_TPU_PHOTON_EXACT", "1")
    st = torch_build(torch_load(str(wide)), "cpu")
    assert st.photon_widths == {"exact": True, "camera": 6, "lamp": 1, "bins": 128}
    assert st.dense_pack["form"] == kd.FORM_SIMPLE
