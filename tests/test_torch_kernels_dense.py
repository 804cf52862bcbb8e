"""The port's plain bounce (tracer.bounce_core, the plain version of the
CUDA bounce and NEE kernels) against the JAX package's tracer.bounce_core,
fed the same state and the same draws; bounce_dense's routing.

Each bounce starts from the JAX state (re-synced after each check), so
float-association noise at a binary decision cannot cascade across bounces.
Tolerances are those of tests/test_kernels_dense.py: flags exact, vectors and
reflectance rtol 1e-3 / atol 1e-4, and brightness per lane with < 1.5 %
divergent lanes and total energy within 0.5 %, because float association
flips a few NEE shadow tests at the lamp's epsilon margin."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers.simple import chunk_rays as jax_chunk_rays
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import convert, kernels_dense
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.film import Film as TorchFilm
from pyrite_tpu_torch.renderers.simple import chunk_rays as torch_chunk_rays
from pyrite_tpu_torch.rng import KeyedDraws
from pyrite_tpu_torch.scene import CameraModel as TorchCamera, build_scene as torch_build

torch.set_num_threads(2)

SCENES = ["flagship", "prism", "tri_lamp", "many_materials"]
# mesh scenes: the bounce walks the clustered wide BVH
MESHES = ["terrain_24", "tri_lamp_24"]
LANES = 2048


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("kd"))
    return dict(
        chip_smoke.scene_paths(directory),
        **chip_smoke.terrain_paths(directory, cells=(24,), width=64, height=32),
        tri_lamp_24=chip_smoke.write_tri_lamp_scene(directory, cells=24),
    )


def _to_torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _setup(path, key):
    """Both packages' scenes, config and the same primary rays."""
    pj = jax_load(path)
    r, im = pj.project.renderer, pj.project.image
    sj = jax_build(pj)
    st = torch_build(torch_load(path), "cpu")
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    rows = max(1, LANES // im.width)
    n, s = rows * im.width, r.spectrum_samples
    film_j = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    film_t = TorchFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    row0 = im.height // 3
    u = np.array(jax.random.uniform(key, (n, s + 5)))
    _, oj, dj, wj = jax_chunk_rays(
        film_j, JaxCamera.from_ir(pj.project.camera), cfg_j, key, row0=row0, rows=rows
    )
    _, ot, dt, wt = torch_chunk_rays(
        film_t, TorchCamera.from_ir(pj.project.camera), cfg_t, torch.as_tensor(u),
        row0=row0, rows=rows,
    )
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    return sj, st, cfg_j, cfg_t, (oj, dj, wj)


def assert_bounce_close(ref, got, what):
    for k in ("alive", "aux_alive", "sample_light", "light_events"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")
    for k in ("origin", "direction", "reflectance"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-4, err_msg=f"{what}: {k}")
    rb, kb = ref["brightness"], got["brightness"]
    lane_bad = (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1)
    assert lane_bad.mean() < 0.015, f"{what}: {lane_bad.sum()} divergent lanes"
    assert abs(rb.sum() - kb.sum()) < 0.005 * max(rb.sum(), 1e-6) + 1e-3, (
        f"{what}: energy {rb.sum():.4f} vs {kb.sum():.4f}"
    )


@pytest.mark.parametrize("name", SCENES + MESHES)
def test_plain_bounce_matches_jax(paths, name):
    sj, st, cfg_j, cfg_t, (oj, dj, wj) = _setup(paths[name], jax.random.PRNGKey(11))
    assert st.use_clusters == sj.use_clusters == (name in MESHES)
    n, s = wj.shape
    # eager, op by op: under jit XLA fuses and reassociates, which flips the
    # odd grazing lane (a self-hit on the radius-50 ground sphere) one way or
    # the other; eager JAX and the port then agree flag for flag
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(sj, cfg_j, k, n))
    ref = {
        "origin": oj, "direction": dj,
        "brightness": jnp.zeros((n, s)), "reflectance": jnp.ones((n, s)),
        "alive": jnp.ones(n, bool), "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool), "light_events": jnp.zeros(n, jnp.int32),
    }
    # On a mesh scene JAX is jitted instead. Eager, its traversal meets the
    # sphere lamp a few ulps short of sample_lamp's distance (t / distance
    # ~ 1 - 1.5e-6 at distances near 15), more than DIST_EPSILON = 1e-4 on
    # the squared distance absorbs, and about a fifth of terrain_24's NEE
    # lanes shadow themselves; jitted as one bounce it agrees with the port
    # lane for lane. The port's sample_lamp and sphere test share one op
    # order, so there t * t equals the squared lamp distance exactly.
    jax_bounce = lambda st_, k: JT.bounce_core(sj, cfg_j, wj, st_, k)[0]
    if name in MESHES:
        jax_bounce = jax.jit(jax_bounce)
    wl_t = torch.as_tensor(np.array(wj))
    for b in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy({k: np.asarray(v) for k, v in draw(key).items()}, "cpu")
        got = TT.bounce_core(st, cfg_t, wl_t, _to_torch(ref), draws)
        ref = jax_bounce(ref, key)
        assert_bounce_close(
            {k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()},
            f"{name} bounce {b}",
        )


def test_bounce_dense_takes_the_plain_version_on_cpu(paths):
    st = torch_build(torch_load(paths["prism"]), "cpu")
    cfg = TT.TraceConfig(bounces=2, light_samples=1, spectrum_samples=1)
    n = 64
    origin = torch.zeros((n, 3)) + torch.tensor([0.0, 3.0, 10.0])
    normal = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    direction = torch.nn.functional.normalize(torch.as_tensor(normal), dim=1)
    wl = torch.full((n, 1), 550.0)
    state = TT.initial_state(origin, direction, 1)
    draws = TT.draw_bounce_uniforms(st, cfg, n, KeyedDraws(0), 0, "cpu")
    bank = kernels_dense.precompute_bank_values(st, wl)
    before = dict(TT.launches), dict(kernels_dense.launches)
    out = kernels_dense.bounce_dense(st, cfg, wl, state, draws, bank)
    assert TT.launches["bounce_core"] == before[0]["bounce_core"] + 1
    assert kernels_dense.launches == before[1]
    want = TT.bounce_core(st, cfg, wl, state, draws)
    for k in want:
        assert torch.equal(out[k], want[k]), k


def test_bounce_dense_refuses_other_devices(paths):
    st = torch_build(torch_load(paths["prism"]), "cpu")
    cfg = TT.TraceConfig(bounces=2, light_samples=1, spectrum_samples=1)
    wl = torch.full((8, 1), 550.0, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels_dense.bounce_dense(st, cfg, wl, {}, {}, None)

