"""The edges of the bidirectional renderer's redesigned kernels, on the CPU.

dense_shadow_kernel compacts each block's live rays to its first threads and
the lamp kernels compact their alive lanes, so what they must keep is pinned
here on their plain versions, which the card holds them to
(tests/test_torch_cuda.py, chip_smoke.py phase 6):

- kernels_dense.shadow_query_plain on chip_smoke.shadow_edge_batches (no
  ray live, every ray live, only each block's last ray live, and a ragged
  batch of M not a multiple of the block) against the JAX package's
  intersect_shadow on the live rays: the blocked verdict (t below
  block_below) equal on every ray, t within rtol 1e-5 where the planes or
  primitives decide it and, where the Julia's march does, within the rtol
  1e-3 that tests/test_torch_de.py holds the DE march to (its estimator is
  a chaotic map: libm and XLA part in a last ulp); a ray that is not live
  keeps max_dist bit for bit;
- tracer.lamp_bounce_step on chip_smoke.sparse_lamp_state (one lane in 37
  alive): the alive lanes bit for bit what the same call gives on those
  lanes alone, and the dead lanes' next state their ray unchanged, not
  alive, their vertex not valid. (A dead lane's other vertex fields the
  plain version computes from its stale ray and no consumer reads; the
  kernel writes fixed defaults there, which the card tests check.)

Small sizes: a 32 x 32 Cornell class (12 triangles, a sphere and a
quaternion Julia) and a 32 x 16 flagship_bdpt (four spheres)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.scene import build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import kernels_dense as kd, rng
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("bdpt_edges"))
    paths = {"cornell_class": chip_smoke.write_cornell_scene(directory, 32, 32, spp=1),
             "flagship_bdpt": chip_smoke.write_flagship_bdpt(directory, "flagship_bdpt", 8, 8, 32, 16)}
    out = {}
    for name, path in paths.items():
        pj = jax_load(path)
        r = pj.project.renderer
        out[name] = (jax_build(pj), JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples),
                     torch_build(torch_load(path), "cpu"),
                     TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples), r.light_bounces)
    return out


@pytest.mark.parametrize("batch", chip_smoke.EDGE_BATCHES)
@pytest.mark.parametrize("name", ["cornell_class", "flagship_bdpt"])
def test_shadow_edge_batch_matches_jax(scenes, name, batch):
    sj, cfg_j, st, cfg_t, _ = scenes[name]
    origin, direction, max_dist, block_below, live = chip_smoke.shadow_edge_batches(
        chip_smoke.EDGE_BOXES[name])[batch]
    t = kd.shadow_query_plain(st, cfg_t, origin, direction, max_dist, block_below, live)
    assert torch.equal(t[~live], max_dist[~live]), "a ray that is not live was traced"
    on = live.numpy()
    if not on.any():
        return
    t_j = np.asarray(JT.intersect_shadow(
        sj, jnp.asarray(origin.numpy()[on]), jnp.asarray(direction.numpy()[on]), cfg_j,
        max_dist=jnp.asarray(max_dist.numpy()[on]), block_below=jnp.asarray(block_below.numpy()[on])))
    got, below = t.numpy()[on], block_below.numpy()[on]
    blocked = got < below
    np.testing.assert_array_equal(blocked, t_j < below, err_msg="blocked verdict")
    # the rays whose t is a DE shape's (below the planes' and primitives')
    marched = np.zeros(on.sum(), bool)
    for shape in st.de_shapes:
        _, t_de = TT.intersect_de(shape, origin[live], direction[live], cfg_t.max_de_steps,
                                  t_cap=max_dist[live])
        marched |= t_de.numpy() == got
    np.testing.assert_allclose(got[~marched], t_j[~marched], rtol=1e-5, atol=0.0, err_msg="t")
    np.testing.assert_allclose(got[marched], t_j[marched], rtol=1e-3, atol=0.0, err_msg="DE t")
    assert not marched.any() or name == "cornell_class"
    if batch in ("all_live", "ragged"):
        assert 0 < blocked.sum() < blocked.size, "the batch should hold blocked and free rays"


@pytest.mark.parametrize("name", ["cornell_class", "flagship_bdpt"])
def test_sparse_lamp_state_matches_alive_lanes_alone(scenes, name):
    _, _, st, cfg_t, light_bounces = scenes[name]
    n, s = 1024, cfg_t.spectrum_samples
    wl = torch.as_tensor(np.random.default_rng(7).uniform(400.0, 700.0, (n, s)).astype(np.float32))
    keyed = rng.KeyedDraws(3)
    _, state = TT.lamp_start(st, wl, rng.lamp_start_draws(keyed, n, st.num_lamps, "cpu"))
    sparse = chip_smoke.sparse_lamp_state(state)
    alive = sparse["alive"]
    assert 0 < int(alive.sum()) <= n // 37 + 1
    lamp_cfg = TT.TraceConfig(light_bounces, 0, s)
    draws = rng.lamp_bounce_draws(keyed, n, 0, "cpu")
    nxt, vertex = TT.lamp_bounce_step(st, lamp_cfg, wl, sparse, draws)
    idx = torch.nonzero(alive)[:, 0]
    nxt_a, vertex_a = TT.lamp_bounce_step(
        st, lamp_cfg, wl[idx], {k: v[idx] for k, v in sparse.items()},
        {k: v[idx] for k, v in draws.items()})
    assert bool(vertex_a["valid"].any()), "no alive lane reflected"
    for k in vertex:
        assert torch.equal(vertex[k][idx], vertex_a[k]), f"vertex {k} of an alive lane"
    for k in nxt:
        assert torch.equal(nxt[k][idx], nxt_a[k]), f"next {k} of an alive lane"
    dead = ~alive
    for k in ("origin", "direction"):
        assert torch.equal(nxt[k][dead], sparse[k][dead]), f"a dead lane's next {k} moved"
    assert not bool(nxt["alive"][dead].any()) and not bool(vertex["valid"][dead].any())
