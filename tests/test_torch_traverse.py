"""The port's plain wide-BVH traversal (tracer.cluster_traverse, the plain
version of the CUDA traversal kernels) against the JAX package's
_cluster_traverse, on the same node table, leaf clusters and rays made from
a numpy seed.

JAX runs in four modes: its default XLA walk; the Pallas leaf sweeps
(PYRITE_TPU_SWEEP_KERNEL=interpret, kernels.py:541 and :593); the Pallas
walk (PYRITE_TPU_PALLAS=interpret, kernels.py:125); the Pallas pop
(PYRITE_TPU_FETCH_KERNEL=interpret, kernels.py:337). Tolerances: t to
rtol 1e-6; idx equal on every ray whose brute-force winner is unique (the
second-nearest primitive more than 1e-5 relative away); shadow rays with an
early exit compare their blocked flags, since the exit makes t depend on the
visit order."""

import math
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyrite_tpu.tracer as JT
from pyrite_tpu import kernels as jax_kernels
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import bvh, geometry as geom, kernels
from pyrite_tpu_torch.scene import pack_wide_clusters_ranges

torch.set_num_threads(2)

TRIS, SPHERES = 2500, 24
MODES = {
    "xla": {},
    "sweep_interpret": {"PYRITE_TPU_SWEEP_KERNEL": "interpret"},
    "walk_interpret": {"PYRITE_TPU_PALLAS": "interpret"},
    "fetch_interpret": {"PYRITE_TPU_FETCH_KERNEL": "interpret"},
}


def _scene(leaf, seed=17):
    """Random triangles and spheres in clusters of ``leaf`` rows."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, size=(TRIS, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.4, size=(TRIS, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.4, size=(TRIS, 3)).astype(np.float32)
    c = rng.uniform(-5, 5, size=(SPHERES, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.6, size=SPHERES).astype(np.float32)
    lo = np.concatenate([np.minimum(np.minimum(v0, v0 + e1), v0 + e2), c - r[:, None]])
    hi = np.concatenate([np.maximum(np.maximum(v0, v0 + e1), v0 + e2), c + r[:, None]])
    _, _, subtree, start, count, perm = bvh.build_bvh_clustered_python(lo, hi, 32)
    geo = np.zeros((TRIS + SPHERES, 12), np.float32)
    tri = perm < TRIS
    geo[tri, 0:3], geo[tri, 3:6], geo[tri, 6:9] = v0[perm[tri]], e1[perm[tri]], e2[perm[tri]]
    geo[~tri, 0:3], geo[~tri, 9] = c[perm[~tri] - TRIS], r[perm[~tri] - TRIS]
    geo[:, 10] = np.where(tri, 0, 1)
    geo[:, 11] = np.where(tri, perm, perm - TRIS)
    ranges = bvh.treelet_ranges(subtree, start, count, leaf)
    rows, packed = pack_wide_clusters_ranges(lo[perm], hi[perm], geo, ranges, leaf)
    jax_scene = types.SimpleNamespace(
        cluster_slots=packed.shape[0], cluster_leaf=leaf,
        arrays={
            "wide_rows": jnp.asarray(rows), "clu_geo": jnp.asarray(packed),
            "wide_rows_pad": jnp.asarray(jax_kernels.pad_rows(rows)),
            "clu_geo_ch": jnp.asarray(jax_kernels.pack_geo_channel_major(packed)),
        },
    )
    torch_scene = types.SimpleNamespace(
        cluster_slots=packed.shape[0], cluster_leaf=leaf,
        arrays={"wide_rows": torch.as_tensor(rows), "clu_geo": torch.as_tensor(packed)},
    )
    return jax_scene, torch_scene, (v0, e1, e2, c, r)


def _rays(seed=29, n=96):
    """Random rays, and rays along the axes from points on slab planes: the
    0 * inf = NaN lanes of the slab test."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    k = n // 6
    dirs[:k] = np.eye(3, dtype=np.float32)[np.arange(k) % 3] * np.where(np.arange(k) % 2, -1, 1)[:, None]
    origins[:k] = np.round(origins[:k])
    dirs[np.arange(k, 2 * k), np.arange(k) % 3] = 0.0
    dirs[k : 2 * k] /= np.linalg.norm(dirs[k : 2 * k], axis=1, keepdims=True)
    return origins, dirs


def _brute_force(prims, origins, dirs):
    """t of every primitive along every ray: [N, TRIS + SPHERES]."""
    v0, e1, e2, c, r = (torch.as_tensor(x) for x in prims)
    o = torch.as_tensor(origins)[:, None, :]
    d = torch.as_tensor(dirs)[:, None, :]
    _, t_tri, _, _ = geom.ray_triangle(o, d, v0[None], e1[None], e2[None])
    _, t_sph = geom.ray_sphere(o, d, c[None], r[None])
    return torch.cat([t_tri, t_sph], dim=1).numpy()


def _jax_traverse(mode, *args, **kwargs):
    saved = {k: os.environ.get(k) for k in MODES[mode]}
    os.environ.update(MODES[mode])
    try:
        if mode == "walk_interpret":
            assert jax_kernels.walk_enabled()
        if mode == "sweep_interpret":
            assert jax_kernels.sweep_kernel_enabled()
        if mode == "fetch_interpret":
            assert jax_kernels.fetch_slab_enabled()
        scene = args[0]
        leaf_sweep = kwargs.pop("leaf_sweep")(scene)
        out = JT._cluster_traverse(*args, leaf_sweep, **kwargs)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module", params=[128, 256], ids=["leaf128", "leaf256"])
def setup(request):
    jax_scene, torch_scene, prims = _scene(request.param)
    origins, dirs = _rays()
    return jax_scene, torch_scene, origins, dirs, _brute_force(prims, origins, dirs)


@pytest.mark.parametrize("mode", list(MODES))
def test_closest_hit_matches_jax(setup, mode):
    jax_scene, torch_scene, origins, dirs, t_all = setup
    n = len(origins)
    init = {
        "t": jnp.full(n, jnp.inf), "kind": jnp.zeros(n, jnp.int32), "idx": jnp.zeros(n, jnp.int32),
        "u": jnp.zeros(n), "v": jnp.zeros(n),
    }
    want = _jax_traverse(
        mode, jax_scene, jnp.asarray(origins), jnp.asarray(dirs), init,
        leaf_sweep=JT._cluster_leaf_closest,
    )
    got = TT.cluster_traverse(
        torch_scene, torch.as_tensor(origins), torch.as_tensor(dirs), TT.empty_hit(n, "cpu"),
        TT._cluster_leaf_closest(torch_scene),
    )
    got = {k: v.numpy() for k, v in got.items()}
    best = t_all.min(axis=1)
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-6)
    np.testing.assert_allclose(got["t"], best, rtol=1e-6)
    hit = np.isfinite(best)
    assert 0.2 < hit.mean() < 1.0
    second = np.sort(t_all, axis=1)[:, 1]
    unique = hit & (second > best * (1 + 1e-5))
    np.testing.assert_array_equal(got["idx"][unique], want["idx"][unique])
    np.testing.assert_array_equal(got["kind"][hit], want["kind"][hit])
    # barycentrics to 1e-5: JAX's dot is a jnp.sum with its own association,
    # the port's ((x + y) + z), and u, v divide by det, which can be small
    tri = unique & (got["kind"] == TT.KIND_TRIANGLE)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][tri], want[k][tri], rtol=0, atol=1e-5)
    assert (got["kind"][hit] == TT.KIND_SPHERE).any() and (got["kind"][hit] == TT.KIND_TRIANGLE).any()


@pytest.mark.parametrize("mode", list(MODES))
def test_shadow_matches_jax(setup, mode):
    jax_scene, torch_scene, origins, dirs, t_all = setup
    n = len(origins)
    rng = np.random.default_rng(3)
    lamp = rng.uniform(1.0, 14.0, size=n).astype(np.float32)  # the lamp distance
    sq = lamp * lamp
    block = np.sqrt(np.maximum(sq - TT.DIST_EPSILON, 0.0)).astype(np.float32)
    o, d = torch.as_tensor(origins), torch.as_tensor(dirs)

    # nearest occluder, no exit: t itself agrees
    want = _jax_traverse(
        mode, jax_scene, jnp.asarray(origins), jnp.asarray(dirs), {"t": jnp.asarray(lamp)},
        leaf_sweep=JT._cluster_leaf_shadow,
    )["t"]
    got = TT.cluster_traverse(
        torch_scene, o, d, {"t": torch.as_tensor(lamp)}, TT._cluster_leaf_shadow(torch_scene)
    )["t"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.minimum(lamp, t_all.min(axis=1)), rtol=1e-6)

    # with the early exit below the occlusion bound: the blocked flags agree
    want = _jax_traverse(
        mode, jax_scene, jnp.asarray(origins), jnp.asarray(dirs), {"t": jnp.asarray(lamp)},
        exit_below=jnp.asarray(block), leaf_sweep=JT._cluster_leaf_shadow,
    )["t"]
    got = TT.cluster_traverse(
        torch_scene, o, d, {"t": torch.as_tensor(lamp)}, TT._cluster_leaf_shadow(torch_scene),
        torch.as_tensor(block),
    )["t"].numpy()

    def blocked(t):
        return np.isfinite(t) & (t * t < sq - TT.DIST_EPSILON)

    truth = t_all.min(axis=1) ** 2 < sq - TT.DIST_EPSILON
    np.testing.assert_array_equal(blocked(got), blocked(want))
    np.testing.assert_array_equal(blocked(got), truth)
    assert 0.1 < truth.mean() < 0.9


def test_slab_propagates_nan_as_jax():
    """A ray in a slab plane with a zero direction component: 0 * inf = NaN
    in the slab test, and both packages miss the box."""
    rows = np.zeros((273, 128), np.float32)
    rows[:, 0:48] = np.inf
    rows[:, 48:96] = -np.inf
    rows[0, [0, 16, 32]] = 0.0  # child 0: the box [0, 1]^3
    rows[0, [48, 64, 80]] = 1.0
    rows[0, 97] = 1.0
    o = np.array([[0.0, 0.5, -1.0], [0.5, 0.5, -1.0], [0.0, 0.5, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.6, 0.0, 0.8]], np.float32)
    t = np.full(3, np.inf, np.float32)
    want = np.asarray(JT._slab16(jnp.asarray(rows[0:1]), jnp.asarray(o), 1.0 / jnp.asarray(d), jnp.asarray(t)))
    row = torch.as_tensor(rows[0:1]).expand(3, -1)
    od, dd = torch.as_tensor(o), torch.as_tensor(d)
    got, _ = TT._slab16(row, od, dd, 1.0 / dd, torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [0, 1, 1]


def test_wrappers_take_the_plain_version_on_cpu(setup):
    _, torch_scene, origins, dirs, _ = setup
    o, d = torch.as_tensor(origins), torch.as_tensor(dirs)
    scene = types.SimpleNamespace(
        use_clusters=True, num_planes=0, de_shapes=[], arrays=torch_scene.arrays,
        cluster_leaf=torch_scene.cluster_leaf, cluster_slots=torch_scene.cluster_slots,
    )
    before = dict(kernels.launches)
    hit = kernels.closest_wide(scene, o, d)
    plain = TT.cluster_traverse(
        scene, o, d, TT.empty_hit(len(o), "cpu"), TT._cluster_leaf_closest(scene)
    )
    for k in hit:
        assert torch.equal(hit[k], plain[k]), k
    lamp = torch.full((len(o),), 6.0)
    t = kernels.shadow_wide(scene, o, d, lamp, lamp * 0.99)
    assert torch.equal(t, TT.intersect_shadow(scene, o, d, lamp, lamp * 0.99))
    assert kernels.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels.closest_wide(scene, o.to("meta"), d.to("meta"))
    assert math.isinf(float(TT.empty_hit(1, "cpu")["t"][0]))
