"""The port's host BVH builders (pyrite_tpu_torch.bvh and the cluster branch
of scene.build_scene) against the JAX package's: the same inputs, made from
a numpy seed, give equal arrays (array_equal, no tolerance)."""

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu import bvh as jax_bvh
from pyrite_tpu import scene as jax_scene
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu_torch import bvh, scene as torch_scene, tracer
from pyrite_tpu_torch.project import load_project as torch_load

torch.set_num_threads(2)


def _boxes(seed=5, count=2500):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, size=(count, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.4, size=(count, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.4, size=(count, 3)).astype(np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    return lo, hi


def _assert_equal_tuples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("leaf", [1, 32, 128])
def test_clustered_build_matches_jax(leaf):
    lo, hi = _boxes()
    _assert_equal_tuples(
        bvh.build_bvh_clustered_python(lo, hi, leaf), jax_bvh.build_bvh_clustered_python(lo, hi, leaf)
    )


@pytest.mark.parametrize("target", [64, 128, 256])
def test_treelets_and_wide_tree_match_jax(target):
    lo, hi = _boxes(seed=9)
    _, _, subtree, start, count, perm = bvh.build_bvh_clustered_python(lo, hi, 32)
    ranges = bvh.treelet_ranges(subtree, start, count, target)
    assert ranges == jax_bvh.treelet_ranges(subtree, start, count, target)
    # merging adjacent treelets: as far as the leaf allows, then refused
    capacity = len(ranges) * 3 // 4
    assert bvh.merge_ranges(ranges, 2 * target, capacity) == jax_bvh.merge_ranges(
        ranges, 2 * target, capacity
    )
    for merge in (bvh.merge_ranges, jax_bvh.merge_ranges):
        with pytest.raises(ValueError):
            merge(ranges, target, 1)
    p_lo, p_hi = lo[perm], hi[perm]
    leaf_lo = np.stack([p_lo[s : s + c].min(axis=0) for s, c in ranges])
    leaf_hi = np.stack([p_hi[s : s + c].max(axis=0) for s, c in ranges])
    _assert_equal_tuples(bvh.build_wide_bvh(leaf_lo, leaf_hi), jax_bvh.build_wide_bvh(leaf_lo, leaf_hi))


def _geo_rows(seed=3, tris=2000, spheres=40):
    """Perm-ordered clu_geo rows of a mixed triangle + sphere set, as
    build_scene packs them, with the primitive boxes."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, size=(tris, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.4, size=(tris, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.4, size=(tris, 3)).astype(np.float32)
    c = rng.uniform(-5, 5, size=(spheres, 3)).astype(np.float32)
    r = rng.uniform(0.05, 0.5, size=spheres).astype(np.float32)
    lo = np.concatenate([np.minimum(np.minimum(v0, v0 + e1), v0 + e2), c - r[:, None]])
    hi = np.concatenate([np.maximum(np.maximum(v0, v0 + e1), v0 + e2), c + r[:, None]])
    _, _, subtree, start, count, perm = bvh.build_bvh_clustered_python(lo, hi, 32)
    geo = np.zeros((tris + spheres, 12), np.float32)
    tri = perm < tris
    geo[tri, 0:3], geo[tri, 3:6], geo[tri, 6:9] = v0[perm[tri]], e1[perm[tri]], e2[perm[tri]]
    geo[~tri, 0:3], geo[~tri, 9] = c[perm[~tri] - tris], r[perm[~tri] - tris]
    geo[:, 10] = np.where(tri, 0, 1)
    geo[:, 11] = np.where(tri, perm, perm - tris)
    return lo[perm], hi[perm], geo, (subtree, start, count)


@pytest.mark.parametrize("leaf", [128, 256])
def test_cluster_packing_matches_jax(leaf):
    p_lo, p_hi, geo, tree = _geo_rows()
    ranges = bvh.treelet_ranges(*tree, leaf)
    _assert_equal_tuples(
        torch_scene.pack_wide_clusters_ranges(p_lo, p_hi, geo, ranges, leaf),
        jax_scene.pack_wide_clusters_ranges(p_lo, p_hi, geo, ranges, leaf),
    )
    _assert_equal_tuples(
        torch_scene.pack_wide_clusters(p_lo, p_hi, geo, leaf),
        jax_scene.pack_wide_clusters(p_lo, p_hi, geo, leaf),
    )


def test_leaf_size_grows_as_in_jax():
    """cluster_leaf_size, and the growth loop of the cluster branch
    (scene.py:716-727 of the JAX package) on synthetic ranges: with room for
    few clusters, treelets of 128 cannot be merged into that many and the
    leaf grows by 128 until they can."""
    for total in (1025, 524_288, 524_289, 871_200 + 1, 3_000_000):
        assert torch_scene.cluster_leaf_size(total) == jax_scene.cluster_leaf_size(total)
    assert torch_scene.cluster_leaf_size(871_201) == 256

    _, _, subtree, start, count, _ = bvh.build_bvh_clustered_python(*_boxes(seed=11, count=3000), 32)
    capacity = 12
    ranges, leaf = torch_scene.cluster_ranges(subtree, start, count, 128, capacity)

    want_leaf = 128
    while True:  # the JAX package's loop, on its own functions
        want = jax_bvh.treelet_ranges(subtree, start, count, want_leaf)
        if len(want) <= capacity:
            break
        try:
            want = jax_bvh.merge_ranges(want, want_leaf, capacity)
            break
        except ValueError:
            want_leaf += 128
    assert leaf > 128 and (ranges, leaf) == (want, want_leaf)
    assert len(ranges) <= capacity and max(c for _, c in ranges) <= leaf
    assert sum(c for _, c in ranges) == 3000
    assert [s for s, _ in ranges] == list(np.cumsum([0] + [c for _, c in ranges])[:-1])
    with pytest.raises(ValueError):
        bvh.merge_ranges(bvh.treelet_ranges(subtree, start, count, 128), 128, capacity)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("meshes"))
    return {
        "terrain_24": chip_smoke.terrain_paths(directory, cells=(24,), width=32, height=16)["terrain_24"],
        "tri_lamp_24": chip_smoke.write_tri_lamp_scene(directory, width=32, height=16, cells=24),
    }


@pytest.mark.parametrize("name", ["terrain_24", "tri_lamp_24"])
def test_scene_clusters_match_jax(meshes, name):
    sj = jax_scene.build_scene(jax_load(meshes[name]))
    st = torch_scene.build_scene(torch_load(meshes[name]), "cpu")
    assert sj.use_clusters and st.use_clusters
    assert (st.cluster_leaf, st.cluster_slots) == (sj.cluster_leaf, sj.cluster_slots)
    for key in ("wide_rows", "clu_geo", "prim_kind", "prim_ref"):
        np.testing.assert_array_equal(st.arrays[key].numpy(), np.asarray(sj.arrays[key]), err_msg=key)
    assert st.arrays["wide_rows"].shape == (273, 128)
    assert st.arrays["clu_geo"].shape == (st.cluster_slots, st.cluster_leaf, 12)
    # both kinds of primitive sit in the clusters
    kinds = set(st.arrays["clu_geo"][..., 10].unique().tolist())
    assert kinds == {-1.0, 0.0, 1.0} if name == "terrain_24" else {-1.0, 0.0}


@pytest.mark.parametrize("query", ["closest", "shadow"])
def test_leaf_visits_per_lane(meshes, query):
    """tracer.work's per-lane leaf visits (chip_smoke reads them for the
    warps' divergence) on terrain_24's camera wavefront and its shadow
    rays: each visit sweeps one leaf of cluster_leaf rows, so the visits
    add up to the leaf rows counted, each ray traced alone sweeps as many
    leaves as its lane recorded, and the divergence factor lies in [1, 32]."""
    scene, film, camera, cfg = chip_smoke.load_scene(meshes["terrain_24"], "cpu")
    origin, direction, _, keyed = chip_smoke._wavefront(film, camera, cfg, 0, device="cpu")
    if query == "closest":
        rays = (origin, direction)
        trace = lambda *r: tracer.intersect_scene(scene, *r)
    else:
        hit = tracer.intersect_scene(scene, origin, direction)
        rays = chip_smoke._shadow_rays(scene, cfg, origin, direction, hit, keyed)[:4]
        trace = lambda *r: tracer.intersect_shadow(scene, *r)
    work = chip_smoke._counted(lambda: trace(*rays))
    (visits,) = work["leaf_visits"]
    n = rays[0].shape[0]
    assert visits["lanes"] == n > 1000
    assert visits["lane"].numel() * scene.cluster_leaf == work["leaf_rows"] > 0
    per_lane = torch.bincount(visits["lane"], minlength=n)
    for i in np.random.default_rng(1).choice(n, 12, replace=False):
        alone = chip_smoke._counted(lambda: trace(*(r[i : i + 1] for r in rays)))
        assert alone.get("leaf_rows", 0) == per_lane[i] * scene.cluster_leaf
    factor, per_leaf = chip_smoke.warp_divergence(visits)
    assert 1.0 <= factor <= 32.0 and per_leaf >= 1.0
    # the same visits seen from a wavefront twice as wide, every other lane idle
    wide = chip_smoke.warp_divergence(visits, 2 * torch.arange(n), 2 * n)
    assert wide[0] >= factor and wide[1] <= per_leaf
