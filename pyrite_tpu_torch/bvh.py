"""Host-side BVH builders for cluster (mesh) scenes: numpy only, no torch
and no device (a jax-free copy of pyrite_tpu.bvh's numpy builders).

- ``build_bvh_clustered_python``: binned SAH (6 buckets over the largest
  centroid axis, even-split fallback on degenerate axes, spatial/bvh.rs:
  36-155) that stops at ``leaf_size`` primitives. scene.build_scene uses it
  when the native C++ builder is unavailable; its depth-first primitive
  order is what the wide tree clusters.
- ``treelet_ranges`` / ``merge_ranges``: cut that tree into leaf clusters.
- ``build_wide_bvh``: the positional 16-ary, 3-level tree over the
  clusters that the traversal (tracer.cluster_traverse and the CUDA kernels
  of csrc/wide_bvh.cuh) walks.

The code is the JAX package's, so the same arrays come out
(tests/test_torch_bvh.py holds them equal). The flat BVH's device
traversal is not ported: neither package runs it on a device.
"""

from __future__ import annotations

import numpy as np

DIST_EPSILON = 1e-4
BUCKETS = 6


def build_bvh_clustered_python(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int):
    """Numpy clustered-BVH build: binned SAH that stops splitting at
    ``leaf_size`` primitives, leaves storing contiguous ranges of a
    primitive permutation (the output contract of the native
    ``build_bvh_clustered``).

    Returns (bbox_min [M,3], bbox_max [M,3], subtree [M], leaf_start [M],
    leaf_count [M], perm [K])."""
    count = len(prim_min)
    prim_min = np.asarray(prim_min, np.float32)
    prim_max = np.asarray(prim_max, np.float32)
    centroids = (prim_min + prim_max) * 0.5

    out_min: list = []
    out_max: list = []
    out_size: list = []
    out_start: list = []
    out_count: list = []
    perm: list = []

    # depth-first emission; ("patch", pos) fixes a node's subtree size once
    # its children are out
    stack = [("node", np.arange(count))]
    while stack:
        kind, payload = stack.pop()
        if kind == "patch":
            out_size[payload] = len(out_size) - payload - 1
            continue

        indices = payload
        lo = prim_min[indices].min(axis=0)
        hi = prim_max[indices].max(axis=0)

        if len(indices) <= leaf_size:
            out_min.append(lo)
            out_max.append(hi)
            out_size.append(0)
            out_start.append(len(perm))
            out_count.append(len(indices))
            perm.extend(indices.tolist())
            continue

        first, second = _sah_split(prim_min, prim_max, centroids, indices)

        pos = len(out_size)
        out_min.append(lo)
        out_max.append(hi)
        out_size.append(-1)  # patched later
        out_start.append(-1)
        out_count.append(0)
        stack.append(("patch", pos))
        stack.append(("node", second))
        stack.append(("node", first))

    return (
        np.asarray(out_min, np.float32),
        np.asarray(out_max, np.float32),
        np.asarray(out_size, np.int32),
        np.asarray(out_start, np.int32),
        np.asarray(out_count, np.int32),
        np.asarray(perm, np.int32),
    )


def _sah_split(prim_min, prim_max, centroids, indices):
    """One binned-SAH split (6 buckets over the largest centroid axis,
    even-split fallback on degenerate axes, bvh.rs:68-147)."""
    cmin = centroids[indices].min(axis=0)
    cmax = centroids[indices].max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))

    def surface_area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])

    if extent[axis] < DIST_EPSILON:
        half = len(indices) // 2
        return indices[:half], indices[half:]

    pos = centroids[indices, axis]
    bucket_of = np.minimum(
        (BUCKETS * (pos - cmin[axis]) / extent[axis]).astype(np.int64),
        BUCKETS - 1,
    )
    lo = prim_min[indices].min(axis=0)
    hi = prim_max[indices].max(axis=0)
    counts = np.zeros(BUCKETS, np.int64)
    bucket_lo = np.full((BUCKETS, 3), np.inf, np.float32)
    bucket_hi = np.full((BUCKETS, 3), -np.inf, np.float32)
    for b in range(BUCKETS):
        mask = bucket_of == b
        counts[b] = mask.sum()
        if counts[b]:
            sel = indices[mask]
            bucket_lo[b] = prim_min[sel].min(axis=0)
            bucket_hi[b] = prim_max[sel].max(axis=0)
    root_area = surface_area(lo, hi)

    def side_area(cnts, los, his):
        if cnts.sum() == 0:
            return 0.0
        m = cnts > 0
        return surface_area(los[m].min(axis=0), his[m].max(axis=0))

    best_cost = np.inf
    best_split = 1
    for split in range(1, BUCKETS):
        c1 = counts[:split].sum()
        c2 = counts[split:].sum()
        a1 = side_area(counts[:split], bucket_lo[:split], bucket_hi[:split])
        a2 = side_area(counts[split:], bucket_lo[split:], bucket_hi[split:])
        cost = (a1 * c1 + a2 * c2) / max(root_area, 1e-30)
        if cost < best_cost:
            best_cost = cost
            best_split = split
    first_mask = bucket_of < best_split
    first, second = indices[first_mask], indices[~first_mask]
    if len(first) == 0 or len(second) == 0:
        half = len(indices) // 2
        order = np.argsort(pos, kind="stable")
        indices = indices[order]
        first, second = indices[:half], indices[half:]
    return first, second


# =============================================================================
# Wide (16-ary) BVH over leaf clusters: the traversal's node table
# =============================================================================

WIDE_FANOUT = 16
WIDE_LEVELS = 3  # root -> L1 -> L2 -> leaf slots; capacity 16^3 = 4096 leaves
WIDE_ROWS = 1 + WIDE_FANOUT + WIDE_FANOUT * WIDE_FANOUT  # 273


def _split_grouped(lo, hi, centroids, idx, k, cap):
    """Split ``idx`` into <= k groups of <= cap elements, SAH-guided with a
    sorted-cut rebalance when a side would overflow its capacity."""
    if len(idx) <= cap or k == 1:
        return [idx]
    half = k // 2
    lcap, rcap = half * cap, (k - half) * cap
    first, second = _sah_split(lo, hi, centroids, idx)
    if len(first) > lcap or len(second) > rcap:
        extent = centroids[idx].max(axis=0) - centroids[idx].min(axis=0)
        axis = int(np.argmax(extent))
        order = np.argsort(centroids[idx, axis], kind="stable")
        cut = int(np.clip(len(first), max(1, len(idx) - rcap), min(lcap, len(idx) - 1)))
        sorted_idx = idx[order]
        first, second = sorted_idx[:cut], sorted_idx[cut:]
    return _split_grouped(lo, hi, centroids, first, half, cap) + _split_grouped(
        lo, hi, centroids, second, k - half, cap
    )


def build_wide_bvh(leaf_lo: np.ndarray, leaf_hi: np.ndarray):
    """Group ``L <= 4096`` leaf-cluster AABBs into a positional 16-ary,
    3-level hierarchy.

    Returns (rows [273, 128] f32, slot_of_leaf [L] int32):
    - row r holds the 16 child AABBs of one node as columns
      [minx(16) | miny | minz | maxx | maxy | maxz | axis | validity | pad];
      empty child slots are (+inf, -inf) boxes, and column 97 is the bitmask
      of the valid children (the slab test cannot reject an inverted box).
      Row 0 is the root, rows 1..16 the L1 nodes (children of root child i),
      rows 17..272 the L2 nodes (L2 node (i, j) is row 17 + i*16 + j).
    - leaf ids are positional: child k of L2 node (i, j) is leaf slot
      (i*16 + j)*16 + k, so the traversal needs no pointers.
    - column 96 is the axis along which a node's children are sorted by
      center, so a walk pops them front to back by the sign of the ray.
    Pruning semantics: spatial/bvh.rs:201-230 (skip on a miss or an entry
    beyond the current best)."""
    num_leaves = len(leaf_lo)
    assert 1 <= num_leaves <= WIDE_FANOUT**WIDE_LEVELS
    centroids = (leaf_lo + leaf_hi) * 0.5

    rows = np.zeros((WIDE_ROWS, 128), np.float32)
    rows[:, 0:48] = np.inf
    rows[:, 48:96] = -np.inf

    def put(row, col, lo, hi):
        rows[row, 0 + col] = lo[0]
        rows[row, 16 + col] = lo[1]
        rows[row, 32 + col] = lo[2]
        rows[row, 48 + col] = hi[0]
        rows[row, 64 + col] = hi[1]
        rows[row, 80 + col] = hi[2]
        rows[row, 97] = float(int(rows[row, 97]) | (1 << col))  # exact in f32

    def order_children(groups_lo, row):
        """Order a node's children along the dominant axis of their centers
        and record the axis in column 96."""
        centers = np.asarray([0.5 * (lo + hi) for lo, hi in groups_lo])
        axis = (
            int(np.argmax(centers.max(axis=0) - centers.min(axis=0))) if len(centers) > 1 else 0
        )
        rows[row, 96] = axis
        return np.argsort(centers[:, axis], kind="stable")

    slot_of_leaf = np.zeros(num_leaves, np.int32)
    all_ids = np.arange(num_leaves)
    l1_groups = _split_grouped(leaf_lo, leaf_hi, centroids, all_ids, WIDE_FANOUT, WIDE_FANOUT**2)
    bounds = [(leaf_lo[g].min(axis=0), leaf_hi[g].max(axis=0)) for g in l1_groups]
    l1_groups = [l1_groups[o] for o in order_children(bounds, 0)]
    for i, g1 in enumerate(l1_groups):
        put(0, i, leaf_lo[g1].min(axis=0), leaf_hi[g1].max(axis=0))
        l2_groups = _split_grouped(leaf_lo, leaf_hi, centroids, g1, WIDE_FANOUT, WIDE_FANOUT)
        bounds = [(leaf_lo[g].min(axis=0), leaf_hi[g].max(axis=0)) for g in l2_groups]
        l2_groups = [l2_groups[o] for o in order_children(bounds, 1 + i)]
        for j, g2 in enumerate(l2_groups):
            put(1 + i, j, leaf_lo[g2].min(axis=0), leaf_hi[g2].max(axis=0))
            row2 = 17 + i * WIDE_FANOUT + j
            bounds = [(leaf_lo[le], leaf_hi[le]) for le in g2]
            g2 = np.asarray(g2)[order_children(bounds, row2)]
            for k, leaf in enumerate(g2):
                put(row2, k, leaf_lo[leaf], leaf_hi[leaf])
                slot_of_leaf[leaf] = (i * WIDE_FANOUT + j) * WIDE_FANOUT + k
    return rows, slot_of_leaf


def treelet_ranges(subtree, leaf_start, leaf_count, target):
    """Cut the clustered binary SAH tree at maximal subtrees holding at most
    ``target`` primitives; returns [(start, count)] contiguous ranges of the
    primitive permutation, in depth-first (spatially coherent) order. Each
    range becomes one leaf cluster of the wide tree, with the tight bound of
    an SAH subtree."""
    subtree = np.asarray(subtree)
    leaf_start = np.asarray(leaf_start)
    leaf_count = np.asarray(leaf_count)
    n = len(subtree)
    prim_count = np.zeros(n, np.int64)
    first_start = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if leaf_count[i] > 0:
            prim_count[i] = leaf_count[i]
            first_start[i] = leaf_start[i]
        else:
            left = i + 1
            right = left + subtree[left] + 1
            prim_count[i] = prim_count[left] + prim_count[right]
            first_start[i] = first_start[left]

    ranges = []
    stack = [0]
    while stack:
        i = stack.pop()
        if prim_count[i] <= target or leaf_count[i] > 0:
            ranges.append((int(first_start[i]), int(prim_count[i])))
        else:
            left = i + 1
            right = left + subtree[left] + 1
            stack.append(right)
            stack.append(left)
    return ranges


def merge_ranges(ranges, target, capacity):
    """Greedily merge ADJACENT (depth-first order) ranges while staying <=
    ``target`` prims until at most ``capacity`` ranges remain; adjacent
    ranges are spatial siblings. Raises ValueError when no merge fits."""
    ranges = list(ranges)
    while len(ranges) > capacity:
        merged = []
        i = 0
        did = False
        while i < len(ranges):
            if i + 1 < len(ranges) and ranges[i][1] + ranges[i + 1][1] <= target:
                merged.append((ranges[i][0], ranges[i][1] + ranges[i + 1][1]))
                i += 2
                did = True
            else:
                merged.append(ranges[i])
                i += 1
        if not did:
            raise ValueError(
                f"cannot merge {len(ranges)} clusters into {capacity} at leaf size {target}"
            )
        ranges = merged
    return ranges
