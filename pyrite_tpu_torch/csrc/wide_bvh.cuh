// Traversal of the clustered wide BVH for the rays of a warp: the device
// functions behind wide_closest_kernel / wide_shadow_kernel (csrc/wide_bvh.cu)
// and the mesh-scene bounce and NEE kernels (csrc/bounce.cu).
//
// The tree is bvh.build_wide_bvh's: 273 rows of 128 floats, each the 16
// child boxes of one node as [minx | miny | minz | maxx | maxy | maxz]
// columns, the children's sort axis in column 96 and their validity bitmask
// in column 97. Row 0 is the root, row 1 + i the L1 node i, row 17 + n the
// L2 node n = i * 16 + j, whose child k is leaf slot n * 16 + k of clu_geo
// [slots, leaf, 12] (v0 or center, e1, e2, radius, kind, ref per row; kind
// -1 pads a leaf at its end).
//
// The walk is per thread. Each ray keeps what the TPU walk keeps, in
// registers: one 16-bit mask of pending children per level, two node
// cursors and three pop directions; no stack, no leaf buffer. The TPU
// design's one-hot row fetches, ray compaction, packed state sheets and
// padded/channel-major table copies are ways around the TPU's gathers and
// are not carried over: here a row is read from global memory. Every popped
// child's box is tested again against the running best t before the walk
// descends into it or sweeps it, which re-prunes all that is still pending
// after each leaf.
//
// The leaf sweep is the warp's (a while-while loop): each thread walks its
// ray until the ray has a leaf pending or is done (the warp pops in step,
// under a vote, so that all its threads reach what follows together; see
// walk_collect); a ballot gives the warp's pending (ray, leaf) pairs; for each pair, in ascending lane order,
// the owner's ray and slot are broadcast and thread l tests rows l, l + 32,
// ... of that leaf, each row read as three 16-byte loads, so one warp step
// reads 32 consecutive rows (1,536 contiguous bytes); padding rows are
// masked by predicate. A butterfly of shuffles reduces the lanes' first
// minima (closest hit, ordered by t, then by row: tracer._first_min's
// winner) or their minimum t (any hit), and only the owner takes the result.
// The loop ends when no ray of the warp is still walking. Each ray walks and
// sweeps in the order it did when it swept alone, so tracer.cluster_traverse,
// the plain version, still agrees bit for bit, on ties and on the early-exit
// shadow t too.
//
// Every thread of a warp must therefore reach the traversal: a thread
// without a ray (past the end of the wavefront, a dead lane, a lane without
// NEE or a lamp sample behind the surface) enters with active = false and
// only helps sweep the others' leaves. No thread may return before it.
//
// What bounds it on an H100: the leaf rows, about 93 % of the counted
// operations (~53 per row, leaf * 48 bytes per visited leaf); per popped
// node 6 floats of the parent row, per descent a whole 512-byte row. The
// node table is 140 KB and clu_geo of the 328,050-triangle terrain 25 MB
// (4092 slots of 128 rows), both inside the 50 MB L2; the 871,200-triangle
// terrain's 75 MB (leaf 384) is read from HBM too. The cooperative sweep
// removes the per-ray sweep's divergence (a warp swept for as long as its
// ray with the most leaves); what remains is the walk's divergence, one
// sweep per pending pair even where several rays of a warp wait on the same
// leaf, and the shuffles. Grouping a warp's pairs by leaf, the top rows in
// shared memory and ray sorting between bounces are later work.
#pragma once

#include "common.cuh"

namespace {

constexpr int WIDE_ROW = 128;
constexpr int WARP = 32;

struct WideBvh {
  const float* __restrict__ rows;  // [273, 128] node table
  const float* __restrict__ geo;   // [slots, leaf, 12] leaf clusters, 16-byte aligned
  int leaf;                        // rows per leaf cluster (128, or more on big meshes)
};

// Slab test of child k of a node row (tracer._slab16, math.rs:184-207). On
// a ray with a zero direction component whose origin lies in a slab plane
// (lo - o) * inv_d is 0 * inf = NaN; NaN propagates and the box is missed,
// as in the JAX package and the plain version.
__device__ __forceinline__ bool child_hit(const float* __restrict__ row, int k, V3 o, V3 inv,
                                          float t_best) {
  const float t1x = (row[k] - o.x) * inv.x, t2x = (row[48 + k] - o.x) * inv.x;
  const float t1y = (row[16 + k] - o.y) * inv.y, t2y = (row[64 + k] - o.y) * inv.y;
  const float t1z = (row[32 + k] - o.z) * inv.z, t2z = (row[80 + k] - o.z) * inv.z;
  const float tmin = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)), nan_min(t1z, t2z));
  const float tmax = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)), nan_max(t1z, t2z));
  return tmax >= tmin && tmax >= 0.0f && nan_max(tmin, 0.0f) < t_best;
}

// Replaces pyrite_tpu/kernels.py `_fetch_slab_kernel` (:337, one pop of the
// TPU walk): read one node row, return the bitmask of its valid children
// hit with an entry before t_best, and whether the ray runs negative along
// the row's sort axis (pop from the high bit). The TPU kernel fetched the
// row by a one-hot matmul and so clamped the +-inf sentinels; a plain load
// needs no clamp, and column 97 masks the empty slots.
__device__ __forceinline__ unsigned fetch_slab(const float* __restrict__ rows, int r, V3 o, V3 d,
                                               V3 inv, float t_best, bool& from_high) {
  const float* row = rows + r * WIDE_ROW;
  unsigned bits = 0;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) bits |= (unsigned)child_hit(row, k, o, inv, t_best) << k;
  const int axis = (int)row[96];
  from_high = (axis == 0 ? d.x : (axis == 1 ? d.y : d.z)) < 0.0f;
  return bits & (unsigned)(int)row[97];
}

__device__ __forceinline__ int pop_bit(unsigned& m, bool from_high) {
  const int k = from_high ? 31 - __clz(m) : __ffs(m) - 1;
  m &= ~(1u << k);
  return k;
}

struct Walk {
  unsigned m0, m1, m2;  // pending children of the root, of L1 node cur1, of L2 node cur2
  int cur1, cur2;
  bool ph0, ph1, ph2;  // pop from the high bit at that level
};

// A walk with nothing pending: walk_collect returns -1 at once.
__device__ __forceinline__ Walk walk_idle() { return {0u, 0u, 0u, 0, 0, false, false, false}; }

__device__ __forceinline__ Walk walk_start(const float* __restrict__ rows, V3 o, V3 d, V3 inv,
                                           float t_best) {
  Walk w = walk_idle();
  w.m0 = fetch_slab(rows, 0, o, d, inv, t_best, w.ph0);
  return w;
}

__device__ __forceinline__ bool walk_done(const Walk& w) { return !(w.m0 | w.m1 | w.m2); }

// One pop of pyrite_tpu/kernels.py `_walk_kernel` (:125, walk_collect):
// take the deepest non-empty mask's next child front to back, test it again
// against t_best, and descend into it, or return its slot where it is a
// leaf; -1 where no leaf is pending yet.
__device__ __forceinline__ int walk_pop(const float* __restrict__ rows, V3 o, V3 d, V3 inv,
                                        float t_best, Walk& w) {
  if (w.m2) {
    const int k = pop_bit(w.m2, w.ph2);
    if (child_hit(rows + (17 + w.cur2) * WIDE_ROW, k, o, inv, t_best)) return w.cur2 * 16 + k;
  } else if (w.m1) {
    const int k = pop_bit(w.m1, w.ph1);
    if (child_hit(rows + (1 + w.cur1) * WIDE_ROW, k, o, inv, t_best)) {
      w.cur2 = w.cur1 * 16 + k;
      w.m2 = fetch_slab(rows, 17 + w.cur2, o, d, inv, t_best, w.ph2);
    }
  } else if (w.m0) {
    const int k = pop_bit(w.m0, w.ph0);
    if (child_hit(rows, k, o, inv, t_best)) {
      w.cur1 = k;
      w.m1 = fetch_slab(rows, 1 + k, o, d, inv, t_best, w.ph1);
    }
  }
  return -1;
}

// walk_collect for the rays of a warp: each thread pops until its ray has a
// leaf pending (its slot) or its walk is done (-1). The warp pops in step,
// under a vote, so that every thread reaches the ballot and the shuffles
// after it together: with a per-thread loop here, the compiler folded that
// loop into the caller's and ran the shuffles with only the threads whose
// walk had just stopped (partial active masks, wrong hits on the card).
__device__ __forceinline__ int walk_collect(const float* __restrict__ rows, V3 o, V3 d, V3 inv,
                                            float t_best, Walk& w) {
  int slot = -1;
  while (__any_sync(FULL_WARP, slot < 0 && !walk_done(w)))
    if (slot < 0 && !walk_done(w)) slot = walk_pop(rows, o, d, inv, t_best, w);
  return slot;
}

// Row r of a leaf cluster as three 16-byte loads: (v0 or center, e1.x),
// (e1.yz, e2.xy), (e2.z, radius, kind, ref).
struct LeafRow {
  float4 a, b, c;
};

__device__ __forceinline__ const float4* leaf_rows(const WideBvh& b, int slot) {
  return reinterpret_cast<const float4*>(b.geo) + (size_t)slot * b.leaf * 3;
}

__device__ __forceinline__ LeafRow leaf_row(const float4* __restrict__ g, int r) {
  return {__ldg(g + 3 * r), __ldg(g + 3 * r + 1), __ldg(g + 3 * r + 2)};
}

// The distance at which the ray meets one row's triangle or sphere,
// INFINITY where it misses and on padding rows; u, v are the triangle's
// barycentrics, 0 on a sphere as the JAX sweep's triangle test gives there.
__device__ __forceinline__ float row_hit(const LeafRow& g, V3 o, V3 d, float& u, float& v) {
  const float kind = g.c.z;
  const V3 p = {g.a.x, g.a.y, g.a.z};
  float t = INFINITY;
  bool ok;
  if (kind == PRIM_TRIANGLE) {
    ok = ray_triangle(o, d, p, {g.a.w, g.b.x, g.b.y}, {g.b.z, g.b.w, g.c.x}, t, u, v);
  } else {
    ok = kind == PRIM_SPHERE && ray_sphere(o, d, p, g.c.y, t);
    u = v = 0.0f;
  }
  return ok ? t : INFINITY;
}

__device__ __forceinline__ V3 shfl3(V3 v, int src) {
  return {__shfl_sync(FULL_WARP, v.x, src), __shfl_sync(FULL_WARP, v.y, src),
          __shfl_sync(FULL_WARP, v.z, src)};
}

// Replaces pyrite_tpu/kernels.py `_make_sweep_closest_kernel` (:541,
// sweep_closest) for one (ray, leaf) pair, swept by the whole warp for the
// ray (o, d) of lane src: each lane keeps the first minimum of its rows
// (rows ascending, strict <), the butterfly leaves every lane with the
// leaf's first minimum (lowest t, then lowest row), and lane src takes it
// where it is strictly nearer than its running hit (tracer.py:2746-2779).
__device__ __forceinline__ void sweep_leaf_closest(const WideBvh& b, int slot, V3 o, V3 d, int src,
                                                   Hit& h) {
  const int lane = threadIdx.x & (WARP - 1);
  const float4* g = leaf_rows(b, slot);
  float best = INFINITY, best_u = 0.0f, best_v = 0.0f, best_kind = 0.0f, best_ref = 0.0f;
  int best_row = b.leaf;
  for (int r = lane; r < b.leaf; r += WARP) {
    const LeafRow row = leaf_row(g, r);
    float u, v;
    const float t = row_hit(row, o, d, u, v);
    if (t < best) {
      best = t;
      best_row = r;
      best_u = u;
      best_v = v;
      best_kind = row.c.z;
      best_ref = row.c.w;
    }
  }
  for (int m = WARP / 2; m > 0; m /= 2) {
    const float t = __shfl_xor_sync(FULL_WARP, best, m);
    const int r = __shfl_xor_sync(FULL_WARP, best_row, m);
    if (t < best || (t == best && r < best_row)) {
      best = t;
      best_row = r;
    }
  }
  // the winning row's lane kept its barycentrics, kind and ref
  const int winner = best_row & (WARP - 1);
  const float u = __shfl_sync(FULL_WARP, best_u, winner);
  const float v = __shfl_sync(FULL_WARP, best_v, winner);
  const float kind = __shfl_sync(FULL_WARP, best_kind, winner);
  const float ref = __shfl_sync(FULL_WARP, best_ref, winner);
  if (lane == src && best < h.t)
    h = {best, kind == PRIM_TRIANGLE ? KIND_TRIANGLE : KIND_SPHERE, (int)ref, u, v};
}

// Replaces pyrite_tpu/kernels.py `_make_sweep_shadow_kernel` (:593,
// sweep_shadow) for one (ray, leaf) pair: the leaf's minimum t along the
// ray, swept by the whole warp; every lane gets it.
__device__ __forceinline__ float sweep_leaf_shadow(const WideBvh& b, int slot, V3 o, V3 d) {
  const float4* g = leaf_rows(b, slot);
  float best = INFINITY;
  for (int r = threadIdx.x & (WARP - 1); r < b.leaf; r += WARP) {
    float u, v;
    best = fminf(best, row_hit(leaf_row(g, r), o, d, u, v));
  }
  for (int m = WARP / 2; m > 0; m /= 2) best = fminf(best, __shfl_xor_sync(FULL_WARP, best, m));
  return best;
}

__device__ __forceinline__ V3 inverse(V3 d) { return {1.0f / d.x, 1.0f / d.y, 1.0f / d.z}; }

// Closest hit over the tree, from the running hit h (planes already in it).
// Every thread of the warp calls it; one with active = false has no ray.
__device__ __forceinline__ void wide_closest(const WideBvh& b, V3 o, V3 d, Hit& h, bool active) {
  const V3 inv = inverse(d);
  Walk w = active ? walk_start(b.rows, o, d, inv, h.t) : walk_idle();
  for (;;) {
    const int slot = walk_collect(b.rows, o, d, inv, h.t, w);
    unsigned pending = __ballot_sync(FULL_WARP, slot >= 0);
    if (!pending) return;
    do {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1u;
      sweep_leaf_closest(b, __shfl_sync(FULL_WARP, slot, src), shfl3(o, src), shfl3(d, src), src,
                         h);
    } while (pending);
  }
}

// Nearest occluder from t (the lamp distance, planes already in it); the
// ray stops at the first leaf that leaves t below block_below, so its t is
// then some blocker's, not necessarily the nearest. Every thread of the
// warp calls it; one with active = false has no ray and gets t back.
__device__ __forceinline__ float wide_shadow(const WideBvh& b, V3 o, V3 d, float t,
                                             float block_below, bool active) {
  const int lane = threadIdx.x & (WARP - 1);
  const V3 inv = inverse(d);
  Walk w = active && !(t < block_below) ? walk_start(b.rows, o, d, inv, t) : walk_idle();
  for (;;) {
    const int slot = walk_collect(b.rows, o, d, inv, t, w);
    unsigned pending = __ballot_sync(FULL_WARP, slot >= 0);
    if (!pending) return t;
    do {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1u;
      const float leaf_t =
          sweep_leaf_shadow(b, __shfl_sync(FULL_WARP, slot, src), shfl3(o, src), shfl3(d, src));
      if (lane == src) {
        t = nan_min(t, leaf_t);
        if (t < block_below) w = walk_idle();  // blocked for sure
      }
    } while (pending);
  }
}

}  // namespace
