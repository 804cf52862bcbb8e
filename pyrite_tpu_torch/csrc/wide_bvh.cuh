// Walk of the clustered wide BVH, one thread per ray: the device functions
// behind wide_closest_kernel / wide_shadow_kernel (csrc/wide_bvh.cu) and the
// mesh-scene bounce and NEE kernels (csrc/bounce.cu).
//
// The tree is bvh.build_wide_bvh's: 273 rows of 128 floats, each the 16
// child boxes of one node as [minx | miny | minz | maxx | maxy | maxz]
// columns, the children's sort axis in column 96 and their validity bitmask
// in column 97. Row 0 is the root, row 1 + i the L1 node i, row 17 + n the
// L2 node n = i * 16 + j, whose child k is leaf slot n * 16 + k of clu_geo
// [slots, leaf, 12] (v0 or center, e1, e2, radius, kind, ref per row; kind
// -1 pads a leaf at its end).
//
// The traversal state is what the TPU walk keeps, in registers: one 16-bit
// mask of pending children per level, two node cursors and three pop
// directions. No stack, no leaf buffer. The TPU design's one-hot row
// fetches, ray compaction, packed state sheets, second pending-leaf register
// and padded/channel-major table copies are ways around the TPU's gathers
// and are not carried over: here a row is read from global memory.
//
// Pruning: every popped child's box is tested again against the running
// best t before the walk descends into it or sweeps it, which re-prunes
// all that is still pending after each leaf. tracer.cluster_traverse is the
// plain version and steps in exactly this order, so the two agree on ties.
//
// What bounds it on an H100: per visited leaf a ray reads leaf * 48 bytes
// of clu_geo (6 KB at leaf 128) and tests every row (~40 flops per
// triangle); per popped node it reads 6 floats of the parent row, per
// descent a whole 512-byte row. The node table is 140 KB and clu_geo of the
// 328,050-triangle terrain 25 MB (4092 slots of 128 rows), both inside the
// 50 MB L2, so there the walk is bound by L1/L2 latency and by divergence
// between the rays of a warp, not by HBM bandwidth; the 871,200-triangle
// terrain's 75 MB (leaf 384) does not fit and is read from HBM too. This
// first version reads everything through the read-only path and keeps all
// state in registers; staging the top rows in shared memory, packet
// traversal and ray sorting are later work.
#pragma once

#include "common.cuh"

namespace {

constexpr int WIDE_ROW = 128;

struct WideBvh {
  const float* __restrict__ rows;  // [273, 128] node table
  const float* __restrict__ geo;   // [slots, leaf, 12] leaf clusters
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

__device__ __forceinline__ Walk walk_start(const float* __restrict__ rows, V3 o, V3 d, V3 inv,
                                           float t_best) {
  Walk w;
  w.m0 = fetch_slab(rows, 0, o, d, inv, t_best, w.ph0);
  w.m1 = w.m2 = 0u;
  w.cur1 = w.cur2 = 0;
  w.ph1 = w.ph2 = false;
  return w;
}

// Replaces pyrite_tpu/kernels.py `_walk_kernel` (:125, walk_collect): pop
// front to back until a leaf is pending, and return its slot, or -1 once
// every mask is empty. Each popped child is tested again against t_best.
__device__ __forceinline__ int walk_collect(const float* __restrict__ rows, V3 o, V3 d, V3 inv,
                                            float t_best, Walk& w) {
  for (;;) {
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
    } else {
      return -1;
    }
  }
}

// Replaces pyrite_tpu/kernels.py `_make_sweep_closest_kernel` (:541,
// sweep_closest): the leaf's rows in order; a strict comparison against the
// running hit keeps the first minimum (tracer.py:2746-2779). A sphere hit
// carries u = v = 0, as the JAX sweep's triangle test gives on sphere rows.
__device__ __forceinline__ void sweep_leaf_closest(const WideBvh& b, int slot, V3 o, V3 d, Hit& h) {
  const float* g = b.geo + (size_t)slot * b.leaf * 12;
  for (int r = 0; r < b.leaf; ++r, g += 12) {
    const float kind = g[10];
    if (kind < 0.0f) break;  // padding fills the tail of a leaf
    const V3 p = {g[0], g[1], g[2]};
    float t, u, v;
    if (kind == PRIM_TRIANGLE) {
      if (ray_triangle(o, d, p, {g[3], g[4], g[5]}, {g[6], g[7], g[8]}, t, u, v) && t < h.t)
        h = {t, KIND_TRIANGLE, (int)g[11], u, v};
    } else if (kind == PRIM_SPHERE) {
      if (ray_sphere(o, d, p, g[9], t) && t < h.t) h = {t, KIND_SPHERE, (int)g[11], 0.0f, 0.0f};
    }
  }
}

// Replaces pyrite_tpu/kernels.py `_make_sweep_shadow_kernel` (:593,
// sweep_shadow): the running minimum t over the leaf's rows.
__device__ __forceinline__ void sweep_leaf_shadow(const WideBvh& b, int slot, V3 o, V3 d,
                                                  float& t_best) {
  const float* g = b.geo + (size_t)slot * b.leaf * 12;
  for (int r = 0; r < b.leaf; ++r, g += 12) {
    const float kind = g[10];
    if (kind < 0.0f) break;
    const V3 p = {g[0], g[1], g[2]};
    float t, u, v;
    if (kind == PRIM_TRIANGLE) {
      if (ray_triangle(o, d, p, {g[3], g[4], g[5]}, {g[6], g[7], g[8]}, t, u, v))
        t_best = nan_min(t_best, t);
    } else if (kind == PRIM_SPHERE) {
      if (ray_sphere(o, d, p, g[9], t)) t_best = nan_min(t_best, t);
    }
  }
}

__device__ __forceinline__ V3 inverse(V3 d) { return {1.0f / d.x, 1.0f / d.y, 1.0f / d.z}; }

// Closest hit over the tree, from the running hit h (planes already in it).
__device__ __forceinline__ void wide_closest(const WideBvh& b, V3 o, V3 d, Hit& h) {
  const V3 inv = inverse(d);
  Walk w = walk_start(b.rows, o, d, inv, h.t);
  for (;;) {
    const int slot = walk_collect(b.rows, o, d, inv, h.t, w);
    if (slot < 0) return;
    sweep_leaf_closest(b, slot, o, d, h);
  }
}

// Nearest occluder from t (the lamp distance, planes already in it); the
// ray stops at the first leaf that leaves t below block_below, so its t is
// then some blocker's, not necessarily the nearest.
__device__ __forceinline__ float wide_shadow(const WideBvh& b, V3 o, V3 d, float t,
                                             float block_below) {
  if (t < block_below) return t;
  const V3 inv = inverse(d);
  Walk w = walk_start(b.rows, o, d, inv, t);
  for (;;) {
    const int slot = walk_collect(b.rows, o, d, inv, t, w);
    if (slot < 0) return t;
    sweep_leaf_shadow(b, slot, o, d, t);
    if (t < block_below) return t;
  }
}

}  // namespace
