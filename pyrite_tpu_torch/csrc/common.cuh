// Shared device code of the kernels in csrc/: vector math, the scene sheet,
// and the ray-primitive tests, in the op order of the plain PyTorch version
// (pyrite_tpu_torch/geometry.py). Every source is compiled with
// --fmad=false (_build.py), so each product is rounded before it is added,
// as in the plain version's separate ops.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int SHEET_W = 128;
constexpr int BLOCK = 128;
constexpr float DIST_EPSILON = 1e-4f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr unsigned FULL_WARP = 0xffffffffu;  // every thread of a warp, for the *_sync ops

// kernels_dense.META_FIELDS, in order: counts first, then sheet rows (-1
// where the scene has no such table). A table of n entries takes ceil(n /
// 128) consecutive rows, so entry i of a field lies at row meta * 128 + i
// (Sheet::at). The DE rows (M_DE_KIND .. M_DE_MAT) hold one column per DE
// shape, in the field order of csrc/march_de.cuh's de_shape
// (kernels_dense.DE_FIELDS). The rows from M_MAT_NORMAL to M_LTRI_UV2V exist
// on a scene that runs the kernels' kProg instantiations (csrc/bounce.cu);
// then, on a scene with directional lamps, their count (-1 on the others),
// every lamp's width and the directional lamps' own table (direction,
// width, color program), in lamp order.
enum Meta {
  M_N_PRIMS, M_N_PLANES, M_N_DE,
  M_PLA_NX, M_PLA_NY, M_PLA_NZ, M_PLA_D, M_PLA_MAT,
  M_MAT_COMP_COUNT, M_MAT_COMP_OFFSET, M_MAT_EMIS_COUNT, M_MAT_EMIS_OFFSET,
  M_COMP_BSDF, M_COMP_COLOR, M_COMP_PROB, M_COMP_PROB_USES_WL, M_COMP_SELECTION,
  M_COMP_IOR, M_COMP_DISP, M_COMP_ENV_IOR, M_COMP_ENV_DISP,
  M_LAMP_TYPE, M_LAMP_VX, M_LAMP_VY, M_LAMP_VZ, M_LAMP_REF, M_LAMP_COLOR,
  M_LSPH_CX, M_LSPH_CY, M_LSPH_CZ, M_LSPH_R, M_LSPH_MAT,
  M_LTRI_V0X, M_LTRI_V0Y, M_LTRI_V0Z, M_LTRI_E1X, M_LTRI_E1Y, M_LTRI_E1Z,
  M_LTRI_E2X, M_LTRI_E2Y, M_LTRI_E2Z,
  M_LTRI_N0X, M_LTRI_N0Y, M_LTRI_N0Z, M_LTRI_N1X, M_LTRI_N1Y, M_LTRI_N1Z,
  M_LTRI_N2X, M_LTRI_N2Y, M_LTRI_N2Z, M_LTRI_MAT,
  M_EMIS_COMP, M_EMIS_SELECTION,
  M_DE_KIND, M_DE_VARIANT, M_DE_ITERATIONS, M_DE_THRESHOLD, M_DE_THR2, M_DE_POWER,
  M_DE_POWER_M1, M_DE_HAS_CONSTANT, M_DE_C0, M_DE_C1, M_DE_C2, M_DE_C3, M_DE_SLICE,
  M_DE_BOUNDS_KIND, M_DE_AX, M_DE_AY, M_DE_AZ, M_DE_BX, M_DE_BY, M_DE_BZ,
  M_DE_CX, M_DE_CY, M_DE_CZ, M_DE_MAT,
  M_MAT_NORMAL, M_LSPH_TSU, M_LSPH_TSV,
  M_LTRI_UV0U, M_LTRI_UV0V, M_LTRI_UV1U, M_LTRI_UV1V, M_LTRI_UV2U, M_LTRI_UV2V,
  M_N_DIR, M_LAMP_WIDTH, M_DIR_VX, M_DIR_VY, M_DIR_VZ, M_DIR_WIDTH, M_DIR_COLOR,
  M_COUNT
};

enum { KIND_NONE = 0, KIND_TRIANGLE = 1, KIND_SPHERE = 2, KIND_PLANE = 3, KIND_DE = 4 };
enum { PRIM_TRIANGLE = 0, PRIM_SPHERE = 1 };

struct V3 {
  float x, y, z;
};

// min / max that return NaN when either side is NaN, as torch.minimum /
// maximum and jnp.minimum / maximum do (fminf / fmaxf would drop it).
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 v) {
  float len = sqrtf(fmaxf(dot(v, v), 1e-20f));
  return {v.x / len, v.y / len, v.z / len};
}
__device__ __forceinline__ V3 load3(const float* __restrict__ p, int lane) {
  return {p[3 * lane], p[3 * lane + 1], p[3 * lane + 2]};
}
__device__ __forceinline__ void store3(float* __restrict__ p, int lane, V3 v) {
  p[3 * lane] = v.x;
  p[3 * lane + 1] = v.y;
  p[3 * lane + 2] = v.z;
}

// Copy `count` floats between global and shared memory with all the
// block's threads, consecutive threads on consecutive words: as float4 where
// both ends are 16-byte aligned, else word by word. Every thread of the
// block must call it (the caller synchronises around it).
__device__ __forceinline__ void block_copy(float* __restrict__ dst, const float* __restrict__ src,
                                           int count) {
  int i = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = count >> 2;
    for (; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i = (n4 << 2) + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) dst[i] = src[i];
}

// The scene: sheet rows by meta field (a table's entries run on across its
// consecutive rows), primitive channels by fixed row.
struct Sheet {
  const float* __restrict__ p;
  const int* __restrict__ meta;
  __device__ __forceinline__ int count(int field) const { return meta[field]; }
  __device__ __forceinline__ float at(int field, int i) const { return p[meta[field] * SHEET_W + i]; }
  __device__ __forceinline__ int iat(int field, int i) const { return (int)at(field, i); }
  __device__ __forceinline__ float row(int r, int i) const { return p[r * SHEET_W + i]; }
  __device__ __forceinline__ V3 row3(int r, int i) const { return {row(r, i), row(r + 1, i), row(r + 2, i)}; }
};

// Moller-Trumbore (geometry.ray_triangle)
__device__ __forceinline__ bool ray_triangle(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float& t, float& u,
                                             float& v) {
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  bool ok = fabsf(det) > DIST_EPSILON;
  float inv_det = 1.0f / (ok ? det : 1.0f);
  V3 tv = o - v0;
  u = dot(tv, p) * inv_det;
  ok = ok && u >= 0.0f && u <= 1.0f;
  V3 q = cross(tv, e1);
  v = dot(d, q) * inv_det;
  ok = ok && v >= 0.0f && u + v <= 1.0f;
  t = dot(e2, q) * inv_det;
  return ok && t > DIST_EPSILON;
}

// nearest root > eps, else the far root (geometry.ray_sphere)
__device__ __forceinline__ bool ray_sphere(V3 o, V3 d, V3 c, float radius, float& t) {
  V3 l = c - o;
  float tca = dot(l, d);
  float d2 = dot(l, l) - tca * tca;
  float r2 = radius * radius;
  bool ok = d2 <= r2;
  float thc = sqrtf(fmaxf(r2 - d2, 0.0f));
  float t0 = tca - thc;
  float t1 = tca + thc;
  t = t0 > DIST_EPSILON ? t0 : t1;
  return ok && t > DIST_EPSILON;
}

__device__ __forceinline__ bool ray_plane(const Sheet& sh, int j, V3 o, V3 d, float& t) {
  V3 n = {sh.at(M_PLA_NX, j), sh.at(M_PLA_NY, j), sh.at(M_PLA_NZ, j)};
  float denom = dot(n, d);
  bool ok = fabsf(denom) > 1e-12f;
  t = (sh.at(M_PLA_D, j) - dot(n, o)) / (ok ? denom : 1.0f);
  return ok && t > DIST_EPSILON;
}

struct Hit {
  float t;
  int kind;
  int j;  // plane index, sheet primitive column (dense) or table index (wide BVH)
  float u, v;
};

// The planes against a running hit: a strict comparison keeps the lowest
// index on ties (intersect_scene's first-min).
__device__ __forceinline__ void plane_hit(const Sheet& sh, V3 o, V3 d, Hit& h) {
  const int n_planes = sh.count(M_N_PLANES);
  for (int j = 0; j < n_planes; ++j) {
    float t;
    if (ray_plane(sh, j, o, d, t) && t < h.t) h = {t, KIND_PLANE, j, h.u, h.v};
  }
}

// The planes against a running shadow distance (intersect_shadow).
__device__ __forceinline__ float plane_shadow(const Sheet& sh, V3 o, V3 d, float best) {
  const int n_planes = sh.count(M_N_PLANES);
  for (int j = 0; j < n_planes; ++j) {
    float t;
    if (ray_plane(sh, j, o, d, t)) best = fminf(best, t);
  }
  return best;
}

}  // namespace
