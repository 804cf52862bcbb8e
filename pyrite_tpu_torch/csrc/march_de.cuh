// The sphere-traced march of a distance-estimated (DE) shape, one thread per
// ray: the estimators, the march, the bounded intersection and the normal.
// march_de_kernel (csrc/march_de.cu) runs the march alone; the bounce and NEE
// kernels (csrc/bounce.cu) run the intersection for every DE shape after the
// primitives, and the normal at a DE hit.
//
// It replaces pyrite_tpu/kernels.py `_make_march_kernel` (:907, with the
// estimators `_de_step_mandelbulb` :758 and `_de_step_julia` :797), the TPU
// kernel that ran the whole march of one shape in one launch. That kernel
// was specialised per shape (its parameters static); here they come at run
// time in a DeShape, whose kind and variant branches are uniform across a
// warp. The TPU loop stepped a whole block while any lane was active; here
// each thread loops while its own ray is active, which computes the same,
// because a lane that stops never changes again. Likewise a thread leaves
// the estimator's iteration loop once its orbit escapes: z, dz and r are
// frozen from then on in the masked TPU loop. The TPU package's opt-in bf16
// Julia and its unroll groups are not carried over.
//
// Numerics follow tracer.de_distance / march_de_plain op for op (the JAX
// package's order), with the libm functions PyTorch's CUDA ops call: sqrtf,
// acosf, atan2f, sinf, cosf, logf and powf (torch.pow with an exponent of 7
// or 8 takes the generic powf), no fast-math intrinsics, and --fmad=false.
// Orbits are chaotic, so where the two libms differ by an ulp a point can
// still escape at another iteration; the checks compare hit flags and t.
//
// What bounds it on an H100: FP32 issue and the libm calls. Per step a ray
// runs up to `iterations` estimator iterations (~30 operations and seven
// libm calls each for a Mandelbulb, ~80 operations for a cubic Julia) and
// touches no memory beyond its 9 inputs and 2 outputs (march_de_kernel) or
// the sheet's DE columns, which every lane of a warp reads at once. Its
// cost follows the steps and iterations each ray needs, and a warp waits
// for its longest ray. Packet marching, cone tracing and ordering rays by
// their step count are later work.
#pragma once

#include "common.cuh"

namespace {

enum { DE_MANDELBULB = 0, DE_JULIA = 1 };
enum { JULIA_REGULAR = 0, JULIA_CUBIC = 1, JULIA_BICOMPLEX = 2 };
enum { BOUNDS_BOX = 0, BOUNDS_SPHERE = 1 };
constexpr int DE_NFIELDS = M_DE_MAT - M_DE_KIND + 1;

// One shape's parameters (kernels_dense.de_fields).
struct DeShape {
  int kind, variant, iterations;
  float threshold, thr2, power, power_m1;
  bool has_constant;
  float c[4];
  float slice;
  int bounds_kind;
  V3 a, b, center;  // box min / max, or sphere center / (radius, 0, 0); local origin
  int mat;
};

// A DeShape from its fields in kernels_dense.DE_FIELDS order (host or device).
__host__ __device__ __forceinline__ DeShape de_shape(const float* f) {
  DeShape s;
  s.kind = (int)f[0];
  s.variant = (int)f[1];
  s.iterations = (int)f[2];
  s.threshold = f[3];
  s.thr2 = f[4];
  s.power = f[5];
  s.power_m1 = f[6];
  s.has_constant = f[7] != 0.0f;
  for (int i = 0; i < 4; ++i) s.c[i] = f[8 + i];
  s.slice = f[12];
  s.bounds_kind = (int)f[13];
  s.a = {f[14], f[15], f[16]};
  s.b = {f[17], f[18], f[19]};
  s.center = {f[20], f[21], f[22]};
  s.mat = (int)f[23];
  return s;
}

// DE shape j of the sheet.
__device__ __forceinline__ DeShape load_de(const Sheet& sh, int j) {
  float f[DE_NFIELDS];
#pragma unroll
  for (int i = 0; i < DE_NFIELDS; ++i) f[i] = sh.at(M_DE_KIND + i, j);
  return de_shape(f);
}

// Mandelbulb (tracer._de_mandelbulb): z -> r^p (sin(p theta) cos(p phi),
// sin(p phi) sin(p theta), cos(p theta)) + c, dr -> r^(p-1) p dr + dc.
__device__ float de_mandelbulb(const DeShape& s, V3 p) {
  const float cx = s.has_constant ? s.c[0] : p.x;
  const float cy = s.has_constant ? s.c[1] : p.y;
  const float cz = s.has_constant ? s.c[2] : p.z;
  const float dc = s.has_constant ? 0.0f : 1.0f;
  float zx = p.x, zy = p.y, zz = p.z;
  float r = 0.0f, dr = 1.0f;
  for (int i = 0; i < s.iterations; ++i) {
    const float r_new = sqrtf(fmaxf(zx * zx + zy * zy + zz * zz, 1e-30f));
    r = r_new;
    if (r_new > s.threshold) break;  // escaped: z and dr stay as they are
    const float theta = acosf(fminf(fmaxf(zz / r_new, -1.0f), 1.0f)) * s.power;
    const float phi = atan2f(zy, zx) * s.power;
    const float dr_new = powf(r_new, s.power_m1) * s.power * dr + dc;
    const float zr = powf(r_new, s.power);
    const float st = sinf(theta);
    zx = st * cosf(phi) * zr + cx;
    zy = sinf(phi) * st * zr + cy;
    zz = cosf(theta) * zr + cz;
    dr = dr_new;
  }
  return 0.5f * logf(fmaxf(r, 1e-30f)) * r / dr;
}

struct Q4 {
  float s, x, y, z;
};

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.s * b.s - a.x * b.x - a.y * b.y - a.z * b.z,
          a.s * b.x + a.x * b.s + a.y * b.z - a.z * b.y,
          a.s * b.y - a.x * b.z + a.y * b.s + a.z * b.x,
          a.s * b.z + a.x * b.y - a.y * b.x + a.z * b.s};
}

// z * z of a quaternion, which commutes with itself: (s^2 - |v|^2, 2 s v)
__device__ __forceinline__ Q4 qsq(Q4 q) {
  const float v2 = q.x * q.x + q.y * q.y + q.z * q.z;
  const float s2 = q.s + q.s;
  return {q.s * q.s - v2, s2 * q.x, s2 * q.y, s2 * q.z};
}

// bicomplex product and square, (x, y, z, w) in the fields (s, x, y, z)
__device__ __forceinline__ Q4 bmul(Q4 a, Q4 b) {
  return {a.s * b.s - a.x * b.x - a.y * b.y + a.z * b.z,
          a.s * b.x + a.x * b.s - a.y * b.z - a.z * b.y,
          a.s * b.y - a.x * b.z + a.y * b.s - a.z * b.x,
          a.s * b.z + a.x * b.y + a.y * b.x + a.z * b.s};
}

__device__ __forceinline__ Q4 bsq(Q4 q) {
  return {q.s * q.s - q.x * q.x - q.y * q.y + q.z * q.z, 2.0f * (q.s * q.x - q.y * q.z),
          2.0f * (q.s * q.y - q.x * q.z), 2.0f * (q.s * q.z + q.x * q.y)};
}

__device__ __forceinline__ Q4 qscale(Q4 q, float f) { return {q.s * f, q.x * f, q.y * f, q.z * f}; }

// Quaternion Julia (tracer._de_julia): z = (x, y, z, slice), the square
// shared, the derivative re-associated ((dz z) z = dz z^2), the escape radius
// carried squared.
__device__ float de_julia(const DeShape& s, V3 p) {
  Q4 z = {p.x, p.y, p.z, s.slice};
  Q4 dz = {1.0f, 0.0f, 0.0f, 0.0f};
  float r2 = 0.0f;
  for (int i = 0; i < s.iterations; ++i) {
    const float r2_new = z.s * z.s + z.x * z.x + z.y * z.y + z.z * z.z;
    r2 = r2_new;
    if (r2_new > s.thr2) break;  // escaped: z and dz stay as they are
    Q4 zp;
    if (s.variant == JULIA_REGULAR) {
      zp = qsq(z);
      dz = qscale(qmul(dz, z), 2.0f);
    } else if (s.variant == JULIA_CUBIC) {
      const Q4 q2 = qsq(z);
      zp = qmul(q2, z);
      dz = qscale(qmul(dz, q2), 3.0f);
    } else {
      zp = bsq(z);
      dz = qscale(bmul(dz, zp), 2.0f);
    }
    z = {zp.s + s.c[0], zp.x + s.c[1], zp.y + s.c[2], zp.z + s.c[3]};
  }
  const float r = sqrtf(fmaxf(r2, 1e-30f));
  const float dz_mag = sqrtf(fmaxf(dz.s * dz.s + dz.x * dz.x + dz.y * dz.y + dz.z * dz.z, 1e-30f));
  return 0.5f * logf(fmaxf(r, 1e-30f)) * r / dz_mag;
}

__device__ __forceinline__ float de_distance(const DeShape& s, V3 p) {
  return s.kind == DE_MANDELBULB ? de_mandelbulb(s, p) : de_julia(s, p);
}

// The march (tracer.march_de_plain) in the shape's local space: from t0
// while t < tmax and the last safe distance is at least DIST_EPSILON, at most
// max_steps steps. With omega > 1 each step is omega * d, stepping back to
// the plain step from the previous point when consecutive step spheres stop
// overlapping (s_prev > d_prev + d); no relaxed step leaps past tmax, and
// dist tracks safe evaluations only.
__device__ void march_de(const DeShape& s, V3 lo, V3 d, float t0, float tmax, bool hit,
                         int max_steps, float omega, float& total, float& dist) {
  total = t0;
  dist = INFINITY;
  float s_prev = 0.0f, d_prev = 1e30f;
  const bool relaxed = omega > 1.0f;
  for (int step = 0; step < max_steps; ++step) {
    if (!(hit && total < tmax && dist >= DIST_EPSILON)) break;
    const float de = de_distance(s, lo + d * total);
    if (!relaxed) {
      total = total + de;
      dist = de;
      continue;
    }
    const bool unsafe = s_prev > d_prev + de;
    const float t_revert = total - s_prev + d_prev;
    float st = omega * de;
    if (total + st > tmax) st = de;
    if (unsafe) {
      total = t_revert;
      s_prev = d_prev;
    } else {
      total = total + st;
      dist = de;
      s_prev = st;
      d_prev = de;
    }
  }
}

// The shape's bounding volume, then the march (tracer.intersect_de): true
// and t on a hit, else false and t = inf. t_cap (INFINITY for none) caps
// the march, as the lamp distance does for a shadow ray.
__device__ bool intersect_de(const DeShape& s, V3 o, V3 d, float t_cap, int max_steps, float omega,
                             float& t) {
  bool hit;
  float tmin, tmax;
  if (s.bounds_kind == BOUNDS_BOX) {
    // geometry.ray_aabb_range: NaN from 0 * inf propagates and misses
    const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
    const float t1x = (s.a.x - o.x) * ix, t2x = (s.b.x - o.x) * ix;
    const float t1y = (s.a.y - o.y) * iy, t2y = (s.b.y - o.y) * iy;
    const float t1z = (s.a.z - o.z) * iz, t2z = (s.b.z - o.z) * iz;
    tmin = nan_max(nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)), nan_min(t1z, t2z)), 0.0f);
    tmax = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)), nan_max(t1z, t2z));
    hit = tmin < tmax;
  } else {
    // geometry.ray_sphere_range, with its tca >= 0 requirement
    const V3 l = s.a - o;
    const float tca = dot(l, d);
    const float d2 = dot(l, l) - tca * tca;
    const float r2 = s.b.x * s.b.x;
    hit = tca >= 0.0f && d2 <= r2;
    const float thc = sqrtf(fmaxf(r2 - d2, 0.0f));
    tmin = nan_max(tca - thc, 0.0f);
    tmax = tca + thc;
  }
  tmax = nan_min(tmax, t_cap);
  float total, dist;
  march_de(s, o - s.center, d, hit ? tmin : INFINITY, tmax, hit, max_steps, omega, total, dist);
  const bool ok = hit && total <= tmax;
  t = ok ? total : INFINITY;
  return ok;
}

// How far and how relaxed the bounce kernels march (TraceConfig.max_de_steps,
// de_omega).
struct DeMarch {
  int steps;
  float omega;
};

// The DE shapes after the primitives (tracer.intersect_scene): a hit counts
// beyond DIST_EPSILON and strictly nearer than the running hit.
__device__ __forceinline__ void de_closest(const Sheet& sh, const DeMarch& m, V3 o, V3 d, Hit& h) {
  const int n_de = sh.count(M_N_DE);
  for (int j = 0; j < n_de; ++j) {
    float t;
    if (intersect_de(load_de(sh, j), o, d, INFINITY, m.steps, m.omega, t) && t > DIST_EPSILON &&
        t < h.t)
      h = {t, KIND_DE, j, h.u, h.v};
  }
}

// The DE shapes along a shadow ray (tracer.intersect_shadow): marched no
// further than the lamp distance, a hit at any t (negative included)
// lowers the running t.
__device__ __forceinline__ float de_shadow(const Sheet& sh, const DeMarch& m, V3 o, V3 d,
                                           float t_cap, float best) {
  const int n_de = sh.count(M_N_DE);
  for (int j = 0; j < n_de; ++j) {
    float t;
    intersect_de(load_de(sh, j), o, d, t_cap, m.steps, m.omega, t);
    best = nan_min(best, t);
  }
  return best;
}

// Normal and material of a hit on DE shape j (tracer.de_normal): central
// differences, eps = DIST_EPSILON, DIST_EPSILON short of the hit in local
// space. The probes add (+-eps, +-0, +-0) as the plain version's offsets do.
__device__ void de_surface(const Sheet& sh, int j, V3 o, V3 d, float t, V3& normal, int& mat) {
  const DeShape s = load_de(sh, j);
  const V3 l = (o - s.center) + d * (t - DIST_EPSILON);
  const float e = DIST_EPSILON;
  const float dxp = de_distance(s, {l.x + e, l.y + 0.0f, l.z + 0.0f});
  const float dyp = de_distance(s, {l.x + 0.0f, l.y + e, l.z + 0.0f});
  const float dzp = de_distance(s, {l.x + 0.0f, l.y + 0.0f, l.z + e});
  const float dxm = de_distance(s, {l.x + -e, l.y + -0.0f, l.z + -0.0f});
  const float dym = de_distance(s, {l.x + -0.0f, l.y + -e, l.z + -0.0f});
  const float dzm = de_distance(s, {l.x + -0.0f, l.y + -0.0f, l.z + -e});
  normal = normalize(V3{dxp - dxm, dyp - dym, dzp - dzm});
  mat = s.mat;
}

}  // namespace
