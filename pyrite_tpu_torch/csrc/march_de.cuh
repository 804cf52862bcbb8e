// The sphere-traced march of distance-estimated (DE) shapes on Hopper: the
// estimators, one iteration at a time; the march's state and step; and
// march_de_kernel, a persistent pass that marches rays as work items. Three
// ray sources instantiate it: the march on its own (march_de.cu, the
// 9-input query kernels.march_de), the bounce rays of a wavefront and the
// shadow rays of its NEE lanes (bounce.cu). The bounce and NEE kernels read
// the two passes' t per DE shape; the normal at a DE hit (de_normals_shared)
// stays in the bounce kernel.
//
// It replaces pyrite_tpu/kernels.py `_make_march_kernel` (:907, with the
// estimators `_de_step_mandelbulb` :758 and `_de_step_julia` :797), the TPU
// kernel that ran the whole march of one shape in one launch, a block
// stepping while any of its lanes was active. The TPU package's opt-in bf16
// Julia and its unroll groups are not carried over.
//
// Numerics follow tracer.de_distance / march_de_plain op for op (the JAX
// package's order), with the libm functions PyTorch's CUDA ops call: sqrtf,
// acosf, atan2f, sinf, cosf, logf and powf (torch.pow with an exponent of 7
// or 8 takes the generic powf), no fast-math intrinsics, and --fmad=false.
// Each ray runs the same operations in the same order whichever thread runs
// it and whenever, so the pass is bit-equal to the plain version.
//
// What bounds it on an H100: instruction issue at low SIMT efficiency, not
// memory. A ray reads its 9 inputs (or its bounce or NEE state) and writes
// one t; per march step it runs up to `iterations` estimator iterations
// (~30 operations and seven libm calls each for a Mandelbulb, ~80 operations
// for a cubic Julia). Iterations per ray are heavy-tailed (on fractal.lua's
// camera rays: median 32, p99 478, max ~2,300), and so are iterations per
// step. One thread per ray made a warp wait for its longest ray, and at each
// step for its longest orbit: 30 % of the lanes' issue slots did useful work
// on fractal.lua's 512x512 camera rays, 16 % on their first shadow rays
// (chip_smoke.py counts these and prints them as `[divergence] march`). So a loop trip here runs ONE
// estimator iteration, and a lane whose ray ends takes the next ray at once
// (Aila and Laine's persistent while-while with dynamic fetch, "Understanding
// the efficiency of ray traversal on GPUs", HPG 2009): about one resident
// grid of warps takes work items, (DE shape, ray) in shape-major order, from
// a global 64-bit counter, one atomicAdd per warp and fetch round for the
// lanes that need a ray (a ballot and a popcount): n_shapes x rays items may
// pass INT_MAX (a 1920x1080 film's 16 light samples x 128 DE shapes), rays
// per shape may not (the wrappers raise). An item whose ray misses the
// bounds, or has no ray, finishes at its fetch. What no scheduling removes
// is the longest single ray, its iterations in sequence in one thread.
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

// An estimator's orbit between two iterations. Mandelbulb: z in (z.s, z.x,
// z.y), dr in dz.s, r in r. Julia: z = (x, y, z, slice), dz, and the escape
// radius carried squared in r. `it` counts the iterations run.
struct Orbit {
  Q4 z, dz;
  float r;
  int it;
};

// The orbit of the point p before the first iteration.
__device__ __forceinline__ Orbit orbit_start(const DeShape& s, V3 p) {
  return {{p.x, p.y, p.z, s.slice}, {1.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0};
}

// One iteration of the Mandelbulb (tracer._de_mandelbulb): z -> r^p (sin(p
// theta) cos(p phi), sin(p phi) sin(p theta), cos(p theta)) + c, dr -> r^(p-1)
// p dr + dc. True once the orbit has escaped (z and dr then stay as they
// are) or run `iterations`.
__device__ __forceinline__ bool mandelbulb_step(const DeShape& s, V3 p, Orbit& o) {
  const float cx = s.has_constant ? s.c[0] : p.x;
  const float cy = s.has_constant ? s.c[1] : p.y;
  const float cz = s.has_constant ? s.c[2] : p.z;
  const float dc = s.has_constant ? 0.0f : 1.0f;
  const float zx = o.z.s, zy = o.z.x, zz = o.z.y;
  const float r_new = sqrtf(fmaxf(zx * zx + zy * zy + zz * zz, 1e-30f));
  o.r = r_new;
  if (r_new > s.threshold) return true;
  const float theta = acosf(fminf(fmaxf(zz / r_new, -1.0f), 1.0f)) * s.power;
  const float phi = atan2f(zy, zx) * s.power;
  const float dr_new = powf(r_new, s.power_m1) * s.power * o.dz.s + dc;
  const float zr = powf(r_new, s.power);
  const float st = sinf(theta);
  o.z.s = st * cosf(phi) * zr + cx;
  o.z.x = sinf(phi) * st * zr + cy;
  o.z.y = cosf(theta) * zr + cz;
  o.dz.s = dr_new;
  return ++o.it >= s.iterations;
}

// One iteration of the quaternion Julia (tracer._de_julia): the square
// shared, the derivative re-associated ((dz z) z = dz z^2). True once the
// orbit has escaped (z and dz then stay as they are) or run `iterations`.
__device__ __forceinline__ bool julia_step(const DeShape& s, Orbit& o) {
  const Q4 z = o.z;
  const float r2_new = z.s * z.s + z.x * z.x + z.y * z.y + z.z * z.z;
  o.r = r2_new;
  if (r2_new > s.thr2) return true;
  Q4 zp;
  if (s.variant == JULIA_REGULAR) {
    zp = qsq(z);
    o.dz = qscale(qmul(o.dz, z), 2.0f);
  } else if (s.variant == JULIA_CUBIC) {
    const Q4 q2 = qsq(z);
    zp = qmul(q2, z);
    o.dz = qscale(qmul(o.dz, q2), 3.0f);
  } else {
    zp = bsq(z);
    o.dz = qscale(bmul(o.dz, zp), 2.0f);
  }
  o.z = {zp.s + s.c[0], zp.x + s.c[1], zp.y + s.c[2], zp.z + s.c[3]};
  return ++o.it >= s.iterations;
}

// One iteration of the shape's estimator at the point p (the orbit's start);
// true once the orbit is done. The branches on kind and variant are uniform
// across a warp whose rays march one shape.
__device__ __forceinline__ bool orbit_step(const DeShape& s, V3 p, Orbit& o) {
  if (o.it >= s.iterations) return true;
  return s.kind == DE_MANDELBULB ? mandelbulb_step(s, p, o) : julia_step(s, o);
}

// The distance estimate of a finished orbit.
__device__ __forceinline__ float orbit_distance(const DeShape& s, const Orbit& o) {
  if (s.kind == DE_MANDELBULB) return 0.5f * logf(fmaxf(o.r, 1e-30f)) * o.r / o.dz.s;
  const float r = sqrtf(fmaxf(o.r, 1e-30f));
  const Q4 dz = o.dz;
  const float dz_mag = sqrtf(fmaxf(dz.s * dz.s + dz.x * dz.x + dz.y * dz.y + dz.z * dz.z, 1e-30f));
  return 0.5f * logf(fmaxf(r, 1e-30f)) * r / dz_mag;
}

// The distance estimate at the local point p, all iterations in this thread
// (tracer.de_distance): the bounce kernel's DE-normal probes.
__device__ float de_distance(const DeShape& s, V3 p) {
  Orbit o = orbit_start(s, p);
  while (!orbit_step(s, p, o)) {
  }
  return orbit_distance(s, o);
}

// A march in the shape's local space (tracer.march_de_plain): from t0 while
// t < tmax and the last safe distance is at least DIST_EPSILON, at most
// max_steps steps. With omega > 1 each step is omega * d, stepping back to
// the plain step from the previous point when consecutive step spheres stop
// overlapping (s_prev > d_prev + d); no relaxed step leaps past tmax, and
// dist tracks safe evaluations only.
struct March {
  V3 lo, d;
  float total, dist, s_prev, d_prev, tmax;
  int step;
  bool hit;
};

__device__ __forceinline__ March march_start(V3 lo, V3 d, float t0, float tmax, bool hit) {
  return {lo, d, t0, INFINITY, 0.0f, 1e30f, tmax, 0, hit};
}

// A march that takes no step and misses: a work item without a ray.
__device__ __forceinline__ March no_march() {
  return march_start({0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, INFINITY, INFINITY, false);
}

// Whether the march takes another step.
__device__ __forceinline__ bool marching(const March& m, int max_steps) {
  return m.step < max_steps && m.hit && m.total < m.tmax && m.dist >= DIST_EPSILON;
}

// Where the next distance estimate is taken.
__device__ __forceinline__ V3 march_point(const March& m) { return m.lo + m.d * m.total; }

// One step with the distance estimate de at march_point.
__device__ __forceinline__ void march_step(March& m, float de, float omega) {
  ++m.step;
  if (!(omega > 1.0f)) {
    m.total = m.total + de;
    m.dist = de;
    return;
  }
  const bool unsafe = m.s_prev > m.d_prev + de;
  const float t_revert = m.total - m.s_prev + m.d_prev;
  float st = omega * de;
  if (m.total + st > m.tmax) st = de;
  if (unsafe) {
    m.total = t_revert;
    m.s_prev = m.d_prev;
  } else {
    m.total = m.total + st;
    m.dist = de;
    m.s_prev = st;
    m.d_prev = de;
  }
}

// The march toward shape s as tracer.intersect_de sets it up: the range of
// the ray inside the bounding volume, capped at t_cap (INFINITY for none, the
// lamp distance for a shadow ray).
__device__ __forceinline__ March march_toward(const DeShape& s, V3 o, V3 d, float t_cap) {
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
  return march_start(o - s.center, d, hit ? tmin : INFINITY, nan_min(tmax, t_cap), hit);
}

// The hit of a finished march (tracer.intersect_de): t, or inf where the
// march ended outside the bounds or never entered them.
__device__ __forceinline__ float march_t(const March& m) {
  return m.hit && m.total <= m.tmax ? m.total : INFINITY;
}

// The persistent march. `Rays` is the ray source: shape(j) gives DE shape j,
// begin(shape, r) the march of ray r toward it, end(item, march) stores the
// finished item's result, kBlocksPerSm caps the resident blocks per SM (0:
// no cap; see launch_march). Item i (64-bit) is (shape i / per_shape, ray
// i % per_shape), and each source stores item i's result at index i.
//
// A lane reads its item's shape from the sheet into registers as it fetches
// the item (rays.shape(j)), so no shared memory grows with the shape count
// and a scene of any number of shapes runs. (Staging every shape in shared
// memory first, 96 bytes a shape, held at most 2,410 a block, left one block
// a SM at that count and was no faster at 1 or 130 shapes: PERF.md row 3.)
//
// Every thread of the grid runs the loop to the end, so the warp operations
// (the ballot, the shuffle, the vote) are reached by all 32 threads: each
// branch between two of them is an `if` that reconverges, and the loops
// around them end on a warp-wide vote. A loop trip runs one fetch round for
// the lanes without a ray (until every lane has one or the items are
// drained), then one estimator iteration on each lane with a ray; a lane
// whose orbit ends takes the march step and starts the next orbit, or
// stores its result and asks for the next item.
template <class Rays>
__global__ void __launch_bounds__(BLOCK)
    march_de_kernel(const Rays rays, int n_shapes, int per_shape, int max_steps, float omega,
                    unsigned long long* __restrict__ next) {
  const long long items = (long long)n_shapes * per_shape;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  March m = no_march();
  Orbit o = {};
  V3 p = {0.f, 0.f, 0.f};
  long long item = 0;
  DeShape s = {};  // the shape of the lane's item
  bool active = false, drained = false;
  for (;;) {
    for (;;) {
      const bool idle = !active && !drained;
      const unsigned want = __ballot_sync(FULL_WARP, idle);
      if (want == 0) break;
      long long base = 0;
      if ((threadIdx.x & 31) == 0) base = (long long)atomicAdd(next, (unsigned long long)__popc(want));
      base = __shfl_sync(FULL_WARP, base, 0);
      if (idle) {
        item = base + __popc(want & below);
        if (item >= items) {
          drained = true;
        } else {
          const int j = (int)(item / per_shape);
          s = rays.shape(j);
          m = rays.begin(s, (int)(item - (long long)j * per_shape));
          active = marching(m, max_steps);
          if (active) {
            p = march_point(m);
            o = orbit_start(s, p);
          } else {
            rays.end(item, m);
          }
        }
      }
    }
    if (!__any_sync(FULL_WARP, active)) break;
    if (active) {
      if (orbit_step(s, p, o)) {
        march_step(m, orbit_distance(s, o), omega);
        active = marching(m, max_steps);
        if (active) {
          p = march_point(m);
          o = orbit_start(s, p);
        } else {
          rays.end(item, m);
        }
      }
    }
  }
}

// Launch march_de_kernel over n_shapes x per_shape items on about one
// resident grid: the SM count x the blocks of BLOCK threads an SM holds at
// this kernel's registers and shared memory, at most Rays::kBlocksPerSm
// where that is set (no more blocks than items fill). `next` is the
// caller's 8-byte counter in device memory, zeroed here on the stream before
// the launch, so a launch repeated with the same arguments marches every item
// again. The kernel takes no dynamic shared memory. Returns the first CUDA
// error (0 on success).
//
// Why the cap: the pass ends with its longest rays, each a chain of
// iterations in one thread (~0.9 us per Mandelbulb iteration for a warp
// alone on an H100), and while the other warps of its SM still run, a
// long ray's warp gets only its share of the scheduler's issue slots. On
// camera and bounce rays fewer warps per scheduler let the long rays
// advance while the rest still fills the issue slots: the cap of 4 blocks of
// 128 threads per SM (4 warps per scheduler) was chosen by timing the pass
// on fractal.lua's camera rays on an H100. Shadow rays, of which most end
// at their fetch, are marched at full occupancy. chip_smoke.py prints the
// pass times, and the longest ray alone.
template <class Rays>
int launch_march(const Rays& rays, int n_shapes, int per_shape, int max_steps, float omega,
                 unsigned long long* next, cudaStream_t stream) {
  const auto kernel = march_de_kernel<Rays>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(next, 0, sizeof(*next), stream);
  if (e != cudaSuccess) return (int)e;
  if (Rays::kBlocksPerSm > 0 && per_sm > Rays::kBlocksPerSm) per_sm = Rays::kBlocksPerSm;
  const long long fill = ((long long)n_shapes * per_shape + BLOCK - 1) / BLOCK;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(fill < resident ? (fill > 0 ? fill : 1) : (resident > 0 ? resident : 1));
  kernel<<<grid, BLOCK, 0, stream>>>(rays, n_shapes, per_shape, max_steps, omega, next);
  return (int)cudaGetLastError();
}

}  // namespace
