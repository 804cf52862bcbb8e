// Ray queries against a mesh scene on Hopper (sm_90a): the closest hit and
// the nearest occluder over the planes and the clustered wide BVH
// (csrc/wide_bvh.cuh), one thread per ray for the walk and the whole warp
// for each leaf sweep. kernels.closest_wide and kernels.shadow_wide launch
// them; their plain versions are tracer.intersect_scene and
// tracer.intersect_shadow.
//
// wide_closest_kernel replaces the TPU closest-hit traversal: the walk
// (pyrite_tpu/kernels.py:125 `_walk_kernel`), the pop (:337
// `_fetch_slab_kernel`) and the closest-hit leaf sweep (:541
// `_make_sweep_closest_kernel`), which the TPU package ran as separate
// launches inside an XLA loop. wide_shadow_kernel does the same with the
// any-hit sweep (:593 `_make_sweep_shadow_kernel`). What bounds them is
// described in csrc/wide_bvh.cuh: the leaf rows tested (leaf * 48 bytes per
// visited leaf, from L2 while clu_geo fits there), the walk's divergence
// within a warp and the sweep's shuffles. Threads past the end of the
// wavefront take part in the traversal without a ray and return after it.

#include "common.cuh"
#include "wide_bvh.cuh"

namespace {

struct RayArgs {
  Sheet sheet;  // the planes (kernels_dense.build_pack's sheet)
  WideBvh bvh;
  const float* __restrict__ origin;     // [N, 3]
  const float* __restrict__ direction;  // [N, 3]
  int n;
};

__global__ void __launch_bounds__(BLOCK)
    wide_closest_kernel(const RayArgs a, const float* __restrict__ t_in,
                        const int* __restrict__ kind_in, const int* __restrict__ idx_in,
                        const float* __restrict__ u_in, const float* __restrict__ v_in,
                        float* __restrict__ t_out, int* __restrict__ kind_out,
                        int* __restrict__ idx_out, float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ray = lane < a.n;
  const V3 o = ray ? load3(a.origin, lane) : V3{0.0f, 0.0f, 0.0f};
  const V3 d = ray ? load3(a.direction, lane) : V3{0.0f, 0.0f, 0.0f};
  Hit h = {INFINITY, KIND_NONE, 0, 0.0f, 0.0f};
  if (ray) {
    h = {t_in[lane], kind_in[lane], idx_in[lane], u_in[lane], v_in[lane]};
    plane_hit(a.sheet, o, d, h);
  }
  wide_closest(a.bvh, o, d, h, ray);
  if (!ray) return;
  t_out[lane] = h.t;
  kind_out[lane] = h.kind;
  idx_out[lane] = h.j;
  u_out[lane] = h.u;
  v_out[lane] = h.v;
}

__global__ void __launch_bounds__(BLOCK)
    wide_shadow_kernel(const RayArgs a, const float* __restrict__ max_dist,
                       const float* __restrict__ block_below, float* __restrict__ t_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ray = lane < a.n;
  const V3 o = ray ? load3(a.origin, lane) : V3{0.0f, 0.0f, 0.0f};
  const V3 d = ray ? load3(a.direction, lane) : V3{0.0f, 0.0f, 0.0f};
  const float t0 = ray ? plane_shadow(a.sheet, o, d, max_dist[lane]) : 0.0f;
  const float t = wide_shadow(a.bvh, o, d, t0, ray ? block_below[lane] : 0.0f, ray);
  if (ray) t_out[lane] = t;
}

}  // namespace

extern "C" {

// Plain C launchers for ctypes, as in csrc/bounce.cu: device pointers, the
// caller's stream; each returns cudaGetLastError() after the launch.

int pyrite_wide_closest(const float* sheet, const int* meta, const float* rows, const float* geo,
                        int leaf, const float* origin, const float* direction, const float* t_in,
                        const int* kind_in, const int* idx_in, const float* u_in,
                        const float* v_in, float* t_out, int* kind_out, int* idx_out,
                        float* u_out, float* v_out, int n, void* stream) {
  const RayArgs a = {{sheet, meta}, {rows, geo, leaf}, origin, direction, n};
  wide_closest_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      a, t_in, kind_in, idx_in, u_in, v_in, t_out, kind_out, idx_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int pyrite_wide_shadow(const float* sheet, const int* meta, const float* rows, const float* geo,
                       int leaf, const float* origin, const float* direction,
                       const float* max_dist, const float* block_below, float* t_out, int n,
                       void* stream) {
  const RayArgs a = {{sheet, meta}, {rows, geo, leaf}, origin, direction, n};
  wide_shadow_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      a, max_dist, block_below, t_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
