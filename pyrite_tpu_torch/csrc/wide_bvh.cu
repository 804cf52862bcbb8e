// Ray queries against a mesh scene on Hopper (sm_90a), one thread per ray:
// the closest hit and the nearest occluder over the planes and the
// clustered wide BVH (csrc/wide_bvh.cuh). kernels.closest_wide and
// kernels.shadow_wide launch them; their plain versions are
// tracer.intersect_scene and tracer.intersect_shadow.
//
// wide_closest_kernel replaces the TPU closest-hit traversal: the walk
// (pyrite_tpu/kernels.py:125 `_walk_kernel`), the pop (:337
// `_fetch_slab_kernel`) and the closest-hit leaf sweep (:541
// `_make_sweep_closest_kernel`), which the TPU package ran as separate
// launches inside an XLA loop. wide_shadow_kernel does the same with the
// any-hit sweep (:593 `_make_sweep_shadow_kernel`). What bounds them is
// described in csrc/wide_bvh.cuh: per ray, the leaves it visits (leaf * 48
// bytes each, from L2 while clu_geo fits there) and the divergence of the
// walk within a warp.

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
  if (lane >= a.n) return;
  const V3 o = load3(a.origin, lane);
  const V3 d = load3(a.direction, lane);
  Hit h = {t_in[lane], kind_in[lane], idx_in[lane], u_in[lane], v_in[lane]};
  plane_hit(a.sheet, o, d, h);
  wide_closest(a.bvh, o, d, h);
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
  if (lane >= a.n) return;
  const V3 o = load3(a.origin, lane);
  const V3 d = load3(a.direction, lane);
  t_out[lane] =
      wide_shadow(a.bvh, o, d, plane_shadow(a.sheet, o, d, max_dist[lane]), block_below[lane]);
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
