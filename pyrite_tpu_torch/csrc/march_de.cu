// The DE march on its own (kernels.march_de; its plain version is
// tracer.march_de_plain): march_de_kernel (csrc/march_de.cuh) over rays
// given in the shape's local space. It replaces the TPU kernel
// pyrite_tpu/kernels.py `_make_march_kernel` (:907, launched by `march_de`
// :1096): the same 9 inputs (local origin and direction xyz, t0, tmax, hit)
// and 2 outputs (total, dist). The design, and what bounds it, are in
// csrc/march_de.cuh.

#include "common.cuh"
#include "march_de.cuh"

namespace {

// The query's rays: one shape, given by value, and each ray's march set up
// by the caller.
struct QueryRays {
  static constexpr int kBlocksPerSm = 4;  // as the bounce rays (launch_march)
  DeShape s;
  const float* __restrict__ local_origin;
  const float* __restrict__ direction;
  const float* __restrict__ t0;
  const float* __restrict__ tmax;
  const uint8_t* __restrict__ hit;
  float* __restrict__ total;
  float* __restrict__ dist;

  __device__ __forceinline__ DeShape shape(int) const { return s; }

  __device__ __forceinline__ March begin(const DeShape&, int i) const {
    return march_start(load3(local_origin, i), load3(direction, i), t0[i], tmax[i], hit[i] != 0);
  }

  __device__ __forceinline__ void end(long long i, const March& m) const {
    total[i] = m.total;
    dist[i] = m.dist;
  }
};

}  // namespace

extern "C" {

// Plain C launcher for ctypes, as in csrc/bounce.cu. `fields` is a HOST
// array of the shape's DE_NFIELDS parameters (kernels_dense.de_fields),
// passed to the kernel by value; the other pointers are device addresses;
// `next` is the pass's work counter (8 bytes), zeroed before the launch.
int pyrite_march_de(const float* fields, const float* local_origin, const float* direction,
                    const float* t0, const float* tmax, const uint8_t* hit, int max_steps,
                    float omega, float* total, float* dist, int n, unsigned long long* next,
                    void* stream) {
  const QueryRays rays = {de_shape(fields), local_origin, direction, t0, tmax, hit, total, dist};
  return launch_march(rays, 1, n, max_steps, omega, next, (cudaStream_t)stream);
}

}  // extern "C"
