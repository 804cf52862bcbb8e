// The DE march on its own, one thread per ray (kernels.march_de; its plain
// version is tracer.march_de_plain). It replaces the TPU kernel
// pyrite_tpu/kernels.py `_make_march_kernel` (:907, launched by `march_de`
// :1096): the same 9 inputs (local origin and direction xyz, t0, tmax, hit)
// and 2 outputs (total, dist). The march itself, and what bounds it, are in
// csrc/march_de.cuh.

#include "common.cuh"
#include "march_de.cuh"

namespace {

__global__ void __launch_bounds__(BLOCK)
    march_de_kernel(const DeShape s, const float* __restrict__ local_origin,
                    const float* __restrict__ direction, const float* __restrict__ t0,
                    const float* __restrict__ tmax, const uint8_t* __restrict__ hit, int max_steps,
                    float omega, float* __restrict__ total, float* __restrict__ dist, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  march_de(s, load3(local_origin, lane), load3(direction, lane), t0[lane], tmax[lane],
           hit[lane] != 0, max_steps, omega, total[lane], dist[lane]);
}

}  // namespace

extern "C" {

// Plain C launcher for ctypes, as in csrc/bounce.cu. `fields` is a HOST
// array of the shape's DE_NFIELDS parameters (kernels_dense.de_fields),
// passed to the kernel by value; the other pointers are device addresses.
int pyrite_march_de(const float* fields, const float* local_origin, const float* direction,
                    const float* t0, const float* tmax, const uint8_t* hit, int max_steps,
                    float omega, float* total, float* dist, int n, void* stream) {
  const DeShape s = de_shape(fields);
  march_de_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      s, local_origin, direction, t0, tmax, hit, max_steps, omega, total, dist, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
