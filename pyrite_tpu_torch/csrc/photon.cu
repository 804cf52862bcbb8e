// The photon renderer's radius gather on Hopper: photon_gather_kernel, the
// kernel of kernels_dense.photon_gather, whose plain version is
// pyrite_tpu_torch/renderers/photon.py gather_plain.
//
// It replaces no Pallas kernel: the JAX package computes the gather in XLA
// (pyrite_tpu/renderers/photon.py:310 `_gather`, its fori_loop of 27 x 32
// scan steps at :395-468). That loop rewrites every lane's [N, B] bins at
// each of its 864 steps; here one thread owns one camera vertex for one
// camera bounce and photon map, scans its candidates itself and keeps its
// bins on chip.
//
// Per valid camera vertex: the 27 neighbour cells of its hash-grid cell
// (floor(position / radius), a true division; the key's products wrap as
// uint32), each found by a binary search over the map's sorted int32 keys
// (searchsorted, left), then up to CELL_CAP photons of the cell in the JAX
// package's order, the index clipped to P - 1 as it clips it. A photon
// within the radius counts in num_neighbors; a pair (not both dispersed)
// adds r x p x g, g the first BRDF times the geometry weight, to the film
// bin of its primary wavelength (acc_bins, cnt_bins), r and p the two
// chains at that wavelength: in exact mode re-walked from color-program
// counts and the programs' log factors (chain_eval), else interpolated
// from the camera's wavelength grid and the photon's bin row (interp);
// where neither dispersed, each fresh wavelength's photon chain times g
// adds into fresh_psum. The adds come in the scan order of the plain
// version, so the sums agree with it to rounding (the counts exactly).
//
// What bounds it on an H100: the bytes it must move are the map (per
// photon a key, position, incident direction, flags, wavelength and its
// power row, or in exact mode its counts and factors) and per lane its
// vertex and chain row in, 4 (2 B + K) + 8 out: memory-bound at the
// flagship's 131,072 lanes and ~900,000 photons. Each lane spends ~20
// dependent key loads on each of its 27 binary searches and then reads its
// candidates one by one: the kernel is bound by the latency of those L2
// reads and by its occupancy. The design keeps it simple:
// - the photon fields arrive gathered into cell order once per map
//   (build_map), so a cell's photons are consecutive and read through the
//   read-only path (__ldg);
// - each thread's B acc and cnt bins and K fresh sums live in dynamic
//   shared memory, rows padded to B + 1 and K + 1 floats against bank
//   conflicts, and the block writes them out as contiguous runs;
// - no fast math: expf and logf-derived factors stay precise, and the
//   build's --fmad=false keeps products rounded as the plain version's.

#include "common.cuh"

namespace {

constexpr int GATHER_BLOCK = 64;  // kernels_dense.GATHER_BLOCK
constexpr int CELL_CAP = 32;      // renderers.photon._CELL_CAP

struct GatherArgs {
  // the photon map, in cell order (renderers.photon.build_map)
  const int* __restrict__ keys;         // [P] sorted cell keys, INT32_MAX for no photon
  const float* __restrict__ p_pos;      // [P, 3]
  const uint8_t* __restrict__ p_valid;  // [P]
  const float* __restrict__ p_inc;      // [P, 3] incident, after the pairs() reversal
  const float* __restrict__ p_power;    // [P, pcols]: column 0 at the photon's own wavelength
  const float* __restrict__ p_lam;      // [P]
  const uint8_t* __restrict__ p_disp;   // [P]
  const float* __restrict__ p_counts;   // [P, M] exact mode: the parent chain's programs
  const float* __restrict__ p_scalar;   // [P]
  const float* __restrict__ p_logf;     // [P, M] the programs' log factors at the photon's wavelength
  const float* __restrict__ p_negf;
  const float* __restrict__ p_zerof;
  // one camera bounce's vertices
  const float* __restrict__ q_pos;      // [N, 3]
  const float* __restrict__ q_normal;   // [N, 3]
  const float* __restrict__ q_inc;      // [N, 3]
  const uint8_t* __restrict__ q_valid;  // [N]
  const uint8_t* __restrict__ q_disp;   // [N]
  const float* __restrict__ q_r;        // [N, cols] partialR: hero at 0, the grid from s
  const float* __restrict__ lam0;       // [N] the lane's hero wavelength
  const float* __restrict__ lam_f;      // [N, K] its fresh wavelengths
  const float* __restrict__ q_counts;   // [N, M] exact mode
  const float* __restrict__ q_scalar;   // [N]
  const float* __restrict__ logf0;      // [N, M] factors at lam0
  const float* __restrict__ negf0;
  const float* __restrict__ zerof0;
  const float* __restrict__ logff;      // [N, K, M] factors at lam_f
  const float* __restrict__ negff;
  const float* __restrict__ zeroff;
  // outputs
  float* __restrict__ acc_bins;  // [N, B]
  float* __restrict__ cnt_bins;  // [N, B]
  int* __restrict__ num;         // [N]
  float* __restrict__ fresh_psum;  // [N, K]
  int* __restrict__ fresh_cnt;     // [N]
  int n, p, m, k, bins, cols, s, g, exact, pcols;
  float radius, rr, lo, bin_scale, d_film, d_grid;
};

// The JAX package's cell key, x 73856093 ^ y 19349663 ^ z 83492791 with
// int32 products that wrap (renderers.photon._hash).
__device__ __forceinline__ int cell_key(unsigned x, unsigned y, unsigned z) {
  return (int)((x * 73856093u) ^ (y * 19349663u) ^ (z * 83492791u));
}

// The first index i of keys[0, p) with keys[i] >= key, p where none
// (torch.searchsorted, side left).
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int p, int key) {
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// scalar x prod_m f_m ^ counts[m] from the factors' logs, sign and zero
// flags (renderers.photon._chain_eval): 0 where a factor that occurs is 0.
__device__ __forceinline__ float chain_eval(const float* __restrict__ counts, float scalar,
                                            const float* __restrict__ logf,
                                            const float* __restrict__ negf,
                                            const float* __restrict__ zerof, int m) {
  float sum = 0.0f, parity = 0.0f, dead = 0.0f;
  for (int i = 0; i < m; ++i) {
    const float c = __ldg(counts + i);
    sum += c * __ldg(logf + i);
    parity += c * __ldg(negf + i);
    dead += c * __ldg(zerof + i);
  }
  const float sign = 1.0f - 2.0f * fmodf(parity, 2.0f);  // parity >= 0: torch.remainder
  return dead > 0.0f ? 0.0f : scalar * expf(sum) * sign;
}

// A row of b values at the bin centres of the span (step d) read at `lam`,
// linearly, clamped to the end bins (renderers.photon.interp_cols).
__device__ __forceinline__ float interp(const float* __restrict__ row, int b, float lo, float d,
                                        float lam) {
  const float t = fminf(fmaxf((lam - lo) / d - 0.5f, 0.0f), (float)b - 1.0f);
  const int i0 = min((int)t, b - 2);
  const float f = t - (float)i0;
  const float v0 = __ldg(row + i0), v1 = __ldg(row + i0 + 1);
  return v0 + (v1 - v0) * f;
}

__device__ __forceinline__ V3 ldg3(const float* __restrict__ p, int i) {
  return {__ldg(p + 3 * (size_t)i), __ldg(p + 3 * (size_t)i + 1), __ldg(p + 3 * (size_t)i + 2)};
}

__global__ void __launch_bounds__(GATHER_BLOCK) photon_gather_kernel(const GatherArgs a) {
  extern __shared__ __align__(16) float gather_smem[];
  const int t = threadIdx.x, base = blockIdx.x * GATHER_BLOCK, lane = base + t;
  const int bs = a.bins + 1, ks = a.k + 1;
  float* ACC = gather_smem;               // [GATHER_BLOCK, B + 1]
  float* CNT = ACC + GATHER_BLOCK * bs;   // [GATHER_BLOCK, B + 1]
  float* FR = CNT + GATHER_BLOCK * bs;    // [GATHER_BLOCK, K + 1]
  float* acc = ACC + t * bs;
  float* cnt = CNT + t * bs;
  float* fr = FR + t * ks;
  for (int j = 0; j < a.bins; ++j) {
    acc[j] = 0.0f;
    cnt[j] = 0.0f;
  }
  for (int j = 0; j < a.k; ++j) fr[j] = 0.0f;
  int num = 0, fcnt = 0;
  if (lane < a.n && a.p > 0 && a.q_valid[lane]) {
    const V3 q = load3(a.q_pos, lane), nrm = load3(a.q_normal, lane);
    const float cos_cam = fmaxf(dot(load3(a.q_inc, lane), -nrm), 0.0f);
    const bool cam_disp = a.q_disp[lane];
    const float* r = a.q_r + (size_t)lane * a.cols;
    const float r_hero = r[0], lam0 = a.lam0[lane];
    const size_t lm = (size_t)lane * a.m;
    const unsigned cx = (unsigned)(int)floorf(q.x / a.radius);
    const unsigned cy = (unsigned)(int)floorf(q.y / a.radius);
    const unsigned cz = (unsigned)(int)floorf(q.z / a.radius);
    for (int c = 0; c < 27; ++c) {
      const int key = cell_key(cx + (unsigned)(c / 9 - 1), cy + (unsigned)((c / 3) % 3 - 1),
                               cz + (unsigned)(c % 3 - 1));
      const int start = lower_bound(a.keys, a.p, key);
      for (int slot = 0; slot < CELL_CAP; ++slot) {
        const int idx = min(start + slot, a.p - 1);
        // the keys are sorted: past the cell's first mismatch none matches
        if (__ldg(a.keys + idx) != key) break;
        if (!__ldg(a.p_valid + idx)) continue;
        const V3 diff = ldg3(a.p_pos, idx) - q;
        if (!(dot(diff, diff) <= a.rr)) continue;
        ++num;
        const bool p_disp = __ldg(a.p_disp + idx);
        if (cam_disp && p_disp) continue;  // counted, not exposed
        const V3 exit = -ldg3(a.p_inc, idx);
        const float w_geom = fmaxf(dot(exit, nrm), 0.0f) * cos_cam / PI_F;
        const float gw = 2.0f * fabsf(dot(nrm, exit)) * w_geom;
        const float* row = a.p_power + (size_t)idx * a.pcols;
        const float lam_p = __ldg(a.p_lam + idx);
        const size_t pm = (size_t)idx * a.m;
        float r_sel, p_sel;
        if (a.exact) {
          r_sel = cam_disp ? r_hero
                           : chain_eval(a.q_counts + lm, a.q_scalar[lane], a.p_logf + pm,
                                        a.p_negf + pm, a.p_zerof + pm, a.m);
          p_sel = cam_disp ? chain_eval(a.p_counts + pm, __ldg(a.p_scalar + idx), a.logf0 + lm,
                                        a.negf0 + lm, a.zerof0 + lm, a.m)
                           : __ldg(row);
        } else {
          r_sel = cam_disp ? r_hero : interp(r + a.s, a.g, a.lo, a.d_grid, lam_p);
          p_sel = cam_disp ? interp(row + 1, a.bins, a.lo, a.d_film, lam0) : __ldg(row);
        }
        const float lam_sel = cam_disp ? lam0 : lam_p;
        const int j = min(max((int)((lam_sel - a.lo) * a.bin_scale), 0), a.bins - 1);
        acc[j] += r_sel * p_sel * gw;
        cnt[j] += 1.0f;
        if (!cam_disp && !p_disp) {
          ++fcnt;
          for (int kk = 0; kk < a.k; ++kk) {
            const size_t lk = (size_t)lane * a.k + kk;
            const float pf =
                a.exact ? chain_eval(a.p_counts + pm, __ldg(a.p_scalar + idx), a.logff + lk * a.m,
                                     a.negff + lk * a.m, a.zeroff + lk * a.m, a.m)
                        : interp(row + 1, a.bins, a.lo, a.d_film, a.lam_f[lk]);
            fr[kk] += pf * gw;
          }
        }
      }
    }
  }
  if (lane < a.n) {
    a.num[lane] = num;
    a.fresh_cnt[lane] = fcnt;
  }
  __syncthreads();
  // the block's rows out as contiguous runs
  const int rows = min(GATHER_BLOCK, a.n - base);
  const size_t ob = (size_t)base * a.bins, ok = (size_t)base * a.k;
  for (int i = t; i < rows * a.bins; i += GATHER_BLOCK) {
    const int rr = i / a.bins, j = i - rr * a.bins;
    a.acc_bins[ob + i] = ACC[rr * bs + j];
    a.cnt_bins[ob + i] = CNT[rr * bs + j];
  }
  for (int i = t; i < rows * a.k; i += GATHER_BLOCK) {
    const int rr = i / a.k, j = i - rr * a.k;
    a.fresh_psum[ok + i] = FR[rr * ks + j];
  }
}

}  // namespace

extern "C" {

// photon_gather_kernel over `n` camera vertices against a map of `p`
// photons (GatherArgs, in its order); returns cudaGetLastError().
int pyrite_photon_gather(
    const int* keys, const float* p_pos, const uint8_t* p_valid, const float* p_inc,
    const float* p_power, const float* p_lam, const uint8_t* p_disp, const float* p_counts,
    const float* p_scalar, const float* p_logf, const float* p_negf, const float* p_zerof,
    const float* q_pos, const float* q_normal, const float* q_inc, const uint8_t* q_valid,
    const uint8_t* q_disp, const float* q_r, const float* lam0, const float* lam_f,
    const float* q_counts, const float* q_scalar, const float* logf0, const float* negf0,
    const float* zerof0, const float* logff, const float* negff, const float* zeroff,
    float* acc_bins, float* cnt_bins, int* num, float* fresh_psum, int* fresh_cnt, int n, int p,
    int m, int k, int bins, int cols, int s, int g, int exact, int pcols, float radius, float rr,
    float lo, float bin_scale, float d_film, float d_grid, void* stream) {
  const GatherArgs a = {keys,     p_pos,    p_valid, p_inc,  p_power, p_lam,      p_disp,
                        p_counts, p_scalar, p_logf,  p_negf, p_zerof, q_pos,      q_normal,
                        q_inc,    q_valid,  q_disp,  q_r,    lam0,    lam_f,      q_counts,
                        q_scalar, logf0,    negf0,   zerof0, logff,   negff,      zeroff,
                        acc_bins, cnt_bins, num,     fresh_psum,      fresh_cnt,  n,
                        p,        m,        k,       bins,   cols,    s,          g,
                        exact,    pcols,    radius,  rr,     lo,      bin_scale,  d_film,
                        d_grid};
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * GATHER_BLOCK * (2 * ((size_t)bins + 1) + k + 1);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute((const void*)photon_gather_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  photon_gather_kernel<<<(n + GATHER_BLOCK - 1) / GATHER_BLOCK, GATHER_BLOCK, smem,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
