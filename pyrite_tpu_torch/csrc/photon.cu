// The photon renderer's radius gather on Hopper: photon_gather_kernel, the
// kernel of kernels_dense.photon_gather, whose plain version is
// pyrite_tpu_torch/renderers/photon.py gather_plain.
//
// It replaces no Pallas kernel: the JAX package computes the gather in XLA
// (pyrite_tpu/renderers/photon.py:310 `_gather`, its fori_loop of 27 x 32
// scan steps at :395-468). That loop rewrites every lane's [N, B] bins at
// each of its 864 steps; here one warp owns one camera vertex for one
// camera bounce and photon map, scans its candidates a cell at a time and
// keeps its bins on chip.
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
// flagship's 131,072 lanes and ~900,000 photons. What it waits on is
// dependent L2 reads (~20 key loads a binary search, then the candidates)
// and, for each pair, a few lanes' worth of work. The design puts a warp on
// each vertex:
// - lanes 0-26 run the 27 binary searches side by side (the warp waits
//   ~20 dependent loads, not 27 x 20), and a ballot of the searches that
//   found their key leaves only the occupied cells to scan;
// - a cell's CELL_CAP = 32 slots are the warp's 32 lanes: lane l reads
//   slot l (key, flag and position coalesced, the index clipped to P - 1
//   as the JAX package clips it, so the clipped duplicates count as they
//   do there), the next cell's keys read while this one is tested; the
//   counts come from __popc of the ballots;
// - a cell holds few pairs (~1.3 of its 32 slots on the flagship), so the
//   pairs go, in scan order, to a ring of photon indices in shared memory,
//   and every 32 of them (and the rest at the end) to a batch, one pair a
//   lane: its geometry, chain values and bin; its adds broadcast
//   (__shfl_sync) in scan order to the lane that owns the bin (bin j on
//   lane j % 32); its K fresh values spread over the lanes as (pair,
//   wavelength) items, staged in shared memory and added in scan order by
//   the lane that owns the wavelength (kk on lane kk % 32): no sum is
//   reassociated, so the sums are the plain version's adds in its order;
// - the vertex's B acc and cnt bins and K fresh sums are one row of the
//   warp in dynamic shared memory (gather_row), each entry touched only by
//   the lane that owns it, written out as coalesced runs; a warp whose
//   vertex is not valid writes its zeros and ends;
// - past what a block's shared memory holds of such rows (7,085 bins at K
//   = 6: kernels_dense.gather_out_row), the <out_row> form keeps the B acc
//   and cnt bins in the vertex's output row in device memory instead, each
//   entry zeroed and added to by the lane that owns it, in the same order,
//   so its bins are the row form's bit for bit and no row grows with B;
// - past FRESH_CHUNK fresh wavelengths the row holds no fresh sums: the
//   owning lanes add into the vertex's row of fresh_psum in device memory
//   (zeroed first, each entry by its owner, so the adds keep their order),
//   and a batch's fresh values go FRESH_CHUNK wavelengths at a time, so
//   the row does not grow with K;
// - no fast math: expf and logf-derived factors stay precise, and the
//   build's --fmad=false keeps products rounded as the plain version's.

#include "common.cuh"

namespace {

constexpr int GATHER_WARPS = 4;  // warps a block, one a camera vertex (kernels_dense.GATHER_WARPS)
// Blocks a SM the launch bound asks for: 8 x 4 warps, which caps a thread
// at 64 registers. Left to itself ptxas gives the kernel 96 registers at
// this block size, 20 resident warps a SM, and it then runs ~40 % slower.
constexpr int GATHER_MIN_BLOCKS = 8;
constexpr int CELL_CAP = 32;         // renderers.photon._CELL_CAP

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

constexpr unsigned FULL = 0xffffffffu;

// Pairs a warp's ring holds: a batch of 32 and the up to 31 before it.
constexpr int PAIR_RING = 64;

// The most fresh wavelengths a warp's row holds sums and a batch's values
// of; past it the sums are the output's and the values go in chunks.
constexpr int FRESH_CHUNK = 64;

// 4-byte words of a warp's row in dynamic shared memory: B acc bins, B
// cnt bins (bins = 0 in the <out_row> form), K fresh sums (none past
// FRESH_CHUNK), CELL_CAP pairs' fresh values of a chunk of kc = min(K,
// FRESH_CHUNK) wavelengths at a stride of kc | 1 and the ring of PAIR_RING
// photon indices (kernels_dense.gather_smem_bytes).
__host__ __device__ __forceinline__ size_t gather_row(int bins, int k) {
  const int kc = k < FRESH_CHUNK ? k : FRESH_CHUNK;
  return 2 * (size_t)bins + (k <= FRESH_CHUNK ? k : 0) + (size_t)CELL_CAP * (kc | 1) + PAIR_RING;
}

// kChunks: past FRESH_CHUNK fresh wavelengths (the output row's sums, the
// values a chunk at a time); kOutRow: the bins in the output row (the
// <out_row> form); each an instantiation of its own, so that the others
// keep their registers (64, no spill).
template <bool kChunks, bool kOutRow>
__global__ void __launch_bounds__(32 * GATHER_WARPS, GATHER_MIN_BLOCKS)
    photon_gather_kernel(const GatherArgs a) {
  extern __shared__ __align__(16) float gather_smem[];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int v = blockIdx.x * GATHER_WARPS + w;  // the warp's camera vertex
  if (v >= a.n) return;
  const int bins = a.bins, k = a.k;
  float* const out_acc = a.acc_bins + (size_t)v * bins;
  float* const out_cnt = a.cnt_bins + (size_t)v * bins;
  float* const out_fr = a.fresh_psum + (size_t)v * k;
  if (a.p == 0 || !a.q_valid[v]) {
    for (int j = l; j < bins; j += 32) {
      out_acc[j] = 0.0f;
      out_cnt[j] = 0.0f;
    }
    for (int j = l; j < k; j += 32) out_fr[j] = 0.0f;
    if (l == 0) {
      a.num[v] = 0;
      a.fresh_cnt[v] = 0;
    }
    return;
  }
  // the warp's row: B acc bins, B cnt bins and K fresh sums (past
  // FRESH_CHUNK the output row's), entry j touched only by lane j % 32; a
  // batch's fresh values of a chunk of kc wavelengths, those of its r-th
  // fresh pair at r * ks (ks odd: no bank conflict); a ring of PAIR_RING
  // pairs' photon indices in scan order
  const int kc = kChunks ? FRESH_CHUNK : k, ks = kc | 1;
  const int row_bins = kOutRow ? 0 : bins;
  float* const row = gather_smem + (size_t)w * gather_row(row_bins, k);
  float* const acc = kOutRow ? out_acc : row;
  float* const cnt = kOutRow ? out_cnt : row + bins;
  float* const fr = kChunks ? out_fr : row + 2 * row_bins;
  float* const fs = row + 2 * row_bins + (kChunks ? 0 : k);
  int* const ring = (int*)(fs + CELL_CAP * ks);
  for (int j = l; j < bins; j += 32) {
    acc[j] = 0.0f;
    cnt[j] = 0.0f;
  }
  for (int j = l; j < k; j += 32) fr[j] = 0.0f;

  const V3 q = load3(a.q_pos, v), nrm = load3(a.q_normal, v);
  const float cos_cam = fmaxf(dot(load3(a.q_inc, v), -nrm), 0.0f);
  const bool cam_disp = a.q_disp[v];
  const float* const r = a.q_r + (size_t)v * a.cols;
  const float r_hero = r[0], lam0 = a.lam0[v];
  const size_t vm = (size_t)v * a.m, vk = (size_t)v * k;
  int num = 0, fcnt = 0;

  // A batch of up to 32 pairs, the ring's first `n` from `head`, one a
  // lane: each pair's weight, chain values and bin; its adds in scan
  // order, each by the lane that owns its bin; where neither dispersed,
  // its K fresh values as items (rank, wavelength) over the lanes, added
  // in scan order by the lanes that own the wavelengths.
  auto batch = [&](int head, int n) {
    __syncwarp();  // the ring's entries
    const bool pair = l < n;
    const int here = pair ? ring[(head + l) % PAIR_RING] : 0;
    float val = 0.0f, gw = 0.0f;
    int j = 0;
    bool clear = false;
    if (pair) {
      clear = !cam_disp && !__ldg(a.p_disp + here);
      const V3 exit = -ldg3(a.p_inc, here);
      const float lam_p = __ldg(a.p_lam + here);
      const float* row = a.p_power + (size_t)here * a.pcols;
      const float power0 = __ldg(row);
      const float w_geom = fmaxf(dot(exit, nrm), 0.0f) * cos_cam / PI_F;
      gw = 2.0f * fabsf(dot(nrm, exit)) * w_geom;
      const size_t pm = (size_t)here * a.m;
      float r_sel, p_sel;
      if (a.exact) {
        r_sel = cam_disp ? r_hero
                         : chain_eval(a.q_counts + vm, a.q_scalar[v], a.p_logf + pm, a.p_negf + pm,
                                      a.p_zerof + pm, a.m);
        p_sel = cam_disp ? chain_eval(a.p_counts + pm, __ldg(a.p_scalar + here), a.logf0 + vm,
                                      a.negf0 + vm, a.zerof0 + vm, a.m)
                         : power0;
      } else {
        r_sel = cam_disp ? r_hero : interp(r + a.s, a.g, a.lo, a.d_grid, lam_p);
        p_sel = cam_disp ? interp(row + 1, bins, a.lo, a.d_film, lam0) : power0;
      }
      const float lam_sel = cam_disp ? lam0 : lam_p;
      j = min(max((int)((lam_sel - a.lo) * a.bin_scale), 0), bins - 1);
      val = r_sel * p_sel * gw;
    }
    for (unsigned left = __ballot_sync(FULL, pair); left; left &= left - 1) {
      const int src = __ffs(left) - 1;
      const int js = __shfl_sync(FULL, j, src);
      const float vs = __shfl_sync(FULL, val, src);
      if ((js & 31) == l) {
        acc[js] += vs;
        cnt[js] += 1.0f;
      }
    }
    const unsigned clears = __ballot_sync(FULL, clear);
    if (clears) {
      const int nc = __popc(clears);
      fcnt += nc;
      // the wavelengths k0 .. k0 + kc - 1 at a time, kChunks (else all K
      // in one pass): each sum's adds stay in scan order
      for (int k0 = 0, first = 1; kChunks ? k0 < k : first; k0 += kc, first = 0) {
        const int kn = kChunks ? min(kc, k - k0) : k;
        for (int item0 = 0; item0 < nc * kn; item0 += 32) {
          const int item = item0 + l, rank = item / kn, kk = k0 + item - rank * kn;
          unsigned nth = clears;  // the pair's lane: the rank-th set bit
          for (int t = 0; t < rank; ++t) nth &= nth - 1;
          const int src = item < nc * kn ? __ffs(nth) - 1 : 0;
          const int is = __shfl_sync(FULL, here, src);
          const float gs = __shfl_sync(FULL, gw, src);
          if (item < nc * kn) {
            const size_t pm = (size_t)is * a.m;
            const float pf =
                a.exact ? chain_eval(a.p_counts + pm, __ldg(a.p_scalar + is),
                                     a.logff + (vk + kk) * a.m, a.negff + (vk + kk) * a.m,
                                     a.zeroff + (vk + kk) * a.m, a.m)
                        : interp(a.p_power + (size_t)is * a.pcols + 1, bins, a.lo, a.d_film,
                                 __ldg(a.lam_f + vk + kk));
            fs[rank * ks + kk - k0] = pf * gs;
          }
        }
        __syncwarp();
        for (int rank = 0; rank < nc; ++rank)
          for (int kk = k0 + l; kk < k0 + kn; kk += 32) fr[kk] += fs[rank * ks + kk - k0];
        if (kChunks) __syncwarp();  // the chunk's values read before the next chunk's are written
      }
    }
    __syncwarp();  // the ring's entries and the values read before they are rewritten
  };

  // the 27 searches side by side: lane c < 27 finds cell c's first index
  int key = 0, start = 0;
  bool occupied = false;
  if (l < 27) {
    const unsigned cx = (unsigned)(int)floorf(q.x / a.radius);
    const unsigned cy = (unsigned)(int)floorf(q.y / a.radius);
    const unsigned cz = (unsigned)(int)floorf(q.z / a.radius);
    key = cell_key(cx + (unsigned)(l / 9 - 1), cy + (unsigned)((l / 3) % 3 - 1),
                   cz + (unsigned)(l % 3 - 1));
    start = lower_bound(a.keys, a.p, key);
    occupied = start < a.p && __ldg(a.keys + start) == key;
  }
  // the occupied cells in order, a cell's slot l on lane l (the index
  // clipped to P - 1), each cell's keys read while the one before is
  // scanned; its pairs go to the ring in slot order, and every 32 of them
  // to a batch
  unsigned cells = __ballot_sync(FULL, occupied);
  auto slot_of = [&](unsigned left) {
    return min(__shfl_sync(FULL, start, __ffs(left) - 1) + l, a.p - 1);
  };
  int idx = cells ? slot_of(cells) : 0;
  int slot_key = cells ? __ldg(a.keys + idx) : 0;
  int head = 0, queued = 0;
  while (cells) {
    const int ckey = __shfl_sync(FULL, key, __ffs(cells) - 1);
    cells &= cells - 1;
    // the keys are sorted: a slot matches until the cell's first mismatch
    const bool match = slot_key == ckey;
    const int here = idx;
    if (cells) {
      idx = slot_of(cells);
      slot_key = __ldg(a.keys + idx);
    }
    bool in_rad = false, p_disp = false;
    if (match) {
      const bool p_valid = __ldg(a.p_valid + here);
      const V3 diff = ldg3(a.p_pos, here) - q;
      p_disp = __ldg(a.p_disp + here);
      in_rad = p_valid && dot(diff, diff) <= a.rr;
    }
    const unsigned rad = __ballot_sync(FULL, in_rad);
    num += __popc(rad);
    const bool pair = in_rad && !(cam_disp && p_disp);
    const unsigned pairs = __ballot_sync(FULL, pair);
    if (pair) ring[(head + queued + __popc(pairs & ((1u << l) - 1))) % PAIR_RING] = here;
    queued += __popc(pairs);
    if (queued >= 32) {
      batch(head, 32);
      head = (head + 32) % PAIR_RING;
      queued -= 32;
    }
  }
  if (queued) batch(head, queued);
  if (l == 0) {
    a.num[v] = num;
    a.fresh_cnt[v] = fcnt;
  }
  // the row out as coalesced runs, each entry by the lane that wrote it
  if (!kOutRow)
    for (int jj = l; jj < bins; jj += 32) {
      out_acc[jj] = acc[jj];
      out_cnt[jj] = cnt[jj];
    }
  if (!kChunks)
    for (int jj = l; jj < k; jj += 32) out_fr[jj] = fr[jj];
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch of `bins` film bins and `k` fresh
// wavelengths passes, in the row form or the <out_row> form
// (kernels_dense.gather_smem_bytes mirrors it).
int pyrite_gather_smem(int bins, int k, int out_row) {
  return (int)(sizeof(float) * GATHER_WARPS * gather_row(out_row ? 0 : bins, k));
}

// photon_gather_kernel over `n` camera vertices against a map of `p`
// photons (GatherArgs, in its order), one warp a vertex in blocks of
// GATHER_WARPS warps, in the <out_row> form where `out_row`
// (kernels_dense.gather_out_row); returns cudaGetLastError().
int pyrite_photon_gather(
    const int* keys, const float* p_pos, const uint8_t* p_valid, const float* p_inc,
    const float* p_power, const float* p_lam, const uint8_t* p_disp, const float* p_counts,
    const float* p_scalar, const float* p_logf, const float* p_negf, const float* p_zerof,
    const float* q_pos, const float* q_normal, const float* q_inc, const uint8_t* q_valid,
    const uint8_t* q_disp, const float* q_r, const float* lam0, const float* lam_f,
    const float* q_counts, const float* q_scalar, const float* logf0, const float* negf0,
    const float* zerof0, const float* logff, const float* negff, const float* zeroff,
    float* acc_bins, float* cnt_bins, int* num, float* fresh_psum, int* fresh_cnt, int n, int p,
    int m, int k, int bins, int cols, int s, int g, int exact, int pcols, int out_row,
    float radius, float rr, float lo, float bin_scale, float d_film, float d_grid, void* stream) {
  const GatherArgs a = {keys,     p_pos,    p_valid, p_inc,  p_power, p_lam,      p_disp,
                        p_counts, p_scalar, p_logf,  p_negf, p_zerof, q_pos,      q_normal,
                        q_inc,    q_valid,  q_disp,  q_r,    lam0,    lam_f,      q_counts,
                        q_scalar, logf0,    negf0,   zerof0, logff,   negff,      zeroff,
                        acc_bins, cnt_bins, num,     fresh_psum,      fresh_cnt,  n,
                        p,        m,        k,       bins,   cols,    s,          g,
                        exact,    pcols,    radius,  rr,     lo,      bin_scale,  d_film,
                        d_grid};
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = pyrite_gather_smem(bins, k, out_row);
  const auto kernel = k > FRESH_CHUNK ? (out_row ? photon_gather_kernel<true, true>
                                                 : photon_gather_kernel<true, false>)
                                      : (out_row ? photon_gather_kernel<false, true>
                                                 : photon_gather_kernel<false, false>);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<(n + GATHER_WARPS - 1) / GATHER_WARPS, 32 * GATHER_WARPS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
