// Keyed random draws on Hopper: philox_draws_kernel, Philox4x32-10 (Salmon et
// al., "Parallel random numbers: as easy as 1, 2, 3", SC'11) keyed by the
// render's seed and counted by (pixel, global sample, bounce, purpose << 16
// | block), in the layout pyrite_tpu_torch/rng.py documents and computes as
// the plain version, bit for bit: a uniform is (x >> 8) * 2^-24, exact in
// f32, and the lamp index min(floor(u * lamps), lamps - 1).
//
// It replaces the JAX package's per-bounce jax.random draws
// (pyrite_tpu/tracer.py draw_bounce_uniforms; threefry inside XLA, not a
// Pallas kernel) and the port's former torch.Generator calls, four to five
// launches a bounce: one launch writes a bounce's u_comp, u_scatter,
// lamp_idx, u_nee and u_emis into one buffer, a step's camera draws, or
// both.
//
// A lane's (pixel, sample, bounce) words come in two modes. Affine (the
// one-shot wavefront): lane l is pixel pixel0 + l % n_pix, sample sample0 +
// l / n_pix, one bounce for all lanes. Indexed (the regeneration and
// survivor-pool schedulers): three int32 arrays give each lane its pixel,
// its sample and its bounce (or one bounce for all lanes when the depth
// array is null), and a mask may restrict the camera draws to the lanes
// that start a path (the others' camera row is written as zeros), so one
// launch makes a regeneration iteration's camera and bounce draws. A third
// output, one purpose's words [N, width] (rng.purpose_words: the
// bidirectional renderer's lamp-path start, lamp bounces and splat lens
// draws), takes word j % take of block j // take, and is launched alone.
//
// What bounds it on an H100: the bytes it writes, (5 + 5 ls) words a lane
// a bounce, (S + 5) a lane for the camera, plus 8-12 bytes a lane read in
// the indexed mode; ten Philox rounds cost ~40 integer operations per 4
// words. One thread makes one lane's draws; the [N, 3] and [N, S + 5]
// outputs go through shared memory so that the block stores them as
// contiguous float4 runs, and u_nee [ls, N, 4] is one float4 per lane and
// light sample. A camera row of more than CAM_STAGED words is not staged:
// the block's threads take its rows' Philox blocks in turn, consecutive
// threads on consecutive blocks of a row, each storing its four words
// straight, so a block's shared memory does not grow with S; a word's value
// is its key's, whichever thread makes it.

#include "common.cuh"

namespace {

enum Purpose { P_CAMERA, P_U_COMP, P_U_SCATTER, P_LAMP, P_U_NEE, P_U_EMIS };  // rng.py; and more

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform(unsigned x) { return (float)(x >> 8) * (1.0f / 16777216.0f); }

__device__ __forceinline__ unsigned word(uint4 x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

struct DrawArgs {
  unsigned k0, k1;
  int n, n_pix;
  unsigned pixel0, sample0, bounce;
  int s_cam, light_samples, n_lamps;
  float* __restrict__ cam_out;  // [N, S + 5] camera draws, or null
  float* __restrict__ out;      // a bounce's draws in rng._layout, or null
  // the indexed mode: each lane's pixel, sample and bounce (depth null: a.bounce
  // for all), and which lanes take camera draws (null: all); pixel null: affine
  const int* __restrict__ pixel;
  const int* __restrict__ sample;
  const int* __restrict__ depth;
  const unsigned char* __restrict__ cam_mask;
  // one purpose's words [N, width], word j % take of block j / take, or null
  float* __restrict__ words_out;
  unsigned purpose;
  int width, take;
};

// The most words of a lane's camera row a block stages (S <= 87): the
// rows a block stages fit the 48 KiB it gets without opting in.
constexpr int CAM_STAGED = 92;

// The words a block stages: its lanes' camera rows, [BLOCK, S + 5], where
// they are staged, and u_scatter, [BLOCK, 3] (stage_bytes, the kernel's
// dynamic shared memory, at most 47,104 bytes; rng.draws_smem_bytes
// mirrors it).
__host__ __forceinline__ size_t stage_bytes(int s_cam) {
  const int w = s_cam + 5 <= CAM_STAGED ? s_cam + 5 : 3;
  return sizeof(float) * BLOCK * (size_t)(w > 3 ? w : 3);
}

// kStraight: camera rows of more than CAM_STAGED words, stored straight;
// an instantiation of its own, so that the staging one keeps its registers.
template <bool kStraight>
__global__ void __launch_bounds__(BLOCK) philox_draws_kernel(const DrawArgs a) {
  extern __shared__ __align__(16) float stage[];
  const int base = blockIdx.x * BLOCK;
  const int lane = base + threadIdx.x;
  const int rows = min(BLOCK, a.n - base);
  const bool in_range = lane < a.n;
  unsigned pixel = 0u, sample = 0u, bounce = a.bounce;
  if (in_range) {
    if (a.pixel) {
      pixel = (unsigned)a.pixel[lane];
      sample = (unsigned)a.sample[lane];
      if (a.depth) bounce = (unsigned)a.depth[lane];
    } else {
      pixel = a.pixel0 + (unsigned)(lane % a.n_pix);
      sample = a.sample0 + (unsigned)(lane / a.n_pix);
    }
  }
  auto draw = [&](int purpose, int block) {
    return philox4x32_10(make_uint4(pixel, sample, bounce, ((unsigned)purpose << 16) | block),
                         a.k0, a.k1);
  };
  const size_t n = a.n;

  if (a.words_out) {  // one purpose's words, launched alone
    if (in_range)
      for (int b = 0; b * a.take < a.width; ++b) {
        const uint4 x = draw((int)a.purpose, b);
        for (int q = 0; q < a.take && b * a.take + q < a.width; ++q)
          a.words_out[(size_t)lane * a.width + b * a.take + q] = uniform(word(x, q));
      }
    return;
  }

  if (a.cam_out) {  // the camera draws [N, S + 5], bounce 0; zeros off the mask
    const int w = a.s_cam + 5;
    const bool drawn = in_range && (!a.cam_mask || a.cam_mask[lane]);
    if constexpr (!kStraight) {  // the rows staged
      if (in_range)
        for (int b = 0; 4 * b < w; ++b) {
          const uint4 x = drawn ? philox4x32_10(
              make_uint4(pixel, sample, 0u, ((unsigned)P_CAMERA << 16) | b), a.k0, a.k1)
                                : make_uint4(0u, 0u, 0u, 0u);
          for (int q = 0; q < 4 && 4 * b + q < w; ++q)
            stage[threadIdx.x * w + 4 * b + q] = uniform(word(x, q));
        }
      __syncthreads();
      block_copy(a.cam_out + (size_t)base * w, stage, rows * w);
    } else {  // a Philox block a thread, its words stored straight: no row staged
      const int nb = (w + 3) / 4;
      for (int i = threadIdx.x; i < rows * nb; i += BLOCK) {
        const int r = i / nb, b = i - r * nb, l = base + r;
        const unsigned px = a.pixel ? (unsigned)a.pixel[l] : a.pixel0 + (unsigned)(l % a.n_pix);
        const unsigned sm = a.pixel ? (unsigned)a.sample[l] : a.sample0 + (unsigned)(l / a.n_pix);
        const uint4 x = !a.cam_mask || a.cam_mask[l]
                            ? philox4x32_10(make_uint4(px, sm, 0u, ((unsigned)P_CAMERA << 16) | b),
                                            a.k0, a.k1)
                            : make_uint4(0u, 0u, 0u, 0u);
        float* dst = a.cam_out + (size_t)l * w + 4 * b;
        for (int q = 0; q < 4 && 4 * b + q < w; ++q) dst[q] = uniform(word(x, q));
      }
    }
    if (!a.out) return;
    __syncthreads();  // the bounce draws below stage u_scatter in the same buffer
  }

  // a bounce's draws, in rng._layout's order
  const bool lamps = a.n_lamps > 0 && a.light_samples > 0;
  const int ls = lamps ? a.light_samples : 0;
  float* u_nee = a.out;                        // [ls, N, 4]
  float* u_comp = a.out + 4 * (size_t)ls * n;  // [N]
  float* u_scatter = u_comp + n;               // [N, 3]
  int* lamp_idx = reinterpret_cast<int*>(u_scatter + 3 * n);  // [N]
  float* u_emis = u_scatter + 4 * n;           // [ls, N]
  if (in_range) {
    u_comp[lane] = uniform(draw(P_U_COMP, 0).x);
    const uint4 x = draw(P_U_SCATTER, 0);
    stage[3 * threadIdx.x] = uniform(x.x);
    stage[3 * threadIdx.x + 1] = uniform(x.y);
    stage[3 * threadIdx.x + 2] = uniform(x.z);
    if (lamps) {
      const float u = uniform(draw(P_LAMP, 0).x);
      lamp_idx[lane] = min((int)(u * (float)a.n_lamps), a.n_lamps - 1);
      const bool vec = (reinterpret_cast<uintptr_t>(u_nee) & 15) == 0;
      for (int j = 0; j < ls; ++j) {
        const uint4 y = draw(P_U_NEE, j);
        float* dst = u_nee + ((size_t)j * n + lane) * 4;
        const float4 v = make_float4(uniform(y.x), uniform(y.y), uniform(y.z), uniform(y.w));
        if (vec) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        }
      }
      for (int b = 0; 4 * b < ls; ++b) {
        const uint4 y = draw(P_U_EMIS, b);
        for (int q = 0; q < 4 && 4 * b + q < ls; ++q) u_emis[(size_t)(4 * b + q) * n + lane] = uniform(word(y, q));
      }
    }
  }
  __syncthreads();
  block_copy(u_scatter + 3 * (size_t)base, stage, 3 * rows);
}

}  // namespace

extern "C" {

// Plain C launcher for ctypes (rng._launch): `cam_out` is a device buffer of
// [n, s_cam + 5] floats for the camera draws or null, `out` one of a
// bounce's draws in rng._layout or null; `pixel`, `sample` and `depth` are
// [n] int32 device arrays for the indexed mode (pixel null: the affine
// mode, from pixel0, sample0 and n_pix; depth null: `bounce` for every
// lane), `cam_mask` [n] bytes or null; `words_out` [n, width] floats of
// `purpose`'s words, `take` (1-4) of each block, or null (then cam_out and
// out are null); `stream` is the caller's cudaStream_t. Returns
// cudaGetLastError() after the launch.
int pyrite_philox_draws(unsigned k0, unsigned k1, int n, int n_pix, unsigned pixel0,
                        unsigned sample0, unsigned bounce, int s_cam, int light_samples,
                        int n_lamps, float* cam_out, float* out, const int* pixel,
                        const int* sample, const int* depth, const unsigned char* cam_mask,
                        float* words_out, unsigned purpose, int width, int take, void* stream) {
  if (n <= 0) return 0;
  const DrawArgs a = {k0, k1, n, n_pix, pixel0, sample0, bounce, s_cam, light_samples, n_lamps,
                      cam_out, out, pixel, sample, depth, cam_mask, words_out, purpose, width,
                      take};
  const size_t smem = stage_bytes(cam_out ? s_cam : 0);
  const auto kernel = cam_out && s_cam + 5 > CAM_STAGED ? philox_draws_kernel<true>
                                                        : philox_draws_kernel<false>;
  kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a launch with camera draws of S columns passes
// (stage_bytes; rng.draws_smem_bytes mirrors it).
int pyrite_draws_smem(int s_cam) { return (int)stage_bytes(s_cam); }

}  // extern "C"
