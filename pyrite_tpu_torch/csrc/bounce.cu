// Bounce and next-event-estimation kernels for Hopper (sm_90a), for dense
// scenes and for mesh scenes.
//
// One thread owns one wavefront lane for a whole kernel: a 1-D grid over the
// N lanes with a masked tail. The scene is the [R, 128] f32 "sheet" that
// kernels_dense.build_pack lays out (one 128-wide row per table: on a dense
// scene the primitive channels in rows 0..21, then plane, material,
// component, lamp and emissive tables), read from global memory through
// const __restrict__ pointers; `meta` gives each table's row (or a count),
// in the order of kernels_dense.META_FIELDS. Per-lane state keeps the layout
// of the plain version (tracer.bounce_core): [N, 3] vectors, [N, S] spectra,
// bool flags as bytes, so the wrapper hands the same tensors to either.
//
// The shading code is written once, for a geometry policy: DenseGeo sweeps
// the sheet's <= 128 primitives (dense_bounce_kernel, dense_nee_kernel);
// WideGeo walks the clustered wide BVH of csrc/wide_bvh.cuh and reads
// surface data from the flat triangle and sphere tables (wide_bounce_kernel,
// wide_nee_kernel). Under either policy the distance-estimated shapes of the
// sheet's DE columns count after the primitives: a scene with DE shapes runs
// march_de_kernel (csrc/march_de.cuh) over the bounce rays before the
// bounce kernel and over the NEE lanes' shadow rays before the NEE kernel
// (pyrite_de_march_bounce / pyrite_de_march_shadow, at the end of this
// file), and the two kernels read each shape's t from those passes. Each
// kernel comes in two instantiations, <true> for scenes with DE shapes and
// <false> for the rest, which reads no pass: a scene without DE shapes runs
// exactly the kernel it ran before. Likewise each bounce, NEE and lamp
// kernel has a kProg instantiation for scenes with image textures, normal
// maps or programs that read the ray beyond the simple form (ProgArgs,
// eval_program); the others read none of it and are the code they were.
//
// Numerics follow tracer.bounce_core's op order: IEEE sqrtf and division
// (no fast math), c^5 as c^2 * c^2 * c, and the reflectance before the BRDF
// factor feeds NEE. _build.py compiles with --fmad=false, so every product
// is rounded before it is added, as in the plain version's separate ops:
// hit-or-miss decisions on grazing rays then agree lane for lane. The
// kernels compute what the plain version computes, lane by lane; the only
// intended difference is the arccos-free uniform sphere direction
// (cos(arccos(x)) = x, sin(arccos(x)) = sqrt(1 - x^2)).

#include "common.cuh"
#include "march_de.cuh"
#include "wide_bvh.cuh"

namespace {

constexpr int PROG_STACK = 8;  // exprs.PROG_STACK: the simple instantiations' stack

// exprs.OP_* (exprs.KernelPrograms); the simple instantiations interpret
// the first eight (eval_prob), the kProg ones all (eval_program)
enum Op {
  OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MIX, OP_CLAMP, OP_FRESNEL, OP_VEC, OP_LEAF,
  OP_LEAF4, OP_TEX_COLOR, OP_TEX_MONO, OP_SPLAT_RGB, OP_SPLAT_VEC, OP_RGB_TO_VEC, OP_TO_NUMBER,
  OP_RGB, OP_VECTOR, OP_SLOT, OP_SWAP
};

enum { BSDF_EMISSIVE = 0, BSDF_DIFFUSE = 1, BSDF_MIRROR = 2, BSDF_REFRACTIVE = 3 };
enum { LAMP_DIRECTIONAL = 0, LAMP_POINT = 1, LAMP_SPHERE = 2, LAMP_TRIANGLE = 3 };

// Per-launch program values, baked program tables and postfix code
// (kernels_dense.precompute_bank_values, scene.bake_bank_tables,
// exprs.KernelPrograms).
struct Programs {
  const int* __restrict__ code_op;
  const float* __restrict__ code_val;
  // [programs + 1]: prob, color, normal, sky; in the kProg instantiations
  // [2 programs + 1]: each program's lane code, then its column code
  const int* __restrict__ code_off;
  const float* __restrict__ cvals;   // [n_color, N, S], null where ctable is not
  const float* __restrict__ pvals;   // [n_prob, N], wavelength-only programs, null where ptable is not
  int n_color;
  // a scene with BANK_TABLE_MIN wavelength-only color (probability)
  // programs reads them from their [P, grid] table at each lane's
  // wavelengths [N, S] (table_value) in place of cvals (pvals)
  const float* __restrict__ ctable;
  const float* __restrict__ ptable;
  const float* __restrict__ wl;
  int grid;
  float lo, scale;  // the table's first wavelength, grid steps per nm
};

// tracer._bank_table_eval for one value: program `prog`'s row of a baked
// [P, g] table, interpolated linearly at wavelength `wl`, in the plain
// version's op order (`lo` the table's first wavelength, `scale` its grid
// steps per nm)
__device__ __forceinline__ float table_value(const float* __restrict__ table, int g, float lo,
                                             float scale, int prog, float wl) {
  const float pos = fminf(fmaxf((wl - lo) * scale, 0.0f), (float)(g - 1));
  const int i0 = min((int)pos, g - 2);
  const float frac = pos - (float)i0;
  const float* row = table + (size_t)max(prog, 0) * g + i0;
  const float v0 = __ldg(row), v1 = __ldg(row + 1);
  return v0 + (v1 - v0) * frac;
}
__device__ __forceinline__ float table_value(const Programs& pr, const float* __restrict__ table,
                                             int prog, float wl) {
  return table_value(table, pr.grid, pr.lo, pr.scale, prog, wl);
}

// ortho (math.rs:98-117): v x unit, the unit picked per component
__device__ __forceinline__ V3 ortho(V3 v) {
  V3 unit;
  if (fabsf(v.x) < DIST_EPSILON) unit = {1.f, 0.f, 0.f};
  else if (fabsf(v.y) < DIST_EPSILON) unit = {0.f, 1.f, 0.f};
  else if (fabsf(v.z) < DIST_EPSILON) unit = {0.f, 0.f, 1.f};
  else unit = {-v.y, v.x, 0.f};
  return cross(v, unit);
}

// uniform sphere direction (math.rs:147-153) without the arccos
__device__ __forceinline__ V3 sample_sphere_dir(float u, float v) {
  float theta = 2.0f * PI_F * u;
  float cos_phi = fminf(fmaxf(2.0f * v - 1.0f, -1.0f), 1.0f);
  float sin_phi = sqrtf(fmaxf(1.0f - cos_phi * cos_phi, 0.0f));
  return {sin_phi * cosf(theta), sin_phi * sinf(theta), cos_phi};
}

__device__ __forceinline__ V3 sample_hemisphere(float u, float v, V3 dir) {
  V3 s = sample_sphere_dir(u, v);
  V3 o = normalize(ortho(dir));
  V3 y = normalize(cross(o, dir));
  V3 z = normalize(dir);
  return o * s.x + y * s.y + z * fabsf(s.z);
}

__device__ __forceinline__ V3 sample_cone(float u1, float u2, V3 dir, float cos_half) {
  V3 o1 = normalize(ortho(dir));
  V3 o2 = normalize(cross(dir, o1));
  float r1 = 2.0f * PI_F * u1;
  float r2 = cos_half + (1.0f - cos_half) * u2;
  float oneminus = sqrtf(fmaxf(1.0f - r2 * r2, 0.0f));
  return o1 * (cosf(r1) * oneminus) + o2 * (sinf(r1) * oneminus) + dir * r2;
}

// DenseGeo: the sheet's primitive channels (rows 0..21), swept in column
// order. Closest hit: planes, then the primitives; a strict comparison keeps
// the lowest index on ties (intersect_scene's first-min). Each thread
// sweeps for itself, so the kernels call the queries only for lanes with a
// ray (the active flag of WideGeo's queries is always true here) and let
// the others return early.
struct DenseGeo {
  static constexpr bool kWholeWarp = false;

  __device__ __forceinline__ Hit closest(const Sheet& sh, V3 o, V3 d, bool) const {
    Hit h = {INFINITY, KIND_NONE, 0, 0.0f, 0.0f};
    plane_hit(sh, o, d, h);
    const int n_prims = sh.count(M_N_PRIMS);
    for (int j = 0; j < n_prims; ++j) {
      float kind = sh.row(10, j);
      V3 c = sh.row3(0, j);
      float t, u, v;
      if (kind == PRIM_TRIANGLE) {
        if (ray_triangle(o, d, c, sh.row3(3, j), sh.row3(6, j), t, u, v) && t < h.t)
          h = {t, KIND_TRIANGLE, j, u, v};
      } else if (kind == PRIM_SPHERE) {
        if (ray_sphere(o, d, c, sh.row(9, j), t) && t < h.t) h = {t, KIND_SPHERE, j, h.u, h.v};
      }
    }
    return h;
  }

  // Nearest occluder along a shadow ray, starting from the lamp distance
  // (tracer.intersect_shadow): unoccluded rays return t0. A dense sweep
  // tests everything and has no use for the occlusion bound.
  __device__ __forceinline__ float shadow(const Sheet& sh, V3 o, V3 d, float t0, float,
                                          bool) const {
    float best = plane_shadow(sh, o, d, t0);
    const int n_prims = sh.count(M_N_PRIMS);
    for (int j = 0; j < n_prims; ++j) {
      float kind = sh.row(10, j);
      V3 c = sh.row3(0, j);
      float t, u, v;
      if (kind == PRIM_TRIANGLE) {
        if (ray_triangle(o, d, c, sh.row3(3, j), sh.row3(6, j), t, u, v)) best = fminf(best, t);
      } else if (kind == PRIM_SPHERE) {
        if (ray_sphere(o, d, c, sh.row(9, j), t)) best = fminf(best, t);
      }
    }
    return best;
  }

  // normal and material of a triangle or sphere hit (tracer.surface_data)
  __device__ __forceinline__ void surface(const Sheet& sh, const Hit& h, V3 pos, V3& normal,
                                          int& mat) const {
    if (h.kind == KIND_TRIANGLE) {
      const float w = 1.0f - h.u - h.v;
      normal = normalize(sh.row3(13, h.j) * w + sh.row3(16, h.j) * h.u + sh.row3(19, h.j) * h.v);
    } else {
      normal = normalize(pos - sh.row3(0, h.j));
    }
    mat = (int)sh.row(12, h.j);
  }

  // the triangle or sphere table index of sheet column j (row 11, prim_ref)
  __device__ __forceinline__ int ref(const Sheet& sh, int j) const { return (int)sh.row(11, j); }
};

// WideGeo: the clustered wide BVH (csrc/wide_bvh.cuh) after the planes,
// and surface data from the flat tables by (kind, table index). The warp
// sweeps each leaf together, so every thread of a warp must call the
// queries, one without a ray with active = false.
struct WideGeo {
  static constexpr bool kWholeWarp = true;

  WideBvh bvh;
  const float* __restrict__ tri_n;       // [T, 3, 3] vertex normals
  const int* __restrict__ tri_mat;       // [T]
  const float* __restrict__ sph_center;  // [S, 3]
  const int* __restrict__ sph_mat;       // [S]

  __device__ __forceinline__ Hit closest(const Sheet& sh, V3 o, V3 d, bool active) const {
    Hit h = {INFINITY, KIND_NONE, 0, 0.0f, 0.0f};
    if (active) plane_hit(sh, o, d, h);
    wide_closest(bvh, o, d, h, active);
    return h;
  }

  __device__ __forceinline__ float shadow(const Sheet& sh, V3 o, V3 d, float t0, float block_below,
                                          bool active) const {
    return wide_shadow(bvh, o, d, active ? plane_shadow(sh, o, d, t0) : t0, block_below, active);
  }

  __device__ __forceinline__ void surface(const Sheet&, const Hit& h, V3 pos, V3& normal,
                                          int& mat) const {
    if (h.kind == KIND_TRIANGLE) {
      const float w = 1.0f - h.u - h.v;
      const float* n = tri_n + (size_t)h.j * 9;
      normal = normalize(V3{n[0], n[1], n[2]} * w + V3{n[3], n[4], n[5]} * h.u +
                         V3{n[6], n[7], n[8]} * h.v);
      mat = tri_mat[h.j];
    } else {
      normal = normalize(pos - load3(sph_center, h.j));
      mat = sph_mat[h.j];
    }
  }

  __device__ __forceinline__ int ref(const Sheet&, int j) const { return j; }
};

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

// spectra.schlick / spectra.fresnel
__device__ float schlick(float r1, float r2, V3 n, V3 i) {
  float cos_psi = -dot(n, i);
  float r0 = (r1 - r2) / (r1 + r2);
  float nn = r1 / r2;
  float sin_t2 = nn * nn * (1.0f - cos_psi * cos_psi);
  bool tir = sin_t2 > 1.0f;
  float cos_out = sqrtf(fmaxf(1.0f - sin_t2, 0.0f));
  if (r1 > r2) cos_psi = cos_out;
  float r = r0 * r0 + (1.0f - r0 * r0) * pow5(1.0f - cos_psi);
  return (r1 > r2 && tir) ? 1.0f : r;
}

__device__ float fresnel(float ior, float env_ior, V3 n, V3 i) {
  bool entering = dot(i, n) < 0.0f;
  return entering ? schlick(env_ior, ior, n, i) : schlick(ior, env_ior, -n, i);
}

// A wavelength-only probability program's value for one lane at its hero
// wavelength (column 0 of its [N, S] row of wavelengths): from the baked
// table where the scene has one, else the launch's values.
__device__ __forceinline__ float prob_value(const Programs& pr, int prog, int lane, int n, int s) {
  return pr.ptable ? table_value(pr, pr.ptable, prog, pr.wl[(size_t)lane * s])
                   : pr.pvals[(size_t)prog * n + lane];
}

// tracer.eval_prob_bank for one lane in the simple instantiations: program
// -1 is probability 1; wavelength-only programs come from prob_value
// (kTable; else from the launch's values: a scene without a baked table);
// ray-input programs run their postfix code (the simple form: numbers,
// OP_CONST .. OP_FRESNEL, within PROG_STACK values) here.
template <bool kTable>
__device__ float eval_prob(const Programs& pr, int prog, int lane, int n, int s, V3 normal,
                           V3 incident) {
  if (prog < 0) return 1.0f;
  const int begin = pr.code_off[prog];
  const int end = pr.code_off[prog + 1];
  if (begin == end)
    return kTable ? prob_value(pr, prog, lane, n, s) : pr.pvals[(size_t)prog * n + lane];
  float st[PROG_STACK];
  int sp = 0;
  for (int k = begin; k < end; ++k) {
    const int op = pr.code_op[k];
    if (op == OP_CONST) {
      st[sp++] = pr.code_val[k];
    } else if (op == OP_MIX || op == OP_CLAMP) {
      float c = st[--sp];
      float b = st[--sp];
      float a = st[--sp];
      if (op == OP_MIX) {
        float t = fminf(fmaxf(c, 0.0f), 1.0f);
        st[sp++] = a * (1.0f - t) + b * t;
      } else {
        st[sp++] = fminf(fmaxf(a, b), c);
      }
    } else {
      float b = st[--sp];
      float a = st[--sp];
      float r;
      switch (op) {
        case OP_ADD: r = a + b; break;
        case OP_SUB: r = a - b; break;
        case OP_MUL: r = a * b; break;
        case OP_DIV: r = a / b; break;
        default: r = fresnel(a, b, normal, incident); break;  // OP_FRESNEL
      }
      st[sp++] = r;
    }
  }
  return st[0];
}

// ---- the kProg instantiations: frames, uv, normal maps and the program
// code (exprs.KernelPrograms), interpreted per lane and spectral column ----
//
// A scene with image textures, normal maps, color or sky programs that read
// the ray, or probability programs beyond the simple form runs the kernels'
// kProg instantiations (kernels_dense.build_pack); the others run the code
// they had, which reads none of this. Each largest subtree of a program that
// reads no ray is a leaf, evaluated once per launch (kernels_dense.
// precompute_bank_values) at each lane's wavelengths; the code here does
// the rest on a stack of 4-float values, in two parts (exprs.split_code):
// the lane code, which depends on no spectral column (the textures, the
// fresnels, their conversions), once per lane, then the column code (the
// leaves, Burns' basis dot and what takes their values) once per column.
// What bounds it: per texture node and lane 16 taps, each one aligned
// 16-byte load of a colour texel (one float of a mono one) read from the
// texture with __ldg (so that the wrap rule and the reference's cubic are
// its own, texture.rs:88-148 and :324-334; a texture object's filtering is
// neither), and the column code's few instructions per column. Before the
// split the whole program ran per column: a textured floor lane of the
// textures scene sampled 7 textures (its normal map, its colour at each of
// 6 columns), 112 taps, where it now samples 2 (32 taps).
struct ProgArgs {
  const int* __restrict__ arg;         // [L] code arguments
  const float* __restrict__ vecs;      // [C, 4] vector constants
  const float* __restrict__ leaves;    // the launch's leaf values
  const float* __restrict__ tex;       // the textures' texels, one after another
  const int* __restrict__ tex_info;    // [T, 4] offset, height, width, channels
  const float* __restrict__ tri_q;     // [T, 3, 4] vertex frames
  const float* __restrict__ tri_uv;    // [T, 3, 2] vertex uv
  const float* __restrict__ sph_texscale;  // [S, 2]
  const float* __restrict__ pla_quat;      // [P, 4]
  const float* __restrict__ pla_texscale;  // [P, 2]
  int n_prob, n_normal;
  int own_off;  // where the kernel's own dynamic shared memory starts, after the stack: floats
};

// What a program reads of its lane besides the leaves: normal, incident
// direction and uv.
struct ProgIn {
  V3 normal, incident;
  float u, v;
};

__device__ __forceinline__ float4 f4(float x) { return make_float4(x, x, x, x); }
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 operator/(float4 a, float4 b) {
  return make_float4(a.x / b.x, a.y / b.y, a.z / b.z, a.w / b.w);
}

// quaternions (w, x, y, z) as float4 (x = w), in geometry.py's op order
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float4 quat_mul(float4 a, float4 b) {
  return make_float4(a.x * b.x - a.y * b.y - a.z * b.z - a.w * b.w,
                     a.x * b.y + a.y * b.x + a.z * b.w - a.w * b.z,
                     a.x * b.z - a.y * b.w + a.z * b.x + a.w * b.y,
                     a.x * b.w + a.y * b.z - a.z * b.y + a.w * b.x);
}
__device__ __forceinline__ float4 quat_normalize(float4 q) {
  const float len = sqrtf(fmaxf(dot4(q, q), 1e-20f));
  return make_float4(q.x / len, q.y / len, q.z / len, q.w / len);
}
// v + w t + qv x t, t = 2 qv x v
__device__ __forceinline__ V3 quat_rotate(float4 q, V3 v) {
  const V3 qv = {q.y, q.z, q.w};
  const V3 c = cross(qv, v);
  const V3 t = {2.0f * c.x, 2.0f * c.y, 2.0f * c.z};
  return v + t * q.x + cross(qv, t);
}
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int i) {
  return make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
}

// geometry.sphere_surface_frame: the frame quat_mul(qy, qx) from the
// latitude and longitude of the normal, uv = (lon / 2 pi, 1 - lat / pi) /
// texture scale
__device__ void sphere_frame(V3 n, float su, float sv, float4& q, float& u, float& v) {
  const float lat = acosf(fminf(fmaxf(n.y, -1.0f), 1.0f));
  const float lon = atan2f(n.x, n.z);
  const float h1 = lon * 0.5f, h2 = (lat - PI_F * 0.5f) * 0.5f;
  const float s1 = sinf(h1), s2 = sinf(h2);
  const float4 qy = make_float4(cosf(h1), 0.0f * s1, 1.0f * s1, 0.0f * s1);
  const float4 qx = make_float4(cosf(h2), 1.0f * s2, 0.0f * s2, 0.0f * s2);
  q = quat_mul(qy, qx);
  u = (lon / (2.0f * PI_F)) / su;
  v = (1.0f - lat / PI_F) / sv;
}

// geometry.mat3_cols_to_quat (cgmath's From<Matrix3>)
__device__ float4 mat3_cols_to_quat(V3 c0, V3 c1, V3 c2) {
  const float m00 = c0.x, m01 = c0.y, m02 = c0.z, m10 = c1.x, m11 = c1.y, m12 = c1.z;
  const float m20 = c2.x, m21 = c2.y, m22 = c2.z;
  const float trace = m00 + m11 + m22;
  if (trace >= 0.0f) {
    const float s = sqrtf(fmaxf(trace + 1.0f, 0.0f)), d = 0.5f / (s == 0.0f ? 1.0f : s);
    return make_float4(0.5f * s, (m12 - m21) * d, (m20 - m02) * d, (m01 - m10) * d);
  }
  if (m00 > m11 && m00 > m22) {
    const float s = sqrtf(fmaxf(1.0f + m00 - m11 - m22, 0.0f)), d = 0.5f / (s == 0.0f ? 1.0f : s);
    return make_float4((m12 - m21) * d, 0.5f * s, (m01 + m10) * d, (m20 + m02) * d);
  }
  if (m11 > m22) {
    const float s = sqrtf(fmaxf(1.0f + m11 - m00 - m22, 0.0f)), d = 0.5f / (s == 0.0f ? 1.0f : s);
    return make_float4((m20 - m02) * d, (m01 + m10) * d, 0.5f * s, (m12 + m21) * d);
  }
  const float s = sqrtf(fmaxf(1.0f + m22 - m00 - m11, 0.0f)), d = 0.5f / (s == 0.0f ? 1.0f : s);
  return make_float4((m01 - m10) * d, (m20 + m02) * d, (m12 + m21) * d, 0.5f * s);
}

// The four taps around a floor index, wrapped around `size`: a floor modulo
// (never negative, as jnp.mod and torch.remainder), then the neighbours.
__device__ __forceinline__ void wrap_taps(float f, int size, int* i) {
  int m = ((int)f) % size;
  if (m < 0) m += size;
  i[1] = m;
  i[0] = m == 0 ? size - 1 : m - 1;
  i[2] = m == size - 1 ? 0 : m + 1;
  i[3] = i[2] == size - 1 ? 0 : i[2] + 1;
}

// the reference's cubic (texture.rs:324-334)
__device__ __forceinline__ float4 cubic(float4 v1, float4 v2, float4 v3, float4 v4, float t) {
  const float4 a = (v4 - v3) - (v1 - v2);
  const float4 b = (v1 - v2) - a;
  const float4 c = v3 - v1;
  const float4 tt = f4(t);
  return v2 + (c + (b + a * tt) * tt) * tt;
}

// exprs.sample_texture_bicubic of texture `t` at (u, v): each of the four
// rows' cubic along x, then the cubic of the rows along y; a mono texel
// fills all four floats
__device__ float4 sample_texture(const ProgArgs& pa, int t, float u, float v) {
  const int off = pa.tex_info[4 * t], height = pa.tex_info[4 * t + 1];
  const int width = pa.tex_info[4 * t + 2], channels = pa.tex_info[4 * t + 3];
  const float x = u * (float)width - 0.5f, xf = floorf(x);
  const float y = (1.0f - v) * (float)height - 0.5f, yf = floorf(y);
  int xs[4], ys[4];
  wrap_taps(xf, width, xs);
  wrap_taps(yf, height, ys);
  const float tx = x - xf, ty = y - yf;
  float4 rows[4];
  for (int r = 0; r < 4; ++r) {
    float4 taps[4];
    for (int c = 0; c < 4; ++c) {
      const float* p = pa.tex + off + ((size_t)ys[r] * width + xs[c]) * channels;
      taps[c] = channels == 1 ? f4(__ldg(p)) : __ldg(reinterpret_cast<const float4*>(p));
    }
    rows[r] = cubic(taps[0], taps[1], taps[2], taps[3], tx);
  }
  return cubic(rows[0], rows[1], rows[2], rows[3], ty);
}

// eval_program's stack of float4 values a thread: the thread's column of
// the block's [depth][BLOCK] float4 slice of dynamic shared memory, depth
// the scene's deepest program and at least PROG_STACK
// (KernelPrograms.stack_depth: 16 KiB a block at 8; a warp's access to one
// level is 512 contiguous bytes, free of bank conflicts), value i at at[i *
// BLOCK]. It starts the dynamic shared memory, so that its address is the
// static one it had (a start past the kernel's own arrays, known only at
// run time, cost the textures bounce 4 % and spills); the launcher sizes
// it, and the kernel's own arrays follow it (ProgArgs.own_off). A per-thread array
// would live in local memory, its index known only at run time, and
// measured up to 11 % slower on the NEE kernel and 71 % on
// program_colors_kernel (`chip_smoke.py --prog`, variant stack_moved).
struct ProgStack {
  float4* at;
  __device__ __forceinline__ float4& operator[](int i) const { return at[i * BLOCK]; }
};

// Whether program g runs code (its lane or column code is not empty).
__device__ __forceinline__ bool has_code(const Programs& pr, int g) {
  return pr.code_off[2 * g] != pr.code_off[2 * g + 2];
}

// Program g (exprs.KernelPrograms.run) for lane `lane` of an n x s launch:
// its lane code once, which leaves its slots at the bottom of the stack,
// then its column code above them at columns 0 .. cols - 1, the number at
// column k into out[k] unless out is null. Returns the value at column 0.
// One switch runs both parts, the lane code as "column -1". Inlined at
// each call: as a called function (the parent's eval_code was) the call
// saved and restored the caller's registers in local memory, and the
// kernels measured 7-27 % slower (`chip_smoke.py --prog`, PERF.md).
// With `from` >= 0 it runs the column code alone, at columns from .. cols -
// 1, over the slots a call with cols = 0 left on the stack (`slots_io`
// carries their count from the one call to the others): a row made in
// chunks of columns, its texture taps once a lane (bounce_lane's and
// nee_lane's kStream kProg forms).
__device__ __forceinline__ float4 eval_program(const Programs& pr, const ProgArgs& pa, int g, int lane,
                                            int n, int s, int cols, const ProgIn& in, float* out,
                                            int from = -1, int* slots_io = nullptr) {
  extern __shared__ __align__(16) float4 prog_smem[];
  const ProgStack st = {prog_smem + threadIdx.x};
  float4 first = f4(0.0f);
  int slots = slots_io && from >= 0 ? *slots_io : 0;
  for (int k = from; k < cols; ++k) {
    int sp = k < 0 ? 0 : slots;
    const size_t cell = (size_t)lane * s + max(k, 0);
    for (int i = pr.code_off[2 * g + (k >= 0)], end = pr.code_off[2 * g + 1 + (k >= 0)]; i < end;
         ++i) {
      const int op = pr.code_op[i], arg = pa.arg[i];
      switch (op) {
        case OP_CONST: st[sp++] = f4(pr.code_val[i]); break;
        case OP_VEC: st[sp++] = load4(pa.vecs, arg); break;
        case OP_SLOT: st[sp] = st[arg]; ++sp; break;
        case OP_SWAP: {  // the top value and the one `arg` below it change places
          const float4 top = st[sp - 1];
          st[sp - 1] = st[sp - 1 - arg];
          st[sp - 1 - arg] = top;
          break;
        }
        case OP_LEAF: st[sp++] = f4(pa.leaves[(size_t)arg * n * s + cell]); break;
        case OP_LEAF4: st[sp++] = load4(pa.leaves + (size_t)arg * n * s, (int)cell); break;
        case OP_TEX_COLOR:
        case OP_TEX_MONO: {  // one inlined sample_texture for both
          const float4 v = sample_texture(pa, arg, in.u, in.v);
          st[sp++] = op == OP_TEX_MONO ? f4(v.x) : v;
          break;
        }
        case OP_SPLAT_RGB: st[sp - 1] = make_float4(st[sp - 1].x, st[sp - 1].x, st[sp - 1].x, 1.0f); break;
        case OP_SPLAT_VEC: st[sp - 1] = f4(st[sp - 1].x); break;
        case OP_RGB_TO_VEC: st[sp - 1] = st[sp - 1] * f4(2.0f) - f4(1.0f); break;
        case OP_TO_NUMBER: {
          const float4 c = st[sp - 1], b = load4(pa.leaves + (size_t)arg * n * s, (int)cell);
          st[sp - 1] = f4(c.x * b.x + c.y * b.y + c.z * b.z);
          break;
        }
        case OP_RGB:
          sp -= 2;
          st[sp - 1] = make_float4(st[sp - 1].x, st[sp].x, st[sp + 1].x, 1.0f);
          break;
        case OP_VECTOR:
          sp -= 3;
          st[sp - 1] = make_float4(st[sp - 1].x, st[sp].x, st[sp + 1].x, st[sp + 2].x);
          break;
        case OP_MIX: {
          sp -= 2;
          const float t = fminf(fmaxf(st[sp + 1].x, 0.0f), 1.0f);
          st[sp - 1] = st[sp - 1] * f4(1.0f - t) + st[sp] * f4(t);
          break;
        }
        case OP_CLAMP:
          sp -= 2;
          st[sp - 1] = f4(nan_min(nan_max(st[sp - 1].x, st[sp].x), st[sp + 1].x));
          break;
        case OP_FRESNEL:
          --sp;
          st[sp - 1] = f4(fresnel(st[sp - 1].x, st[sp].x, in.normal, in.incident));
          break;
        default: {  // the binary ops
          --sp;
          const float4 a = st[sp - 1], b = st[sp];
          st[sp - 1] = op == OP_ADD ? a + b : op == OP_SUB ? a - b : op == OP_MUL ? a * b : a / b;
        }
      }
    }
    if (k < 0) {
      slots = sp;
    } else {
      const float4 v = st[slots];
      if (k == 0) first = v;
      if (out) out[k] = v.x;
    }
  }
  if (slots_io) *slots_io = slots;
  return first;
}

// tracer.eval_prob_bank for one lane on a kProg scene: program -1 is
// probability 1; programs that read no ray were evaluated per launch; the
// others run their code at the hero wavelength (column 0).
__device__ float eval_prob_code(const Programs& pr, const ProgArgs& pa, int prog, int lane, int n,
                                int s, const ProgIn& in) {
  if (prog < 0) return 1.0f;
  if (!has_code(pr, prog)) return prob_value(pr, prog, lane, n, s);
  return eval_program(pr, pa, prog, lane, n, s, 1, in, nullptr).x;
}

// Whether color program `color` (in range) runs code, and its number.
__device__ __forceinline__ bool color_code(const Programs& pr, const ProgArgs& pa, int color,
                                           int& g) {
  g = pa.n_prob + color;
  return has_code(pr, g);
}

// tracer.apply_normal_maps for one hit: the material's vector program
// (column 0: normal programs read no wavelength) rotated by the frame and
// normalised; a vector with |v|^2 < 1e-12 keeps the geometric normal.
__device__ V3 map_normal(const Sheet& sh, const Programs& pr, const ProgArgs& pa, int mat, int lane,
                         int n, int s, float4 q, const ProgIn& in) {
  const int np = sh.iat(M_MAT_NORMAL, mat);
  if (np < 0) return in.normal;
  const float4 vec = eval_program(pr, pa, pa.n_prob + pr.n_color + np, lane, n, s, 1, in, nullptr);
  const V3 v = {vec.x, vec.y, vec.z};
  return dot(v, v) < 1e-12f ? in.normal : normalize(quat_rotate(q, v));
}

// The frame and uv of a plane or primitive hit at `pos` with normal
// `normal` (tracer.surface_data with frames); a DE hit's frame comes from
// its normal (geometry.de_normal_quat), uv 0.
template <class Geo>
__device__ void hit_frame(const Sheet& sh, const Geo& geo, const ProgArgs& pa, const Hit& h, V3 pos,
                          V3 normal, float4& q, float& u, float& v) {
  q = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
  u = v = 0.0f;
  if (h.kind == KIND_PLANE) {
    q = load4(pa.pla_quat, h.j);
    const V3 local = quat_rotate(make_float4(q.x, -q.y, -q.z, -q.w), pos);
    u = local.x / pa.pla_texscale[2 * h.j];
    v = local.y / pa.pla_texscale[2 * h.j + 1];
  } else if (h.kind == KIND_TRIANGLE) {
    const int ref = geo.ref(sh, h.j);
    const float w = 1.0f - h.u - h.v;
    const float* tq = pa.tri_q + (size_t)ref * 12;
    const float* tuv = pa.tri_uv + (size_t)ref * 6;
    q = quat_normalize(load4(tq, 0) * f4(w) + load4(tq, 1) * f4(h.u) + load4(tq, 2) * f4(h.v));
    u = tuv[0] * w + tuv[2] * h.u + tuv[4] * h.v;
    v = tuv[1] * w + tuv[3] * h.u + tuv[5] * h.v;
  } else if (h.kind == KIND_SPHERE) {
    const int ref = geo.ref(sh, h.j);
    sphere_frame(normal, pa.sph_texscale[2 * ref], pa.sph_texscale[2 * ref + 1], q, u, v);
  } else if (h.kind == KIND_DE) {
    const V3 z = normalize(ortho(normal));
    q = mat3_cols_to_quat(normalize(cross(z, normal)), z, normal);
  }
}

// The shading that the camera bounce (bounce_lane) and the lamp bounce
// (lamp_lane) share, written once: the surface of a hit, the uniform
// component pick and the BSDF scatter (SCATTER_BSDF).

// Normal and material of a plane or primitive hit (tracer.surface_data); a
// DE hit's come from de_normals_shared.
template <class Geo, bool kDE>
__device__ __forceinline__ void hit_surface(const Sheet& sh, const Geo& geo, const Hit& h, V3 pos,
                                            V3& normal, int& mat) {
  if (h.kind == KIND_PLANE) {
    normal = {sh.at(M_PLA_NX, h.j), sh.at(M_PLA_NY, h.j), sh.at(M_PLA_NZ, h.j)};
    mat = sh.iat(M_PLA_MAT, h.j);
  } else if (!(kDE && h.kind == KIND_DE)) {
    geo.surface(sh, h, pos, normal, mat);
  }
}

// uniform component choice (materials/mod.rs:48-54)
__device__ __forceinline__ int pick_component(const Sheet& sh, int mat, float u_comp) {
  const int count = max(sh.iat(M_MAT_COMP_COUNT, mat), 1);
  const int pick = min((int)(u_comp * (float)count), count - 1);
  return sh.iat(M_MAT_COMP_OFFSET, mat) + pick;
}

// tracer.scatter for a non-emissive component COMP of BSDF kind BSDF:
// from the ray direction D, the shading normal NORMAL and the normal facing
// the ray FLIP (and the sheet SH), with the uniforms U0, U1, U2, it sets the
// caller's OUT (the new direction), PROB (the scatter's probability) and
// DISPERSED: diffuse, mirror or refractive (refractive.rs:46-91, Cauchy
// dispersion in micrometres at the hero wavelength HERO_WL, an expression
// that only the refractive branch evaluates). The camera bounce
// (bounce_lane) and the lamp bounce (lamp_lane) expand it; every name it
// reads or sets is an argument. It is a macro and not a function: as a
// __forceinline__ function with reference out-parameters (the hero
// wavelength passed as a pointer, a pointer and an index, or a value) it
// gives the simple renderer's dense_bounce_kernel<false> 48 registers where
// it has 46 and 8 more SASS instructions (ptxas -v and cuobjdump, sm_90a);
// expanded in place it is the code that kernel always had.
#define SCATTER_BSDF(SH, BSDF, COMP, D, NORMAL, FLIP, HERO_WL, U0, U1, U2, OUT, PROB, DISPERSED) \
  do {                                                                                 \
    PROB = 1.0f;                                                                       \
    DISPERSED = false;                                                                 \
    if (BSDF == BSDF_DIFFUSE) {                                                        \
      OUT = sample_hemisphere(U0, U1, FLIP);                                           \
    } else if (BSDF == BSDF_MIRROR) {                                                  \
      OUT = D - FLIP * (2.0f * dot(D, FLIP));                                          \
    } else {                                                                           \
      const float wl_um = (HERO_WL) * 0.001f;                                          \
      const float disp = SH.at(M_COMP_DISP, COMP), env_disp = SH.at(M_COMP_ENV_DISP, COMP); \
      const float ior = SH.at(M_COMP_IOR, COMP) + disp / (wl_um * wl_um);              \
      const float env_ior = SH.at(M_COMP_ENV_IOR, COMP) + env_disp / (wl_um * wl_um);  \
      const V3 reflected_dir = D - NORMAL * (2.0f * dot(NORMAL, D));                   \
      const bool into = dot(NORMAL, FLIP) > 0.0f;                                      \
      const float nnt = into ? env_ior / ior : ior / env_ior;                          \
      const float ddn = dot(D, FLIP);                                                  \
      const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);                       \
      const bool tir = cos2t < 0.0f;                                                   \
      const float s_val = (into ? 1.0f : -1.0f) * (ddn * nnt + sqrtf(fmaxf(cos2t, 0.0f))); \
      const V3 tdir = normalize(D * nnt - NORMAL * s_val);                             \
      const float a_ = ior - env_ior, b_ = ior + env_ior;                              \
      const float r0 = (a_ * a_) / (b_ * b_);                                          \
      const float c_ = 1.0f - (into ? -ddn : dot(tdir, NORMAL));                       \
      const float re = r0 + (1.0f - r0) * pow5(c_);                                    \
      const float tr = 1.0f - re;                                                      \
      const float p_refl = 0.25f + 0.5f * re;                                          \
      const bool pick_reflect = (U2) < p_refl;                                         \
      OUT = (tir || pick_reflect) ? reflected_dir : tdir;                              \
      PROB = tir ? 1.0f : (pick_reflect ? re / p_refl : tr / (1.0f - p_refl));         \
      DISPERSED = disp != 0.0f || env_disp != 0.0f;                                    \
    }                                                                                  \
  } while (0)

struct BounceArgs {
  Sheet sheet;
  Programs progs;
  const float* __restrict__ sky;  // [1 + D, N, S]: the sky, then each directional lamp's color
  const float* __restrict__ wl;   // [N, S], hero at column 0
  const float* __restrict__ origin;
  const float* __restrict__ direction;
  const float* __restrict__ brightness;
  const float* __restrict__ reflectance;
  const uint8_t* __restrict__ alive;
  const uint8_t* __restrict__ aux_alive;
  const uint8_t* __restrict__ sample_light;
  const int* __restrict__ light_events;
  const float* __restrict__ u_comp;     // [N]
  const float* __restrict__ u_scatter;  // [N, 3]
  float* __restrict__ o_origin;
  float* __restrict__ o_direction;
  float* __restrict__ o_brightness;
  float* __restrict__ o_reflectance;
  uint8_t* __restrict__ o_alive;
  uint8_t* __restrict__ o_aux_alive;
  uint8_t* __restrict__ o_sample_light;
  int* __restrict__ o_light_events;
  float* __restrict__ o_flip;      // [N, 3] normal facing the incoming ray
  float* __restrict__ o_refl_nee;  // [N, S] reflectance before the BRDF factor
  uint8_t* __restrict__ o_nee;     // [N] lane takes NEE this bounce
  int n, s, light_samples;
  const float* __restrict__ t_de;  // [n_de, N] the bounce march pass's t (<true> only)
};

// The camera vertex of each lane that a kRecord bounce writes
// (tracer.bounce_core's info but its incident direction, the bounce's
// input): [N, 3] position and normal, [N] BRDF factor and byte flags; and
// where color_prob is not null (the photon renderer; the bidirectional one
// passes nulls and the stores are skipped) the chain factors of a
// reflection: [N, S] color x path probability, [N] color program, path
// probability and reflected flag (0, -1, 0 and 0 on the other lanes).
struct Record {
  float* __restrict__ position;
  float* __restrict__ normal;
  float* __restrict__ brdf;
  uint8_t* __restrict__ is_diffuse;
  uint8_t* __restrict__ dispersed;
  uint8_t* __restrict__ recorded;
  uint8_t* __restrict__ miss;
  float* __restrict__ color_prob;
  int* __restrict__ color_prog;
  float* __restrict__ path_prob;
  uint8_t* __restrict__ reflected;
};

// The DE shapes after the primitives, from the march pass's t of each
// (tracer.intersect_scene): a hit counts beyond DIST_EPSILON and strictly
// nearer than the running hit, shape by shape. A ray that missed a shape has
// t = inf there.
__device__ __forceinline__ void apply_de_closest(const Sheet& sh, const float* __restrict__ t_de,
                                                 int n, int lane, Hit& h) {
  const int n_de = sh.count(M_N_DE);
  for (int j = 0; j < n_de; ++j) {
    const float t = t_de[(size_t)j * n + lane];
    if (t > DIST_EPSILON && t < h.t) h = {t, KIND_DE, j, h.u, h.v};
  }
}

// Shared memory of a bounce kernel block, bounce_smem_bytes(S, kDE): the
// block's [BLOCK, S] brightness, reflectance, pre-BRDF reflectance and
// gathered sky or color row, its [BLOCK, 3] origin, direction, facing normal
// and u_scatter, and with DE shapes each warp's probe slots (de_normals_shared).
constexpr int DE_SLOT_FLOATS = 32 * 3 + 32 + 32 * 6;  // local points, shape indices, probes

__host__ __device__ __forceinline__ size_t bounce_smem_bytes(int s, bool de) {
  return sizeof(float) * ((size_t)BLOCK * (4 * s + 12) + (de ? (BLOCK / 32) * DE_SLOT_FLOATS : 0));
}

// What the streamed form (bounce_lane's kStream instantiations) does to a
// lane's spectral rows, left by its thread in shared memory for the
// block's spectral pass (bounce_rows): the ops of the staged form's loops,
// column 0 alone or, with `all`, every column.
enum { ROW_KEEP, ROW_MISS, ROW_EMIT, ROW_REFLECT };
struct RowOp {
  const float* src;  // the lane's sky or color row, or null: zeros
  float f;           // EMIT: the component probability; REFLECT: the path probability
  float brdf;        // REFLECT: the BRDF factor
  int table;         // the baked color program whose table gives the row, or -1
  int op;            // ROW_*
  int all;
};

// Shared memory of a streamed bounce block: [BLOCK, 3] origin, direction,
// facing normal and u_scatter, a RowOp a lane, with DE shapes each warp's
// probe slots, and in the kProg forms each lane's own colour row
// (eval_program's): the whole row at S <= MAX_ROW in the record form (`own`
// = S), past MAX_ROW a chunk's slot (`own` = OWN_STRIDE, RECORD_STRIDE in
// the record form). None of it grows with S past MAX_ROW.
constexpr int ROW_OP_FLOATS = (int)(sizeof(RowOp) / sizeof(float));
// Columns of an own row made and streamed at a time: 16 in the simple
// renderer's bounce and the NEE, 128 in the camera walk (kRecord), whose
// window pass writes four arrays (chip_smoke.py --wide-prog measured 16,
// 32 and 64 on both, and 128 on the camera walk: PERF.md §6 rows 1 and A);
// a slot's stride is odd, so that a warp's column writes fall on 32 banks.
constexpr int ROW_CHUNK = 16;
constexpr int RECORD_CHUNK = 128;
constexpr int OWN_STRIDE = ROW_CHUNK + 1;
constexpr int RECORD_STRIDE = RECORD_CHUNK + 1;

__host__ __device__ __forceinline__ size_t stream_smem_bytes(bool de, int own = 0) {
  return sizeof(float) * ((size_t)BLOCK * (12 + ROW_OP_FLOATS + own) +
                          (de ? (BLOCK / 32) * DE_SLOT_FLOATS : 0));
}

// Words the streamed bounce's spectral pass keeps in flight a thread: each
// loads its inputs before any of them is stored.
constexpr int ROW_BATCH = 4;

// Row l and column k of word e of a block's [rows, s] span, the row through
// the reciprocal (exact for e < BLOCK * s up to widths of thousands, as
// row_owner).
__device__ __forceinline__ int span_row(int e, float inv_s) {
  return (int)(((float)e + 0.5f) * inv_s);
}

// The streamed bounce's spectral pass: the block's [rows, S] span of
// brightness, reflectance, pre-BRDF reflectance (and, where the kRecord
// caller asks, color x path probability) as one elementwise pass, thread t
// on words t, t + BLOCK, ..., so every load and store is a coalesced run.
// Each word takes the ops of the staged form's loops in their order
// (b + c * r; b + c * p * r; r * c * p, then * brdf), so every bit is theirs.
// kWindow (the kProg form past MAX_ROW columns, bounce_lane's kWhole false)
// takes the span's columns from .. from + width - 1 alone, a chunk of them.
template <bool kRecord, bool kWindow = false>
__device__ __forceinline__ void bounce_rows(const BounceArgs& a, const Record& rec, const RowOp* ops,
                                            int base, int rows, int from = 0, int width = 0) {
  const int s = a.s, w = kWindow ? width : s, count = rows * w;
  const size_t sp = (size_t)base * s;
  const float inv_s = 1.0f / (float)w;
  const Programs& pr = a.progs;
  const bool chain = kRecord && rec.color_prob != nullptr;
  // word e of the span (or of the window) at [N, S] offset sp + at(e, l, k)
  auto at = [&](int e, int l, int k) { return kWindow ? (size_t)l * s + from + k : (size_t)e; };
  for (int e0 = threadIdx.x; e0 < count; e0 += ROW_BATCH * BLOCK) {
    float b[ROW_BATCH], r[ROW_BATCH], c[ROW_BATCH];
#pragma unroll
    for (int q = 0; q < ROW_BATCH; ++q) {
      const int e = e0 + q * BLOCK;
      if (e >= count) break;
      const int l = span_row(e, inv_s), kw = e - l * w, k = kWindow ? from + kw : kw;
      const size_t i = sp + at(e, l, kw);
      const RowOp& op = ops[l];
      const bool col = k == 0 || op.all;
      b[q] = a.brightness[i];
      r[q] = a.reflectance[i];
      c[q] = 0.0f;
      if ((op.op != ROW_KEEP && col) || (chain && op.op == ROW_REFLECT))
        c[q] = op.table >= 0 ? table_value(pr, pr.ctable, op.table, a.wl[i])
                             : (op.src ? op.src[k] : 0.0f);
    }
#pragma unroll
    for (int q = 0; q < ROW_BATCH; ++q) {
      const int e = e0 + q * BLOCK;
      if (e >= count) break;
      const int l = span_row(e, inv_s), kw = e - l * w, k = kWindow ? from + kw : kw;
      const size_t i = sp + at(e, l, kw);
      const RowOp& op = ops[l];
      float bk = b[q], rk = r[q], rn = r[q];
      if (k == 0 || op.all) {
        if (op.op == ROW_MISS) {
          bk = bk + c[q] * rk;
        } else if (op.op == ROW_EMIT) {
          bk = bk + c[q] * op.f * rk;
        } else if (op.op == ROW_REFLECT) {
          rn = rk * c[q] * op.f;
          rk = rn * op.brdf;
        }
      }
      a.o_brightness[i] = bk;
      a.o_reflectance[i] = rk;
      a.o_refl_nee[i] = rn;
      if (chain) rec.color_prob[i] = op.op == ROW_REFLECT ? c[q] * op.f : 0.0f;
    }
  }
}

// The widest row the unrolled part of warp_gather moves; wider rows (S >
// 16) go on in a loop of the same steps.
constexpr int MAX_ROW = 16;

// The lane (of 32) whose row holds word i of a warp's [32, width] rows:
// i / width, through the reciprocal (exact for any i < 32 x width up to
// widths of thousands: the quotient's fraction is at least 1 / (2 width)
// from an integer, and the product's error is below 2^-19).
__device__ __forceinline__ int row_owner(int i, float inv_width) {
  return min((int)(((float)i + 0.5f) * inv_width), 31);
}

// Words r0 .. r0 + 3 (of `width`) of the warp's [32, width] rows: four loads
// in flight per thread.
__device__ __forceinline__ void gather_step(float* dst, unsigned long long mine, int width,
                                            float inv, int lid, int r0) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = lid + 32 * (r0 + q), owner = row_owner(i, inv);
    const float* p = reinterpret_cast<const float*>(__shfl_sync(FULL_WARP, mine, owner));
    v[q] = (r0 + q < width && p) ? p[i - owner * width] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (r0 + q < width) dst[lid + 32 * (r0 + q)] = v[q];
}

// Each lane's row of `width` floats at `src` (nullptr: zeros) into the
// warp's [32, width] rows `dst` in shared memory. Consecutive threads read
// consecutive words, row after row, so a warp's loads of neighbouring
// lanes' rows are contiguous runs. The first MAX_ROW words of each row
// unrolled, the rest (kWide: S > 16) in a loop. Every thread of the warp
// calls it.
template <bool kWide>
__device__ __forceinline__ void warp_gather(float* dst, const float* src, int width) {
  const int lid = threadIdx.x & 31;
  const unsigned long long mine = reinterpret_cast<unsigned long long>(src);
  const float inv = 1.0f / (float)width;
  __syncwarp();
#pragma unroll
  for (int r0 = 0; r0 < MAX_ROW; r0 += 4) {
    if (r0 >= width) break;
    gather_step(dst, mine, width, inv, lid, r0);
  }
  if (kWide) {
#pragma unroll 1
    for (int r0 = MAX_ROW; r0 < width; r0 += 4) gather_step(dst, mine, width, inv, lid, r0);
  }
  __syncwarp();
}

// Normal and material of the warp's DE hits (tracer.de_normal): central
// differences of the estimator, eps = DIST_EPSILON, at the point
// DIST_EPSILON short of the hit in the shape's local space, the probes
// adding (+-eps, +-0, +-0) as the plain version's offsets do. The warp's 32
// threads share the 6k estimator probes of its k hit lanes: each hit lane
// publishes its local point and its shape into the warp's slots; probe
// `task` belongs to hit lane task / 6 (in lane order) on axis and sign
// task % 6 (+x, +y, +z, -x, -y, -z), and runs the same de_distance on the
// same point, so every bit is kept; the threads take the tasks round-robin,
// 32 a round; the owner then forms the normal in the plain version's order.
// (Refilling a thread with the next task per estimator iteration, as
// march_de_kernel does, wastes fewer issue slots on paper but measured
// slower: chip_smoke.bounce_warp_counts, PERF.md.) Every thread of the warp
// calls it.
__device__ __forceinline__ void de_normals_shared(const Sheet& sh, float* slots, bool de_hit,
                                                  const Hit& h, V3 o, V3 d, V3& normal, int& mat) {
  const unsigned hits = __ballot_sync(FULL_WARP, de_hit);
  if (hits == 0) return;
  const int lid = threadIdx.x & 31;
  float* pts = slots;                                    // [32, 3]
  int* shape = reinterpret_cast<int*>(slots + 32 * 3);  // [32]
  float* probe = slots + 32 * 4;                         // [32, 6]
  const int rank = __popc(hits & ((1u << lid) - 1u));
  __syncwarp();
  if (de_hit) {
    const V3 c = {sh.at(M_DE_CX, h.j), sh.at(M_DE_CY, h.j), sh.at(M_DE_CZ, h.j)};
    const V3 l = (o - c) + d * (h.t - DIST_EPSILON);
    pts[3 * rank] = l.x;
    pts[3 * rank + 1] = l.y;
    pts[3 * rank + 2] = l.z;
    shape[rank] = h.j;
  }
  __syncwarp();
  const int tasks = 6 * __popc(hits);
  for (int task = lid; task < tasks; task += 32) {
    const int owner = task / 6, axis = task - 6 * owner, ax = axis % 3;
    const float e = axis < 3 ? DIST_EPSILON : -DIST_EPSILON, z = axis < 3 ? 0.0f : -0.0f;
    const V3 l = {pts[3 * owner], pts[3 * owner + 1], pts[3 * owner + 2]};
    const V3 p = {l.x + (ax == 0 ? e : z), l.y + (ax == 1 ? e : z), l.z + (ax == 2 ? e : z)};
    probe[task] = de_distance(load_de(sh, shape[owner]), p);
  }
  __syncwarp();
  if (de_hit) {
    const float* q = probe + 6 * rank;
    normal = normalize(V3{q[0] - q[3], q[1] - q[4], q[2] - q[5]});
    mat = sh.iat(M_DE_MAT, h.j);
  }
}

// One bounce of tracer.bounce_core per lane, minus the NEE contribution
// (the NEE kernel adds it): closest hit (the planes, then the geometry
// policy, then the DE shapes' t from the march pass), miss -> sky, uniform
// component pick, probability programs,
// diffuse/mirror/refractive scatter with Cauchy dispersion, emission,
// reflectance update, NEE eligibility.
//
// dense_bounce_kernel replaces pyrite_tpu/kernels_dense.py
// `_make_kernels.bounce_kernel` (:717, the Pallas TPU kernel).
// What bounds it on an H100: per lane it reads and writes its state, about
// (2 * 6 + 3) * 4 + 3 bytes of vectors and flags plus 4 * S bytes for each
// of brightness, reflectance, wavelengths, sky and each color program, and
// it writes 4 * S more for the pre-BRDF reflectance: ~250 bytes at S = 6
// against ~30 flops per primitive tested. With the few primitives of a
// spheres-class scene that is memory-bound; at 128 primitives the sweep's
// ~4k flops per lane make it compute-bound. On a DE scene the six
// estimator probes of each DE hit's normal come on top, ~650 instructions
// per estimator iteration. The design:
// - the sheet is read through the L1/read-only path (every lane of a warp
//   reads the same sheet element at the same time, a broadcast);
// - the block stages its lanes' [BLOCK, S] brightness and reflectance and
//   [BLOCK, 3] origin, direction and u_scatter through shared memory with
//   contiguous float4 loads, shades there, and stores brightness,
//   reflectance, pre-BRDF reflectance, origin, direction and facing normal
//   the same way (block_copy); a lane's sky or color row, which depends on
//   its hit, is gathered by its warp into shared memory (warp_gather). One
//   thread per lane wrote rows of 4 S bytes a word at a time before, a
//   warp-wide access spanning 32 such rows;
// - with DE shapes, the warp's threads share its DE hits' normal probes
//   (de_normals_shared): a warp with k hit lanes runs ceil(6k / 32) rounds
//   of probes where each hit lane ran its six in turn while the rest of the
//   warp waited.
// Dead lanes and threads past the end of the wavefront take part in the
// staging and the warp operations and skip the rest (there is no early
// return: every thread reaches every barrier and warp operation).
//
// wide_bounce_kernel runs the same code over a mesh scene; the TPU package
// ran that bounce as XLA ops around its walk and sweep kernels
// (pyrite_tpu/kernels.py:125, :337, :541), which live on here as the device
// functions of csrc/wide_bvh.cuh. Its cost is the closest-hit traversal's
// (see there); the shading around it is the dense kernel's ~250 bytes per
// lane. The traversal sweeps each leaf with the whole warp, so there every
// thread computes the closest hit, dead lanes and threads past the end of
// the wavefront with active = false; the dense kernel sweeps for its alive
// lanes alone.
//
// kRecord (the bidirectional renderer's camera walk) also writes each
// lane's camera vertex, tracer.bounce_core's info (Record), from values the
// lane computes anyway: the hit point (the origin where the ray found
// nothing), the shading normal, the BRDF factor of a reflection (1
// elsewhere) and the flags is_diffuse, dispersed, recorded and miss. The
// simple renderer's instantiations (kRecord = false) compile to the code
// they had. kGate (always where kProg) compiles in what the scene gate
// took last: directional lamps on a miss, the baked colour and probability
// tables and rows past MAX_ROW columns; without it the code is the one
// before them (kernels_dense.build_pack's "form" picks it).
//
// The kStream instantiations (the gate form past MAX_ROW columns: kGate,
// not kProg) stage no spectral row: a lane's thread leaves what its rows
// take in a RowOp (which case, its factors, where its color row comes
// from), and after the block's barrier bounce_rows applies them to the
// block's span of the [N, S] arrays in global memory, consecutive threads
// on consecutive words. The staged form kept four [BLOCK, S] rows at a
// stride of S floats, which past 16 columns put every thread of a warp on
// one bank (S = 32, 64) and sized the block's shared memory by S (one
// block a SM at S = 64); the streamed block's shared memory is
// stream_smem_bytes, whatever S. Every kRecord launch (A, the camera
// walks) takes a streamed instantiation, at any S: the gate form's on a
// scene without the program form, and the kProg one, where a lane whose
// program makes its colour row writes that one row into its [BLOCK, S]
// slot (eval_program, as the staged form did), its RowOp points there, and
// the other three rows stream; that block holds one [BLOCK, S] row where
// the staged form held four (at the photon renderer's S + G = 70 columns
// 65,536 B with the program stack, against 165,888). Streamed, A measured
// faster than staged on every form at every S (PERF.md §6 row A). The
// simple renderer's instantiations stay as they were at S <= MAX_ROW.
//
// Past MAX_ROW columns every kProg launch streams with its own rows in
// chunks (kStream, kWhole false: the simple renderer's kProg bounce and the
// kProg camera walk alike; the record form keeps its whole own row, kWhole,
// at S <= MAX_ROW, the code it was). A lane whose program makes its colour
// row runs the program's lane code once, its slots left on the stack;
// then, per chunk of kChunk columns (ROW_CHUNK, RECORD_CHUNK in the camera
// walk), it runs the column code into its [BLOCK, kChunk + 1] slot and the
// block streams that window of every row (bounce_rows<kWindow>). The
// block's shared memory is stream_smem_bytes(de, kChunk + 1) whatever S; a
// texture is still sampled once a lane. (The other way, the own row written
// to an [N, S] device scratch that bounce_rows reads as it reads the sky
// rows, is chip_smoke.py's WIDE_PROG_VARIANTS probe own_scratch: slower at
// S = 64, 128 and 512, PERF.md §6 row 1.)
template <class Geo, bool kDE, bool kRecord, bool kProg, bool kGate, bool kStream, bool kWhole>
__device__ __forceinline__ void bounce_lane(const BounceArgs& a, const Geo& geo, const Record& rec,
                                            const ProgArgs& pa) {
  static_assert(!kStream || kGate, "the streamed forms are the gate form's and the kProg forms'");
  static_assert(!kWhole || (kStream && kRecord && kProg), "a whole own row is the camera walk's");
  constexpr bool kChunks = kProg && kStream && !kWhole;
  constexpr int kChunk = kRecord ? RECORD_CHUNK : ROW_CHUNK, kStride = kChunk + 1;
  extern __shared__ __align__(16) float dyn_smem[];
  float* smem = dyn_smem + (kProg ? pa.own_off : 0);  // after the program stack
  const int n = a.n, s = a.s, t = threadIdx.x;
  const int base = blockIdx.x * BLOCK, lane = base + t;
  const int rows = min(BLOCK, n - base);
  const bool in_range = t < rows;
  float* B = smem;               // [BLOCK, S] brightness, in and out
  float* R = B + BLOCK * s;      // reflectance, in and out
  float* RN = R + BLOCK * s;     // pre-BRDF reflectance, out
  float* C = RN + BLOCK * s;     // the lane's sky or color row
  float* O = kStream ? smem : C + BLOCK * s;  // [BLOCK, 3] origin, in and out
  float* D = O + 3 * BLOCK;      // direction, in and out
  float* F = D + 3 * BLOCK;      // facing normal, out
  float* U = F + 3 * BLOCK;      // u_scatter
  RowOp* ops = reinterpret_cast<RowOp*>(U + 3 * BLOCK);  // kStream: a lane's RowOp
  // kStream and kProg: each lane's own colour row, after the DE probe slots
  float* own = O + BLOCK * (12 + ROW_OP_FLOATS) + (kDE ? (BLOCK / 32) * DE_SLOT_FLOATS : 0);
  const size_t sp = (size_t)base * s, vp = (size_t)base * 3;
  if (!kStream) {
    block_copy(B, a.brightness + sp, rows * s);
    block_copy(R, a.reflectance + sp, rows * s);
  }
  block_copy(O, a.origin + vp, rows * 3);
  block_copy(D, a.direction + vp, rows * 3);
  block_copy(U, a.u_scatter + vp, rows * 3);
  __syncthreads();

  const Sheet sh = a.sheet;
  const Programs pr = a.progs;
  float* b = B + t * s;
  float* r = R + t * s;
  float* rn = RN + t * s;
  const float* c = C + t * s;
  const V3 o = in_range ? V3{O[3 * t], O[3 * t + 1], O[3 * t + 2]} : V3{0.f, 0.f, 0.f};
  const V3 d = in_range ? V3{D[3 * t], D[3 * t + 1], D[3 * t + 2]} : V3{0.f, 0.f, 0.f};
  const bool alive = in_range && a.alive[lane];
  Hit h = {INFINITY, KIND_NONE, 0, 0.0f, 0.0f};
  if (Geo::kWholeWarp) {
    h = geo.closest(sh, o, d, alive);
  } else if (alive) {
    h = geo.closest(sh, o, d, true);
  }
  if (kDE && alive) apply_de_closest(sh, a.t_de, n, lane, h);
  const bool found = alive && h.kind != KIND_NONE;

  V3 normal = {0.f, 0.f, 0.f};
  int mat = 0;
  if (kDE)
    de_normals_shared(sh, smem + BLOCK * (kStream ? 12 + ROW_OP_FLOATS : 4 * s + 12) + (t >> 5) * DE_SLOT_FLOATS,
                      found && h.kind == KIND_DE, h, o, d, normal, mat);
  const V3 pos = o + d * h.t;
  int comp = 0, bsdf = BSDF_EMISSIVE, color_id = -1;
  float comp_probability = 0.0f;
  bool normal_dispersed = false;
  const float* row_src = nullptr;  // this lane's sky or color row
  ProgIn in = {d, d, 0.0f, 0.0f};  // kProg: what its programs read
  // the program whose row the lane makes itself: in kProg one whose code
  // gives it (>= 0), or -2 - the baked color program whose table gives it
  int own_prog = -1;
  int own_slots = 0;  // kChunks: the slots its lane code left on the stack
  if (found) {
    hit_surface<Geo, kDE>(sh, geo, h, pos, normal, mat);
    if (kProg) {  // the frame and uv, then the normal map (tracer._shading_normal)
      float4 q;
      hit_frame(sh, geo, pa, h, pos, normal, q, in.u, in.v);
      in.normal = normal;
      normal = map_normal(sh, pr, pa, mat, lane, n, s, q, in);
      in.normal = normal;
    }
    comp = pick_component(sh, mat, a.u_comp[lane]);
    const int prob = sh.iat(M_COMP_PROB, comp);
    comp_probability = (kProg ? eval_prob_code(pr, pa, prob, lane, n, s, in)
                              : eval_prob<kGate>(pr, prob, lane, n, s, normal, d)) *
                       sh.at(M_COMP_SELECTION, comp);
    normal_dispersed = sh.at(M_COMP_PROB_USES_WL, comp) > 0.5f;
    bsdf = sh.iat(M_COMP_BSDF, comp);
    color_id = sh.iat(M_COMP_COLOR, comp);
    // tracer.eval_color_bank: out-of-range programs are 0
    if (color_id >= 0 && color_id < pr.n_color) {
      int g;
      if (kProg && color_code(pr, pa, color_id, g)) own_prog = g;
      else if (kGate && pr.ctable) own_prog = -2 - color_id;
      else row_src = pr.cvals + ((size_t)color_id * n + lane) * s;
    }
  } else if (alive) {
    // miss: the first directional lamp whose direction . d >= its width
    // while the lane samples lamps, else the sky (tracer.bounce_core); its
    // program reads normal -d, incident d and uv 0, a wavelength-only one
    // row 1 + j (the lamp's) or 0 (the sky's) of the launch's values
    int g = pa.n_prob + pr.n_color + pa.n_normal, sky_row = 0;
    if constexpr (kGate) {
      const int n_dir = sh.count(M_N_DIR);
      if (n_dir > 0 && a.sample_light[lane])
        for (int j = 0; j < n_dir; ++j)
          if (dot(V3{sh.at(M_DIR_VX, j), sh.at(M_DIR_VY, j), sh.at(M_DIR_VZ, j)}, d) >=
              sh.at(M_DIR_WIDTH, j)) {
            g = pa.n_prob + sh.iat(M_DIR_COLOR, j);
            sky_row = 1 + j;
            break;
          }
    }
    if (kProg && has_code(pr, g)) {
      own_prog = g;
      in.normal = -d;
    } else {
      row_src = a.sky + ((size_t)sky_row * n + lane) * s;
    }
  }
  if (!kStream) {
    warp_gather<kGate>(C + (t & ~31) * s, row_src, s);
    if (kProg && own_prog >= 0)  // the lane's own row, after the warp's gather
      eval_program(pr, pa, own_prog, lane, n, s, s, in, C + t * s);
    if (kGate && own_prog < -1)
      for (int k = 0; k < s; ++k)
        C[t * s + k] = table_value(pr, pr.ctable, -2 - own_prog, a.wl[(size_t)lane * s + k]);
  } else if (kChunks && own_prog >= 0) {  // the lane code now, the columns chunk by chunk
    eval_program(pr, pa, own_prog, lane, n, s, 0, in, nullptr, -1, &own_slots);
  } else if (kProg && own_prog >= 0) {  // the lane's own row, for bounce_rows to read
    eval_program(pr, pa, own_prog, lane, n, s, s, in, own + t * s);
    row_src = own + t * s;
  }

  if (in_range) {
    RowOp op = {row_src, 0.0f, 1.0f, own_prog < -1 ? -2 - own_prog : -1, ROW_KEEP, 0};  // kStream
    const bool aux = a.aux_alive[lane];
    const bool sample_light = a.sample_light[lane];
    const int light_events = a.light_events[lane];
    // state carried through unless the lane reflects
    V3 new_o = o, new_d = d, flip = {0.f, 0.f, 0.f};
    bool alive_next = false, aux_next = aux, sample_light_next = sample_light, nee = false;
    int light_events_next = light_events;
    bool reflected = false;
    float rec_brdf = 1.0f;  // kRecord: the reflection's BRDF factor, its flags
    float rec_path_prob = 0.0f;  // and its path probability
    bool rec_diffuse = false, rec_dispersed = false;
    if (alive && !found) {
      if (kStream) {
        op.op = ROW_MISS;
        op.all = aux;
      } else {
        for (int k = 0; k < s; ++k)
          if (k == 0 || aux) b[k] = b[k] + c[k] * r[k];
      }
    } else if (found && bsdf == BSDF_EMISSIVE) {
      if (kStream && sample_light) {
        op.op = ROW_EMIT;
        op.f = comp_probability;
        op.all = aux && !normal_dispersed;
      } else if (sample_light) {
        for (int k = 0; k < s; ++k)
          if (k == 0 || (aux && !normal_dispersed)) b[k] = b[k] + c[k] * comp_probability * r[k];
      }
    } else if (found) {
      // scatter (tracer.scatter)
      reflected = true;
      flip = dot(d, normal) < 0.0f ? normal : -normal;
      const float u0 = U[3 * t], u1 = U[3 * t + 1], u2 = U[3 * t + 2];
      V3 out;
      float sc_probability;
      bool sc_dispersed;
      SCATTER_BSDF(sh, bsdf, comp, d, normal, flip, a.wl[(size_t)lane * s], u0, u1, u2, out,
                   sc_probability, sc_dispersed);
      const bool is_diffuse = bsdf == BSDF_DIFFUSE;

      // reflection: color * probability now, the BRDF after NEE has read it
      aux_next = aux && !(sc_dispersed || normal_dispersed);
      const float path_prob = sc_probability * comp_probability;
      const float brdf = is_diffuse ? 2.0f * fabsf(dot(normal, out)) : 1.0f;
      if (kStream) {
        op = {row_src, path_prob, brdf, op.table, ROW_REFLECT, aux_next};
      } else {
        for (int k = 0; k < s; ++k) {
          float rk = r[k];
          if (k == 0 || aux_next) {
            rk = rk * c[k] * path_prob;
            r[k] = rk * brdf;
          }
          rn[k] = rk;
        }
      }
      nee = is_diffuse && light_events < 2;
      light_events_next = light_events + (nee ? 1 : 0);
      sample_light_next = light_events < 2 ? (!is_diffuse || a.light_samples == 0) : true;
      new_o = pos;
      new_d = out;
      alive_next = true;
      if (kRecord) {
        rec_brdf = brdf;
        rec_path_prob = path_prob;
        rec_diffuse = is_diffuse;
        rec_dispersed = sc_dispersed || normal_dispersed;
      }
    }
    if (kRecord) {
      const bool miss = alive && !found;
      store3(rec.position, lane, isfinite(h.t) ? pos : o);
      store3(rec.normal, lane, normal);
      rec.brdf[lane] = rec_brdf;
      rec.is_diffuse[lane] = rec_diffuse;
      rec.dispersed[lane] = rec_dispersed;
      rec.recorded[lane] = reflected || miss || (found && bsdf == BSDF_EMISSIVE && sample_light);
      rec.miss[lane] = miss;
      if (rec.color_prob) {  // kStream: the row in bounce_rows
        float* cp = rec.color_prob + (size_t)lane * s;
        if (!kStream)
          for (int k = 0; k < s; ++k) cp[k] = reflected ? c[k] * rec_path_prob : 0.0f;
        rec.color_prog[lane] = reflected ? color_id : -1;
        rec.path_prob[lane] = rec_path_prob;
        rec.reflected[lane] = reflected;
      }
    }
    if (kStream) ops[t] = op;
    else if (!reflected)
      for (int k = 0; k < s; ++k) rn[k] = r[k];
    O[3 * t] = new_o.x; O[3 * t + 1] = new_o.y; O[3 * t + 2] = new_o.z;
    D[3 * t] = new_d.x; D[3 * t + 1] = new_d.y; D[3 * t + 2] = new_d.z;
    F[3 * t] = flip.x; F[3 * t + 1] = flip.y; F[3 * t + 2] = flip.z;
    a.o_alive[lane] = alive_next;
    a.o_aux_alive[lane] = aux_next;
    a.o_sample_light[lane] = sample_light_next;
    a.o_light_events[lane] = light_events_next;
    a.o_nee[lane] = nee;
  }
  __syncthreads();
  if constexpr (kChunks) {
    // per chunk: the own rows' columns into their slots (a lane's RowOp
    // pointed so that src[k] is column k), then the block's window
    for (int from = 0; from < s; from += kChunk) {
      const int width = min(kChunk, s - from);
      if (own_prog >= 0) {
        float* row = own + t * kStride - from;
        eval_program(pr, pa, own_prog, lane, n, s, from + width, in, row, from, &own_slots);
        ops[t].src = row;
      }
      __syncthreads();
      bounce_rows<kRecord, true>(a, rec, ops, base, rows, from, width);
      __syncthreads();
    }
  } else if (kStream) {
    bounce_rows<kRecord>(a, rec, ops, base, rows);
  } else {
    block_copy(a.o_brightness + sp, B, rows * s);
    block_copy(a.o_reflectance + sp, R, rows * s);
    block_copy(a.o_refl_nee + sp, RN, rows * s);
  }
  block_copy(a.o_origin + vp, O, rows * 3);
  block_copy(a.o_direction + vp, D, rows * 3);
  block_copy(a.o_flip + vp, F, rows * 3);
}

struct NeeArgs {
  Sheet sheet;
  Programs progs;
  const float* __restrict__ position;  // [N, 3] hit point (the bounce's new origin)
  const float* __restrict__ flip;      // [N, 3]
  const uint8_t* __restrict__ nee;     // [N]
  const uint8_t* __restrict__ aux_alive;
  const float* __restrict__ refl_nee;  // [N, S]
  const int* __restrict__ lamp_idx;    // [N]
  const float* __restrict__ u_nee;     // [ls, N, 4]
  const float* __restrict__ u_emis;    // [ls, N]
  float* __restrict__ brightness;      // [N, S], accumulated in place
  int n, s, light_samples;
  float nee_prob;  // 1 / (ls * 2 pi * (1 / n_lamps))
  const float* __restrict__ t_de_shadow;  // [n_de, ls, N] the shadow march pass's t (<true> only)
};

// The DE shapes along shadow ray (light sample, lane) `ray` of the
// `per_shape` = ls * N, from the shadow pass's t of each
// (tracer.intersect_shadow): a hit at any t, negative included, lowers the
// running t, shape by shape.
__device__ __forceinline__ float apply_de_shadow(const Sheet& sh, const float* __restrict__ t_de,
                                                 size_t per_shape, size_t ray, float best) {
  const int n_de = sh.count(M_N_DE);
  for (int j = 0; j < n_de; ++j) best = nan_min(best, t_de[(size_t)j * per_shape + ray]);
  return best;
}

struct LampSample {
  V3 dir;
  float sq_distance, weight;
  V3 normal;
  int mat;
  bool is_shape;
  float u, v;  // the sample's surface uv (kUV)
};

// tracer.sample_lamp for one lane: directional, point, sphere and triangle
// lamps; with kUV also the uv of a sphere or triangle sample (its
// "surf_uv"). A directional lamp's direction is a cone sample about its own
// where its width (a cosine) is above 0, else its own; its distance is
// infinite and its weight 1 (kDir: the NEE kernels' kGate instantiations,
// the DE shadow pass).
template <bool kUV = false, bool kDir = true>
__device__ LampSample sample_lamp(const Sheet& sh, int li, V3 p, float u0, float u1) {
  LampSample ls = {{0.f, 0.f, 1.f}, INFINITY, 0.0f, {0.f, 0.f, 1.f}, 0, false};
  const int type = sh.iat(M_LAMP_TYPE, li);
  const int ref = max(sh.iat(M_LAMP_REF, li), 0);
  if (kDir && type == LAMP_DIRECTIONAL) {
    const V3 dir = {sh.at(M_LAMP_VX, li), sh.at(M_LAMP_VY, li), sh.at(M_LAMP_VZ, li)};
    const float width = sh.at(M_LAMP_WIDTH, li);
    ls.dir = width > 0.0f ? sample_cone(u0, u1, dir, width) : dir;
    ls.weight = 1.0f;
  } else if (type == LAMP_POINT) {
    const V3 v = V3{sh.at(M_LAMP_VX, li), sh.at(M_LAMP_VY, li), sh.at(M_LAMP_VZ, li)} - p;
    ls.sq_distance = dot(v, v);
    ls.dir = normalize(v);
    ls.weight = 4.0f * PI_F / fmaxf(ls.sq_distance, 1e-20f);
  } else if (type == LAMP_SPHERE) {
    // shapes/mod.rs:209-271: cone from the epsilon-reduced radius, sample
    // point on the full sphere
    const V3 c = {sh.at(M_LSPH_CX, ref), sh.at(M_LSPH_CY, ref), sh.at(M_LSPH_CZ, ref)};
    const float r_full = sh.at(M_LSPH_R, ref);
    const float r = fmaxf(r_full - DIST_EPSILON, 0.0f);
    const V3 to_c = c - p;
    const float dist2 = dot(to_c, to_c);
    const bool outside = dist2 > r * r;
    const float cos_max = sqrtf(fmaxf(1.0f - (r * r) / fmaxf(dist2, 1e-20f), 0.0f));
    const V3 cone = sample_cone(u0, u1, normalize(to_c), cos_max);
    float cone_t;
    if (!ray_sphere(p, cone, c, r_full, cone_t)) cone_t = 0.0f;
    const V3 point = outside ? p + cone * cone_t : c + sample_sphere_dir(u0, u1) * r_full;
    const V3 sv = point - p;
    ls.sq_distance = outside ? cone_t * cone_t : dot(sv, sv);
    ls.dir = outside ? cone : normalize(sv);
    const float cos_full = sqrtf(fmaxf(1.0f - (r_full * r_full) / fmaxf(dist2, 1e-20f), 0.0f));
    ls.normal = normalize(point - c);
    if (kUV) {
      float4 q;
      sphere_frame(ls.normal, sh.at(M_LSPH_TSU, ref), sh.at(M_LSPH_TSV, ref), q, ls.u, ls.v);
    }
    const float area = r_full * r_full * 4.0f * PI_F;
    const float cos_in = fabsf(dot(ls.normal, -ls.dir));
    ls.weight = dist2 > r_full * r_full
                    ? (cos_full >= 1.0f ? 0.0f : 2.0f * PI_F * (1.0f - cos_full))
                    : cos_in * area / fmaxf(ls.sq_distance, 1e-20f);
    ls.mat = sh.iat(M_LSPH_MAT, ref);
    ls.is_shape = true;
  } else if (type == LAMP_TRIANGLE) {
    // shapes/mod.rs:180-207: uniform point
    float tu = u0, tv = u1;
    if (tu + tv > 1.0f) {
      tu = 1.0f - tu;
      tv = 1.0f - tv;
    }
    const V3 v0 = {sh.at(M_LTRI_V0X, ref), sh.at(M_LTRI_V0Y, ref), sh.at(M_LTRI_V0Z, ref)};
    const V3 e1 = {sh.at(M_LTRI_E1X, ref), sh.at(M_LTRI_E1Y, ref), sh.at(M_LTRI_E1Z, ref)};
    const V3 e2 = {sh.at(M_LTRI_E2X, ref), sh.at(M_LTRI_E2Y, ref), sh.at(M_LTRI_E2Z, ref)};
    const V3 point = v0 + e1 * tu + e2 * tv;
    const V3 v = point - p;
    ls.sq_distance = dot(v, v);
    ls.dir = normalize(v);
    const float tw = 1.0f - tu - tv;
    const V3 n0 = {sh.at(M_LTRI_N0X, ref), sh.at(M_LTRI_N0Y, ref), sh.at(M_LTRI_N0Z, ref)};
    const V3 n1 = {sh.at(M_LTRI_N1X, ref), sh.at(M_LTRI_N1Y, ref), sh.at(M_LTRI_N1Z, ref)};
    const V3 n2 = {sh.at(M_LTRI_N2X, ref), sh.at(M_LTRI_N2Y, ref), sh.at(M_LTRI_N2Z, ref)};
    ls.normal = normalize(n0 * tw + n1 * tu + n2 * tv);
    if (kUV) {
      ls.u = sh.at(M_LTRI_UV0U, ref) * tw + sh.at(M_LTRI_UV1U, ref) * tu + sh.at(M_LTRI_UV2U, ref) * tv;
      ls.v = sh.at(M_LTRI_UV0V, ref) * tw + sh.at(M_LTRI_UV1V, ref) * tu + sh.at(M_LTRI_UV2V, ref) * tv;
    }
    const V3 cr = cross(e1, e2);
    const float area = 0.5f * sqrtf(fmaxf(dot(cr, cr), 0.0f));
    const float cos_in = fabsf(dot(ls.normal, -ls.dir));
    ls.weight = cos_in * area / fmaxf(ls.sq_distance, 1e-20f);
    ls.mat = sh.iat(M_LTRI_MAT, ref);
    ls.is_shape = true;
  }
  return ls;
}

// Light sample j of a thread's NEE lane in the streamed forms (nee_lane's
// kStream instantiations): the lamp sample (with its uv in kProg), the
// shadow query (on WideGeo every thread of the warp calls it, one without
// a ray with cast false) and, where the lamp is seen, the emitter's pick
// and the sample's factor l_prob, as nee_lane's loop computes them (a copy:
// the loop calling a shared one changed the other instantiations'
// registers). Returns whether the sample adds to the lane.
template <class Geo, bool kDE, bool kProg = false>
__device__ __forceinline__ bool light_sample(const NeeArgs& a, const Geo& geo, const Sheet& sh,
                                             const Programs& pr, const ProgArgs& pa, int j, bool nee,
                                             int lane, V3 p, V3 flip, int li, bool pairs,
                                             LampSample& ls, float& l_prob, int& color_id,
                                             bool& l_dispersed) {
  const int n = a.n, s = a.s;
  ls = {{0.f, 0.f, 1.f}, INFINITY, 0.0f, {0.f, 0.f, 1.f}, 0, false};
  if (nee) {
    const float* u = a.u_nee + ((size_t)j * n + lane) * 4;
    float u0, u1;
    if (pairs) {
      const float2 uv = *reinterpret_cast<const float2*>(u);
      u0 = uv.x;
      u1 = uv.y;
    } else {
      u0 = u[0];
      u1 = u[1];
    }
    ls = sample_lamp<kProg, true>(sh, li, p, u0, u1);
  }
  const bool cast = nee && fmaxf(dot(flip, ls.dir), 0.0f) > 0.0f;
  if (!Geo::kWholeWarp && !cast) return false;
  float t_hit = geo.shadow(sh, p, ls.dir, sqrtf(ls.sq_distance),
                           sqrtf(fmaxf(ls.sq_distance - DIST_EPSILON, 0.0f)), cast);
  if (!cast) return false;
  if (kDE)
    t_hit = apply_de_shadow(sh, a.t_de_shadow, (size_t)a.light_samples * n, (size_t)j * n + lane, t_hit);
  if (t_hit * t_hit < ls.sq_distance - DIST_EPSILON) return false;  // blocked

  float mat_prob = 1.0f;
  l_dispersed = false;
  color_id = sh.iat(M_LAMP_COLOR, li);
  if (ls.is_shape) {
    // choose_emissive (materials/mod.rs:56-62)
    const float u_emis = a.u_emis[(size_t)j * n + lane];
    const int count = max(sh.iat(M_MAT_EMIS_COUNT, ls.mat), 1);
    const int pick = min((int)(u_emis * (float)count), count - 1);
    const int eidx = sh.iat(M_MAT_EMIS_OFFSET, ls.mat) + pick;
    const int e_comp = sh.iat(M_EMIS_COMP, eidx);
    const int prob = sh.iat(M_COMP_PROB, e_comp);
    mat_prob = (kProg ? eval_prob_code(pr, pa, prob, lane, n, s, {ls.normal, ls.dir, ls.u, ls.v})
                      : eval_prob<true>(pr, prob, lane, n, s, ls.normal, ls.dir)) *
               sh.at(M_EMIS_SELECTION, eidx);
    l_dispersed = sh.at(M_COMP_PROB_USES_WL, e_comp) > 0.5f;
    color_id = sh.iat(M_COMP_COLOR, e_comp);
  }
  const float brdf = 2.0f * fabsf(dot(flip, ls.dir));
  l_prob = ls.weight * a.nee_prob * brdf * mat_prob;
  return true;
}

// What light sample j adds to an NEE lane in the streamed form, left by the
// lane's thread for the block's spectral pass (nee_rows): `code` -1 adds
// nothing, else 2 (color program + 1) + all, program -1 being none (zeros)
// and `all` every column where column 0 alone is not.
struct NeeOp {
  float l_prob;
  int code;
};
// Light samples a streamed NEE block takes per pass over its rows.
constexpr int NEE_CHUNK = 4;

// The streamed NEE's spectral pass over (NEE lane, column) words of the
// block's compacted lanes, word e lane lanes[e / S] and column e % S, so a
// warp reads and writes runs of its lanes' rows: each word is read once,
// takes the chunk's `jn` light samples in order, b + c * l_prob * rn each as
// the staged loops did, and is written once. A thread keeps one word in
// flight (its colour reads issued before the adds): more words a thread
// took more registers and ran slower (PERF.md §6, row 2).
__device__ __forceinline__ void nee_rows(const NeeArgs& a, const int* lanes,
                                         const NeeOp (*ops)[BLOCK], int total, int jn) {
  const int s = a.s, n = a.n, count = total * s;
  const float inv_s = 1.0f / (float)s;
  const Programs& pr = a.progs;
  for (int e = threadIdx.x; e < count; e += BLOCK) {
    const int l = span_row(e, inv_s), k = e - l * s, lane = lanes[l];
    const size_t i = (size_t)lane * s + k;
    float c[NEE_CHUNK];
    unsigned takes = 0;  // bit j: light sample j adds to the word
#pragma unroll
    for (int j = 0; j < NEE_CHUNK; ++j) {
      if (j >= jn) break;
      const NeeOp op = ops[j][l];
      if (op.code < 0 || !(k == 0 || (op.code & 1))) continue;
      takes |= 1u << j;
      const int color = (op.code >> 1) - 1;
      c[j] = color < 0 ? 0.0f
             : pr.ctable ? table_value(pr, pr.ctable, color, pr.wl[i])
                         : pr.cvals[((size_t)color * n + lane) * s + k];
    }
    if (!takes) continue;
    const float rn = a.refl_nee[i];
    float b = a.brightness[i];
#pragma unroll
    for (int j = 0; j < NEE_CHUNK; ++j)
      if ((takes >> j) & 1u) b = b + c[j] * ops[j][l].l_prob * rn;
    a.brightness[i] = b;
  }
}

// The kProg streamed NEE's spectral pass over one light sample's window of
// columns from .. from + width - 1: word e is NEE lane lanes[e / width] at
// column from + e % width. `ops` hold each lane's sample, `code` -1 adding
// nothing, else 4 (color program + 1) + 2 own + all: `own` where the
// program's code made the window's colours into the lane's slot of `rows`
// ([BLOCK, OWN_STRIDE], column k at k - from), else the launch's values or
// the baked table as nee_rows reads them; b + c * l_prob * rn as the
// per-thread loop adds it.
__device__ __forceinline__ void nee_prog_rows(const NeeArgs& a, const int* lanes, const NeeOp* ops,
                                              const float* rows, int total, int from, int width) {
  const int s = a.s, n = a.n, count = total * width;
  const float inv_w = 1.0f / (float)width;
  const Programs& pr = a.progs;
  for (int e = threadIdx.x; e < count; e += BLOCK) {
    const int l = span_row(e, inv_w), kw = e - l * width, k = from + kw, lane = lanes[l];
    const NeeOp op = ops[l];
    if (op.code < 0 || !(k == 0 || (op.code & 1))) continue;
    const size_t i = (size_t)lane * s + k;
    const int color = (op.code >> 2) - 1;
    const float c = (op.code & 2)  ? rows[l * OWN_STRIDE + kw]
                    : color < 0    ? 0.0f
                    : pr.ctable    ? table_value(pr, pr.ctable, color, pr.wl[i])
                                   : pr.cvals[((size_t)color * n + lane) * s + k];
    const float rn = a.refl_nee[i];
    a.brightness[i] = a.brightness[i] + c * op.l_prob * rn;
  }
}

// tracer.trace_direct for the lanes the bounce kernel marked. Per light
// sample: sample_lamp, a shadow query (the planes, the geometry policy, then
// the DE shapes' t from the shadow march pass, which marched no further than
// the lamp) seeded at the lamp distance, the emissive component pick,
// the lamp's probability and color programs, and the contribution added to
// the lane's brightness. The TPU kernel revisited its output block across
// a grid axis of light samples; here the thread owns its lane and loops.
//
// What bounds it on an H100: per lane and light sample it reads 12 bytes of
// draws and the shadow sweep costs ~30 flops per primitive; per lane it
// reads ~40 bytes of state and reads and writes 4 * S bytes of brightness
// plus 4 * S of pre-BRDF reflectance and of each lamp color program read.
// Lanes that take no NEE (dead, missed, emissive, specular, or past two
// diffuse events) read one byte; on deep bounces that is most lanes, so its
// cost follows the diffuse share of the wavefront. Those lanes are spread
// through the warps (37 % of flagship's lanes take NEE at bounce 0, 8 % at
// bounce 1), and a warp ran its lamp samples and shadow sweeps with the
// others idle. So the block first compacts its NEE lanes, in lane order,
// to its first threads (a ballot per warp, the warps' counts in shared
// memory): thread t works on the block's t-th NEE lane, the warps past the
// last NEE lane leave at once, and the lanes a thread reads and writes are
// its lane's own rows, as in the plain version. A lane reads its lamp
// sample's two uniforms as one 8-byte load.
//
// dense_nee_kernel replaces pyrite_tpu/kernels_dense.py
// `_make_kernels.nee_kernel` (:909, the Pallas TPU kernel), whose output
// block was revisited across a grid axis of light samples; here the thread
// owns its lane and loops. wide_nee_kernel runs the same code over a mesh
// scene, where the shadow query is the any-hit traversal of
// csrc/wide_bvh.cuh (it replaces the TPU sweep at pyrite_tpu/kernels.py:593
// with the walk of :125 and :337) and stops at the first leaf that leaves t
// under the occlusion bound sqrt(max(d^2 - eps, 0)) (tracer.py:1269-1270):
// a ray to the lamp that is blocked for sure needs no nearer blocker. That
// traversal sweeps each leaf with the whole warp, so there the threads of
// the last warp with an NEE lane that have none, and lamp samples behind
// the surface, call it with active = false, once per light sample like the
// others (the loop over light samples is uniform across the warp), and only
// help sweep.
//
// The kStream instantiations (a gate scene past MAX_ROW columns) read and
// write no row per thread: for each NEE_CHUNK light samples a lane's
// thread leaves a NeeOp each, and the block then walks its NEE lanes'
// (lane, column) words (nee_rows), reading and writing each brightness
// word once a chunk where the per-thread loop read and wrote it once per
// light sample, every warp access a run of a lane's row.
//
// The kStream kProg instantiations (a kProg scene past MAX_ROW columns) keep
// no [BLOCK, S] colour row: per light sample each NEE lane's thread makes
// its sample (light_sample<kProg>) and, where the emitter's colour program
// runs code, that program's lane code, leaving a NeeOp; then per chunk of
// ROW_CHUNK columns the thread runs the column code into its [BLOCK,
// OWN_STRIDE] slot and the block adds the window into its lanes' rows
// (nee_prog_rows); only column 0 where no lane of the block takes all.
template <class Geo, bool kDE, bool kProg, bool kGate, bool kStream>
__device__ __forceinline__ void nee_lane(const NeeArgs& a, const Geo& geo, const ProgArgs& pa) {
  static_assert(!kStream || kGate, "the streamed forms are the gate form's and the kProg form's");
  __shared__ int lanes[BLOCK];             // the block's NEE lanes, in lane order
  __shared__ int warp_count[BLOCK / 32];  // NEE lanes per warp
  // kProg: each thread's row of its lamp's colour program, the block's
  // [BLOCK, S] floats of dynamic shared memory (after the program stack)
  extern __shared__ __align__(16) float nee_smem[];
  const int n = a.n, s = a.s, t = threadIdx.x, lid = t & 31;
  float* colors = nee_smem + pa.own_off + t * s;
  const int base = blockIdx.x * BLOCK;
  const bool mine = base + t < n && a.nee[base + t];
  const unsigned marked = __ballot_sync(FULL_WARP, mine);
  if (lid == 0) warp_count[t >> 5] = __popc(marked);
  __syncthreads();
  int offset = 0, total = 0;
  for (int i = 0; i < BLOCK / 32; ++i) {
    offset += i < (t >> 5) ? warp_count[i] : 0;
    total += warp_count[i];
  }
  if (mine) lanes[offset + __popc(marked & ((1u << lid) - 1u))] = base + t;
  __syncthreads();
  if constexpr (kStream && kProg) {
    __shared__ NeeOp ops[BLOCK];
    if (total == 0) return;
    const bool nee = t < total;
    const bool run = Geo::kWholeWarp ? t < ((total + 31) & ~31) : nee;
    float* row = nee_smem + pa.own_off + t * OWN_STRIDE;
    for (int j = 0; j < a.light_samples; ++j) {
      int g = -1, slots = 0;  // the sample's colour program where its code makes the row
      bool all = false;
      ProgIn in = {};
      const int lane = nee ? lanes[t] : 0;
      if (run) {
        const Sheet sh = a.sheet;
        const Programs pr = a.progs;
        const V3 p = nee ? load3(a.position, lane) : V3{0.f, 0.f, 0.f};
        const V3 flip = nee ? load3(a.flip, lane) : V3{0.f, 0.f, 0.f};
        const int li = nee ? a.lamp_idx[lane] : 0;
        const bool pairs = (reinterpret_cast<uintptr_t>(a.u_nee) & 7) == 0;
        LampSample ls;
        float l_prob;
        int color_id;
        bool l_dispersed;
        NeeOp op = {0.0f, -1};
        if (light_sample<Geo, kDE, true>(a, geo, sh, pr, pa, j, nee, lane, p, flip, li, pairs, ls,
                                         l_prob, color_id, l_dispersed)) {
          const bool colored = color_id >= 0 && color_id < pr.n_color;
          all = a.aux_alive[lane] && !l_dispersed;
          if (colored && color_code(pr, pa, color_id, g)) {
            // the emitter's colour at the lamp sample (tracer._direct_sample's
            // inputs: the surface normal, or -dir on a point lamp)
            in = {ls.is_shape ? ls.normal : -ls.dir, ls.dir, ls.u, ls.v};
            eval_program(pr, pa, g, lane, n, s, 0, in, nullptr, -1, &slots);
          } else {
            g = -1;
          }
          op = {l_prob, 4 * (colored ? color_id + 1 : 0) + (g >= 0 ? 2 : 0) + (all ? 1 : 0)};
        }
        if (nee) ops[t] = op;
      }
      const int cols = __syncthreads_or(nee && all) ? s : 1;
      for (int from = 0; from < cols; from += ROW_CHUNK) {
        const int width = min(ROW_CHUNK, cols - from);
        if (g >= 0 && (from == 0 || all))
          eval_program(a.progs, pa, g, lane, n, s, from + (all ? width : 1), in, row - from, from,
                       &slots);
        __syncthreads();
        nee_prog_rows(a, lanes, ops, nee_smem + pa.own_off, total, from, width);
        __syncthreads();
      }
    }
    return;
  } else if constexpr (kStream) {
    // The streamed form: per chunk of light samples each NEE lane's thread
    // leaves its samples' NeeOps, then the block adds them into its lanes'
    // rows (nee_rows); no thread leaves before the block's last barrier.
    __shared__ NeeOp ops[NEE_CHUNK][BLOCK];
    if (total == 0) return;
    const bool nee = t < total;
    const bool run = Geo::kWholeWarp ? t < ((total + 31) & ~31) : nee;
    for (int j0 = 0; j0 < a.light_samples; j0 += NEE_CHUNK) {
      const int jn = min(NEE_CHUNK, a.light_samples - j0);
      if (run) {
        // read per chunk, so that none of it is live across nee_rows
        const int lane = nee ? lanes[t] : 0;
        const Sheet sh = a.sheet;
        const Programs pr = a.progs;
        const V3 p = nee ? load3(a.position, lane) : V3{0.f, 0.f, 0.f};
        const V3 flip = nee ? load3(a.flip, lane) : V3{0.f, 0.f, 0.f};
        const bool aux = nee && a.aux_alive[lane];
        const int li = nee ? a.lamp_idx[lane] : 0;
        const bool pairs = (reinterpret_cast<uintptr_t>(a.u_nee) & 7) == 0;
        for (int j = 0; j < jn; ++j) {
          LampSample ls;
          float l_prob;
          int color_id;
          bool l_dispersed;
          NeeOp op = {0.0f, -1};
          if (light_sample<Geo, kDE>(a, geo, sh, pr, pa, j0 + j, nee, lane, p, flip, li, pairs, ls,
                                     l_prob, color_id, l_dispersed)) {
            const bool colored = color_id >= 0 && color_id < pr.n_color;
            op = {l_prob, 2 * (colored ? color_id + 1 : 0) + (aux && !l_dispersed ? 1 : 0)};
          }
          if (nee) ops[j][t] = op;
        }
      }
      __syncthreads();
      nee_rows(a, lanes, ops, total, jn);
      __syncthreads();
    }
    return;
  }
  if (t >= ((total + 31) & ~31)) return;  // whole warps past the last NEE lane
  const bool nee = t < total;
  if (!Geo::kWholeWarp && !nee) return;
  const int lane = nee ? lanes[t] : 0;
  const size_t row = (size_t)lane * s;
  const Sheet sh = a.sheet;
  const Programs pr = a.progs;
  const V3 p = nee ? load3(a.position, lane) : V3{0.f, 0.f, 0.f};
  const V3 flip = nee ? load3(a.flip, lane) : V3{0.f, 0.f, 0.f};
  const bool aux = nee && a.aux_alive[lane];
  const int li = nee ? a.lamp_idx[lane] : 0;
  const bool pairs = (reinterpret_cast<uintptr_t>(a.u_nee) & 7) == 0;

  for (int j = 0; j < a.light_samples; ++j) {
    LampSample ls = {{0.f, 0.f, 1.f}, INFINITY, 0.0f, {0.f, 0.f, 1.f}, 0, false};
    if (nee) {
      const float* u = a.u_nee + ((size_t)j * n + lane) * 4;
      float u0, u1;
      if (pairs) {
        const float2 uv = *reinterpret_cast<const float2*>(u);
        u0 = uv.x;
        u1 = uv.y;
      } else {
        u0 = u[0];
        u1 = u[1];
      }
      ls = sample_lamp<kProg, kGate>(sh, li, p, u0, u1);
    }
    const bool cast = nee && fmaxf(dot(flip, ls.dir), 0.0f) > 0.0f;
    if (!Geo::kWholeWarp && !cast) continue;
    float t_hit = geo.shadow(sh, p, ls.dir, sqrtf(ls.sq_distance),
                             sqrtf(fmaxf(ls.sq_distance - DIST_EPSILON, 0.0f)), cast);
    if (!cast) continue;
    if (kDE)
      t_hit = apply_de_shadow(sh, a.t_de_shadow, (size_t)a.light_samples * n, (size_t)j * n + lane, t_hit);
    if (t_hit * t_hit < ls.sq_distance - DIST_EPSILON) continue;  // blocked

    float mat_prob = 1.0f;
    bool l_dispersed = false;
    int color_id = sh.iat(M_LAMP_COLOR, li);
    if (ls.is_shape) {
      // choose_emissive (materials/mod.rs:56-62)
      const float u_emis = a.u_emis[(size_t)j * n + lane];
      const int count = max(sh.iat(M_MAT_EMIS_COUNT, ls.mat), 1);
      const int pick = min((int)(u_emis * (float)count), count - 1);
      const int eidx = sh.iat(M_MAT_EMIS_OFFSET, ls.mat) + pick;
      const int e_comp = sh.iat(M_EMIS_COMP, eidx);
      const int prob = sh.iat(M_COMP_PROB, e_comp);
      mat_prob = (kProg ? eval_prob_code(pr, pa, prob, lane, n, s, {ls.normal, ls.dir, ls.u, ls.v})
                        : eval_prob<kGate>(pr, prob, lane, n, s, ls.normal, ls.dir)) *
                 sh.at(M_EMIS_SELECTION, eidx);
      l_dispersed = sh.at(M_COMP_PROB_USES_WL, e_comp) > 0.5f;
      color_id = sh.iat(M_COMP_COLOR, e_comp);
    }
    const float brdf = 2.0f * fabsf(dot(flip, ls.dir));
    const float l_prob = ls.weight * a.nee_prob * brdf * mat_prob;
    // tracer.eval_color_bank: out-of-range programs are 0
    const bool colored = color_id >= 0 && color_id < pr.n_color;
    int g;
    if (kProg && colored && color_code(pr, pa, color_id, g)) {
      // the emitter's color at the lamp sample (tracer._direct_sample's
      // inputs: the surface normal, or -dir on a point lamp)
      const ProgIn in = {ls.is_shape ? ls.normal : -ls.dir, ls.dir, ls.u, ls.v};
      const int cols = aux && !l_dispersed ? s : 1;
      eval_program(pr, pa, g, lane, n, s, cols, in, colors);
      for (int k = 0; k < cols; ++k) a.brightness[row + k] += colors[k] * l_prob * a.refl_nee[row + k];
      continue;
    }
    if (kGate && pr.ctable) {  // the baked table at the lane's wavelengths
      for (int k = 0; k < s; ++k)
        if (k == 0 || (aux && !l_dispersed))
          a.brightness[row + k] +=
              (colored ? table_value(pr, pr.ctable, color_id, pr.wl[row + k]) : 0.0f) * l_prob *
              a.refl_nee[row + k];
      continue;
    }
    const float* c = pr.cvals + ((size_t)(colored ? color_id : 0) * n + lane) * s;
    for (int k = 0; k < s; ++k)
      if (k == 0 || (aux && !l_dispersed))
        a.brightness[row + k] += (colored ? c[k] : 0.0f) * l_prob * a.refl_nee[row + k];
  }
}

// The lamp bounce of the bidirectional renderer, kernel of
// tracer.lamp_bounce_step (and, with `start`, of tracer.lamp_start): it
// records a lamp path's vertex where the camera bounce accumulates
// brightness, with no emission and no NEE. The JAX package runs these
// steps as XLA ops (pyrite_tpu/tracer.py:1904-2090), so this ports no TPU
// kernel; it keeps the lamp walk off the plain path on the card.
struct LampArgs {
  Sheet sheet;
  Programs progs;
  const float* __restrict__ wl;         // [N, S], hero at column 0
  const float* __restrict__ origin;     // [N, 3] (bounce mode)
  const float* __restrict__ direction;  // [N, 3]
  const uint8_t* __restrict__ alive;    // [N]
  const float* __restrict__ u;  // [N, 6] LAMP_START words (start) or [N, 4] LAMP_BOUNCE words
  // the vertex (tracer.LAMP_VERTEX), and brdf_scatter [N] in bounce mode
  float* __restrict__ o_position;
  float* __restrict__ o_normal;
  float* __restrict__ o_uv;  // [N, 2], written by the kProg instantiations
  int* __restrict__ o_color;
  float* __restrict__ o_probability;
  uint8_t* __restrict__ o_diffuse;
  uint8_t* __restrict__ o_dispersed;
  uint8_t* __restrict__ o_valid;
  float* __restrict__ o_brdf;
  float* __restrict__ o_brdf_scatter;
  // the walk's next state
  float* __restrict__ o_origin;
  float* __restrict__ o_direction;
  uint8_t* __restrict__ o_alive;
  int n, s, n_lamps, start;
  const float* __restrict__ t_de;  // [n_de, N] the bounce march pass's t (<true> only)
};

// A dense scene's primitive rows that a ray test reads (sheet rows 0-10:
// v0 or centre, e1, e2, radius, kind), three float4 a primitive in shared
// memory: every thread of a warp then reads the same 16 bytes at once (a
// broadcast), three loads a primitive where the sheet took eleven, and none
// of them waits on global memory. A dense scene has at most BLOCK
// primitives (kernels_dense.build_pack), so thread j stages primitive j,
// before the kernel's one barrier.
constexpr int PRIM_FLOATS = 12 * BLOCK;

__device__ __forceinline__ void stage_prims(const Sheet& sh, float4* dst) {
  const int j = threadIdx.x;
  if (j < sh.count(M_N_PRIMS)) {
    dst[3 * j] = make_float4(sh.row(0, j), sh.row(1, j), sh.row(2, j), sh.row(10, j));
    dst[3 * j + 1] = make_float4(sh.row(3, j), sh.row(4, j), sh.row(5, j), sh.row(9, j));
    dst[3 * j + 2] = make_float4(sh.row(6, j), sh.row(7, j), sh.row(8, j), 0.0f);
  }
}

// DenseGeo's primitive sweep of a shadow ray over the staged rows, after
// the planes: the same tests on the same floats in the same (sheet) order,
// so every bit is DenseGeo::shadow's.
__device__ __forceinline__ float shadow_staged(const Sheet& sh, const float4* prims, V3 o, V3 d,
                                               float best) {
  const int n_prims = sh.count(M_N_PRIMS);
  for (int j = 0; j < n_prims; ++j) {
    const float4 p0 = prims[3 * j], p1 = prims[3 * j + 1], p2 = prims[3 * j + 2];
    const V3 c = {p0.x, p0.y, p0.z};
    float t, u, v;
    if (p0.w == PRIM_TRIANGLE) {
      if (ray_triangle(o, d, c, V3{p1.x, p1.y, p1.z}, V3{p2.x, p2.y, p2.z}, t, u, v))
        best = fminf(best, t);
    } else if (p0.w == PRIM_SPHERE) {
      if (ray_sphere(o, d, c, p1.w, t)) best = fminf(best, t);
    }
  }
  return best;
}

// A warp's queue of the lanes it has to work on, in lane order: each tile
// of 32 lanes appends its flagged ones (a ballot), and once 32 are queued
// the warp takes them as a batch, one a thread. A ring of 64 slots in
// shared memory holds them (at most 31 wait when a tile appends its 32).
// Every thread of the warp calls append and take, and keeps the same
// counts.
struct WarpRing {
  int* slot;  // [64], the warp's
  int head, tail;  // lanes appended, taken

  __device__ __forceinline__ void append(bool mine, int lane) {
    const int lid = threadIdx.x & 31;
    const unsigned m = __ballot_sync(FULL_WARP, mine);
    if (mine) slot[(head + __popc(m & ((1u << lid) - 1u))) & 63] = lane;
    head += __popc(m);
    __syncwarp();
  }
  __device__ __forceinline__ int size() const { return head - tail; }
  // The next batch: this thread's lane, or -1 past the queue's end.
  __device__ __forceinline__ int take() {
    const int lid = threadIdx.x & 31, n = min(32, head - tail);
    const int lane = lid < n ? slot[(tail + lid) & 63] : -1;
    tail += n;
    __syncwarp();
    return lane;
  }
};
constexpr int RING_INTS = (BLOCK / 32) * 64;

// Tiles of 32 rays one warp of dense_shadow_kernel takes.
constexpr int SHADOW_TILES = 8;

// The word pairs of lane `lane`'s draws at `u` (`per_lane` floats a lane):
// 8-byte loads where `pairs` (the array 8-byte aligned), else words.
__device__ __forceinline__ float2 word_pair(const float* __restrict__ u, size_t i, bool pairs) {
  return pairs ? *reinterpret_cast<const float2*>(u + i) : make_float2(u[i], u[i + 1]);
}

// The emitter of one lamp path (tracer.sample_lamp_ray and lamp_start): a
// uniform lamp pick, a point and a direction on the point, sphere or
// triangle lamp, the emissive component of a shape lamp and its
// probability program, and Bounce.probability = weight / (pick probability
// x material probability); the walk starts DIST_EPSILON off the emitter
// along its normal. A directional lamp starts no path: its vertex is not
// valid (at the origin, weight 1).
template <bool kProg>
__device__ __forceinline__ void lamp_start_lane(const LampArgs& a, const ProgArgs& pa, int lane,
                                                bool pairs) {
  const Sheet sh = a.sheet;
  const size_t w = 6 * (size_t)lane;
  const float2 u01 = word_pair(a.u, w, pairs), u23 = word_pair(a.u, w + 2, pairs),
               u45 = word_pair(a.u, w + 4, pairs);
  V3 pos = {0.f, 0.f, 0.f}, dir = {0.f, 0.f, 0.f}, normal = {0.f, 0.f, 0.f};
  float su = 0.0f, sv = 0.0f;  // kProg: the emitter's uv
  int color = -1, smat = 0;
  float prob = 1.0f;
  bool dispersed = false, is_shape = false, valid = false;
  if (a.n_lamps > 0) {
    const int li = min((int)(u01.x * (float)a.n_lamps), a.n_lamps - 1);
    const int type = sh.iat(M_LAMP_TYPE, li), ref = max(sh.iat(M_LAMP_REF, li), 0);
    valid = type != LAMP_DIRECTIONAL;
    float weight = 1.0f;
    if (type == LAMP_POINT) {
      pos = {sh.at(M_LAMP_VX, li), sh.at(M_LAMP_VY, li), sh.at(M_LAMP_VZ, li)};
      dir = sample_sphere_dir(u01.y, u23.x);
      normal = dir;  // Surface::Color
      weight = 4.0f * PI_F;
    } else if (type == LAMP_SPHERE) {
      const V3 c = {sh.at(M_LSPH_CX, ref), sh.at(M_LSPH_CY, ref), sh.at(M_LSPH_CZ, ref)};
      const float r = sh.at(M_LSPH_R, ref);
      pos = c + sample_sphere_dir(u01.y, u23.x) * r;
      normal = normalize(pos - c);
      if (kProg) {
        float4 q;
        sphere_frame(normal, sh.at(M_LSPH_TSU, ref), sh.at(M_LSPH_TSV, ref), q, su, sv);
      }
      dir = sample_hemisphere(u23.y, u45.x, normal);
      weight = r * r * 4.0f * PI_F;
      is_shape = true;
      smat = sh.iat(M_LSPH_MAT, ref);
    } else if (type == LAMP_TRIANGLE) {
      float tu = u01.y, tv = u23.x;
      if (tu + tv > 1.0f) {
        tu = 1.0f - tu;
        tv = 1.0f - tv;
      }
      const V3 v0 = {sh.at(M_LTRI_V0X, ref), sh.at(M_LTRI_V0Y, ref), sh.at(M_LTRI_V0Z, ref)};
      const V3 e1 = {sh.at(M_LTRI_E1X, ref), sh.at(M_LTRI_E1Y, ref), sh.at(M_LTRI_E1Z, ref)};
      const V3 e2 = {sh.at(M_LTRI_E2X, ref), sh.at(M_LTRI_E2Y, ref), sh.at(M_LTRI_E2Z, ref)};
      pos = v0 + e1 * tu + e2 * tv;
      const float tw = 1.0f - tu - tv;
      const V3 n0 = {sh.at(M_LTRI_N0X, ref), sh.at(M_LTRI_N0Y, ref), sh.at(M_LTRI_N0Z, ref)};
      const V3 n1 = {sh.at(M_LTRI_N1X, ref), sh.at(M_LTRI_N1Y, ref), sh.at(M_LTRI_N1Z, ref)};
      const V3 n2 = {sh.at(M_LTRI_N2X, ref), sh.at(M_LTRI_N2Y, ref), sh.at(M_LTRI_N2Z, ref)};
      normal = normalize(n0 * tw + n1 * tu + n2 * tv);
      if (kProg) {
        su = sh.at(M_LTRI_UV0U, ref) * tw + sh.at(M_LTRI_UV1U, ref) * tu + sh.at(M_LTRI_UV2U, ref) * tv;
        sv = sh.at(M_LTRI_UV0V, ref) * tw + sh.at(M_LTRI_UV1V, ref) * tu + sh.at(M_LTRI_UV2V, ref) * tv;
      }
      dir = sample_hemisphere(u23.y, u45.x, normal);
      const V3 cr = cross(e1, e2);
      weight = 0.5f * sqrtf(fmaxf(dot(cr, cr), 0.0f));
      is_shape = true;
      smat = sh.iat(M_LTRI_MAT, ref);
    }
    float mat_prob = 1.0f;
    color = sh.iat(M_LAMP_COLOR, li);
    if (is_shape) {
      // choose_emissive (materials/mod.rs:56-62)
      const int count = max(sh.iat(M_MAT_EMIS_COUNT, smat), 1);
      const int pick = min((int)(u45.y * (float)count), count - 1);
      const int eidx = sh.iat(M_MAT_EMIS_OFFSET, smat) + pick;
      const int e_comp = sh.iat(M_EMIS_COMP, eidx);
      const int prob_prog = sh.iat(M_COMP_PROB, e_comp);
      mat_prob = (kProg ? eval_prob_code(a.progs, pa, prob_prog, lane, a.n, a.s, {normal, -dir, su, sv})
                        : eval_prob<true>(a.progs, prob_prog, lane, a.n, a.s, normal, -dir)) *
                 sh.at(M_EMIS_SELECTION, eidx);
      dispersed = sh.at(M_COMP_PROB_USES_WL, e_comp) > 0.5f;
      color = sh.iat(M_COMP_COLOR, e_comp);
    }
    prob = weight / ((1.0f / (float)a.n_lamps) * fmaxf(mat_prob, 1e-20f));
  }
  const V3 origin = pos + normal * DIST_EPSILON;
  store3(a.o_position, lane, origin);
  store3(a.o_normal, lane, normal);
  if (kProg) {
    a.o_uv[2 * lane] = su;
    a.o_uv[2 * lane + 1] = sv;
  }
  a.o_color[lane] = color;
  a.o_probability[lane] = prob;
  a.o_diffuse[lane] = false;
  a.o_dispersed[lane] = dispersed;
  a.o_valid[lane] = valid;
  a.o_brdf[lane] = 1.0f;
  store3(a.o_origin, lane, origin);
  store3(a.o_direction, lane, dir);
  a.o_alive[lane] = valid;
}

// One lamp bounce per lane (tracer.lamp_bounce_step): the closest hit
// (planes, the geometry policy, the DE shapes' t from the march pass), the
// surface (hit_surface, and de_normals_shared on DE hits), the component
// pick, its probability program and the scatter, the same device code as
// bounce_lane's. A reflection records a valid vertex and goes on; an
// emissive hit or a miss ends the path and records nothing (its vertex is
// written, not valid; a lane that is not alive writes its origin as
// position, normal 0, colour -1, probability 0, every flag false, brdf and
// brdf_scatter 1, and its ray unchanged with alive false). Every thread
// reaches the traversal and the DE probes (whole-warp operations), as in
// bounce_lane.
//
// What bounds it on an H100: a bounce lane reads its ray and flag (25
// bytes) and writes its vertex and next state (68; the kProg
// instantiations 8 more of uv), and an alive lane reads its four draws and
// hero wavelength (20) and costs the closest-hit sweep (~30 flops a
// primitive), the surface and the scatter (~150), and on a DE hit the six
// estimator probes of its normal: ~100 bytes against ~500 flops at
// cornell_class's 13 primitives. At the renderers' wavefronts (131,072 to
// 262,144 lanes: two waves of blocks or fewer) a launch is held by the
// longest path through a block more than by either, and every barrier or
// dependent load on that path shows.
//
// So it stays one thread a lane. Measured slower at the lamp depths of
// cornell_class and flagship_bdpt (`chip_smoke.py --bdpt` and
// `--bdpt-probes`, PERF.md): the block's alive lanes compacted to its
// first threads between barriers, with rays and outputs staged in shared
// memory (block_copy); a warp queueing the alive lanes of 2 or 4 tiles and
// working on them 32 at a time (WarpRing, as dense_shadow_kernel does); the
// dense primitives' rows staged in shared memory behind a barrier; dead
// lanes written ahead of the warp's alive ones. Lamp paths thin out (a miss
// or an emissive hit ends one), but a batch of 32 alive lanes only saves
// issue slots, and this kernel waits on latency. The wide traversal sweeps
// each leaf with the whole warp; compacted, a warp walked the union of 32
// lanes' leaves where four warps had walked a quarter each (1.6x slower on
// terrain_405_bdpt at 11 % alive). What it has of that work: the draws
// read as a float4 (bounce) or three float2 (start) where the array is
// aligned, the first DE shape's t read before the sweep, and the simple
// dense_lamp_kernel's request for 8 resident blocks (below).
template <class Geo, bool kDE, bool kProg>
__device__ __forceinline__ void lamp_lane(const LampArgs& a, const Geo& geo, const ProgArgs& pa) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const bool in_range = lane < a.n;
  if (a.start) {  // the same for the whole grid
    if (in_range) lamp_start_lane<kProg>(a, pa, lane, (reinterpret_cast<uintptr_t>(a.u) & 7) == 0);
    return;
  }
  extern __shared__ __align__(16) float lamp_smem[];
  const Sheet sh = a.sheet;
  const V3 o = in_range ? load3(a.origin, lane) : V3{0.f, 0.f, 0.f};
  const V3 d = in_range ? load3(a.direction, lane) : V3{0.f, 0.f, 0.f};
  const bool alive = in_range && a.alive[lane];
  const int n_de = kDE ? sh.count(M_N_DE) : 0;
  const float de0 = alive && n_de > 0 ? a.t_de[lane] : INFINITY;
  Hit h = {INFINITY, KIND_NONE, 0, 0.0f, 0.0f};
  if (Geo::kWholeWarp) {
    h = geo.closest(sh, o, d, alive);
  } else if (alive) {
    h = geo.closest(sh, o, d, true);
  }
  if (kDE && alive)  // apply_de_closest, its first t read above
    for (int j = 0; j < n_de; ++j) {
      const float tj = j == 0 ? de0 : a.t_de[(size_t)j * a.n + lane];
      if (tj > DIST_EPSILON && tj < h.t) h = {tj, KIND_DE, j, h.u, h.v};
    }
  const bool found = alive && h.kind != KIND_NONE;
  V3 normal = {0.f, 0.f, 0.f};
  int mat = 0;
  if (kDE) de_normals_shared(sh, lamp_smem + (kProg ? pa.own_off : 0) + (threadIdx.x >> 5) * DE_SLOT_FLOATS,
                             found && h.kind == KIND_DE, h, o, d, normal, mat);
  if (!in_range) return;
  const V3 pos = o + d * h.t;
  V3 next_o = o, next_d = d;
  int color = -1;
  float prob = 0.0f, brdf = 1.0f, brdf_scatter = 1.0f;
  bool diffuse = false, dispersed = false, valid = false;
  ProgIn in = {d, d, 0.0f, 0.0f};  // kProg: what the programs read
  if (found) {
    hit_surface<Geo, kDE>(sh, geo, h, pos, normal, mat);
    if (kProg) {
      float4 q;
      hit_frame(sh, geo, pa, h, pos, normal, q, in.u, in.v);
      in.normal = normal;
      normal = map_normal(sh, a.progs, pa, mat, lane, a.n, a.s, q, in);
      in.normal = normal;
    }
    const float* uw = a.u + 4 * (size_t)lane;
    const float4 u = (reinterpret_cast<uintptr_t>(a.u) & 15) == 0
                         ? *reinterpret_cast<const float4*>(uw)
                         : make_float4(uw[0], uw[1], uw[2], uw[3]);
    const int comp = pick_component(sh, mat, u.x);
    const int prob_prog = sh.iat(M_COMP_PROB, comp);
    const float comp_probability =
        (kProg ? eval_prob_code(a.progs, pa, prob_prog, lane, a.n, a.s, in)
               : eval_prob<true>(a.progs, prob_prog, lane, a.n, a.s, normal, d)) *
        sh.at(M_COMP_SELECTION, comp);
    const int bsdf = sh.iat(M_COMP_BSDF, comp);
    color = sh.iat(M_COMP_COLOR, comp);
    if (bsdf != BSDF_EMISSIVE) {
      const V3 flip = dot(d, normal) < 0.0f ? normal : -normal;
      V3 out;
      float sc_probability;
      bool sc_dispersed;
      SCATTER_BSDF(sh, bsdf, comp, d, normal, flip, a.wl[(size_t)lane * a.s], u.y, u.z, u.w, out,
                   sc_probability, sc_dispersed);
      diffuse = bsdf == BSDF_DIFFUSE;
      dispersed = sc_dispersed || sh.at(M_COMP_PROB_USES_WL, comp) > 0.5f;
      prob = sc_probability * comp_probability;
      brdf = diffuse ? 2.0f * fabsf(dot(normal, d)) : 1.0f;
      brdf_scatter = diffuse ? 2.0f * fabsf(dot(normal, out)) : 1.0f;
      valid = true;
      next_o = pos;
      next_d = out;
    }
  }
  store3(a.o_position, lane, found ? pos : o);
  store3(a.o_normal, lane, normal);
  if (kProg) {
    a.o_uv[2 * lane] = in.u;
    a.o_uv[2 * lane + 1] = in.v;
  }
  a.o_color[lane] = color;
  a.o_probability[lane] = prob;
  a.o_diffuse[lane] = diffuse;
  a.o_dispersed[lane] = dispersed;
  a.o_valid[lane] = valid;
  a.o_brdf[lane] = brdf;
  a.o_brdf_scatter[lane] = brdf_scatter;
  store3(a.o_origin, lane, next_o);
  store3(a.o_direction, lane, next_d);
  a.o_alive[lane] = valid;
}

// The any-hit query of an arbitrary ray batch over a dense scene
// (tracer.intersect_shadow, the bidirectional renderer's connection and
// splat batches): the planes, then the sheet's primitives (DenseGeo's
// shadow sweep, here over rows staged in shared memory), seeded at
// max_dist, then the DE shapes' t from a march pass over the same rays
// (pyrite_de_march_query_shadow), which count at any t. A ray that is not
// `live` is not traced and returns max_dist. Unoccluded rays return
// max_dist.
//
// What bounds it on an H100: a live ray reads 29 bytes and writes 4 (and
// reads its DE shapes' t), a ray that is not live reads 5 and writes 4,
// and the sweep costs ~30 flops a primitive a live ray: at cornell_class's
// 12 triangles and a sphere, ~660 flops against 33 bytes, so the
// operations bound it where half the rays are live.
//
// The design (each point against one thread a ray over the whole batch):
// - a warp takes SHADOW_TILES tiles of 32 rays: a ray that is not live
//   writes its max_dist at once, and the live ones queue in ray order
//   (WarpRing) and are swept 32 at a time, one a thread. A connection batch
//   is [N, K], and a camera lane that is not diffuse or a lamp slot that is
//   not valid kills its rays, so the live ones were spread through the
//   warps, and a warp with one live ray swept as long as a full one; now a
//   batch holds 32 live rays but the last of a warp's;
// - the queue is the warp's own: the block's one barrier stages the
//   primitives' rows in shared memory (shadow_staged), and a warp then
//   runs on its own. A first version compacted the block's live rays
//   between barriers (two, and a block without a live ray left after
//   one), which cost more than it saved where few rays are live
//   (flagship_bdpt: 1 to 5 %, `chip_smoke.py --bdpt`);
// - the first DE shape's t is read before the sweep, so that its load
//   overlaps it.
// The planes and primitives still fold with fminf in sheet order and the
// DE shapes' t after them, so every t is the plain version's bit for bit.
struct ShadowArgs {
  Sheet sheet;
  const float* __restrict__ origin;       // [M, 3]
  const float* __restrict__ direction;    // [M, 3]
  const float* __restrict__ max_dist;     // [M]
  const float* __restrict__ block_below;  // [M], unused by a dense sweep
  const uint8_t* __restrict__ live;       // [M]
  float* __restrict__ t;                  // [M]
  int m;
  const float* __restrict__ t_de;  // [n_de, M] (<true> only)
};

// One live ray of a batch (`ray` < 0: none, the thread idles).
template <bool kDE>
__device__ __forceinline__ void shadow_ray(const ShadowArgs& a, const float4* prims, int ray) {
  if (ray < 0) return;
  const Sheet sh = a.sheet;
  const int n_de = kDE ? sh.count(M_N_DE) : 0;
  const float de0 = n_de > 0 ? a.t_de[ray] : 0.0f;
  const V3 o = load3(a.origin, ray), d = load3(a.direction, ray);
  float best = shadow_staged(sh, prims, o, d, plane_shadow(sh, o, d, a.max_dist[ray]));
  if (kDE)  // apply_de_shadow, its first t read above
    for (int j = 0; j < n_de; ++j) best = nan_min(best, j == 0 ? de0 : a.t_de[(size_t)j * a.m + ray]);
  a.t[ray] = best;
}

template <bool kDE>
__global__ void __launch_bounds__(BLOCK) dense_shadow_kernel(const ShadowArgs a) {
  __shared__ __align__(16) float4 prims[3 * BLOCK];
  __shared__ int rings[RING_INTS];
  const int lid = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int first = (blockIdx.x * (BLOCK / 32) + w) * 32 * SHADOW_TILES;
  stage_prims(a.sheet, prims);
  unsigned live = 0;  // bit i: this thread's ray of tile i
#pragma unroll
  for (int i = 0; i < SHADOW_TILES; ++i) {
    const int ray = first + 32 * i + lid;
    const bool on = ray < a.m && a.live[ray];
    live |= (unsigned)on << i;
    if (ray < a.m && !on) a.t[ray] = a.max_dist[ray];
  }
  __syncthreads();  // the staged rows
  WarpRing ring = {rings + 64 * w, 0, 0};
#pragma unroll 1
  for (int i = 0; i <= SHADOW_TILES; ++i) {  // a batch once 32 are queued, and the rest at the end
    if (i < SHADOW_TILES) ring.append((live >> i) & 1u, first + 32 * i + lid);
    if (ring.size() >= 32 || (i == SHADOW_TILES && ring.size() > 0))
      shadow_ray<kDE>(a, prims, ring.take());
  }
}

// Each kernel's kProg instantiation (kProg = true) runs a scene whose
// programs need the program form; <..., false> reads none of ProgArgs and
// is the code it was. The bounce and NEE kernels' kGate instantiations
// (bounce_lane) run a simple scene with directional lamps, a baked table or
// more than MAX_ROW spectral columns; every kProg one is also kGate. Past
// MAX_ROW columns a gate scene runs the kStream ones (bounce_rows,
// nee_rows); at MAX_ROW or fewer the kGate code stages its rows as before.
template <bool kDE, bool kRecord, bool kProg, bool kGate, bool kStream, bool kWhole = false>
__global__ void __launch_bounds__(BLOCK)
    dense_bounce_kernel(const BounceArgs a, const Record rec, const ProgArgs pa) {
  bounce_lane<DenseGeo, kDE, kRecord, kProg, kGate, kStream, kWhole>(a, DenseGeo{}, rec, pa);
}

// A on a dense scene with DE shapes asks for 8 resident blocks (at most 64
// registers): on cornell_class 0.80x the unbounded kernel at camera bounce
// 1 and later, 1.07x at bounce 0 (PERF.md §6 row A); without DE shapes it
// lost at the bound. An explicit specialization, so that the others keep
// their launch bounds.
template <>
__global__ void __launch_bounds__(BLOCK, 8)
    dense_bounce_kernel<true, true, false, true, true>(const BounceArgs a, const Record rec,
                                                       const ProgArgs pa) {
  bounce_lane<DenseGeo, true, true, false, true, true, false>(a, DenseGeo{}, rec, pa);
}

template <bool kDE, bool kProg, bool kGate, bool kStream>
__global__ void __launch_bounds__(BLOCK) dense_nee_kernel(const NeeArgs a, const ProgArgs pa) {
  nee_lane<DenseGeo, kDE, kProg, kGate, kStream>(a, DenseGeo{}, pa);
}

// The kProg instantiations ask for 6 resident blocks (at most 80 registers,
// some spills): 13 % faster than at the 96 registers the compiler picks
// alone (5 blocks), where the bounce kernels lost at such caps
// (`chip_smoke.py --prog`, variants nee_uncapped and min_blocks_<b>;
// PERF.md). Explicit specializations, so that the simple instantiations
// keep their launch bounds (a second bound there changes their registers).
template <>
__global__ void __launch_bounds__(BLOCK, 6)
    dense_nee_kernel<false, true, true, false>(const NeeArgs a, const ProgArgs pa) {
  nee_lane<DenseGeo, false, true, true, false>(a, DenseGeo{}, pa);
}
template <>
__global__ void __launch_bounds__(BLOCK, 6)
    dense_nee_kernel<true, true, true, false>(const NeeArgs a, const ProgArgs pa) {
  nee_lane<DenseGeo, true, true, true, false>(a, DenseGeo{}, pa);
}

template <bool kDE, bool kRecord, bool kProg, bool kGate, bool kStream, bool kWhole = false>
__global__ void __launch_bounds__(BLOCK)
    wide_bounce_kernel(const BounceArgs a, const WideGeo geo, const Record rec, const ProgArgs pa) {
  bounce_lane<WideGeo, kDE, kRecord, kProg, kGate, kStream, kWhole>(a, geo, rec, pa);
}

template <bool kDE, bool kProg, bool kGate, bool kStream>
__global__ void __launch_bounds__(BLOCK)
    wide_nee_kernel(const NeeArgs a, const WideGeo geo, const ProgArgs pa) {
  nee_lane<WideGeo, kDE, kProg, kGate, kStream>(a, geo, pa);
}

template <bool kDE, bool kProg>
__global__ void __launch_bounds__(BLOCK) dense_lamp_kernel(const LampArgs a, const ProgArgs pa) {
  lamp_lane<DenseGeo, kDE, kProg>(a, DenseGeo{}, pa);
}

// The simple dense_lamp_kernel instantiations ask for 8 resident blocks
// (at most 64 registers: <true> spills ~30 B), ~5 % faster on
// cornell_class than at the compiler's 72 registers (`chip_smoke.py
// --bdpt-probes`, variant lamp_bounds); explicit specializations, so that
// the kProg ones keep their bound (at 64 registers they spill ~1 KB).
template <>
__global__ void __launch_bounds__(BLOCK, 8) dense_lamp_kernel<false, false>(const LampArgs a, const ProgArgs pa) {
  lamp_lane<DenseGeo, false, false>(a, DenseGeo{}, pa);
}
template <>
__global__ void __launch_bounds__(BLOCK, 8) dense_lamp_kernel<true, false>(const LampArgs a, const ProgArgs pa) {
  lamp_lane<DenseGeo, true, false>(a, DenseGeo{}, pa);
}

template <bool kDE, bool kProg>
__global__ void __launch_bounds__(BLOCK)
    wide_lamp_kernel(const LampArgs a, const WideGeo geo, const ProgArgs pa) {
  lamp_lane<WideGeo, kDE, kProg>(a, geo, pa);
}

// The lamp vertices' colors of the bidirectional renderer on a scene whose
// color programs read the ray (kernels_dense.vertex_colors, the plain
// version tracer.eval_color_bank): each vertex of the [N, K] path arrays
// gets its color program at each of its lane's S wavelengths from its uv,
// normal and incident direction; a program that reads no ray is read from
// the launch's values (or the baked table); 0 where the vertex is not valid
// or the program out of range. The JAX package evaluates these in XLA after
// the walk (pyrite_tpu/renderers/bidirectional.py:73-121), so this ports no
// TPU kernel. What bounds it: 4 S bytes written a vertex and, for a
// textured program, 16 taps a texture node (its lane code, once a vertex).
//
// The design (PERF.md §6 row D). Valid slots are a prefix of each lamp
// path (34 % of them valid on textures_bdpt), so one thread a slot left most
// of a warp idle in the interpreter. Here a persistent grid (as many blocks
// as are resident) gives each warp every (warps)-th tile of 32 slots: per
// tile it queues the slots whose program runs code in its ring (WarpRing,
// as dense_shadow_kernel does) and runs them 32 at a time, one a thread,
// each writing its row straight into the output, and writes the other
// slots' words (the launch's values, the baked table or 0) consecutive
// words on consecutive lanes. The ring runs across all of the warp's tiles,
// so its batches fill whatever the valid share. Each colour takes the
// interpreter's ops in their order, as before. A block that staged its
// [BLOCK x tiles, S] rows in shared memory and wrote them out with
// block_copy measured slower at every tile count (1.13-1.65x this design on
// textures_bdpt), as it held 5 tiles of 32 slots a warp at S = 6 and so
// made only 1.3 waves of blocks. __launch_bounds__(BLOCK, 8): 64
// registers, 8 resident blocks.
struct ColorArgs {
  Programs progs;
  const int* __restrict__ color_prog;  // [N, K]
  const uint8_t* __restrict__ valid;   // [N, K]
  const float* __restrict__ normal;    // [N, K, 3]
  const float* __restrict__ incident;  // [N, K, 3]
  const float* __restrict__ uv;        // [N, K, 2]
  float* __restrict__ out;             // [N, K, S]
  int n, slots, s;
};

constexpr int SLOT_CODE = -2;  // a slot whose program runs code; -1: its colour is 0

// The colour row of slot `m` (-1: none) by its program's code, straight
// into its row of the output.
__device__ __forceinline__ void color_row(const ColorArgs& a, const ProgArgs& pa, int m) {
  if (m < 0) return;
  const int g = pa.n_prob + a.color_prog[m];  // color_code's program
  const ProgIn in = {load3(a.normal, m), load3(a.incident, m), a.uv[2 * m], a.uv[2 * m + 1]};
  eval_program(a.progs, pa, g, m / a.slots, a.n, a.s, a.s, in, a.out + (size_t)m * a.s);
}

__global__ void __launch_bounds__(BLOCK, 8) program_colors_kernel(const ColorArgs a, const ProgArgs pa) {
  extern __shared__ __align__(16) float colors_smem[];
  const Programs& pr = a.progs;
  const int s = a.s, m_total = a.n * a.slots, tiles = (m_total + 31) / 32;
  const int lid = threadIdx.x & 31, w = threadIdx.x >> 5, warps = gridDim.x * (BLOCK / 32);
  WarpRing ring = {reinterpret_cast<int*>(colors_smem + pa.own_off) + 64 * w, 0, 0};
  const float inv_s = 1.0f / (float)s;
#pragma unroll 1
  for (int tile = blockIdx.x * (BLOCK / 32) + w;; tile += warps) {
    const bool more = tile < tiles;  // the same on every lane of the warp
    if (more) {
      const int base = 32 * tile, m = base + lid;
      int kind = -1;
      bool code = false;
      if (m < m_total) {
        const int prog = a.color_prog[m];
        const bool ok = a.valid[m] && prog >= 0 && prog < pr.n_color;
        int g;
        code = ok && color_code(pr, pa, prog, g);
        kind = code ? SLOT_CODE : ok ? prog : -1;
      }
      ring.append(code, m);
      // the tile's words of the slots that run no code, word e on lane e % 32
      const int words = min(32, m_total - base) * s;
      for (int e0 = 0; e0 < words; e0 += 32) {
        const int e = e0 + lid, l = row_owner(e, inv_s);
        const int own = __shfl_sync(FULL_WARP, kind, l);
        if (e < words && own != SLOT_CODE) {
          const int lane = (base + l) / a.slots, k = e - l * s;
          a.out[(size_t)base * s + e] =
              own < 0     ? 0.0f
              : pr.ctable ? table_value(pr, pr.ctable, own, pr.wl[(size_t)lane * s + k])
                          : pr.cvals[((size_t)own * a.n + lane) * s + k];
        }
      }
    }
    if (ring.size() >= 32 || (!more && ring.size() > 0)) color_row(a, pa, ring.take());
    if (!more) break;
  }
}

// The march passes of a scene with DE shapes: march_de_kernel
// (csrc/march_de.cuh) over each (DE shape, ray) of a bounce, shape-major, as
// tracer.intersect_de marches them; t = inf for a ray that misses the shape
// or that the kernels do not trace. The <true> bounce and NEE kernels used
// to march in-thread, where a warp waited for its longest ray; the pass
// refills a lane as its ray ends.

// The bounce rays: each alive lane's ray, uncapped (the bounce kernel's
// closest hit). Writes t_de [n_de, N].
struct BounceRays {
  static constexpr int kBlocksPerSm = 4;  // lets the longest rays advance (launch_march)
  Sheet sheet;
  const float* __restrict__ origin;
  const float* __restrict__ direction;
  const uint8_t* __restrict__ alive;
  float* __restrict__ t_de;

  __device__ __forceinline__ DeShape shape(int j) const { return load_de(sheet, j); }

  __device__ __forceinline__ March begin(const DeShape& s, int lane) const {
    if (!alive[lane]) return no_march();
    return march_toward(s, load3(origin, lane), load3(direction, lane), INFINITY);
  }

  __device__ __forceinline__ void end(long long i, const March& m) const { t_de[i] = march_t(m); }
};

// The shadow rays: for each (light sample, lane) with NEE, the ray toward
// the lamp sample that nee_lane casts, capped at the lamp distance. The ray
// is made again here from the NEE kernel's own draws by the same device
// functions (sample_lamp and the cast test of nee_lane), so it is the same
// ray bit for bit; computing it twice costs less than storing ls x N rays
// (24 bytes each) between the two launches. Writes t_de_shadow [n_de, ls, N].
struct ShadowRays {
  static constexpr int kBlocksPerSm = 0;  // full occupancy (launch_march)
  Sheet sheet;
  const float* __restrict__ position;  // [N, 3] the bounce's new origin
  const float* __restrict__ flip;      // [N, 3]
  const uint8_t* __restrict__ nee;     // [N]
  const int* __restrict__ lamp_idx;    // [N]
  const float* __restrict__ u_nee;     // [ls, N, 4]
  float* __restrict__ t_de;
  int n;

  __device__ __forceinline__ DeShape shape(int j) const { return load_de(sheet, j); }

  __device__ __forceinline__ March begin(const DeShape& s, int ray) const {
    const int j = ray / n, lane = ray - j * n;  // light sample j
    if (!nee[lane]) return no_march();
    const V3 p = load3(position, lane);
    const float* u = u_nee + ((size_t)j * n + lane) * 4;
    const LampSample ls = sample_lamp(sheet, lamp_idx[lane], p, u[0], u[1]);
    if (!(fmaxf(dot(load3(flip, lane), ls.dir), 0.0f) > 0.0f)) return no_march();
    return march_toward(s, p, ls.dir, sqrtf(ls.sq_distance));
  }

  __device__ __forceinline__ void end(long long i, const March& m) const { t_de[i] = march_t(m); }
};

// Any batch of shadow rays (dense_shadow_kernel's, or a mesh scene's
// wide_shadow_kernel's): each live ray toward each DE shape, capped at its
// max_dist. Writes t_de [n_de, M].
struct QueryShadowRays {
  static constexpr int kBlocksPerSm = 0;  // as the NEE shadow rays
  Sheet sheet;
  const float* __restrict__ origin;
  const float* __restrict__ direction;
  const float* __restrict__ max_dist;
  const uint8_t* __restrict__ live;
  float* __restrict__ t_de;

  __device__ __forceinline__ DeShape shape(int j) const { return load_de(sheet, j); }

  __device__ __forceinline__ March begin(const DeShape& s, int ray) const {
    if (!live[ray]) return no_march();
    return march_toward(s, load3(origin, ray), load3(direction, ray), max_dist[ray]);
  }

  __device__ __forceinline__ void end(long long i, const March& m) const { t_de[i] = march_t(m); }
};

// The dynamic shared memory a block gets without opting in (48 KiB), less
// the static arrays of the kernels that take any (at most the NEE kernels'
// 528 bytes; dense_shadow_kernel, with 7 KiB of its own, takes none).
constexpr size_t SMEM_DEFAULT = 47 * 1024;

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that
// passes SMEM_DEFAULT (a bounce kernel past S = 20, a kProg one past S = 12),
// and makes no call below it: a call before every launch is not free.
void opt_in_smem(const void* kernel, size_t smem) {
  if (smem > SMEM_DEFAULT)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One launch over `n` lanes, `per_block` a block, of a kernel's <true>
// instantiation where the scene has DE shapes and its <false> one
// elsewhere, with `smem` bytes of dynamic shared memory.
template <class K, class... Args>
void launch_blocks(K with_de, K without_de, int n, int per_block, int n_de, size_t smem,
                   void* stream, const Args&... args) {
  if (n <= 0) return;
  const dim3 grid((n + per_block - 1) / per_block);
  const K kernel = n_de > 0 ? with_de : without_de;
  opt_in_smem((const void*)kernel, smem);
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(args...);
}

// launch_blocks of one lane a thread
template <class K, class... Args>
void launch_lanes(K with_de, K without_de, int n, int n_de, size_t smem, void* stream,
                  const Args&... args) {
  launch_blocks(with_de, without_de, n, BLOCK, n_de, smem, stream, args...);
}

// dynamic shared memory of a lamp kernel block: each warp's DE probe slots
__host__ __device__ __forceinline__ size_t lamp_smem_bytes(bool de) {
  return de ? sizeof(float) * (BLOCK / 32) * DE_SLOT_FLOATS : 0;
}

}  // namespace

extern "C" {

// Plain C launchers for ctypes: pointers are device addresses, `stream` is
// the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 on success); nothing is allocated or synchronised here.

// What every shading kernel takes first: the sheet, the program code and
// the launch's values, then the baked program tables (null where the scene
// has none), the lanes' wavelengths and the tables' grid (Programs).
#define SCENE_PARAMS                                                                           \
  const float *sheet, const int *meta, const int *code_op, const float *code_val,               \
      const int *code_off, const float *cvals, const float *pvals, const float *ctable,         \
      const float *ptable, const float *wl, int grid, float bank_lo, float bank_scale
#define PROGRAMS(N_COLOR) \
  {code_op, code_val, code_off, cvals, pvals, N_COLOR, ctable, ptable, wl, grid, bank_lo, bank_scale}
#define BOUNCE_PARAMS                                                                          \
  SCENE_PARAMS, const float *sky, const float *origin, const float *direction,                   \
      const float *brightness, const float *reflectance, const uint8_t *alive,                  \
      const uint8_t *aux_alive, const uint8_t *sample_light, const int *light_events,           \
      const float *u_comp, const float *u_scatter, float *o_origin, float *o_direction,         \
      float *o_brightness, float *o_reflectance, uint8_t *o_alive, uint8_t *o_aux_alive,        \
      uint8_t *o_sample_light, int *o_light_events, float *o_flip, float *o_refl_nee,           \
      uint8_t *o_nee, int n, int s, int light_samples, int n_color, int n_de, const float *t_de
#define BOUNCE_ARGS                                                                            \
  BounceArgs a = {{sheet, meta},                                                               \
                  PROGRAMS(n_color),                                                           \
                  sky, wl, origin, direction, brightness, reflectance, alive, aux_alive,       \
                  sample_light, light_events, u_comp, u_scatter, o_origin, o_direction,        \
                  o_brightness, o_reflectance, o_alive, o_aux_alive, o_sample_light,           \
                  o_light_events, o_flip, o_refl_nee, o_nee, n, s, light_samples, t_de}
#define NEE_PARAMS                                                                             \
  SCENE_PARAMS, const float *position, const float *flip, const uint8_t *nee,                    \
      const uint8_t *aux_alive, const float *refl_nee, const int *lamp_idx, const float *u_nee, \
      const float *u_emis, float *brightness, int n, int s, int light_samples, int n_color,     \
      float nee_prob, int n_de, const float *t_de_shadow
#define NEE_ARGS                                                                               \
  NeeArgs a = {{sheet, meta},                                                                  \
               PROGRAMS(n_color),                                                              \
               position, flip, nee, aux_alive, refl_nee, lamp_idx, u_nee, u_emis, brightness,  \
               n, s, light_samples, nee_prob, t_de_shadow}
// the mesh scene's tables, after the shared arguments
#define WIDE_PARAMS                                                                            \
  const float *rows, const float *geo, const float *tri_n, const int *tri_mat,                  \
      const float *sph_center, const int *sph_mat, int leaf
#define WIDE_GEO const WideGeo g = {{rows, geo, leaf}, tri_n, tri_mat, sph_center, sph_mat}
// what the kProg instantiations read (ProgArgs), the depth of their program
// stack, and the scene's `form`, which picks the instantiation
// (kernels_dense.build_pack): FORM_SIMPLE, FORM_PROG (kProg) or FORM_GATE
// (the simple code with the gate's: kGate)
enum { FORM_SIMPLE = 0, FORM_PROG = 1, FORM_GATE = 2 };
#define PROG_PARAMS                                                                            \
  const int *p_arg, const float *p_vecs, const float *p_leaves, const float *p_tex,             \
      const int *p_tex_info, const float *p_tri_q, const float *p_tri_uv,                       \
      const float *p_sph_texscale, const float *p_pla_quat, const float *p_pla_texscale,        \
      int p_n_prob, int p_n_normal, int p_stack, int form
// ProgArgs; in the kProg instantiations the program stack of p_stack
// float4 values a thread starts the dynamic shared memory, the kernel's own
// arrays after it
#define STACK_BYTES (form == FORM_PROG ? (size_t)p_stack * BLOCK * sizeof(float4) : 0)
#define PROG_ARGS                                                                              \
  const ProgArgs pa = {p_arg,   p_vecs,         p_leaves,     p_tex,          p_tex_info,         \
                       p_tri_q, p_tri_uv,       p_sph_texscale, p_pla_quat,   p_pla_texscale,     \
                       p_n_prob, p_n_normal, (int)(STACK_BYTES / sizeof(float))}
// a kernel's dynamic shared memory: the program stack and its own OWN bytes
#define WITH_STACK(OWN) ((OWN) + STACK_BYTES)
// a kernel's instantiation for the scene: kDE from n_de (launch_lanes), kProg
// from `form`; the bounce and NEE kernels' kGate too, and kStream where a
// gate or kProg scene has more than MAX_ROW spectral columns (PICK_GATE,
// WIDE; the kProg ones make their own rows in chunks)
#define PICK(K, ...) (form == FORM_PROG ? &K<__VA_ARGS__, true> : &K<__VA_ARGS__, false>)
#define WIDE (s > MAX_ROW)
#define STREAM (form == FORM_GATE && WIDE)
#define PICK_GATE(K, ...)                                                                       \
  (form == FORM_PROG   ? (WIDE ? &K<__VA_ARGS__, true, true, true> : &K<__VA_ARGS__, true, true, false>) \
   : STREAM            ? &K<__VA_ARGS__, false, true, true>                                     \
   : form == FORM_GATE ? &K<__VA_ARGS__, false, true, false>                                    \
                       : &K<__VA_ARGS__, false, false, false>)

// the camera vertex a kRecord bounce writes (Record)
#define RECORD_PARAMS                                                                          \
  float *r_position, float *r_normal, float *r_brdf, uint8_t *r_diffuse, uint8_t *r_dispersed,  \
      uint8_t *r_recorded, uint8_t *r_miss, float *r_color_prob, int *r_color_prog,            \
      float *r_path_prob, uint8_t *r_reflected
#define RECORD                                                                                 \
  const Record rec = {r_position, r_normal,   r_brdf,       r_diffuse,   r_dispersed, r_recorded, \
                      r_miss,     r_color_prob, r_color_prog, r_path_prob, r_reflected}

// the floats of a kProg block's own colour rows a lane: the whole row at
// S <= MAX_ROW, a chunk's slot past it (STRIDE)
#define OWN_FLOATS(STRIDE) (WIDE ? (STRIDE) : s)
// a NEE kernel block's own dynamic shared memory: the kProg instantiations'
// colour rows, [BLOCK, OWN_FLOATS] floats
#define NEE_SMEM (form == FORM_PROG ? (size_t)BLOCK * OWN_FLOATS(OWN_STRIDE) * sizeof(float) : 0)
// a bounce kernel block's own dynamic shared memory: the staged rows
// (bounce_smem_bytes) or, in the streamed forms, stream_smem_bytes (the
// kProg one with its chunks' slots)
#define BOUNCE_SMEM                                                                            \
  (form == FORM_PROG && WIDE ? stream_smem_bytes(n_de > 0, OWN_STRIDE)                        \
   : STREAM                  ? stream_smem_bytes(n_de > 0)                                    \
                             : bounce_smem_bytes(s, n_de > 0))
// the kRecord launchers' instantiation: a streamed one at any S, the kProg
// form's (with its own colour rows, whole at S <= MAX_ROW, kWhole) on a
// kProg scene, else the gate form's (which a simple scene runs as it is: it
// reads no gate table there)
#define PICK_RECORD(K, DE)                                                                     \
  (form != FORM_PROG ? &K<DE, true, false, true, true>                                         \
   : WIDE            ? &K<DE, true, true, true, true>                                          \
                     : &K<DE, true, true, true, true, true>)
#define RECORD_SMEM stream_smem_bytes(n_de > 0, form == FORM_PROG ? OWN_FLOATS(RECORD_STRIDE) : 0)

int pyrite_dense_bounce(BOUNCE_PARAMS, PROG_PARAMS, void* stream) {
  BOUNCE_ARGS;
  const size_t own = BOUNCE_SMEM;
  PROG_ARGS;
  launch_lanes(PICK_GATE(dense_bounce_kernel, true, false), PICK_GATE(dense_bounce_kernel, false, false), n,
               n_de, WITH_STACK(own), stream, a, Record{}, pa);
  return (int)cudaGetLastError();
}

int pyrite_dense_nee(NEE_PARAMS, PROG_PARAMS, void* stream) {
  NEE_ARGS;
  PROG_ARGS;
  launch_lanes(PICK_GATE(dense_nee_kernel, true), PICK_GATE(dense_nee_kernel, false), n, n_de,
               WITH_STACK(NEE_SMEM), stream, a, pa);
  return (int)cudaGetLastError();
}

int pyrite_wide_bounce(BOUNCE_PARAMS, WIDE_PARAMS, PROG_PARAMS, void* stream) {
  BOUNCE_ARGS;
  WIDE_GEO;
  const size_t own = BOUNCE_SMEM;
  PROG_ARGS;
  launch_lanes(PICK_GATE(wide_bounce_kernel, true, false), PICK_GATE(wide_bounce_kernel, false, false), n,
               n_de, WITH_STACK(own), stream, a, g, Record{}, pa);
  return (int)cudaGetLastError();
}

int pyrite_wide_nee(NEE_PARAMS, WIDE_PARAMS, PROG_PARAMS, void* stream) {
  NEE_ARGS;
  WIDE_GEO;
  PROG_ARGS;
  launch_lanes(PICK_GATE(wide_nee_kernel, true), PICK_GATE(wide_nee_kernel, false), n, n_de,
               WITH_STACK(NEE_SMEM), stream, a, g, pa);
  return (int)cudaGetLastError();
}

// The bounce kernels' kRecord instantiations: the bounce, and the camera
// vertex into the RECORD_PARAMS arrays.
int pyrite_dense_bounce_record(BOUNCE_PARAMS, RECORD_PARAMS, PROG_PARAMS, void* stream) {
  BOUNCE_ARGS;
  RECORD;
  const size_t own = RECORD_SMEM;
  PROG_ARGS;
  launch_lanes(PICK_RECORD(dense_bounce_kernel, true), PICK_RECORD(dense_bounce_kernel, false), n,
               n_de, WITH_STACK(own), stream, a, rec, pa);
  return (int)cudaGetLastError();
}

int pyrite_wide_bounce_record(BOUNCE_PARAMS, WIDE_PARAMS, RECORD_PARAMS, PROG_PARAMS,
                              void* stream) {
  BOUNCE_ARGS;
  WIDE_GEO;
  RECORD;
  const size_t own = RECORD_SMEM;
  PROG_ARGS;
  launch_lanes(PICK_RECORD(wide_bounce_kernel, true), PICK_RECORD(wide_bounce_kernel, false), n,
               n_de, WITH_STACK(own), stream, a, g, rec, pa);
  return (int)cudaGetLastError();
}

// The lamp kernels (LampArgs, in its order): `start` 1 samples the
// emitters from LAMP_START words, 0 takes one lamp bounce from LAMP_BOUNCE
// words.
#define LAMP_PARAMS                                                                            \
  SCENE_PARAMS, const float *origin, const float *direction, const uint8_t *alive,              \
      const float *u, float *o_position, float *o_normal, float *o_uv, int *o_color,            \
      float *o_probability, uint8_t *o_diffuse, uint8_t *o_dispersed, uint8_t *o_valid,         \
      float *o_brdf, float *o_brdf_scatter, float *o_origin, float *o_direction,                \
      uint8_t *o_alive, int n, int s, int n_lamps, int start, int n_color, int n_de,            \
      const float *t_de
#define LAMP_ARGS                                                                              \
  const LampArgs a = {{sheet, meta},                                                           \
                      PROGRAMS(n_color),                                                       \
                      wl, origin, direction, alive, u, o_position, o_normal, o_uv, o_color,    \
                      o_probability, o_diffuse, o_dispersed, o_valid, o_brdf, o_brdf_scatter, \
                      o_origin, o_direction, o_alive, n, s, n_lamps, start, t_de}

int pyrite_dense_lamp(LAMP_PARAMS, PROG_PARAMS, void* stream) {
  LAMP_ARGS;
  const size_t own = lamp_smem_bytes(n_de > 0);
  PROG_ARGS;
  launch_lanes(PICK(dense_lamp_kernel, true), PICK(dense_lamp_kernel, false), n, n_de,
               WITH_STACK(own), stream, a, pa);
  return (int)cudaGetLastError();
}

int pyrite_wide_lamp(LAMP_PARAMS, WIDE_PARAMS, PROG_PARAMS, void* stream) {
  LAMP_ARGS;
  WIDE_GEO;
  const size_t own = lamp_smem_bytes(n_de > 0);
  PROG_ARGS;
  launch_lanes(PICK(wide_lamp_kernel, true), PICK(wide_lamp_kernel, false), n, n_de,
               WITH_STACK(own), stream, a, g, pa);
  return (int)cudaGetLastError();
}

// program_colors_kernel over the [n, slots] lamp vertices (ColorArgs)
int pyrite_program_colors(SCENE_PARAMS, const int* color_prog, const uint8_t* valid,
                          const float* normal, const float* incident, const float* uv, float* out,
                          int n, int slots, int s, int n_color, PROG_PARAMS, void* stream) {
  PROG_ARGS;
  (void)sheet;
  (void)meta;
  const ColorArgs a = {PROGRAMS(n_color), color_prog, valid, normal, incident, uv, out, n, slots,
                       s};
  const int m = n * slots;
  if (m <= 0) return (int)cudaGetLastError();
  // a persistent grid: as many blocks as are resident, or as the tiles fill
  const size_t smem = WITH_STACK(sizeof(int) * RING_INTS);
  opt_in_smem((const void*)program_colors_kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, program_colors_kernel, BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  const int fill = (m + BLOCK - 1) / BLOCK, resident = sms * per_sm;
  program_colors_kernel<<<fill < resident ? fill : (resident > 0 ? resident : 1), BLOCK, smem,
                          (cudaStream_t)stream>>>(a, pa);
  return (int)cudaGetLastError();
}

// dense_shadow_kernel over `m` rays; `t_de` [n_de, m] the query march
// pass's t where the scene has DE shapes.
int pyrite_dense_shadow(const float* sheet, const int* meta, const float* origin,
                        const float* direction, const float* max_dist, const float* block_below,
                        const uint8_t* live, float* t, int m, int n_de, const float* t_de,
                        void* stream) {
  const ShadowArgs a = {{sheet, meta}, origin, direction, max_dist, block_below, live, t, m, t_de};
  launch_blocks(dense_shadow_kernel<true>, dense_shadow_kernel<false>, m, BLOCK * SHADOW_TILES, n_de,
                0, stream, a);
  return (int)cudaGetLastError();
}

// Resident blocks of BLOCK threads per SM of each bounce and NEE kernel at
// S spectral columns (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// blocks[12]: dense bounce <false>, <true>, dense NEE <false>, <true>, wide
// bounce <false>, <true>, wide NEE <false>, <true> (the bounce kernels
// without kRecord), then the kProg instantiations without DE shapes at a
// program stack of `stack` values: dense bounce, dense NEE, wide bounce,
// wide NEE. Returns the first error.
int pyrite_bounce_occupancy(int s, int stack, int* blocks) {
  const size_t b0 = bounce_smem_bytes(s, false), b1 = bounce_smem_bytes(s, true);
  const size_t st = (size_t)stack * BLOCK * sizeof(float4), rows = (size_t)BLOCK * s * sizeof(float);
  const size_t smem[12] = {b0, b1, 0, 0, b0, b1, 0, 0, b0 + st, rows + st, b0 + st, rows + st};
  const void* kernels[12] = {
      (const void*)dense_bounce_kernel<false, false, false, false, false>,
      (const void*)dense_bounce_kernel<true, false, false, false, false>,
      (const void*)dense_nee_kernel<false, false, false, false>,
      (const void*)dense_nee_kernel<true, false, false, false>,
      (const void*)wide_bounce_kernel<false, false, false, false, false>,
      (const void*)wide_bounce_kernel<true, false, false, false, false>,
      (const void*)wide_nee_kernel<false, false, false, false>,
      (const void*)wide_nee_kernel<true, false, false, false>,
      (const void*)dense_bounce_kernel<false, false, true, true, false>,
      (const void*)dense_nee_kernel<false, true, true, false>,
      (const void*)wide_bounce_kernel<false, false, true, true, false>,
      (const void*)wide_nee_kernel<false, true, true, false>};
  for (int i = 0; i < 12; ++i) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[i], kernels[i], BLOCK, smem[i]);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The dynamic shared memory a bounce kernel block of the scene's `form`
// takes at S spectral columns, with (`de`) or without DE shapes, less the
// kProg program stack: what the launchers pass (BOUNCE_SMEM;
// kernels_dense.bounce_smem_bytes mirrors it, with the stack).
int pyrite_bounce_smem(int s, int de, int form) {
  const int n_de = de;
  return (int)BOUNCE_SMEM;
}

// The same for the kRecord launchers (RECORD_SMEM; kernels_dense.
// record_smem_bytes mirrors it, with the stack).
int pyrite_bounce_record_smem(int s, int de, int form) {
  const int n_de = de;
  return (int)RECORD_SMEM;
}

// The same for the NEE launchers (NEE_SMEM; kernels_dense.nee_smem_bytes).
int pyrite_nee_smem(int s, int form) { return (int)NEE_SMEM; }

// The march passes (march_de_kernel over BounceRays / ShadowRays): `n_de`
// shapes, `de_steps` and `de_omega` as TraceConfig.max_de_steps and
// tracer.DE_OMEGA, `next` the pass's work counter (8 bytes), zeroed before
// the launch. The bounce pass reads the bounce kernel's inputs; the shadow
// pass the bounce kernel's outputs and the NEE kernel's draws.
int pyrite_de_march_bounce(const float* sheet, const int* meta, const float* origin,
                           const float* direction, const uint8_t* alive, float* t_de, int n,
                           int n_de, int de_steps, float de_omega, unsigned long long* next,
                           void* stream) {
  const BounceRays rays = {{sheet, meta}, origin, direction, alive, t_de};
  return launch_march(rays, n_de, n, de_steps, de_omega, next, (cudaStream_t)stream);
}

int pyrite_de_march_shadow(const float* sheet, const int* meta, const float* position,
                           const float* flip, const uint8_t* nee, const int* lamp_idx,
                           const float* u_nee, float* t_de_shadow, int n, int light_samples,
                           int n_de, int de_steps, float de_omega, unsigned long long* next,
                           void* stream) {
  const ShadowRays rays = {{sheet, meta}, position, flip, nee, lamp_idx, u_nee, t_de_shadow, n};
  return launch_march(rays, n_de, light_samples * n, de_steps, de_omega, next,
                      (cudaStream_t)stream);
}

// The query march pass (march_de_kernel over QueryShadowRays): t of each
// DE shape along each live ray of a shadow batch, capped at its max_dist,
// into t_de [n_de, m].
int pyrite_de_march_query_shadow(const float* sheet, const int* meta, const float* origin,
                                 const float* direction, const float* max_dist,
                                 const uint8_t* live, float* t_de, int m, int n_de, int de_steps,
                                 float de_omega, unsigned long long* next, void* stream) {
  const QueryShadowRays rays = {{sheet, meta}, origin, direction, max_dist, live, t_de};
  return launch_march(rays, n_de, m, de_steps, de_omega, next, (cudaStream_t)stream);
}

}  // extern "C"
