// CUDA backward kernel of the variant-A MIS integrator for NVIDIA Hopper
// (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_mis_bwd.py).  Built like
// mis_kernels.cu, WITHOUT --use_fast_math and WITH -fmad=false, IEEE divide
// and 1 / sqrtf: the plain PyTorch version (cuda_mis_bwd.mis_bwd_plain) runs
// the same operations in the same order, so per (pixel, camera ray) the two
// agree to the last bit; only the sums over lanes differ in order.
//
// ---------------------------------------------------------------------------
// mis_bwd_kernel  replaces  gpuraytracer_tpu/ops/pallas_mis_bwd.py:_mis_bwd_kernel
//                 (static tier: at most 64 triangles, plus analytic spheres)
// mis_bwd_grouped_kernel  replaces  the same kernel's grouped tier
//                 (grouped=True: any number of primitives below the record
//                 encoding's limit; pallas_mis_bwd.py:1153-1230, 1398-1417)
// ---------------------------------------------------------------------------
// Inputs: the cotangent g [3, N] of the raw accumulated hdr, the two record
// streams of mis_kernel (camera [camera_rays, N], samples [camera_rays, s_per,
// N], pixel axis minor-most), the differentiable parameter views — table
// [10 | 15, P] (n xyz, c0, diffuse rgb, metallic, roughness, is_emissive |
// sphere center xyz, radius, is_sphere), camera [12], light [17] — and the
// [16, s_per] sample table.  Per (pixel, camera ray) it rebuilds the camera
// ray and the camera hit from the recorded winner (the hoisted stage), then
// per sample the three strategies' continuous math from the recorded
// decisions — no traversal — and reverses it by hand; after the samples it
// reverses the hoisted stage once.  Outputs: dtab [P, 10 | 15] (the selector
// columns stay zero) and dscal [29] (camera 12, light 17).  Visibility is
// piecewise constant: the records are constants.
//
// Bound on this card: OPERATIONS.  A live sample step reads one int32 record
// (and the tables from shared memory) against a few thousand f32 operations
// of recomputed BRDF, pdf and direction arithmetic and their reverse.
// Design:
//   * one thread per (pixel, camera ray), grid (pixel blocks, camera rays), so
//     a warp reads 32 neighbouring records of one sample at once; the table,
//     the sample table, camera and light staged once per block in shared
//     memory (the sample table above 48 KiB by opting in, as mis_kernel);
//   * work only where the function has any: a camera ray that missed or
//     landed on the light contributes the emitted radiance's cotangent alone;
//     a strategy runs only where its gate is open (light sample reached; lobe
//     ray on the light, or on geometry whose light sample was reached); a miss
//     reads no table column;
//   * each forward helper keeps its residuals in a struct that the matching
//     reverse consumes right after, within the sample; the helpers are inlined
//     into the three strategy functions, which, with the bounce body and the
//     hoisted stage, are __noinline__ calls: nvcc 12.9's front end did not get
//     through mis_kernel's chained normalizations inline (see there), and with
//     the helpers as calls too their residual structs lived in local memory
//     (1,632 B of stack, 2.8x the time, bit-equal results; PERF.md);
//   * the 44 hoisted-plane cotangents and the 17 light cotangents accumulate
//     per thread over the samples; table cotangents (three sites per sample:
//     the two lobe winners, and the camera winner after the loop) and the 29
//     scalars go through reduce.cuh's fixed-order reduction, no float atomics:
//     two launches on equal inputs give equal bits;
//   * the strategies are the time (the kernel without them: 1.6 ms of 99 at
//     path I), long dependent chains with IEEE divides and square roots, so
//     the box scene's kernel takes 3 blocks of 128 per SM (12 warps, 168
//     registers and a few bytes of spills, against ptxas' own 232 registers
//     and 2 blocks): 11 % faster.  With spheres the kernel keeps 2 blocks
//     (244 registers): at 3 its spills cost what the warps gain;
//   * the sphere's quadratic and normal, forward and reverse, run in the bounce
//     body only where the recorded winner is a sphere (SPH; the grouped tier
//     keeps running them on every lane): on a triangle winner their values
//     are selected away and their cotangents are zeros, so the outputs do not
//     change (5 % faster with spheres).
//   Tried and dropped (PERF.md): the grouped tier's scatter
//   (warp_scatter_peers, 11 % slower here: a warp's 32 neighbouring pixels
//   share few winners, and one leader summing 32 rows in lane order loses to
//   the butterfly); FMA contraction (16-18 % faster, but outside
//   compare_k5's limits of the plain version); 4 blocks per SM (33-43 %
//   slower).  A strategy's call issues for the warp where any lane's gate is
//   open; 77-90 % of the lanes are open where it issues (chip_smoke.py's
//   lane_share_*), so dealing tasks out to full warps was not built.
//
// The grouped tier runs the same per-(pixel, camera ray) body (mis_bwd_item)
// with two changes, because its tables do not fit a block's shared memory
// (the static layout needs 4 (5 ndif P + 16 s_per + 145) B: about 300 KB at
// P = 1,004 with spheres, 2.6 MB at 12,802 triangles):
//   * the table is the transposed [P][ndif] table in global memory (60 KB at
//     P = 1,004 with spheres, 512 KB at 12,802 triangles, held by L2), read by
//     the recorded winner's index, code - 1, only where code > 0;
//   * the scatter keeps its fixed order without memory that grows with items
//     x P, as shade_bwd_grouped_kernel's (shade_kernels.cu): a persistent grid
//     of G blocks (the card's resident blocks, at most one per 128 (pixel,
//     camera ray) items, capped at 1 GiB of tables), each warp owning one
//     dense [P][ndif] + 29 table in global memory that it zeroes, walks the
//     32-item tiles w, w + 4G, w + 8G, ... in that order (tile t: camera ray
//     t / ceil(n / 32), its 32 pixels from (t mod ceil(n / 32)) * 32) and adds
//     to through warp_scatter_peers (below), a __syncwarp after each scatter;
//     reduce_partials_kernel then sums the 4G tables in float64 in table
//     order.  No float atomics: two launches on equal inputs give equal bits.
//     The tables cost 4G (P ndif + 29) floats written twice and read once
//     (0.54 GB at 12,802 triangles and G = 264).  Bound as for the static
//     tier;
//   * a thread's per-item state, which every live sample reads and updates
//     (the hoisted plane cs[44], its cotangent d_cs[44], the light's d_L[17]
//     and the two lobe winners' rows), lies in shared memory (State: 125 or
//     135 floats a thread at that odd stride, so that a warp's 32 words of
//     one slot fall in 32 banks), not on the stack: passed by address to the
//     __noinline__ stage functions, on the stack it would live in local
//     memory, 1,088 B a thread, 278 KB a SM for 256 threads, more than L1
//     holds.  The stack keeps the hoisted stage's residuals, used once per
//     item (528 / 568 B without / with spheres);
//   * the scatter is reduce.cuh's warp_scatter_peers: __match_any_sync
//     groups the lanes by key, and the lowest lane of each group sums the
//     group's rows from the state in lane order and adds them once, the
//     groups' leaders side by side, in place of a ballot, a shuffle and NDIF
//     five-shuffle sums per distinct key in turn.
//   Budget: 255 registers, 70,516 / 75,636 B of shared memory at 300
//   samples, 2 blocks of 128 threads (8 warps) per SM, as before.
// Not carried over from the TPU: the block-range one-hot fetch and the
// VMEM block scatter (an indexed load and the per-warp tables take their
// place).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using grt::warp_scatter_peers;
using grt::warp_scatter_rows;
using grt::warp_sum;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr float INV_2_32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr int BLOCK_THREADS = 128;
constexpr int WARPS = BLOCK_THREADS / 32;
constexpr int NCAM = 12, NLIGHT = 17, NSCAL = 29, NCS = 44, TAB_ROWS = 16;
constexpr int REC_SHIFT_C = 3, REC_SHIFT_V = 17, REC_CODE_MASK = (1 << 14) - 1;
constexpr size_t MAX_SMEM_BYTES = 227 * 1024;

// Hoisted-plane slots (cuda_mis_bwd.CS_*).
constexpr int CS_D = 0, CS_P = 3, CS_NH = 6, CS_DF = 9, CS_MET = 12, CS_RGH = 13,
              CS_T = 14, CS_B = 17, CS_VE = 20, CS_T1 = 23, CS_T2 = 26,
              CS_ALPHA = 29, CS_OFF = 30, CS_V = 33, CS_CNDV = 36, CS_CSQV = 37,
              CS_F0 = 38, CS_OMM = 41, CS_G1 = 42, CS_VNDV = 43;
// Light slots.
constexpr int L_C = 0, L_E = 3, L_W = 6, L_D = 7, L_N = 8, L_T = 11, L_B = 14;
// Sample-table rows.
constexpr int TAB_LU0 = 0, TAB_LU1 = 1, TAB_CSU0 = 4, TAB_CSU1 = 5, TAB_VSU0 = 8,
              TAB_VSU1 = 9, TAB_W0C = 10, TAB_W1C = 11, TAB_CTH = 12, TAB_K0V = 13,
              TAB_K1V = 14, TAB_VCT = 15;

struct BwdParams {
  const float* g;             // [3, n_local]
  const int32_t* cam_rec;     // [camera_rays, n_local]
  const int32_t* samp_rec;    // [camera_rays, s_per, n_local]
  const float* table;         // [ndif, P]
  const float* cam;           // [12]
  const float* light;         // [17]
  const float* stab;          // [16, s_per]
  float* partials;            // [blocks, P * ndif + 29]
  int n_local, rid_base, width, height, camera_rays, s_per, num_prims;
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float sel(bool c, float x) { return c ? x : 0.0f; }

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ bool in01(float x) { return x >= 0.0f && x <= 1.0f; }

// ---- norm3: x / sqrt(max(|x|^2, eps))
struct NormRes {
  float x, y, z, inv;
  bool ok;
};

__device__ __forceinline__ void norm3_fwd(float x, float y, float z, float eps,
                                          float* out, NormRes& r) {
  const float q = x * x + y * y + z * z;
  r.inv = 1.0f / sqrtf(fmaxf(q, eps));
  r.x = x; r.y = y; r.z = z;
  r.ok = q >= eps;
  out[0] = x * r.inv; out[1] = y * r.inv; out[2] = z * r.inv;
}

__device__ __forceinline__ void norm3_rev(const NormRes& r, float dx, float dy,
                                          float dz, float* out) {
  const float d_inv = r.x * dx + r.y * dy + r.z * dz;
  const float d_q = sel(r.ok, (-0.5f) * r.inv * r.inv * r.inv * d_inv);
  out[0] = r.inv * dx + 2.0f * r.x * d_q;
  out[1] = r.inv * dy + 2.0f * r.y * d_q;
  out[2] = r.inv * dz + 2.0f * r.z * d_q;
}

// ---- GGX D, taking roughness (a quirk of the reference)
struct DggxRes {
  float ndh, rgh, f, inv_den, out;
};

__device__ __forceinline__ float dggx_fwd(float ndh, float rgh, DggxRes& r) {
  r.ndh = ndh; r.rgh = rgh;
  r.f = (ndh * rgh * rgh - ndh) * ndh + 1.0f;
  const float den = PI_F * r.f * r.f + 1e-12f;
  r.out = (rgh * rgh) / den;
  r.inv_den = 1.0f / den;
  return r.out;
}

__device__ __forceinline__ void dggx_rev(const DggxRes& r, float d_out, float* d_ndh,
                                         float* d_rgh) {
  float dr = 2.0f * r.rgh * r.inv_den * d_out;
  const float d_den = -(r.out * r.inv_den) * d_out;
  const float d_f = 2.0f * PI_F * r.f * d_den;
  *d_ndh = 2.0f * r.ndh * (r.rgh * r.rgh - 1.0f) * d_f;
  dr = dr + 2.0f * r.rgh * r.ndh * r.ndh * d_f;
  *d_rgh = dr;
}

// ---- Smith G1 for GGX
struct G1Res {
  float ndv, rgh, a, a2, nv2r, inv_nv2, s, g1;
};

__device__ __forceinline__ float g1_fwd(float ndv, float rgh, G1Res& r) {
  r.ndv = ndv; r.rgh = rgh;
  r.a = rgh * rgh;
  r.a2 = r.a * r.a;
  r.nv2r = ndv * ndv;
  const float nv2 = fmaxf(r.nv2r, 1e-12f);
  r.s = sqrtf(1.0f + r.a2 * (1.0f - nv2) / nv2);
  r.g1 = 2.0f / (1.0f + r.s);
  r.inv_nv2 = 1.0f / nv2;
  return r.g1;
}

__device__ __forceinline__ void g1_rev(const G1Res& r, float d_g1, float* d_ndv,
                                       float* d_rgh) {
  const float d_s = -(r.g1 / (1.0f + r.s)) * d_g1;
  const float d_in = d_s / (2.0f * r.s);
  const float d_a2 = (r.inv_nv2 - 1.0f) * d_in;
  const float d_nv2 = -(r.a2 * r.inv_nv2 * r.inv_nv2) * d_in;
  *d_ndv = sel(r.nv2r >= 1e-12f, 2.0f * r.ndv * d_nv2);
  *d_rgh = 4.0f * r.rgh * r.a * d_a2;
}

// ---- the metallic-roughness BRDF (generic: the secondary surfaces)
struct BrdfRes {
  float v[3], n[3], df[3], met, rgh, l[3], h[3];
  NormRes rh;
  float ndv_raw, ndv, ndl_raw, ndl, ndh_raw, ldh_raw, x4, omm, f0[3];
  DggxRes rd;
  float dggx, p5, fres[3], a, argl, inv_sql, sql, argv, inv_sqv, sqv, vis, inv_sumg,
      inv_dens, spec;
};

__device__ __forceinline__ void brdf_fwd(const float* v, const float* n, const float* df,
                                         float met, float rgh, const float* l, float* out,
                                         BrdfRes& r) {
  for (int c = 0; c < 3; ++c) { r.v[c] = v[c]; r.n[c] = n[c]; r.df[c] = df[c]; r.l[c] = l[c]; }
  r.met = met; r.rgh = rgh;
  norm3_fwd(v[0] + l[0], v[1] + l[1], v[2] + l[2], 1e-12f, r.h, r.rh);
  r.ndv_raw = n[0] * v[0] + n[1] * v[1] + n[2] * v[2];
  r.ndv = fabsf(r.ndv_raw) + 1e-5f;
  r.ndl_raw = n[0] * l[0] + n[1] * l[1] + n[2] * l[2];
  r.ndl = clamp01(r.ndl_raw);
  r.ndh_raw = n[0] * r.h[0] + n[1] * r.h[1] + n[2] * r.h[2];
  const float ndh = clamp01(r.ndh_raw);
  r.ldh_raw = l[0] * r.h[0] + l[1] * r.h[1] + l[2] * r.h[2];
  const float ldh = clamp01(r.ldh_raw);
  r.omm = 1.0f - met;
  for (int c = 0; c < 3; ++c) r.f0[c] = 0.04f * r.omm + df[c] * met;
  r.dggx = dggx_fwd(ndh, rgh, r.rd);
  const float q = 1.0f - ldh;
  const float x2 = q * q;
  r.p5 = x2 * x2 * q;
  r.x4 = x2 * x2;
  for (int c = 0; c < 3; ++c) r.fres[c] = r.f0[c] + (1.0f - r.f0[c]) * r.p5;
  r.a = rgh * rgh;
  r.argl = (-r.ndl * r.a + r.ndl) * r.ndl + r.a;
  r.sql = sqrtf(fmaxf(r.argl, 1e-12f));
  r.inv_sql = 1.0f / r.sql;
  r.argv = (-r.ndv * r.a + r.ndv) * r.ndv + r.a;
  r.sqv = sqrtf(fmaxf(r.argv, 1e-12f));
  r.inv_sqv = 1.0f / r.sqv;
  const float sumg = r.ndl * r.sqv + r.ndv * r.sql + 1e-7f;
  r.vis = 0.5f / sumg;
  r.inv_sumg = r.vis + r.vis;
  const float den_s = 4.0f * r.ndv * r.ndl + 1e-7f;
  r.spec = r.dggx * r.vis / den_s;
  r.inv_dens = 1.0f / den_s;
  for (int c = 0; c < 3; ++c) {
    out[c] = (1.0f - r.fres[c]) * r.omm * (df[c] * INV_PI_F + r.spec * r.fres[c]) * r.ndl;
  }
}

// Returns d_v, d_n, d_df, d_met, d_rgh, d_l.
__device__ __forceinline__ void brdf_rev(const BrdfRes& r, const float* d_out, float* d_v,
                                         float* d_n, float* d_df, float* d_met_out,
                                         float* d_rgh_out, float* d_l) {
  float d_ndl = 0.0f, d_ndv = 0.0f, d_spec = 0.0f, d_omm = 0.0f, d_met = 0.0f,
        d_p5 = 0.0f;
  for (int c = 0; c < 3; ++c) d_df[c] = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float g = d_out[c];
    const float kd = (1.0f - r.fres[c]) * r.omm;
    const float inner = r.df[c] * INV_PI_F + r.spec * r.fres[c];
    const float d_kd = inner * r.ndl * g;
    const float d_inner = kd * r.ndl * g;
    d_ndl = d_ndl + kd * inner * g;
    const float d_fc = r.spec * d_inner - r.omm * d_kd;
    d_omm = d_omm + (1.0f - r.fres[c]) * d_kd;
    d_df[c] = d_df[c] + INV_PI_F * d_inner;
    d_spec = d_spec + r.fres[c] * d_inner;
    const float d_f0 = (1.0f - r.p5) * d_fc;
    d_p5 = d_p5 + (1.0f - r.f0[c]) * d_fc;
    d_omm = d_omm + 0.04f * d_f0;
    d_df[c] = d_df[c] + r.met * d_f0;
    d_met = d_met + r.df[c] * d_f0;
  }
  d_met = d_met - d_omm;
  const float d_ldh = -5.0f * r.x4 * d_p5;
  const float d_dggx = r.vis * r.inv_dens * d_spec;
  const float d_vis = r.dggx * r.inv_dens * d_spec;
  const float d_dens = -(r.spec * r.inv_dens) * d_spec;
  d_ndv = d_ndv + 4.0f * r.ndl * d_dens;
  d_ndl = d_ndl + 4.0f * r.ndv * d_dens;
  const float d_sumg = -(r.vis * r.inv_sumg) * d_vis;
  d_ndl = d_ndl + r.sqv * d_sumg;
  const float d_sqv = r.ndl * d_sumg;
  d_ndv = d_ndv + r.sql * d_sumg;
  const float d_sql = r.ndv * d_sumg;
  const float d_argv = sel(r.argv >= 1e-12f, 0.5f * r.inv_sqv * d_sqv);
  const float d_argl = sel(r.argl >= 1e-12f, 0.5f * r.inv_sql * d_sql);
  d_ndv = d_ndv + 2.0f * r.ndv * (1.0f - r.a) * d_argv;
  float d_a = (1.0f - r.ndv * r.ndv) * d_argv;
  d_ndl = d_ndl + 2.0f * r.ndl * (1.0f - r.a) * d_argl;
  d_a = d_a + (1.0f - r.ndl * r.ndl) * d_argl;
  float d_ndh, d_rgh;
  dggx_rev(r.rd, d_dggx, &d_ndh, &d_rgh);
  d_rgh = d_rgh + 2.0f * r.rgh * d_a;
  const float d_ldh_raw = sel(in01(r.ldh_raw), d_ldh);
  const float d_ndh_raw = sel(in01(r.ndh_raw), d_ndh);
  const float d_ndl_raw = sel(in01(r.ndl_raw), d_ndl);
  const float d_ndv_raw = sgn(r.ndv_raw) * d_ndv;
  float d_h[3];
  for (int c = 0; c < 3; ++c) {
    d_n[c] = r.l[c] * d_ndl_raw + r.h[c] * d_ndh_raw + r.v[c] * d_ndv_raw;
    d_l[c] = r.n[c] * d_ndl_raw + r.h[c] * d_ldh_raw;
    d_h[c] = r.n[c] * d_ndh_raw + r.l[c] * d_ldh_raw;
    d_v[c] = r.n[c] * d_ndv_raw;
  }
  float dh[3];
  norm3_rev(r.rh, d_h[0], d_h[1], d_h[2], dh);
  for (int c = 0; c < 3; ++c) {
    d_v[c] = d_v[c] + dh[c];
    d_l[c] = d_l[c] + dh[c];
  }
  *d_met_out = d_met;
  *d_rgh_out = d_rgh;
}

// ---- cosine pdf max(0, n.d) / pi
__device__ __forceinline__ float cospdf_fwd(const float* n, const float* d, float* raw) {
  *raw = n[0] * d[0] + n[1] * d[1] + n[2] * d[2];
  return fmaxf(*raw, 0.0f) * INV_PI_F;
}

__device__ __forceinline__ void cospdf_rev(const float* n, const float* d, float raw,
                                           float d_pdf, float* d_n, float* d_d) {
  const float d_raw = sel(raw >= 0.0f, d_pdf * INV_PI_F);
  for (int c = 0; c < 3; ++c) { d_n[c] = d[c] * d_raw; d_d[c] = n[c] * d_raw; }
}

// ---- square-light pdf to the light center (a quirk of the reference)
struct LpdfRes {
  float dir[3], to[3], ct_raw, cos_t, inv_den, pdf;
};

__device__ __forceinline__ float lightpdf_fwd(const float* L, const float* q,
                                              const float* dir, LpdfRes& r) {
  for (int c = 0; c < 3; ++c) { r.dir[c] = dir[c]; r.to[c] = L[L_C + c] - q[c]; }
  const float dist2 = r.to[0] * r.to[0] + r.to[1] * r.to[1] + r.to[2] * r.to[2];
  r.ct_raw = -(dir[0] * L[L_N] + dir[1] * L[L_N + 1] + dir[2] * L[L_N + 2]);
  r.cos_t = fmaxf(r.ct_raw, 0.0f);
  const float den = L[L_W] * L[L_D] * r.cos_t + 1e-6f;
  r.pdf = dist2 / den;
  r.inv_den = 1.0f / den;
  return r.pdf;
}

// Adds the light's cotangents to d_L; returns d_q, d_dir.
__device__ __forceinline__ void lightpdf_rev(const LpdfRes& r, const float* L, float d_pdf,
                                             float* d_L, float* d_q, float* d_dir) {
  const float lw = L[L_W], ldep = L[L_D];
  const float d_dist2 = d_pdf * r.inv_den;
  const float d_den = -(r.pdf * r.inv_den) * d_pdf;
  d_L[L_W] = d_L[L_W] + ldep * r.cos_t * d_den;
  d_L[L_D] = d_L[L_D] + lw * r.cos_t * d_den;
  const float d_ct = sel(r.ct_raw >= 0.0f, lw * ldep * d_den);
  for (int c = 0; c < 3; ++c) d_dir[c] = -L[L_N + c] * d_ct;
  for (int c = 0; c < 3; ++c) {
    d_L[L_N + c] = d_L[L_N + c] - r.dir[c] * d_ct;
    const float d_to = 2.0f * r.to[c] * d_dist2;
    d_L[L_C + c] = d_L[L_C + c] + d_to;
    d_q[c] = -d_to;
  }
}

// ---- beta = 1 power heuristic
struct Ph3Res {
  float inv_den, w, n;
};

__device__ __forceinline__ float ph3_fwd(float p1, float p2, float p3, float n,
                                         Ph3Res& r) {
  const float aa = n * p1;
  const float den = aa + n * p2 + n * p3 + 1e-6f;
  r.w = aa / den;
  r.inv_den = 1.0f / den;
  r.n = n;
  return r.w;
}

__device__ __forceinline__ void ph3_rev(const Ph3Res& r, float d_w, float* d1, float* d2,
                                        float* d3) {
  const float t = d_w * r.inv_den;
  *d1 = r.n * (1.0f - r.w) * t;
  *d2 = -r.n * r.w * t;
  *d3 = -r.n * r.w * t;
}

// ---- the camera-material BRDF and VNDF pdf toward l, the direction-free
// terms read from the hoisted planes, the half vector shared
struct BvRes {
  float l[3], h[3];
  NormRes rh;
  float ndl_raw, ndl, ndh_raw, ldh_raw, x4, p5, fres[3], dggx_b;
  DggxRes rdb;
  float argl, inv_sql, sql, inv_sumg, vis, inv_dens, spec, vdh_raw, vdh, dggx_v;
  DggxRes rdv;
  float inv_denv, pdf;
};

__device__ __forceinline__ void bv_fwd(const float* cs, const float* l, float* out,
                                       float* pdf_out, BvRes& r) {
  const float* v = cs + CS_V;
  const float* n = cs + CS_NH;
  const float* df = cs + CS_DF;
  const float* f0 = cs + CS_F0;
  const float rgh = cs[CS_RGH], a = cs[CS_ALPHA], ndv = cs[CS_CNDV], sqv = cs[CS_CSQV];
  const float omm = cs[CS_OMM], g1 = cs[CS_G1], vndv = cs[CS_VNDV];
  for (int c = 0; c < 3; ++c) r.l[c] = l[c];
  norm3_fwd(v[0] + l[0], v[1] + l[1], v[2] + l[2], 1e-12f, r.h, r.rh);
  r.ndl_raw = n[0] * l[0] + n[1] * l[1] + n[2] * l[2];
  r.ndl = clamp01(r.ndl_raw);
  r.ndh_raw = n[0] * r.h[0] + n[1] * r.h[1] + n[2] * r.h[2];
  r.ldh_raw = l[0] * r.h[0] + l[1] * r.h[1] + l[2] * r.h[2];
  const float ldh = clamp01(r.ldh_raw);
  r.dggx_b = dggx_fwd(clamp01(r.ndh_raw), rgh, r.rdb);
  const float q = 1.0f - ldh;
  const float x2 = q * q;
  r.p5 = x2 * x2 * q;
  r.x4 = x2 * x2;
  for (int c = 0; c < 3; ++c) r.fres[c] = f0[c] + (1.0f - f0[c]) * r.p5;
  r.argl = (-r.ndl * a + r.ndl) * r.ndl + a;
  r.sql = sqrtf(fmaxf(r.argl, 1e-12f));
  r.inv_sql = 1.0f / r.sql;
  const float sumg = r.ndl * sqv + ndv * r.sql + 1e-7f;
  r.vis = 0.5f / sumg;
  r.inv_sumg = r.vis + r.vis;
  const float den_s = 4.0f * ndv * r.ndl + 1e-7f;
  r.spec = r.dggx_b * r.vis / den_s;
  r.inv_dens = 1.0f / den_s;
  for (int c = 0; c < 3; ++c) {
    out[c] = (1.0f - r.fres[c]) * omm * (df[c] * INV_PI_F + r.spec * r.fres[c]) * r.ndl;
  }
  r.vdh_raw = v[0] * r.h[0] + v[1] * r.h[1] + v[2] * r.h[2];
  r.vdh = fabsf(r.vdh_raw);
  r.dggx_v = dggx_fwd(fabsf(r.ndh_raw), rgh, r.rdv);
  const float denv = 4.0f * vndv + 1e-7f;
  r.pdf = r.dggx_v * g1 * r.vdh / denv;
  r.inv_denv = 1.0f / denv;
  *pdf_out = r.pdf;
}

// Adds the hoisted-plane cotangents to d_cs (in the order of
// cuda_mis_bwd._apply_bv); returns d_l.
__device__ __forceinline__ void bv_rev(const BvRes& r, const float* cs, const float* d_out,
                                       float d_pdf, float* d_cs, float* d_l) {
  const float* v = cs + CS_V;
  const float* n = cs + CS_NH;
  const float* df = cs + CS_DF;
  const float* f0 = cs + CS_F0;
  const float a = cs[CS_ALPHA], ndv = cs[CS_CNDV], sqv = cs[CS_CSQV];
  const float omm = cs[CS_OMM], g1 = cs[CS_G1];
  float d_ndl = 0.0f, d_spec = 0.0f, d_omm = 0.0f, d_p5 = 0.0f;
  float d_df[3], d_f0[3];
  for (int c = 0; c < 3; ++c) {
    const float g = d_out[c];
    const float kd = (1.0f - r.fres[c]) * omm;
    const float inner = df[c] * INV_PI_F + r.spec * r.fres[c];
    const float gi = r.ndl * g;
    const float d_kd = inner * gi;
    const float d_inner = kd * gi;
    d_ndl = d_ndl + (kd * inner) * g;
    const float d_fc = r.spec * d_inner - omm * d_kd;
    d_omm = d_omm + (1.0f - r.fres[c]) * d_kd;
    d_df[c] = INV_PI_F * d_inner;
    d_spec = d_spec + r.fres[c] * d_inner;
    d_f0[c] = (1.0f - r.p5) * d_fc;
    d_p5 = d_p5 + (1.0f - f0[c]) * d_fc;
  }
  const float d_ldh = -5.0f * r.x4 * d_p5;
  const float d_dggx_b = r.vis * r.inv_dens * d_spec;
  const float d_vis = r.dggx_b * r.inv_dens * d_spec;
  const float d_dens = -(r.spec * r.inv_dens) * d_spec;
  float d_ndv = 4.0f * r.ndl * d_dens;
  d_ndl = d_ndl + 4.0f * ndv * d_dens;
  const float d_sumg = -(r.vis * r.inv_sumg) * d_vis;
  d_ndl = d_ndl + sqv * d_sumg;
  const float d_sqv = r.ndl * d_sumg;
  d_ndv = d_ndv + r.sql * d_sumg;
  const float d_sql = ndv * d_sumg;
  const float d_argl = sel(r.argl >= 1e-12f, 0.5f * r.inv_sql * d_sql);
  d_ndl = d_ndl + 2.0f * r.ndl * (1.0f - a) * d_argl;
  const float d_a = (1.0f - r.ndl * r.ndl) * d_argl;
  float d_ndh_b, d_rgh, d_ndh_v, d_rgh_v;
  dggx_rev(r.rdb, d_dggx_b, &d_ndh_b, &d_rgh);
  const float d_dggx_v = g1 * r.vdh * r.inv_denv * d_pdf;
  const float d_g1 = r.dggx_v * r.vdh * r.inv_denv * d_pdf;
  const float d_vdh = r.dggx_v * g1 * r.inv_denv * d_pdf;
  const float d_vndv = 4.0f * (-(r.pdf * r.inv_denv) * d_pdf);
  dggx_rev(r.rdv, d_dggx_v, &d_ndh_v, &d_rgh_v);
  d_rgh = d_rgh + d_rgh_v;
  const float d_ndh_raw = sel(in01(r.ndh_raw), d_ndh_b) + sgn(r.ndh_raw) * d_ndh_v;
  const float d_ndl_raw = sel(in01(r.ndl_raw), d_ndl);
  const float d_ldh_raw = sel(in01(r.ldh_raw), d_ldh);
  const float d_vdh_raw = sgn(r.vdh_raw) * d_vdh;
  float d_n[3], d_h[3], d_v[3], dh[3];
  for (int c = 0; c < 3; ++c) {
    d_n[c] = r.l[c] * d_ndl_raw + r.h[c] * d_ndh_raw;
    d_l[c] = n[c] * d_ndl_raw + r.h[c] * d_ldh_raw;
    d_h[c] = n[c] * d_ndh_raw + r.l[c] * d_ldh_raw + v[c] * d_vdh_raw;
    d_v[c] = r.h[c] * d_vdh_raw;
  }
  norm3_rev(r.rh, d_h[0], d_h[1], d_h[2], dh);
  for (int c = 0; c < 3; ++c) {
    d_v[c] = d_v[c] + dh[c];
    d_l[c] = d_l[c] + dh[c];
  }
  for (int c = 0; c < 3; ++c) d_cs[CS_V + c] = d_cs[CS_V + c] + d_v[c];
  for (int c = 0; c < 3; ++c) d_cs[CS_NH + c] = d_cs[CS_NH + c] + d_n[c];
  for (int c = 0; c < 3; ++c) d_cs[CS_DF + c] = d_cs[CS_DF + c] + d_df[c];
  for (int c = 0; c < 3; ++c) d_cs[CS_F0 + c] = d_cs[CS_F0 + c] + d_f0[c];
  d_cs[CS_RGH] = d_cs[CS_RGH] + d_rgh;
  d_cs[CS_ALPHA] = d_cs[CS_ALPHA] + d_a;
  d_cs[CS_CNDV] = d_cs[CS_CNDV] + d_ndv;
  d_cs[CS_CSQV] = d_cs[CS_CSQV] + d_sqv;
  d_cs[CS_OMM] = d_cs[CS_OMM] + d_omm;
  d_cs[CS_G1] = d_cs[CS_G1] + d_g1;
  d_cs[CS_VNDV] = d_cs[CS_VNDV] + d_vndv;
}

// ---- the direction from o to the light sample at (u0, u1)
struct ToLight {
  float to[3], q2, inv_dist, su0, su1;
};

__device__ __forceinline__ void to_light_fwd(const float* L, const float* o, float u0,
                                             float u1, float* ld, ToLight& r) {
  r.su0 = u0 - 0.5f;
  r.su1 = u1 - 0.5f;
  const float sw = r.su0 * L[L_W];
  const float sdep = r.su1 * L[L_D];
  for (int c = 0; c < 3; ++c) r.to[c] = L[L_C + c] + L[L_T + c] * sw + L[L_B + c] * sdep - o[c];
  r.q2 = r.to[0] * r.to[0] + r.to[1] * r.to[1] + r.to[2] * r.to[2];
  const float dist = sqrtf(fmaxf(r.q2, 1e-30f));
  r.inv_dist = 1.0f / dist;
  for (int c = 0; c < 3; ++c) ld[c] = r.to[c] / dist;
}

// Adds the light's cotangents to d_L; returns d_o.
__device__ __forceinline__ void to_light_rev(const ToLight& r, const float* L,
                                             const float* d_ld, float* d_L, float* d_o) {
  float d_to[3];
  for (int c = 0; c < 3; ++c) d_to[c] = r.inv_dist * d_ld[c];
  const float d_invd = r.to[0] * d_ld[0] + r.to[1] * d_ld[1] + r.to[2] * d_ld[2];
  const float d_q2 =
      sel(r.q2 >= 1e-30f, -0.5f * r.inv_dist * r.inv_dist * r.inv_dist * d_invd);
  const float lw = L[L_W], ldep = L[L_D];
  for (int c = 0; c < 3; ++c) {
    const float d_s = d_to[c] + 2.0f * r.to[c] * d_q2;
    d_L[L_C + c] = d_L[L_C + c] + d_s;
    d_L[L_T + c] = d_L[L_T + c] + r.su0 * lw * d_s;
    d_L[L_W] = d_L[L_W] + r.su0 * L[L_T + c] * d_s;
    d_L[L_B + c] = d_L[L_B + c] + r.su1 * ldep * d_s;
    d_L[L_D] = d_L[L_D] + r.su1 * L[L_B + c] * d_s;
    d_o[c] = -d_s;
  }
}

// ---- one unweighted light sample at a secondary surface (the occlusion
// decision given: the caller runs it only where the probe reached the light)
struct DlRes {
  float n[3], ld[3];
  ToLight tl;
  LpdfRes pl;
  float b[3];
  BrdfRes rb;
  float inv_pdf;
};

__device__ __forceinline__ void direct_light_fwd(const float* L, const float* q,
                                                 const float* n, const float* inc,
                                                 const float* df, float met, float rgh,
                                                 float u0, float u1, float* out,
                                                 DlRes& r) {
  float o[3], v[3];
  for (int c = 0; c < 3; ++c) { r.n[c] = n[c]; o[c] = q[c] + n[c] * 1e-4f; }
  to_light_fwd(L, o, u0, u1, r.ld, r.tl);
  const float pdf_l = lightpdf_fwd(L, q, r.ld, r.pl);
  for (int c = 0; c < 3; ++c) v[c] = -inc[c];
  brdf_fwd(v, n, df, met, rgh, r.ld, r.b, r.rb);
  r.inv_pdf = 1.0f / pdf_l;
  for (int c = 0; c < 3; ++c) out[c] = r.b[c] * L[L_E + c] * r.inv_pdf;
}

// Adds the light's cotangents to d_L; returns d_q, d_n, d_inc, d_df, d_met,
// d_rgh.
__device__ __forceinline__ void direct_light_rev(const DlRes& r, const float* L,
                                                 const float* d_out, float* d_L,
                                                 float* d_q, float* d_n, float* d_inc,
                                                 float* d_df, float* d_met, float* d_rgh) {
  float d_inv_pdf = 0.0f, d_b[3];
  for (int c = 0; c < 3; ++c) {
    d_b[c] = L[L_E + c] * r.inv_pdf * d_out[c];
    d_L[L_E + c] = d_L[L_E + c] + r.b[c] * r.inv_pdf * d_out[c];
    d_inv_pdf = d_inv_pdf + r.b[c] * L[L_E + c] * d_out[c];
  }
  const float d_pdf_l = 0.0f + (-(r.inv_pdf * r.inv_pdf) * d_inv_pdf);
  float d_v[3], d_ld[3], d_qp[3], d_dirp[3], d_o[3];
  brdf_rev(r.rb, d_b, d_v, d_n, d_df, d_met, d_rgh, d_ld);
  lightpdf_rev(r.pl, L, d_pdf_l, d_L, d_qp, d_dirp);
  for (int c = 0; c < 3; ++c) d_ld[c] = d_ld[c] + d_dirp[c];
  to_light_rev(r.tl, L, d_ld, d_L, d_o);
  for (int c = 0; c < 3; ++c) {
    d_q[c] = d_qp[c] + d_o[c];
    d_n[c] = d_n[c] + 1e-4f * d_o[c];
    d_inc[c] = -d_v[c];
  }
}

// The stage functions below are __noinline__ calls, one copy per tier
// (GROUPED): ptxas allocates a called function's registers once for all its
// callers, and shared with the grouped kernel they took the static kernel
// from 231 to 243 registers.

// ---- the cosine / VNDF bounce body, forward recompute and reverse in one:
// the recorded winner's column `at2` (the caller runs it only where the lobe
// ray hit something: on the light, or on geometry whose light sample was
// reached), the camera-material BRDF toward sd as b2.  Adds the light's and
// the winner's cotangents to d_L and d_at2; returns d_off, d_b2, d_sd,
// d_pdf_self, d_w.
template <bool SPH, bool GROUPED>
__device__ __noinline__ void bounce_fwd_rev(const float* cs, const float* L,
                                            const float* at2, const float* sd,
                                            float pdf_self, float w, float su0,
                                            float su1, const float* b2, const float* gs,
                                            float* d_L, float* d_at2, float* d_off,
                                            float* d_b2, float* d_sd, float* d_pdf_self,
                                            float* d_w_out) {
  const float* off = cs + CS_OFF;
  const float* n2t = at2;
  const float c02 = at2[3];
  const float den2 = sd[0] * n2t[0] + sd[1] * n2t[1] + sd[2] * n2t[2];
  const bool ok2 = fabsf(den2) >= 1e-12f;
  const float sden2 = ok2 ? den2 : 1.0f;
  const float inv_sden2 = 1.0f / sden2;
  const float num2 = c02 - (off[0] * n2t[0] + off[1] * n2t[1] + off[2] * n2t[2]);
  const float t2p = num2 / sden2;
  float t2 = t2p;
  bool is_sph = false, posd = false, t1_ok = false;
  float oc[3] = {0.0f, 0.0f, 0.0f}, rad = 0.0f, a_q = 1.0f, b_q = 0.0f, c_q = 0.0f,
        sq = 1.0f, t1 = 0.0f, t2q = 0.0f;
  // The static tier skips the sphere's terms on a triangle winner (see the
  // note at the top); here and below they keep their initial values.
  if (SPH) is_sph = at2[14] > 0.5f;
  if (SPH && (GROUPED || is_sph)) {
    for (int c = 0; c < 3; ++c) oc[c] = off[c] - at2[10 + c];
    rad = at2[13];
    a_q = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2];
    b_q = 2.0f * (oc[0] * sd[0] + oc[1] * sd[1] + oc[2] * sd[2]);
    c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - rad * rad;
    const float disc = b_q * b_q - 4.0f * a_q * c_q;
    posd = disc > 0.0f;
    sq = sqrtf(posd ? disc : 1.0f);
    t1 = (-b_q - sq) / (2.0f * a_q);
    t2q = (-b_q + sq) / (2.0f * a_q);
    t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
    t2 = is_sph ? (t1_ok ? t1 : t2q) : t2p;
  }
  const bool pdf_ok = pdf_self > 0.0f;
  const float inv_pdf = sel(pdf_ok, 1.0f / (pdf_ok ? pdf_self : 1.0f));
  const bool hit_light = at2[9] > 0.5f;
  const bool hit_geo = !hit_light;
  const float t2s = sel(hit_geo, t2);
  float bp[3], n2[3];
  for (int c = 0; c < 3; ++c) { bp[c] = off[c] + sd[c] * t2s; n2[c] = n2t[c]; }
  bool sel_n = false;
  float nv[3] = {0.0f, 0.0f, 0.0f}, qn = 0.0f, inv_n = 0.0f;
  if (SPH && (GROUPED || is_sph)) {
    sel_n = hit_geo && is_sph;
    for (int c = 0; c < 3; ++c) nv[c] = bp[c] - at2[10 + c];
    qn = nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2];
    inv_n = 1.0f / sqrtf(fmaxf(qn, 1e-6f));
    if (sel_n) for (int c = 0; c < 3; ++c) n2[c] = nv[c] * inv_n;
  }
  DlRes dl;
  float dl3[3] = {0.0f, 0.0f, 0.0f};
  if (hit_geo) {
    direct_light_fwd(L, bp, n2, sd, at2 + 4, at2[7], at2[8], su0, su1, dl3, dl);
  }

  // reverse
  float d_inv_pdf = 0.0f, d_w = 0.0f, d_dl[3];
  for (int c = 0; c < 3; ++c) {
    const float d_lt = sel(hit_light, gs[c]);
    const float d_g = sel(hit_geo, gs[c]);
    d_b2[c] = 0.0f + inv_pdf * dl3[c] * d_g;
    d_inv_pdf = d_inv_pdf + b2[c] * dl3[c] * d_g;
    d_dl[c] = b2[c] * inv_pdf * d_g;
    d_w = d_w + b2[c] * L[L_E + c] * inv_pdf * d_lt;
    d_b2[c] = d_b2[c] + w * L[L_E + c] * inv_pdf * d_lt;
    d_L[L_E + c] = d_L[L_E + c] + w * b2[c] * inv_pdf * d_lt;
    d_inv_pdf = d_inv_pdf + w * b2[c] * L[L_E + c] * d_lt;
  }
  *d_pdf_self = sel(pdf_ok, -(inv_pdf * inv_pdf) * d_inv_pdf);
  *d_w_out = d_w;
  float d_bp[3] = {0.0f, 0.0f, 0.0f}, d_n2[3] = {0.0f, 0.0f, 0.0f};
  float d_df2[3] = {0.0f, 0.0f, 0.0f}, d_met2 = 0.0f, d_rgh2 = 0.0f;
  for (int c = 0; c < 3; ++c) d_sd[c] = 0.0f;
  if (hit_geo) {
    direct_light_rev(dl, L, d_dl, d_L, d_bp, d_n2, d_sd, d_df2, &d_met2, &d_rgh2);
  }
  for (int c = 0; c < 3; ++c) d_at2[4 + c] = d_at2[4 + c] + d_df2[c];
  d_at2[7] = d_at2[7] + d_met2;
  d_at2[8] = d_at2[8] + d_rgh2;
  float d_n2t[3];
  if (SPH && (GROUPED || is_sph)) {
    float d_n2s[3];
    for (int c = 0; c < 3; ++c) {
      d_n2t[c] = sel(!sel_n, d_n2[c]);
      d_n2s[c] = sel(sel_n, d_n2[c]);
    }
    const float d_inv_n = nv[0] * d_n2s[0] + nv[1] * d_n2s[1] + nv[2] * d_n2s[2];
    const float d_qn = sel(qn >= 1e-6f, -0.5f * inv_n * inv_n * inv_n * d_inv_n);
    for (int c = 0; c < 3; ++c) {
      const float d_nv = d_n2s[c] * inv_n + 2.0f * nv[c] * d_qn;
      d_bp[c] = d_bp[c] + d_nv;
      d_at2[10 + c] = d_at2[10 + c] - d_nv;
    }
  } else {
    for (int c = 0; c < 3; ++c) d_n2t[c] = d_n2[c];
  }
  for (int c = 0; c < 3; ++c) d_off[c] = d_bp[c];
  const float d_t2s = sd[0] * d_bp[0] + sd[1] * d_bp[1] + sd[2] * d_bp[2];
  for (int c = 0; c < 3; ++c) d_sd[c] = d_sd[c] + t2s * d_bp[c];
  const float d_t2 = sel(hit_geo, d_t2s);
  float d_t2p = d_t2;
  if (SPH && (GROUPED || is_sph)) {
    const float d_tsph = sel(is_sph, d_t2);
    d_t2p = sel(!is_sph, d_t2);
    const float d_t1 = sel(t1_ok, d_tsph);
    const float d_t2q = sel(!t1_ok, d_tsph);
    const float inv2a = 1.0f / (2.0f * a_q);
    float d_b_q = -(d_t1 + d_t2q) * inv2a;
    const float d_sq = (d_t2q - d_t1) * inv2a;
    float d_a_q = -(t1 * d_t1 + t2q * d_t2q) / a_q;
    const float d_disc = sel(posd, d_sq / (2.0f * sq));
    d_b_q = d_b_q + 2.0f * b_q * d_disc;
    d_a_q = d_a_q + (-4.0f * c_q * d_disc);
    const float d_c_q = -4.0f * a_q * d_disc;
    d_at2[13] = d_at2[13] + (-2.0f * rad * d_c_q);
    for (int c = 0; c < 3; ++c) {
      const float d_oc = 2.0f * oc[c] * d_c_q + 2.0f * sd[c] * d_b_q;
      d_sd[c] = d_sd[c] + 2.0f * oc[c] * d_b_q + 2.0f * sd[c] * d_a_q;
      d_off[c] = d_off[c] + d_oc;
      d_at2[10 + c] = d_at2[10 + c] - d_oc;
    }
  }
  const float d_num = d_t2p * inv_sden2;
  const float d_sden = -(t2p * inv_sden2) * d_t2p;
  const float d_den2 = sel(ok2, d_sden);
  d_at2[3] = d_at2[3] + d_num;
  for (int c = 0; c < 3; ++c) {
    d_off[c] = d_off[c] - n2t[c] * d_num;
    d_n2t[c] = d_n2t[c] + sd[c] * d_den2 - off[c] * d_num;
    d_sd[c] = d_sd[c] + n2t[c] * d_den2;
    d_at2[c] = d_at2[c] + d_n2t[c];
  }
}

// ---- strategy 1: the light rectangle, heuristic-weighted (run where the
// camera ray is on a surface and the light sample was reached)
template <bool GROUPED>
__device__ __noinline__ void strategy_light(const float* cs, const float* L,
                                            const float* tb, const float* gs,
                                            float s_per_f, float* d_cs, float* d_L) {
  const float* p3 = cs + CS_P;
  const float* nh3 = cs + CS_NH;
  ToLight tl;
  LpdfRes pl;
  BvRes bv;
  Ph3Res ph;
  float ld[3], b1[3], pdf_v1, raw_pc;
  to_light_fwd(L, cs + CS_OFF, tb[TAB_LU0], tb[TAB_LU1], ld, tl);
  const float pdf_l1 = lightpdf_fwd(L, p3, ld, pl);
  bv_fwd(cs, ld, b1, &pdf_v1, bv);
  const float pdf_c1 = cospdf_fwd(nh3, ld, &raw_pc);
  const float w1 = ph3_fwd(pdf_l1, pdf_c1, pdf_v1, s_per_f, ph);
  const float inv_pdf1 = 1.0f / pdf_l1;
  float d_w = 0.0f, d_invp = 0.0f, d_b1[3];
  for (int c = 0; c < 3; ++c) {
    const float g = gs[c];
    const float cpre = b1[c] * L[L_E + c] * inv_pdf1;
    d_w = d_w + cpre * g;
    const float d_cpre = w1 * g;
    d_b1[c] = L[L_E + c] * inv_pdf1 * d_cpre;
    d_L[L_E + c] = d_L[L_E + c] + b1[c] * inv_pdf1 * d_cpre;
    d_invp = d_invp + b1[c] * L[L_E + c] * d_cpre;
  }
  float d_pdf_l1 = -(inv_pdf1 * inv_pdf1) * d_invp;
  float d_pl, d_pc, d_pv;
  ph3_rev(ph, d_w, &d_pl, &d_pc, &d_pv);
  d_pdf_l1 = d_pdf_l1 + d_pl;
  float d_n_pc[3], d_d_pc[3], d_l[3], d_q[3], d_dir[3], d_ld[3], d_off[3];
  cospdf_rev(nh3, ld, raw_pc, d_pc, d_n_pc, d_d_pc);
  bv_rev(bv, cs, d_b1, d_pv, d_cs, d_l);
  lightpdf_rev(pl, L, d_pdf_l1, d_L, d_q, d_dir);
  for (int c = 0; c < 3; ++c) d_ld[c] = d_l[c] + d_d_pc[c] + d_dir[c];
  to_light_rev(tl, L, d_ld, d_L, d_off);
  for (int c = 0; c < 3; ++c) {
    d_cs[CS_P + c] = d_cs[CS_P + c] + d_q[c];
    d_cs[CS_NH + c] = d_cs[CS_NH + c] + d_n_pc[c];
    d_cs[CS_OFF + c] = d_cs[CS_OFF + c] + d_off[c];
  }
}

// ---- strategy 2: the cosine lobe (run where its ray hit the light, or
// geometry whose light sample was reached)
template <bool SPH, bool GROUPED>
__device__ __noinline__ void strategy_cosine(const float* cs, const float* L,
                                             const float* tb, const float* at2,
                                             const float* gs, float s_per_f,
                                             float* d_cs, float* d_L, float* d_at) {
  const float* p3 = cs + CS_P;
  const float* nh3 = cs + CS_NH;
  const float* t3 = cs + CS_T;
  const float* b3 = cs + CS_B;
  const float w0 = tb[TAB_W0C], w1c = tb[TAB_W1C], cth = tb[TAB_CTH];
  NormRes rcd;
  LpdfRes pl;
  BvRes bv;
  Ph3Res ph;
  float cd[3], b2[3], pdf_v, raw_pc;
  norm3_fwd(t3[0] * w0 + b3[0] * w1c + nh3[0] * cth, t3[1] * w0 + b3[1] * w1c + nh3[1] * cth,
            t3[2] * w0 + b3[2] * w1c + nh3[2] * cth, 1e-12f, cd, rcd);
  const float pdf_c = cospdf_fwd(nh3, cd, &raw_pc);
  const float pdf_l = lightpdf_fwd(L, p3, cd, pl);
  bv_fwd(cs, cd, b2, &pdf_v, bv);
  const float w_c = ph3_fwd(pdf_c, pdf_l, pdf_v, s_per_f, ph);
  float d_off[3], d_b2[3], d_cd[3], d_pdf_self, d_w;
  bounce_fwd_rev<SPH, GROUPED>(cs, L, at2, cd, pdf_c, w_c, tb[TAB_CSU0], tb[TAB_CSU1], b2, gs,
                      d_L, d_at, d_off, d_b2, d_cd, &d_pdf_self, &d_w);
  float d_p1, d_p2, d_p3v;
  ph3_rev(ph, d_w, &d_p1, &d_p2, &d_p3v);
  const float d_pdf_c = d_pdf_self + d_p1;
  float d_l[3], d_q[3], d_dir[3], d_n_pc[3], d_d_pc[3], d_raw[3];
  bv_rev(bv, cs, d_b2, d_p3v, d_cs, d_l);
  lightpdf_rev(pl, L, d_p2, d_L, d_q, d_dir);
  cospdf_rev(nh3, cd, raw_pc, d_pdf_c, d_n_pc, d_d_pc);
  for (int c = 0; c < 3; ++c) d_cd[c] = d_cd[c] + d_l[c] + d_dir[c] + d_d_pc[c];
  norm3_rev(rcd, d_cd[0], d_cd[1], d_cd[2], d_raw);
  for (int c = 0; c < 3; ++c) {
    d_cs[CS_OFF + c] = d_cs[CS_OFF + c] + d_off[c];
    d_cs[CS_NH + c] = d_cs[CS_NH + c] + (d_n_pc[c] + cth * d_raw[c]);
    d_cs[CS_P + c] = d_cs[CS_P + c] + d_q[c];
    d_cs[CS_T + c] = d_cs[CS_T + c] + w0 * d_raw[c];
    d_cs[CS_B + c] = d_cs[CS_B + c] + w1c * d_raw[c];
  }
}

// ---- strategy 3: the GGX visible-normal lobe (the same gate)
template <bool SPH, bool GROUPED>
__device__ __noinline__ void strategy_vndf(const float* cs, const float* L,
                                           const float* tb, const float* at2,
                                           const float* gs, float s_per_f, float* d_cs,
                                           float* d_L, float* d_at) {
  const float* d3 = cs + CS_D;
  const float* p3 = cs + CS_P;
  const float* nh3 = cs + CS_NH;
  const float* t3 = cs + CS_T;
  const float* b3 = cs + CS_B;
  const float* ve3 = cs + CS_VE;
  const float* t1v = cs + CS_T1;
  const float* t2v = cs + CS_T2;
  const float alpha = cs[CS_ALPHA];
  const float k0 = tb[TAB_K0V], k1 = tb[TAB_K1V], vct = tb[TAB_VCT];
  NormRes rh, rnl, rwh;
  LpdfRes pl;
  BvRes bv;
  Ph3Res ph;
  float h3[3], nl3[3], wh3[3], vd[3], b2v[3], pdf_v2, raw_pc;
  norm3_fwd(t1v[0] * k0 + t2v[0] * k1 + ve3[0] * vct,
            t1v[1] * k0 + t2v[1] * k1 + ve3[1] * vct,
            t1v[2] * k0 + t2v[2] * k1 + ve3[2] * vct, 1e-12f, h3, rh);
  const float mz = fmaxf(h3[2], 0.0f);
  norm3_fwd(alpha * h3[0], alpha * h3[1], mz, 1e-12f, nl3, rnl);
  norm3_fwd(t3[0] * nl3[0] + b3[0] * nl3[1] + nh3[0] * nl3[2],
            t3[1] * nl3[0] + b3[1] * nl3[1] + nh3[1] * nl3[2],
            t3[2] * nl3[0] + b3[2] * nl3[1] + nh3[2] * nl3[2], 1e-12f, wh3, rwh);
  const float ddh = d3[0] * wh3[0] + d3[1] * wh3[1] + d3[2] * wh3[2];
  for (int c = 0; c < 3; ++c) vd[c] = d3[c] - 2.0f * ddh * wh3[c];
  bv_fwd(cs, vd, b2v, &pdf_v2, bv);
  const float pdf_l2 = lightpdf_fwd(L, p3, vd, pl);
  const float pdf_c2 = cospdf_fwd(nh3, vd, &raw_pc);
  const float w_v = ph3_fwd(pdf_v2, pdf_l2, pdf_c2, s_per_f, ph);
  float d_off[3], d_b2[3], d_vd[3], d_pdf_self, d_w;
  bounce_fwd_rev<SPH, GROUPED>(cs, L, at2, vd, pdf_v2, w_v, tb[TAB_VSU0], tb[TAB_VSU1], b2v, gs,
                      d_L, d_at, d_off, d_b2, d_vd, &d_pdf_self, &d_w);
  float d_p1, d_p2, d_p3v;
  ph3_rev(ph, d_w, &d_p1, &d_p2, &d_p3v);
  const float d_pdf_v2 = d_pdf_self + d_p1;
  float d_n_pc[3], d_d_pc[3], d_q[3], d_dir[3], d_l[3];
  cospdf_rev(nh3, vd, raw_pc, d_p3v, d_n_pc, d_d_pc);
  lightpdf_rev(pl, L, d_p2, d_L, d_q, d_dir);
  bv_rev(bv, cs, d_b2, d_pdf_v2, d_cs, d_l);
  for (int c = 0; c < 3; ++c) d_vd[c] = d_vd[c] + d_d_pc[c] + d_dir[c] + d_l[c];
  // vd = d - 2 ddh wh, ddh = d.wh
  const float d_ddh = -2.0f * (wh3[0] * d_vd[0] + wh3[1] * d_vd[1] + wh3[2] * d_vd[2]);
  float d_wh[3], d_dl[3], d_whraw[3], d_nraw[3], d_hraw[3];
  for (int c = 0; c < 3; ++c) {
    d_wh[c] = -2.0f * ddh * d_vd[c] + d3[c] * d_ddh;
    d_dl[c] = d_vd[c] + wh3[c] * d_ddh;
  }
  norm3_rev(rwh, d_wh[0], d_wh[1], d_wh[2], d_whraw);
  const float d_nlx = t3[0] * d_whraw[0] + t3[1] * d_whraw[1] + t3[2] * d_whraw[2];
  const float d_nly = b3[0] * d_whraw[0] + b3[1] * d_whraw[1] + b3[2] * d_whraw[2];
  const float d_nlz = nh3[0] * d_whraw[0] + nh3[1] * d_whraw[1] + nh3[2] * d_whraw[2];
  norm3_rev(rnl, d_nlx, d_nly, d_nlz, d_nraw);
  d_cs[CS_ALPHA] = d_cs[CS_ALPHA] + (h3[0] * d_nraw[0] + h3[1] * d_nraw[1]);
  norm3_rev(rh, alpha * d_nraw[0], alpha * d_nraw[1], sel(h3[2] >= 0.0f, d_nraw[2]),
            d_hraw);
  for (int c = 0; c < 3; ++c) {
    d_cs[CS_T1 + c] = d_cs[CS_T1 + c] + k0 * d_hraw[c];
    d_cs[CS_T2 + c] = d_cs[CS_T2 + c] + k1 * d_hraw[c];
    d_cs[CS_VE + c] = d_cs[CS_VE + c] + vct * d_hraw[c];
    d_cs[CS_T + c] = d_cs[CS_T + c] + nl3[0] * d_whraw[c];
    d_cs[CS_B + c] = d_cs[CS_B + c] + nl3[1] * d_whraw[c];
    d_cs[CS_OFF + c] = d_cs[CS_OFF + c] + d_off[c];
    d_cs[CS_D + c] = d_cs[CS_D + c] + d_dl[c];
    d_cs[CS_NH + c] = d_cs[CS_NH + c] + (d_n_pc[c] + nl3[2] * d_whraw[c]);
    d_cs[CS_P + c] = d_cs[CS_P + c] + d_q[c];
  }
}

// ---- the sample-invariant stage (cuda_mis_bwd._fwd_hoist / _rev_hoist)
struct HoistRes {
  float s, t, d[3];
  NormRes rd;
  bool ok;
  float inv_sden, tt_p;
  bool is_sph, posd, t1_ok, sel;
  float oc[3], rad, a_q, b_q, c_q, sq, t1, t2;
  float t_safe, nv[3], qn, inv_n;
  float nh[3], ax, ay, an;
  NormRes rtg;
  float tg[3], bt[3], v[3], alpha, vtx, vtb;
  NormRes rve;
  float ve[3];
  NormRes rt1;
  float t1v[3], cndv_raw, cndv, argv, csqv;
  G1Res rg;
};

// The camera ray from the 12 camera scalars and the jitter, its hit from the
// recorded winner's column `at` (plane, or sphere), the basis, the VNDF view
// frame, the offset origin and the camera-material invariants: cs[44].  Run
// on lanes whose camera ray landed on a surface.
template <bool SPH, bool GROUPED>
__device__ __noinline__ void hoist_fwd(const float* at, const float* cam, float px,
                                       float py, float jx, float jy, float fW, float fH,
                                       float* cs, HoistRes& r) {
  const float* pos = cam;
  r.s = ((px + jx) / fW) * 2.0f - 1.0f;
  r.t = -(((py + jy) / fH) * 2.0f - 1.0f);
  norm3_fwd(r.s * cam[3] + r.t * cam[6] - cam[9], r.s * cam[4] + r.t * cam[7] - cam[10],
            r.s * cam[5] + r.t * cam[8] - cam[11], 1e-12f, r.d, r.rd);
  const float* d = r.d;
  const float den = d[0] * at[0] + d[1] * at[1] + d[2] * at[2];
  r.ok = fabsf(den) >= 1e-12f;
  const float sden = r.ok ? den : 1.0f;
  r.inv_sden = 1.0f / sden;
  r.tt_p = (at[3] - (pos[0] * at[0] + pos[1] * at[1] + pos[2] * at[2])) / sden;
  float tt = r.tt_p;
  r.is_sph = false;
  if (SPH) {
    r.is_sph = at[14] > 0.5f;
    for (int c = 0; c < 3; ++c) r.oc[c] = pos[c] - at[10 + c];
    r.rad = at[13];
    r.a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    r.b_q = 2.0f * (r.oc[0] * d[0] + r.oc[1] * d[1] + r.oc[2] * d[2]);
    r.c_q = (r.oc[0] * r.oc[0] + r.oc[1] * r.oc[1] + r.oc[2] * r.oc[2]) - r.rad * r.rad;
    const float disc = r.b_q * r.b_q - 4.0f * r.a_q * r.c_q;
    r.posd = disc > 0.0f;
    r.sq = sqrtf(r.posd ? disc : 1.0f);
    r.t1 = (-r.b_q - r.sq) / (2.0f * r.a_q);
    r.t2 = (-r.b_q + r.sq) / (2.0f * r.a_q);
    r.t1_ok = (r.t1 > RAY_TMIN) && (r.t1 < RAY_TMAX);
    if (r.is_sph) tt = r.t1_ok ? r.t1 : r.t2;
  }
  r.t_safe = tt;
  float p[3];
  for (int c = 0; c < 3; ++c) { p[c] = pos[c] + d[c] * r.t_safe; r.nh[c] = at[c]; }
  r.sel = false;
  if (SPH) {
    r.sel = r.is_sph;
    for (int c = 0; c < 3; ++c) r.nv[c] = p[c] - at[10 + c];
    r.qn = r.nv[0] * r.nv[0] + r.nv[1] * r.nv[1] + r.nv[2] * r.nv[2];
    r.inv_n = 1.0f / sqrtf(fmaxf(r.qn, 1e-6f));
    if (r.sel) for (int c = 0; c < 3; ++c) r.nh[c] = r.nv[c] * r.inv_n;
  }
  const float* nh = r.nh;
  const float met = at[7], rgh = at[8];
  const bool use_y = fabsf(nh[0]) > 0.9f;
  r.ax = use_y ? 0.0f : 1.0f;
  r.ay = use_y ? 1.0f : 0.0f;
  r.an = r.ax * nh[0] + r.ay * nh[1];
  norm3_fwd(r.ax - r.an * nh[0], r.ay - r.an * nh[1], -r.an * nh[2], 1e-12f, r.tg, r.rtg);
  r.bt[0] = nh[1] * r.tg[2] - nh[2] * r.tg[1];
  r.bt[1] = nh[2] * r.tg[0] - nh[0] * r.tg[2];
  r.bt[2] = nh[0] * r.tg[1] - nh[1] * r.tg[0];
  for (int c = 0; c < 3; ++c) r.v[c] = -d[c];
  r.alpha = rgh * rgh;
  r.vtx = r.v[0] * r.tg[0] + r.v[1] * r.tg[1] + r.v[2] * r.tg[2];
  r.vtb = r.v[0] * r.bt[0] + r.v[1] * r.bt[1] + r.v[2] * r.bt[2];
  const float vtn = r.v[0] * nh[0] + r.v[1] * nh[1] + r.v[2] * nh[2];
  norm3_fwd(r.alpha * r.vtx, r.alpha * r.vtb, vtn, 1e-12f, r.ve, r.rve);
  norm3_fwd(r.ve[2], r.ve[2] * 0.0f, -r.ve[0], 1e-12f, r.t1v, r.rt1);
  r.cndv_raw = nh[0] * r.v[0] + nh[1] * r.v[1] + nh[2] * r.v[2];
  r.cndv = fabsf(r.cndv_raw) + 1e-5f;
  const float comm = 1.0f - met;
  r.argv = (-r.cndv * r.alpha + r.cndv) * r.cndv + r.alpha;
  r.csqv = sqrtf(fmaxf(r.argv, 1e-12f));
  const float vndv = fabsf(r.cndv_raw);
  const float g1v = g1_fwd(vndv, rgh, r.rg);
  for (int c = 0; c < 3; ++c) {
    cs[CS_D + c] = d[c];
    cs[CS_P + c] = p[c];
    cs[CS_NH + c] = nh[c];
    cs[CS_DF + c] = at[4 + c];
    cs[CS_T + c] = r.tg[c];
    cs[CS_B + c] = r.bt[c];
    cs[CS_VE + c] = r.ve[c];
    cs[CS_T1 + c] = r.t1v[c];
    cs[CS_OFF + c] = p[c] + nh[c] * 1e-4f;
    cs[CS_V + c] = r.v[c];
    cs[CS_F0 + c] = 0.04f * comm + at[4 + c] * met;
  }
  cs[CS_T2] = r.ve[1] * r.t1v[2] - r.ve[2] * r.t1v[1];
  cs[CS_T2 + 1] = r.ve[2] * r.t1v[0] - r.ve[0] * r.t1v[2];
  cs[CS_T2 + 2] = r.ve[0] * r.t1v[1] - r.ve[1] * r.t1v[0];
  cs[CS_MET] = met;
  cs[CS_RGH] = rgh;
  cs[CS_ALPHA] = r.alpha;
  cs[CS_CNDV] = r.cndv;
  cs[CS_CSQV] = r.csqv;
  cs[CS_OMM] = comm;
  cs[CS_G1] = g1v;
  cs[CS_VNDV] = vndv;
}

// Reverse: the 44 accumulated cotangents d_cs to the winner's column d_at
// [NDIF] and the camera's d_cam [12].
template <bool SPH, bool GROUPED>
__device__ __noinline__ void hoist_rev(const HoistRes& r, const float* at,
                                       const float* cam, const float* d_cs,
                                       float* d_at, float* d_cam) {
  const float* pos = cam;
  const float* nh = r.nh;
  const float* d3 = r.d;
  const float met = at[7], rgh = at[8];
  float d_p[3], d_nh[3], d_v[3], d_df[3];
  for (int c = 0; c < 3; ++c) {
    d_p[c] = d_cs[CS_P + c] + d_cs[CS_OFF + c];
    d_nh[c] = d_cs[CS_NH + c] + 1e-4f * d_cs[CS_OFF + c];
  }
  float d_vndv_g, d_rgh_g;
  g1_rev(r.rg, d_cs[CS_G1], &d_vndv_g, &d_rgh_g);
  const float d_vndv = d_cs[CS_VNDV] + d_vndv_g;
  float d_rgh = d_cs[CS_RGH] + d_rgh_g;
  const float d_argv = sel(r.argv >= 1e-12f, 0.5f * (1.0f / r.csqv) * d_cs[CS_CSQV]);
  const float d_cndv = d_cs[CS_CNDV] + 2.0f * r.cndv * (1.0f - r.alpha) * d_argv;
  float d_alpha = d_cs[CS_ALPHA] + (1.0f - r.cndv * r.cndv) * d_argv;
  float d_comm = d_cs[CS_OMM];
  float d_met = d_cs[CS_MET];
  for (int c = 0; c < 3; ++c) d_df[c] = d_cs[CS_DF + c];
  for (int c = 0; c < 3; ++c) {
    const float d_f0 = d_cs[CS_F0 + c];
    d_comm = d_comm + 0.04f * d_f0;
    d_df[c] = d_df[c] + met * d_f0;
    d_met = d_met + at[4 + c] * d_f0;
  }
  d_met = d_met - d_comm;
  const float d_craw = sgn(r.cndv_raw) * (d_cndv + d_vndv);
  for (int c = 0; c < 3; ++c) {
    d_v[c] = d_cs[CS_V + c] + nh[c] * d_craw;
    d_nh[c] = d_nh[c] + r.v[c] * d_craw;
  }
  // t2v = ve x t1v
  const float* d_t2 = d_cs + CS_T2;
  float d_ve[3], d_t1[3];
  d_ve[0] = d_cs[CS_VE] + (r.t1v[1] * d_t2[2] - r.t1v[2] * d_t2[1]);
  d_ve[1] = d_cs[CS_VE + 1] + (r.t1v[2] * d_t2[0] - r.t1v[0] * d_t2[2]);
  d_ve[2] = d_cs[CS_VE + 2] + (r.t1v[0] * d_t2[1] - r.t1v[1] * d_t2[0]);
  d_t1[0] = d_cs[CS_T1] + (d_t2[1] * r.ve[2] - d_t2[2] * r.ve[1]);
  d_t1[1] = d_cs[CS_T1 + 1] + (d_t2[2] * r.ve[0] - d_t2[0] * r.ve[2]);
  d_t1[2] = d_cs[CS_T1 + 2] + (d_t2[0] * r.ve[1] - d_t2[1] * r.ve[0]);
  float d_r1[3], d_rv[3];
  norm3_rev(r.rt1, d_t1[0], d_t1[1], d_t1[2], d_r1);
  d_ve[2] = d_ve[2] + d_r1[0];
  d_ve[0] = d_ve[0] - d_r1[2];
  norm3_rev(r.rve, d_ve[0], d_ve[1], d_ve[2], d_rv);
  d_alpha = d_alpha + (r.vtx * d_rv[0] + r.vtb * d_rv[1]);
  const float d_vtx = r.alpha * d_rv[0];
  const float d_vtb = r.alpha * d_rv[1];
  const float d_vtn = d_rv[2];
  float d_tg[3], d_bt[3], d_d[3];
  for (int c = 0; c < 3; ++c) {
    d_v[c] = d_v[c] + r.tg[c] * d_vtx + r.bt[c] * d_vtb + nh[c] * d_vtn;
    d_tg[c] = d_cs[CS_T + c] + r.v[c] * d_vtx;
    d_bt[c] = d_cs[CS_B + c] + r.v[c] * d_vtb;
    d_nh[c] = d_nh[c] + r.v[c] * d_vtn;
  }
  d_rgh = d_rgh + 2.0f * rgh * d_alpha;
  for (int c = 0; c < 3; ++c) d_d[c] = d_cs[CS_D + c] - d_v[c];
  // bt = nh x tg
  d_nh[0] = d_nh[0] + (r.tg[1] * d_bt[2] - r.tg[2] * d_bt[1]);
  d_nh[1] = d_nh[1] + (r.tg[2] * d_bt[0] - r.tg[0] * d_bt[2]);
  d_nh[2] = d_nh[2] + (r.tg[0] * d_bt[1] - r.tg[1] * d_bt[0]);
  d_tg[0] = d_tg[0] + (d_bt[1] * nh[2] - d_bt[2] * nh[1]);
  d_tg[1] = d_tg[1] + (d_bt[2] * nh[0] - d_bt[0] * nh[2]);
  d_tg[2] = d_tg[2] + (d_bt[0] * nh[1] - d_bt[1] * nh[0]);
  // tg = norm3(a - an nh), an = a.nh
  float d_tr[3];
  norm3_rev(r.rtg, d_tg[0], d_tg[1], d_tg[2], d_tr);
  const float d_an = -(nh[0] * d_tr[0] + nh[1] * d_tr[1] + nh[2] * d_tr[2]);
  for (int c = 0; c < 3; ++c) d_nh[c] = d_nh[c] - r.an * d_tr[c];
  d_nh[0] = d_nh[0] + r.ax * d_an;
  d_nh[1] = d_nh[1] + r.ay * d_an;
  float d_nt[3], d_center[3] = {0.0f, 0.0f, 0.0f};
  if (SPH) {
    float d_ns[3];
    for (int c = 0; c < 3; ++c) {
      d_nt[c] = sel(!r.sel, d_nh[c]);
      d_ns[c] = sel(r.sel, d_nh[c]);
    }
    const float d_inv_n = r.nv[0] * d_ns[0] + r.nv[1] * d_ns[1] + r.nv[2] * d_ns[2];
    const float d_qn = sel(r.qn >= 1e-6f, -0.5f * r.inv_n * r.inv_n * r.inv_n * d_inv_n);
    for (int c = 0; c < 3; ++c) {
      const float d_nv = d_ns[c] * r.inv_n + 2.0f * r.nv[c] * d_qn;
      d_p[c] = d_p[c] + d_nv;
      d_center[c] = d_center[c] - d_nv;
    }
  } else {
    for (int c = 0; c < 3; ++c) d_nt[c] = d_nh[c];
  }
  // p = pos + d t_safe
  float d_o[3];
  for (int c = 0; c < 3; ++c) d_o[c] = d_p[c];
  const float d_tt = d3[0] * d_p[0] + d3[1] * d_p[1] + d3[2] * d_p[2];
  for (int c = 0; c < 3; ++c) d_d[c] = d_d[c] + r.t_safe * d_p[c];
  float d_ttp = d_tt, d_rad = 0.0f;
  if (SPH) {
    const float d_tsph = sel(r.is_sph, d_tt);
    d_ttp = sel(!r.is_sph, d_tt);
    const float d_t1s = sel(r.t1_ok, d_tsph);
    const float d_t2s = sel(!r.t1_ok, d_tsph);
    const float inv2a = 1.0f / (2.0f * r.a_q);
    float d_b_q = -(d_t1s + d_t2s) * inv2a;
    const float d_sq = (d_t2s - d_t1s) * inv2a;
    float d_a_q = -(r.t1 * d_t1s + r.t2 * d_t2s) / r.a_q;
    const float d_disc = sel(r.posd, d_sq / (2.0f * r.sq));
    d_b_q = d_b_q + 2.0f * r.b_q * d_disc;
    d_a_q = d_a_q + (-4.0f * r.c_q * d_disc);
    const float d_c_q = -4.0f * r.a_q * d_disc;
    d_rad = -2.0f * r.rad * d_c_q;
    for (int c = 0; c < 3; ++c) {
      const float d_oc = 2.0f * r.oc[c] * d_c_q + 2.0f * d3[c] * d_b_q;
      d_d[c] = d_d[c] + 2.0f * r.oc[c] * d_b_q + 2.0f * d3[c] * d_a_q;
      d_o[c] = d_o[c] + d_oc;
      d_center[c] = d_center[c] - d_oc;
    }
  }
  // tt_p = (c0 - pos.nt) / sden, den = d.nt
  const float d_num = d_ttp * r.inv_sden;
  const float d_den = sel(r.ok, -(r.tt_p * r.inv_sden) * d_ttp);
  for (int c = 0; c < 3; ++c) {
    d_o[c] = d_o[c] - at[c] * d_num;
    d_nt[c] = d_nt[c] + d3[c] * d_den - pos[c] * d_num;
    d_d[c] = d_d[c] + at[c] * d_den;
  }
  float d_r[3];
  norm3_rev(r.rd, d_d[0], d_d[1], d_d[2], d_r);
  for (int c = 0; c < 3; ++c) {
    d_cam[c] = d_o[c];
    d_cam[3 + c] = r.s * d_r[c];
    d_cam[6 + c] = r.t * d_r[c];
    d_cam[9 + c] = -d_r[c];
    d_at[c] = d_nt[c];
    d_at[4 + c] = d_df[c];
  }
  d_at[3] = d_num;
  d_at[7] = d_met;
  d_at[8] = d_rgh;
  d_at[9] = 0.0f;
  if (SPH) {
    for (int c = 0; c < 3; ++c) d_at[10 + c] = d_center[c];
    d_at[13] = d_rad;
    d_at[14] = 0.0f;
  }
}

// The grouped tier keeps a lane's per-item state in shared memory, not on
// the stack: the hoisted plane cs, its cotangent d_cs, the light's d_L and the
// two lobe winners' cotangent rows of the sample, NST floats a thread at an
// odd stride, so that the 32 lanes' words of one slot lie in 32 banks.
template <int NDIF>
struct State {
  static constexpr int CS = 0, D_CS = NCS, D_L = 2 * NCS, D_AT_C = D_L + NLIGHT,
                       D_AT_V = D_AT_C + NDIF, NST = D_AT_V + NDIF;
  static_assert(NST % 2 == 1, "the state's stride must be odd");
};

// One (pixel i, camera ray cr): the hoisted stage from the camera record, the
// samples' strategies from the sample records, the reverse of the hoisted
// stage; the table rows (the two lobe winners per sample, the camera winner
// after the loop) scattered into this warp's table `wtab` [P][NDIF], the
// camera's and light's cotangents written to ds[29].  `tab` is the [P][NDIF]
// parameter table (shared memory in the static tier, global in the grouped
// one), `stab` the staged [s_per][16] sample table, `cam` and `L` the 12
// camera and 17 light scalars.  Every lane of the warp calls it (the scatter
// shuffles); a lane past the range runs on with no live ray.  GLOBAL_TABLE:
// wtab lies in global memory, the lane's state at `state` (State<NDIF>) in
// shared memory, the scatter is reduce.cuh's warp_scatter_peers, and a
// __syncwarp after each scatter orders one leader's add before the next one's.
template <bool SPH, bool GLOBAL_TABLE>
__device__ __forceinline__ void mis_bwd_item(const BwdParams& p, const float* tab,
                                             const float* stab, const float* cam,
                                             const float* L, float* wtab, int i, int cr,
                                             int lane, float* ds, float* state) {
  constexpr int NDIF = SPH ? 15 : 10;
  using St = State<NDIF>;
  const int s_per = p.s_per;
  const size_t n = (size_t)p.n_local;
  const bool in_range = i < p.n_local;
  const int code_cam = in_range ? p.cam_rec[(size_t)cr * n + i] : 0;
  const bool cam_hit = code_cam > 0;
  const int pc_cam = cam_hit ? code_cam - 1 : 0;
  const float* at_cam = tab + NDIF * pc_cam;
  const bool isem = cam_hit && at_cam[9] > 0.5f;
  const bool surf = cam_hit && !isem;
  float g[3];
  for (int c = 0; c < 3; ++c) g[c] = in_range ? p.g[c * n + i] : 0.0f;

  // A camera ray on the light adds the emitted radiance.
  float d_L_own[GLOBAL_TABLE ? 1 : NLIGHT];
  float* d_L = GLOBAL_TABLE ? state + St::D_L : d_L_own;
  for (int k = 0; k < NLIGHT; ++k) d_L[k] = 0.0f;
  for (int c = 0; c < 3; ++c) d_L[L_E + c] = sel(cam_hit && isem, g[c]);

  float cs_own[GLOBAL_TABLE ? 1 : NCS], d_cs_own[GLOBAL_TABLE ? 1 : NCS];
  float* cs = GLOBAL_TABLE ? state + St::CS : cs_own;
  float* d_cs = GLOBAL_TABLE ? state + St::D_CS : d_cs_own;
  for (int k = 0; k < NCS; ++k) { cs[k] = 0.0f; d_cs[k] = 0.0f; }
  HoistRes hr;
  if (surf) {
    // hashRandom jitter: the literal 800 / 600 strides of the reference.
    const int rid = p.rid_base + i;
    const uint32_t xi = (uint32_t)(rid % p.width);
    const uint32_t yi = (uint32_t)(rid / p.width);
    const uint32_t sample_id = (yi * 800u + xi) * (uint32_t)cr;
    const float jx = __uint2float_rn(hash_u32(xi + yi * 800u + sample_id)) * INV_2_32;
    const float jy =
        __uint2float_rn(hash_u32(yi + xi * 600u + sample_id + 12345u)) * INV_2_32;
    hoist_fwd<SPH, GLOBAL_TABLE>(at_cam, cam, (float)xi, (float)yi, jx, jy, (float)p.width,
                   (float)p.height, cs, hr);
  }
  const float inv_s = (float)(1.0 / (double)s_per);
  const float s_per_f = (float)s_per;
  float gs[3];
  for (int c = 0; c < 3; ++c) gs[c] = sel(surf, g[c] * inv_s);

  for (int k = 0; k < s_per; ++k) {
    const float* tb = stab + TAB_ROWS * k;
    const int rec = surf ? p.samp_rec[((size_t)cr * s_per + k) * n + i] : 0;
    const int code_c = (rec >> REC_SHIFT_C) & REC_CODE_MASK;
    const int code_v = (rec >> REC_SHIFT_V) & REC_CODE_MASK;
    float d_at_c_own[GLOBAL_TABLE ? 1 : NDIF], d_at_v_own[GLOBAL_TABLE ? 1 : NDIF];
    float* d_at_c = GLOBAL_TABLE ? state + St::D_AT_C : d_at_c_own;
    float* d_at_v = GLOBAL_TABLE ? state + St::D_AT_V : d_at_v_own;
    for (int q = 0; q < NDIF; ++q) { d_at_c[q] = 0.0f; d_at_v[q] = 0.0f; }
    if (surf && (rec & 1)) strategy_light<GLOBAL_TABLE>(cs, L, tb, gs, s_per_f, d_cs, d_L);
    bool act_c = false, act_v = false;
    if (surf && code_c > 0) {
      const float* at = tab + NDIF * (code_c - 1);
      const bool on_light = at[9] > 0.5f;
      if (on_light || (rec & 2)) {
        strategy_cosine<SPH, GLOBAL_TABLE>(cs, L, tb, at, gs, s_per_f, d_cs, d_L, d_at_c);
        act_c = !on_light;
      }
    }
    if (surf && code_v > 0) {
      const float* at = tab + NDIF * (code_v - 1);
      const bool on_light = at[9] > 0.5f;
      if (on_light || (rec & 4)) {
        strategy_vndf<SPH, GLOBAL_TABLE>(cs, L, tb, at, gs, s_per_f, d_cs, d_L, d_at_v);
        act_v = !on_light;
      }
    }
    // A lobe ray on the light gives its winner no cotangent.
    if constexpr (GLOBAL_TABLE) {
      warp_scatter_peers<NDIF>(act_c, code_c - 1, d_at_c, St::NST, wtab, lane);
      __syncwarp();
      warp_scatter_peers<NDIF>(act_v, code_v - 1, d_at_v, St::NST, wtab, lane);
      __syncwarp();
    } else {
      warp_scatter_rows<NDIF>(__ballot_sync(grt::FULL_MASK, act_c), act_c, code_c - 1,
                              d_at_c, wtab, lane);
      warp_scatter_rows<NDIF>(__ballot_sync(grt::FULL_MASK, act_v), act_v, code_v - 1,
                              d_at_v, wtab, lane);
    }
  }

  // The grouped tier takes the camera winner's row in the cosine winner's slot.
  float d_at_cam_own[GLOBAL_TABLE ? 1 : NDIF];
  float* d_at_cam = GLOBAL_TABLE ? state + St::D_AT_C : d_at_cam_own;
  for (int q = 0; q < NDIF; ++q) d_at_cam[q] = 0.0f;
  for (int q = 0; q < NCAM; ++q) ds[q] = 0.0f;
  if (surf) hoist_rev<SPH, GLOBAL_TABLE>(hr, at_cam, cam, d_cs, d_at_cam, ds);
  if constexpr (GLOBAL_TABLE) {
    warp_scatter_peers<NDIF>(surf, pc_cam, d_at_cam, St::NST, wtab, lane);
    __syncwarp();
  } else {
    warp_scatter_rows<NDIF>(__ballot_sync(grt::FULL_MASK, surf), surf, pc_cam, d_at_cam,
                            wtab, lane);
  }
  for (int q = 0; q < NLIGHT; ++q) ds[NCAM + q] = d_L[q];
}

// 3 blocks per SM for the box scene, 2 with spheres (see the note at the top).
template <bool SPH>
__global__ void __launch_bounds__(BLOCK_THREADS, SPH ? 2 : 3)
    mis_bwd_kernel(const BwdParams p) {
  constexpr int NDIF = SPH ? 15 : 10;
  extern __shared__ float smem[];
  const int P = p.num_prims;
  const int s_per = p.s_per;
  float* s_tab = smem;                          // [P][NDIF]
  float* s_stab = s_tab + NDIF * P;             // [s_per][16]
  float* s_vec = s_stab + TAB_ROWS * s_per;     // camera 12, light 17
  float* s_wtab = s_vec + NSCAL;                // [WARPS][P][NDIF]
  float* s_wscal = s_wtab + WARPS * P * NDIF;   // [WARPS][NSCAL]

  for (int k = threadIdx.x; k < NDIF * P; k += blockDim.x) {
    const int q = k / NDIF, row = k - q * NDIF;
    s_tab[k] = p.table[row * P + q];
  }
  for (int k = threadIdx.x; k < TAB_ROWS * s_per; k += blockDim.x) {
    const int s = k / TAB_ROWS, row = k - s * TAB_ROWS;
    s_stab[k] = p.stab[row * s_per + s];
  }
  for (int k = threadIdx.x; k < NSCAL; k += blockDim.x) {
    s_vec[k] = k < NCAM ? p.cam[k] : p.light[k - NCAM];
  }
  for (int k = threadIdx.x; k < WARPS * P * NDIF; k += blockDim.x) s_wtab[k] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float ds[NSCAL];
  mis_bwd_item<SPH, false>(p, s_tab, s_stab, s_vec, s_vec + NCAM,
                           s_wtab + warp * P * NDIF, blockIdx.x * blockDim.x + threadIdx.x,
                           blockIdx.y, lane, ds, nullptr);

  // ---- block partial: scalars over the warp, then warps in index order
  for (int q = 0; q < NSCAL; ++q) {
    const float v = warp_sum(ds[q]);
    if (lane == 0) s_wscal[warp * NSCAL + q] = v;
  }
  __syncthreads();
  const int ntab_total = P * NDIF;
  float* out = p.partials
      + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (ntab_total + NSCAL);
  for (int k = threadIdx.x; k < ntab_total + NSCAL; k += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      v += k < ntab_total ? s_wtab[w * ntab_total + k]
                          : s_wscal[w * NSCAL + (k - ntab_total)];
    }
    out[k] = v;
  }
}

// The grouped tier: a persistent grid; warp w of the grid owns the table
// partials[w] = [P][NDIF] then 29 scalars, and walks the 32-item tiles w,
// w + (warps in the grid), ...  A tile is 32 neighbouring pixels of one camera
// ray: tile t holds camera ray t / ceil(n / 32) and the pixels from
// (t mod ceil(n / 32)) * 32.  p.table is the TRANSPOSED [P][NDIF] table, read
// from global memory; the sample table, camera and light are staged, and each
// thread's per-item state lies in shared memory.
template <bool SPH>
__global__ void __launch_bounds__(BLOCK_THREADS)
mis_bwd_grouped_kernel(const BwdParams p) {
  constexpr int NDIF = SPH ? 15 : 10;
  extern __shared__ float smem[];
  const int s_per = p.s_per;
  float* s_stab = smem;                         // [s_per][16]
  float* s_vec = s_stab + TAB_ROWS * s_per;     // camera 12, light 17
  float* s_state = s_vec + NSCAL;               // [BLOCK_THREADS][NST]
  for (int k = threadIdx.x; k < TAB_ROWS * s_per; k += blockDim.x) {
    const int s = k / TAB_ROWS, row = k - s * TAB_ROWS;
    s_stab[k] = p.stab[row * s_per + s];
  }
  for (int k = threadIdx.x; k < NSCAL; k += blockDim.x) {
    s_vec[k] = k < NCAM ? p.cam[k] : p.light[k - NCAM];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  const size_t row = (size_t)p.num_prims * NDIF + NSCAL;
  float* wtab = p.partials + (size_t)warp * row;
  for (size_t k = lane; k < row; k += 32) wtab[k] = 0.0f;
  __syncwarp();

  float ds[NSCAL];
  for (int q = 0; q < NSCAL; ++q) ds[q] = 0.0f;
  const int pixel_tiles = (p.n_local + 31) / 32;
  const int tiles = pixel_tiles * p.camera_rays;
  for (int tile = warp; tile < tiles; tile += n_warps) {
    const int cr = tile / pixel_tiles;
    float item[NSCAL];
    mis_bwd_item<SPH, true>(p, p.table, s_stab, s_vec, s_vec + NCAM, wtab,
                            (tile - cr * pixel_tiles) * 32 + lane, cr, lane, item,
                            s_state + threadIdx.x * State<NDIF>::NST);
    for (int q = 0; q < NSCAL; ++q) ds[q] += item[q];
  }
  for (int q = 0; q < NSCAL; ++q) {
    const float v = warp_sum(ds[q]);
    if (lane == 0) wtab[row - NSCAL + q] = v;
  }
}

// Shared memory of the static kernel: the parameter table, the sample table,
// camera and light, and the warps' tables and scalars.
size_t static_smem(int s_per, int num_prims, bool has_spheres) {
  const int ndif = has_spheres ? 15 : 10;
  return sizeof(float) * ((size_t)ndif * num_prims + (size_t)TAB_ROWS * s_per + NSCAL
                          + (size_t)WARPS * ((size_t)num_prims * ndif + NSCAL));
}


// Shared memory of the grouped kernel: the sample table, camera and light,
// and the threads' per-item state.
size_t grouped_smem(int s_per, bool has_spheres) {
  const int nst = has_spheres ? State<15>::NST : State<10>::NST;
  return sizeof(float) * ((size_t)TAB_ROWS * s_per + NSCAL + (size_t)BLOCK_THREADS * nst);
}

}  // namespace

extern "C" {

// Number of blocks mis_bwd_kernel runs for n_local pixels and camera_rays
// rays each: the wrapper sizes the partials buffer [blocks, P * ndif + 29].
int grt_mis_bwd_blocks(int n_local, int camera_rays) {
  return ((n_local + BLOCK_THREADS - 1) / BLOCK_THREADS) * camera_rays;
}

// Blocks of the grouped tier's persistent grid on the current device: the
// blocks the card holds at once, at most one per 128 (pixel, camera ray)
// items, and at most as many as keep the per-warp tables (WARPS x (num_prims
// * ndif + 29) floats each) within 1 GiB.  The wrapper sizes the partials
// [blocks * 4, ...] with it; 0 means the occupancy query failed.
int grt_mis_bwd_grouped_blocks(int n_local, int camera_rays, int s_per, int num_prims,
                               int has_spheres) {
  const size_t smem = grouped_smem(s_per, has_spheres != 0);
  const int tiles = ((n_local + 31) / 32) * camera_rays;
  const size_t row = (size_t)num_prims * (has_spheres ? 15 : 10) + NSCAL;
  return has_spheres ? grt::persistent_blocks(mis_bwd_grouped_kernel<true>,
                                              BLOCK_THREADS, smem, tiles, row)
                     : grt::persistent_blocks(mis_bwd_grouped_kernel<false>,
                                              BLOCK_THREADS, smem, tiles, row);
}

// Shared memory bytes of the static kernel (ops/cuda_mis_bwd.
// static_smem_bytes mirrors it).
int grt_mis_bwd_static_smem(int s_per, int num_prims, int has_spheres) {
  return (int)static_smem(s_per, num_prims, has_spheres != 0);
}

// Blocks of the static kernel one SM of the current device holds at that
// shared memory; 0 where the query fails.
int grt_mis_bwd_static_blocks_per_sm(int s_per, int num_prims, int has_spheres) {
  const size_t smem = static_smem(s_per, num_prims, has_spheres != 0);
  return has_spheres ? grt::blocks_per_sm(mis_bwd_kernel<true>, BLOCK_THREADS, smem)
                     : grt::blocks_per_sm(mis_bwd_kernel<false>, BLOCK_THREADS, smem);
}

// Shared memory bytes of the grouped kernel (ops/cuda_mis_bwd.
// grouped_smem_bytes mirrors it).
int grt_mis_bwd_grouped_smem(int s_per, int has_spheres) {
  return (int)grouped_smem(s_per, has_spheres != 0);
}

// Blocks of the grouped kernel one SM of the current device holds at that
// shared memory; 0 where the query fails.
int grt_mis_bwd_grouped_blocks_per_sm(int s_per, int has_spheres) {
  const size_t smem = grouped_smem(s_per, has_spheres != 0);
  return has_spheres
             ? grt::blocks_per_sm(mis_bwd_grouped_kernel<true>, BLOCK_THREADS, smem)
             : grt::blocks_per_sm(mis_bwd_grouped_kernel<false>, BLOCK_THREADS, smem);
}

// Launches mis_bwd_kernel (grouped == 0: table [ndif, P], partials
// [grt_mis_bwd_blocks, ...]) or mis_bwd_grouped_kernel (grouped == 1: table
// [P, ndif], partials [4 * blocks, ...] with blocks from
// grt_mis_bwd_grouped_blocks), then reduce_partials_kernel, on `stream`;
// returns cudaGetLastError() as an int.  out is [num_prims * ndif + 29]
// float32: dtab [P, ndif] row-major, then camera 12 and light 17.
int grt_mis_bwd(const float* g, const int32_t* cam_rec, const int32_t* samp_rec,
                const float* table, const float* cam, const float* light,
                const float* stab, float* partials, float* out, int n_local,
                int rid_base, int width, int height, int camera_rays, int s_per,
                int num_prims, int has_spheres, int grouped, int blocks, void* stream) {
  BwdParams p;
  p.g = g; p.cam_rec = cam_rec; p.samp_rec = samp_rec; p.table = table;
  p.cam = cam; p.light = light; p.stab = stab; p.partials = partials;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.camera_rays = camera_rays; p.s_per = s_per; p.num_prims = num_prims;
  if (n_local <= 0 || camera_rays <= 0 || s_per <= 0 || num_prims <= 0 || width <= 0
      || height <= 0 || rid_base < 0
      || (long long)rid_base + n_local > (long long)width * height) {
    return (int)cudaErrorInvalidValue;
  }
  const int ndif = has_spheres ? 15 : 10;
  const int count = num_prims * ndif + NSCAL;
  cudaStream_t st = (cudaStream_t)stream;
  if (grouped) {
    if (blocks <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = grouped_smem(s_per, has_spheres != 0);
    if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    const cudaError_t err = has_spheres ? grt::allow_smem(mis_bwd_grouped_kernel<true>, smem)
                                        : grt::allow_smem(mis_bwd_grouped_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    if (has_spheres) {
      mis_bwd_grouped_kernel<true><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    } else {
      mis_bwd_grouped_kernel<false><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    }
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
    grt::launch_reduce_partials(partials, blocks * WARPS, count, out, st);
    return (int)cudaGetLastError();
  }
  const size_t smem = static_smem(s_per, num_prims, has_spheres != 0);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const cudaError_t err = has_spheres ? grt::allow_smem(mis_bwd_kernel<true>, smem)
                                      : grt::allow_smem(mis_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_local + BLOCK_THREADS - 1) / BLOCK_THREADS, camera_rays);
  if (has_spheres) {
    mis_bwd_kernel<true><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else {
    mis_bwd_kernel<false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  }
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  grt::launch_reduce_partials(partials, grid.x * grid.y, count, out, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
