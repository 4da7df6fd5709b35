// CUDA kernels of the silhouette-gradient path for NVIDIA Hopper (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_soft.py).  Built like
// path_kernels.cu, WITHOUT --use_fast_math and WITH -fmad=false: the plain
// PyTorch versions run every multiply and add as its own rounded operation,
// and the records must hold the same decisions.
//
// ---------------------------------------------------------------------------
// silh_kernel      replaces  gpuraytracer_tpu/ops/pallas_soft.py:_silh_kernel
//                  (sphere scenes, at most 64 triangles)
// ---------------------------------------------------------------------------
// Per (sample, pixel): the discrete decisions of the two-layer soft composite
// of grad/diff_render.render_direct_soft, packed into one int32 (code2, the
// JAX package's layout; ops/cuda_soft.py spells it out): the triangle-only
// closest winner (the background layer) and its shadow bit, the closest
// sphere candidate (first minimum over the roots of the spheres the ray hits;
// sphere 0 when it hits none) and its layer's shadow bit, and the
// sphere_front / potential gates.  Records are [spp, N], pixel axis
// minor-most.  The camera ray divides by |r| (the JAX kernel's _camera_ray),
// the sphere layer's normal is floored at 1e-6.
//
// Bound on this card: OPERATIONS.  Per (sample, pixel) T closest-hit tests,
// S sphere tests and two shadow probes (n_shadow triangle and S sphere tests
// each, to the first occluder) against 4 B of record written.  Design:
//   * one thread per (sample, pixel) item, the pixel minor-most as the
//     records are: at path J 262,144 threads where one thread per pixel,
//     the samples looped inside it, ran 65,536 on 15.5 warps per SM (with
//     the probes below, the items took J's device time from 0.040 to 0.030
//     ms and the recovery's from 0.014 to 0.008; PERF.md).  A warp's record
//     store is one contiguous 128-byte line;
//   * the triangle table, the compacted occluder list and the spheres staged
//     once per block in shared memory (a warp reads one triangle from one
//     address: a broadcast);
//   * both shadow probes take trace.cuh's prefiltered any-hit loop at t_min
//     = 0 (any_triangle_filtered, as path_kernel's probe does): the divide
//     only where two exact conditions hold, and the loop ends at the first
//     occluder; the spheres are tested only where no triangle blocks, and
//     their loop ends at the first hit.  The same bits as testing every
//     occluder to its divide (trace.cuh proves the prefilters exact; the
//     probe's decision is an OR);
//   * the closest hit tests every triangle to its divide (closest_triangle),
//     blocks of 128 at ptxas' own occupancy: the prefiltered closest hit was
//     4 % slower at J and at the recovery (4 % faster at 800x600 x 16), a
//     minimum of 12 or 16 blocks per SM no faster (PERF.md).
//
// ---------------------------------------------------------------------------
// soft_bwd_kernel  replaces  gpuraytracer_tpu/ops/pallas_soft.py:_soft_bwd_kernel
// ---------------------------------------------------------------------------
// Replays the soft composite of every (pixel, sample) from its record and
// reverses it by hand (the JAX kernel takes an in-kernel jax.vjp; its tie
// rules are kept: d max(x, c) and d clip split 0.5 / 0.5 at a tie).  Inputs:
// the image cotangent g [3, N] already divided by spp, the records, the
// Halton offsets (camera jitter and the light sample are regenerated), the
// parameter table [16, P] (n, c0, diffuse, emissive, is_emissive | sphere
// center, radius, is_sphere), camera [12], light [9] (center, color, normal).
// Outputs dtab [P, 14] (d n, d c0, d diffuse, d emissive, d center, d radius)
// and the 21 scalars.  The composite: L = alpha Ls + (1 - alpha) Lt, alpha
// evaluating to sphere_front and differentiating as the sigmoid coverage on
// `potential` lanes; Ls is evaluated on every lane that needs it (with the
// normal at t = 1 and the point at the camera where the sphere is not in
// front: the reference's estimator).
//
// Bound on this card: OPERATIONS — a few hundred f32 operations per live
// (pixel, sample) against 4 B of record.  Design:
//   * one thread per (sample, pixel) item on a persistent grid: the blocks
//     the card holds at once (grt::persistent_blocks), at most one per four
//     32-item tiles; warp w of the grid takes the tiles w, w + (warps of the
//     grid), ... in that order.  The partials are one per resident block,
//     whatever the frame (the previous design, one thread per pixel with
//     the samples looped inside, ran 512 blocks at path J in two waves on 3
//     blocks per SM, and 3,750 partials at 800x600 x 16);
//   * compiled for 4 blocks of 128 per SM (BWD_MIN_BLOCKS: 128 registers
//     and 56 B of spills, 12-14 % faster at J than ptxas' own 3 blocks;
//     PERF.md);
//   * the table, camera and light staged once per block in shared memory,
//     the two attribute fetches indexed shared-memory reads, the background
//     one gated on the hit (a miss reads no row);
//   * per item the forward and its reverse in registers; work a lane does
//     not need is skipped (the sphere layer where neither front nor
//     potential, its reverse where not front, the background's reverse where
//     the sphere is in front or the probe was blocked);
//   * sums in a FIXED order, without float atomics (reduce.cuh): each item's
//     two rows go to a per-warp table in shared memory, the lanes that share
//     a primitive summed first (scatter_row: a reduce-scatter of the ten
//     columns a row can fill, one round per distinct primitive of the
//     warp; at J a warp's lanes hold 1.5 distinct background and 1.1
//     sphere primitives, 22-24 lanes on one: the peer scatter of K3 took 43
//     % more time, the butterflies over ten or fourteen columns 2 or 8 %);
//     the 21 scalars accumulate in registers; per
//     block one partial; reduce_partials_kernel sums them in float64.  Two
//     launches on equal inputs give equal bits;
//   * the table and the per-warp tables take 4 (16 P + 21 + 4 (14 P + 21))
//     B of shared memory: 55,428 B at the most primitives the silhouette
//     path takes (64 triangles and 127 spheres, P = 191), opted in above
//     48 KiB; 4 blocks of it fit an SM.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "halton.cuh"
#include "reduce.cuh"
#include "trace.cuh"

namespace {

using grt::camera_jitter;
using grt::closest_triangle;
using grt::GEO_ROWS;
using grt::halton;
using grt::any_triangle_filtered;
using grt::SPH_ROWS;
using grt::sphere_roots;
using grt::warp_sum;

constexpr float BIG = 1e30f;
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr int ISEM_ROW = 15;    // is_emissive row of the packed triangle table
constexpr int BLOCK_THREADS = 128;
constexpr int WARPS = BLOCK_THREADS / 32;
// Blocks per SM that soft_bwd_kernel is compiled for (PERF.md: 128 registers
// and 56 B of spills at 4, against ptxas' own 142 registers at 3; 5 spill
// 288 B and are slower).
constexpr int BWD_MIN_BLOCKS = 4;
// The most primitives the silhouette path takes: 64 triangles (the static
// tier) and 127 spheres (s* + 1 fills the code's 7 bits above bit 24).
constexpr int MAX_PRIMS = 64 + 127;
constexpr int NROWS = 16;       // parameter table rows
constexpr int NTAB = 14;        // cotangent columns
constexpr int NSCAL = 21;       // camera 12 | light center, color, normal
constexpr unsigned FULL = grt::FULL_MASK;

constexpr int B_OCCB = 1 << 20;
constexpr int B_OCCS = 1 << 21;
constexpr int B_FRONT = 1 << 22;
constexpr int B_POT = 1 << 23;
constexpr int SIDX_SHIFT = 24;

// Parameter table rows ([rows, P] in global memory, [P, rows] in shared).
constexpr int R_N = 0, R_C0 = 3, R_DF = 4, R_EM = 7, R_ISEM = 10;
constexpr int R_SC = 11, R_RAD = 14;

// ---------------------------------------------------------------------------
// silh_kernel
// ---------------------------------------------------------------------------

struct SilhParams {
  const int32_t* offsets;     // [n] Halton index offset per pixel
  const float* cam;           // [12] position, u*half_w, v*half_h, w
  const float* light;         // [6] center xyz, color rgb
  const float* tri;           // [19, T] packed triangle rows
  const float* sph;           // [11, S] packed sphere rows (first 4: geometry)
  const int32_t* shadow_idx;  // [n_shadow] triangles kept in the shadow probes
  int32_t* codes;             // [spp, n]
  int n, width, height, spp, num_tris, num_spheres, n_shadow, strat_k;
  float inv_k, half_extent;
};

// Shadow bit of the light sample (half-extent square about the light center,
// draws w0, w1 in [-1, 1)) seen from h: any hit in (0, dist - 1e-3) over the
// occluder list (prefiltered, to the first occluder) and, where none blocks,
// the spheres (to the first hit).
__device__ __forceinline__ bool light_blocked(const float* s_shadow, int n_shadow,
                                              const float* s_sph, int S,
                                              const float* lc, float he, float w0,
                                              float w1, float hx, float hy, float hz) {
  const float tlx = lc[0] + he * w0 - hx;
  const float tly = lc[1] - hy;
  const float tlz = lc[2] + he * w1 - hz;
  const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 0.0f));
  const float inv_d = 1.0f / fmaxf(dist, 1e-3f);
  const float ldx = tlx * inv_d, ldy = tly * inv_d, ldz = tlz * inv_d;
  const float t_max = dist - 1e-3f;
  if (any_triangle_filtered(s_shadow, n_shadow, hx, hy, hz, ldx, ldy, ldz, 0.0f, t_max)) {
    return true;
  }
  for (int k = 0; k < S; ++k) {
    float t1, t2;
    const bool pos = sphere_roots(s_sph + SPH_ROWS * k, hx, hy, hz, ldx, ldy, ldz, &t1,
                                  &t2);
    if (pos && (((t1 > 0.0f) && (t1 < t_max)) || ((t2 > 0.0f) && (t2 < t_max)))) {
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(BLOCK_THREADS) silh_kernel(const SilhParams p) {
  extern __shared__ float4 smem4[];
  const int T = p.num_tris, S = p.num_spheres, NS = p.n_shadow;
  float* s_geo = reinterpret_cast<float*>(smem4);   // [T][12]
  float* s_shadow = s_geo + GEO_ROWS * T;           // [n_shadow][12]
  float* s_sph = s_shadow + GEO_ROWS * NS;          // [S][4]
  float* s_isem = s_sph + SPH_ROWS * S;             // [T]
  for (int k = threadIdx.x; k < GEO_ROWS * T; k += blockDim.x) {
    const int t = k / GEO_ROWS, r = k - t * GEO_ROWS;
    s_geo[k] = p.tri[r * T + t];
  }
  for (int k = threadIdx.x; k < GEO_ROWS * NS; k += blockDim.x) {
    const int j = k / GEO_ROWS, r = k - j * GEO_ROWS;
    s_shadow[k] = p.tri[r * T + p.shadow_idx[j]];
  }
  for (int k = threadIdx.x; k < SPH_ROWS * S; k += blockDim.x) {
    const int s = k / SPH_ROWS, r = k - s * SPH_ROWS;
    s_sph[k] = p.sph[r * S + s];
  }
  for (int k = threadIdx.x; k < T; k += blockDim.x) {
    s_isem[k] = p.tri[ISEM_ROW * T + k];
  }
  __syncthreads();

  // Item n * N + i: sample n of pixel i, the record's own index.
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= p.n * p.spp) return;
  const int n = item / p.n;
  const int i = item - n * p.n;
  const float px = (float)(i % p.width);
  const float py = (float)(i / p.width);
  const float fW = (float)p.width, fH = (float)p.height;
  const uint32_t off = (uint32_t)p.offsets[i];
  const float* cam = p.cam;
  const float* lc = p.light;
  const float he = p.half_extent;

  const uint32_t ih = off + (uint32_t)n;
  float jx, jy;
  camera_jitter(ih, p.spp, p.strat_k, p.inv_k, &jx, &jy);
  const float s = ((px + jx) / fW) * 2.0f - 1.0f;
  const float t = -(((py + jy) / fH) * 2.0f - 1.0f);
  const float rx = s * cam[3] + t * cam[6] - cam[9];
  const float ry = s * cam[4] + t * cam[7] - cam[10];
  const float rz = s * cam[5] + t * cam[8] - cam[11];
  const float rn = sqrtf(rx * rx + ry * ry + rz * rz);
  const float dx = rx / rn, dy = ry / rn, dz = rz / rn;
  const float ox = cam[0], oy = cam[1], oz = cam[2];

  // ---- background: triangle-only closest hit, index order, strict <
  float t_bg = BIG;
  int prim_bg = -1;
  closest_triangle(s_geo, T, ox, oy, oz, dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_bg,
                   &prim_bg);
  const bool bg_hit = t_bg < BIG * 0.5f;

  // ---- sphere candidate: first minimum of the masked roots
  int s_idx = 0;
  float t_s = 0.0f, masked_b = BIG;
  bool valid_b = false;
  for (int k = 0; k < S; ++k) {
    float t1, t2;
    const bool pos = sphere_roots(s_sph + SPH_ROWS * k, ox, oy, oz, dx, dy, dz,
                                  &t1, &t2);
    const bool t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
    const bool t2_ok = (t2 > RAY_TMIN) && (t2 < RAY_TMAX);
    const float tt = t1_ok ? t1 : t2;
    const bool valid = pos && (t1_ok || t2_ok);
    const float masked = valid ? tt : BIG;
    if (k == 0 || masked < masked_b) {
      masked_b = masked; valid_b = valid; t_s = tt; s_idx = k;
    }
  }
  const bool front = valid_b && (t_s < t_bg);
  const float* sc = s_sph + SPH_ROWS * s_idx;
  const float t_ca = (sc[0] - ox) * dx + (sc[1] - oy) * dy + (sc[2] - oz) * dz;
  const bool pot = (t_ca > RAY_TMIN) && (t_ca < t_bg);

  const float w0 = halton(ih, 2) * 2.0f - 1.0f;
  const float w1 = halton(ih, 3) * 2.0f - 1.0f;

  // ---- sphere layer probe: normal at where(front, t_s, 1), point at
  // where(front, t_s, 0)
  const float ts_n = front ? t_s : 1.0f;
  const float ts_p = front ? t_s : 0.0f;
  const float tox = (ox + dx * ts_n) - sc[0];
  const float toy = (oy + dy * ts_n) - sc[1];
  const float toz = (oz + dz * ts_n) - sc[2];
  const float inv_n = 1.0f / sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-6f));
  const bool occ_s = light_blocked(
      s_shadow, NS, s_sph, S, lc, he, w0, w1, ox + dx * ts_p + (tox * inv_n) * 1e-3f,
      oy + dy * ts_p + (toy * inv_n) * 1e-3f, oz + dz * ts_p + (toz * inv_n) * 1e-3f);

  // ---- background probe from the winner's plane normal (zero on a miss)
  float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, b_isem = 0.0f;
  if (bg_hit) {
    const float* g = s_geo + GEO_ROWS * prim_bg;
    bnx = g[0]; bny = g[1]; bnz = g[2];
    b_isem = s_isem[prim_bg];
  }
  const bool tri_surf = bg_hit && (b_isem < 0.5f);
  const float tb_p = tri_surf ? t_bg : 0.0f;
  const bool occ_b = light_blocked(s_shadow, NS, s_sph, S, lc, he, w0, w1,
                                   ox + dx * tb_p + bnx * 1e-3f,
                                   oy + dy * tb_p + bny * 1e-3f,
                                   oz + dz * tb_p + bnz * 1e-3f);

  p.codes[item] =
      (prim_bg + 1) + (occ_b ? B_OCCB : 0) + (occ_s ? B_OCCS : 0)
      + (front ? B_FRONT : 0) + (pot ? B_POT : 0) + ((s_idx + 1) << SIDX_SHIFT);
}

// ---------------------------------------------------------------------------
// soft_bwd_kernel
// ---------------------------------------------------------------------------

struct SoftParams {
  const float* g;             // [3, n] image cotangent / spp
  const int32_t* codes;       // [spp, n]
  const int32_t* offsets;     // [n]
  const float* table;         // [16, P]
  const float* cam;           // [12]
  const float* light;         // [9]
  float* partials;            // [blocks, P * 14 + 21]
  int n, width, height, spp, num_prims, num_tris, strat_k;
  float inv_k, half_extent, kappa;
};

// d max(x, c) / dx and d clip(x, 0, 1) / dx under JAX's tie rule.
__device__ __forceinline__ float gmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float gclip01(float x) {
  const float y = fmaxf(x, 0.0f);
  return gmax(x, 0.0f) * (y < 1.0f ? 1.0f : (y == 1.0f ? 0.5f : 0.0f));
}

// What the reverse of one layer's light sample needs.
struct Shade {
  float tl[3], ld[3];
  float q, dist, inv_d, cl_raw, cs_raw, cos_l, cos_s, inv_d2, base;
};

// Next-event estimation at the offset point h with normal nrm and diffuse
// df (ops/cuda_soft._shade_fwd): out = (color * base) * df.
__device__ __forceinline__ void shade_fwd(Shade& r, const float* h, const float* nrm,
                                          const float* df, bool occ, const float* lv,
                                          float w0, float w1, float he, float* out) {
  r.tl[0] = (lv[0] + he * w0) - h[0];
  r.tl[1] = lv[1] - h[1];
  r.tl[2] = (lv[2] + he * w1) - h[2];
  r.q = r.tl[0] * r.tl[0] + r.tl[1] * r.tl[1] + r.tl[2] * r.tl[2];
  r.dist = sqrtf(fmaxf(r.q, 0.0f));
  r.inv_d = 1.0f / fmaxf(r.dist, 1e-3f);
  for (int k = 0; k < 3; ++k) r.ld[k] = r.tl[k] * r.inv_d;
  r.cl_raw = -(r.ld[0] * lv[6] + r.ld[1] * lv[7] + r.ld[2] * lv[8]);
  r.cs_raw = nrm[0] * r.ld[0] + nrm[1] * r.ld[1] + nrm[2] * r.ld[2];
  r.cos_l = fminf(fmaxf(r.cl_raw, 0.0f), 1.0f);
  r.cos_s = fminf(fmaxf(r.cs_raw, 0.0f), 1.0f);
  r.inv_d2 = r.inv_d * r.inv_d;
  r.base = ((r.inv_d2 * r.cos_l) * r.cos_s) * (occ ? 0.0f : 1.0f);
  for (int c = 0; c < 3; ++c) out[c] = (lv[3 + c] * r.base) * df[c];
}

// Reverse of shade_fwd on a lane that is not occluded (ops/cuda_soft._shade_rev):
// d_h, d_n, d_df out; the light's cotangents added to d_lv[9].
__device__ __forceinline__ void shade_rev(const Shade& r, const float* nrm,
                                          const float* df, const float* lv,
                                          const float* d_out, float* d_lv, float* d_h,
                                          float* d_n, float* d_df) {
  float d_lb[3];
  for (int c = 0; c < 3; ++c) {
    d_df[c] = d_out[c] * (lv[3 + c] * r.base);
    d_lb[c] = d_out[c] * df[c];
    d_lv[3 + c] += d_lb[c] * r.base;
  }
  const float d_base = (d_lb[0] * lv[3] + d_lb[1] * lv[4]) + d_lb[2] * lv[5];
  const float ic = r.inv_d2 * r.cos_l;
  const float d_ic = d_base * r.cos_s;
  const float d_cos_s = d_base * ic;
  const float d_invd2 = d_ic * r.cos_l;
  const float d_cos_l = d_ic * r.inv_d2;
  float d_invd = 2.0f * r.inv_d * d_invd2;
  const float d_cs = gclip01(r.cs_raw) * d_cos_s;
  const float d_cl = gclip01(r.cl_raw) * d_cos_l;
  float d_ld[3], d_tl[3];
  for (int k = 0; k < 3; ++k) {
    d_n[k] = r.ld[k] * d_cs;
    d_ld[k] = nrm[k] * d_cs - lv[6 + k] * d_cl;
    d_lv[6 + k] -= r.ld[k] * d_cl;
    d_tl[k] = r.inv_d * d_ld[k];
  }
  d_invd = d_invd + ((r.tl[0] * d_ld[0] + r.tl[1] * d_ld[1]) + r.tl[2] * d_ld[2]);
  const float d_md = -(d_invd * (r.inv_d * r.inv_d));
  const float d_dist = gmax(r.dist, 1e-3f) * d_md;
  const float d_q = gmax(r.q, 0.0f) * (r.dist > 0.0f ? d_dist / (2.0f * r.dist) : 0.0f);
  for (int k = 0; k < 3; ++k) {
    d_tl[k] = d_tl[k] + (2.0f * r.tl[k]) * d_q;
    d_lv[k] += d_tl[k];
    d_h[k] = -d_tl[k];
  }
}

// One sample of one pixel: the composite from its record, forward and
// reversed (ops/cuda_soft._soft_forward and _soft_sample_rev, operation for
// operation).  Adds the camera's and light's cotangents to ds[21]; fills the
// background row (primitive *key_bg, when *act_bg) and the sphere row.
__device__ __forceinline__ void soft_sample(
    const SoftParams& p, const float* __restrict__ s_tab, const float* cam,
    const float* lv, int code, uint32_t ih, float px, float py, const float* g,
    float* ds, float* row_bg, bool* act_bg, int* key_bg, float* row_s, bool* act_s,
    int* key_s) {
  const int P = p.num_prims;
  const int prim_bg = (code & (B_OCCB - 1)) - 1;
  const bool occ_b = (code & B_OCCB) != 0;
  const bool occ_s = (code & B_OCCS) != 0;
  const bool front = (code & B_FRONT) != 0;
  const bool pot = (code & B_POT) != 0;
  const int s_idx = (code >> SIDX_SHIFT) - 1;
  const bool bg_hit = prim_bg >= 0;
  const float he = p.half_extent;

  // ---- camera ray and the light sample's draws
  float jx, jy;
  camera_jitter(ih, p.spp, p.strat_k, p.inv_k, &jx, &jy);
  const float s = ((px + jx) / (float)p.width) * 2.0f - 1.0f;
  const float t = -(((py + jy) / (float)p.height) * 2.0f - 1.0f);
  float rv[3];
  for (int k = 0; k < 3; ++k) rv[k] = s * cam[3 + k] + t * cam[6 + k] - cam[9 + k];
  const float rn = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  const float d[3] = {rv[0] / rn, rv[1] / rn, rv[2] / rn};
  const float o[3] = {cam[0], cam[1], cam[2]};
  const float w0 = halton(ih, 2) * 2.0f - 1.0f;
  const float w1 = halton(ih, 3) * 2.0f - 1.0f;

  // ---- sphere layer (candidate s*), where front or potential needs it
  const float* at_s = s_tab + NROWS * min(max(p.num_tris + s_idx, 0), P - 1);
  const float sc[3] = {at_s[R_SC], at_s[R_SC + 1], at_s[R_SC + 2]};
  const float srad = at_s[R_RAD];
  const float sdf[3] = {at_s[R_DF], at_s[R_DF + 1], at_s[R_DF + 2]};
  float ls[3] = {0.0f, 0.0f, 0.0f};
  float oc[3], to[3], ns[3], hs[3];
  float a_q = 1.0f, b_q = 0.0f, c_q = 0.0f, sq = 1.0f, t1 = 0.0f, t2 = 0.0f;
  float ts_safe = 1.0f, ts_p = 0.0f, qq = 1.0f, mq = 1.0f, inv_n = 1.0f;
  bool posd = false, t1_ok = false;
  Shade sh_s;
  if (front || pot) {
    for (int k = 0; k < 3; ++k) oc[k] = o[k] - sc[k];
    a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    b_q = 2.0f * (oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]);
    c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - srad * srad;
    const float disc = b_q * b_q - 4.0f * a_q * c_q;
    posd = disc > 0.0f;
    sq = sqrtf(posd ? disc : 1.0f);
    t1 = (-b_q - sq) / (2.0f * a_q);
    t2 = (-b_q + sq) / (2.0f * a_q);
    t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
    ts_safe = front ? (t1_ok ? t1 : t2) : 1.0f;
    for (int k = 0; k < 3; ++k) to[k] = (o[k] + d[k] * ts_safe) - sc[k];
    qq = to[0] * to[0] + to[1] * to[1] + to[2] * to[2];
    mq = fmaxf(qq, 1e-6f);
    inv_n = 1.0f / sqrtf(mq);
    ts_p = front ? ts_safe : 0.0f;
    for (int k = 0; k < 3; ++k) {
      ns[k] = to[k] * inv_n;
      hs[k] = (o[k] + d[k] * ts_p) + ns[k] * 1e-3f;
    }
    shade_fwd(sh_s, hs, ns, sdf, occ_s, lv, w0, w1, he, ls);
    for (int c = 0; c < 3; ++c) ls[c] = ls[c] + at_s[R_EM + c];
  }

  // ---- background (triangle) layer; a miss reads no row and shows black
  float lt[3] = {0.0f, 0.0f, 0.0f};
  float bn[3] = {0.0f, 0.0f, 0.0f}, bdf[3] = {0.0f, 0.0f, 0.0f}, hb[3];
  float sden = 1.0f, t_bg = 0.0f;
  bool ok = false, em_show = false;
  Shade sh_b;
  if (bg_hit) {
    const float* at_bg = s_tab + NROWS * min(prim_bg, P - 1);
    for (int k = 0; k < 3; ++k) { bn[k] = at_bg[R_N + k]; bdf[k] = at_bg[R_DF + k]; }
    em_show = at_bg[R_ISEM] > 0.5f;
    const float den = d[0] * bn[0] + d[1] * bn[1] + d[2] * bn[2];
    ok = fabsf(den) >= 1e-12f;
    sden = ok ? den : 1.0f;
    t_bg = (at_bg[R_C0] - (o[0] * bn[0] + o[1] * bn[1] + o[2] * bn[2])) / sden;
    if (em_show) {
      for (int c = 0; c < 3; ++c) lt[c] = at_bg[R_EM + c];
    } else {
      for (int k = 0; k < 3; ++k) hb[k] = (o[k] + d[k] * t_bg) + bn[k] * 1e-3f;
      shade_fwd(sh_b, hb, bn, bdf, occ_b, lv, w0, w1, he, lt);
    }
  }

  float d_o[3] = {0.0f, 0.0f, 0.0f}, d_d[3] = {0.0f, 0.0f, 0.0f};
  float d_sc[3] = {0.0f, 0.0f, 0.0f}, d_srad = 0.0f;
  float d_sdf[3] = {0.0f, 0.0f, 0.0f};

  // ---- coverage: alpha = front + (alpha_soft - its detached value)
  if (pot) {
    float soc[3];
    for (int k = 0; k < 3; ++k) soc[k] = sc[k] - o[k];
    const float t_ca = soc[0] * d[0] + soc[1] * d[1] + soc[2] * d[2];
    const float hm =
        (soc[0] * soc[0] + soc[1] * soc[1] + soc[2] * soc[2]) - t_ca * t_ca;
    const float h = sqrtf(fmaxf(hm, 1e-12f));
    const float kr = p.kappa * srad;
    const float z = (srad - h) / kr;
    const float sig = 1.0f / (1.0f + expf(-z));
    const float dal = ((g[0] * ls[0] + g[1] * ls[1]) + g[2] * ls[2])
                      - ((g[0] * lt[0] + g[1] * lt[1]) + g[2] * lt[2]);
    const float d_z = dal * (sig * (1.0f - sig));
    const float d_num = d_z / kr;
    const float d_kr = -(d_z * z) / kr;
    d_srad = d_srad + (d_num + p.kappa * d_kr);
    const float d_hm = gmax(hm, 1e-12f) * (((-d_num) * 0.5f) / h);
    const float d_tca = (-2.0f * t_ca) * d_hm;
    for (int k = 0; k < 3; ++k) {
      const float d_soc = (2.0f * soc[k]) * d_hm + d[k] * d_tca;
      d_d[k] = d_d[k] + soc[k] * d_tca;
      d_sc[k] = d_sc[k] + d_soc;
      d_o[k] = d_o[k] - d_soc;
    }
  }

  // ---- sphere layer reversed: dL/dLs = front
  if (front) {
    float d_hs[3] = {0.0f, 0.0f, 0.0f}, d_ns[3] = {0.0f, 0.0f, 0.0f};
    if (!occ_s) shade_rev(sh_s, ns, sdf, lv, g, ds + 12, d_hs, d_ns, d_sdf);
    for (int k = 0; k < 3; ++k) {
      d_o[k] = d_o[k] + d_hs[k];
      d_d[k] = d_d[k] + ts_p * d_hs[k];
      d_ns[k] = d_ns[k] + 1e-3f * d_hs[k];
    }
    const float d_tsp = (d[0] * d_hs[0] + d[1] * d_hs[1]) + d[2] * d_hs[2];
    float d_to[3];
    for (int k = 0; k < 3; ++k) d_to[k] = inv_n * d_ns[k];
    const float d_invn = (to[0] * d_ns[0] + to[1] * d_ns[1]) + to[2] * d_ns[2];
    const float d_qq = gmax(qq, 1e-6f) * (d_invn * ((-0.5f * inv_n) / mq));
    for (int k = 0; k < 3; ++k) {
      d_to[k] = d_to[k] + (2.0f * to[k]) * d_qq;
      d_sc[k] = d_sc[k] - d_to[k];
      d_o[k] = d_o[k] + d_to[k];
      d_d[k] = d_d[k] + ts_safe * d_to[k];
    }
    const float d_ts = d_tsp + ((d[0] * d_to[0] + d[1] * d_to[1]) + d[2] * d_to[2]);
    const float d_t1 = t1_ok ? d_ts : 0.0f;
    const float d_t2 = t1_ok ? 0.0f : d_ts;
    const float inv2a = 1.0f / (2.0f * a_q);
    float d_b = -(d_t1 + d_t2) * inv2a;
    const float d_sq = (d_t2 - d_t1) * inv2a;
    float d_a = -(t1 * d_t1 + t2 * d_t2) / a_q;
    const float d_disc = posd ? d_sq / (2.0f * sq) : 0.0f;
    d_b = d_b + (2.0f * b_q) * d_disc;
    d_a = d_a + (-4.0f * c_q) * d_disc;
    const float d_c = (-4.0f * a_q) * d_disc;
    for (int k = 0; k < 3; ++k) {
      const float d_oc = (2.0f * oc[k]) * d_c + (2.0f * d[k]) * d_b;
      d_d[k] = d_d[k] + ((2.0f * oc[k]) * d_b + (2.0f * d[k]) * d_a);
      d_o[k] = d_o[k] + d_oc;
      d_sc[k] = d_sc[k] - d_oc;
    }
    d_srad = d_srad + (-2.0f * srad) * d_c;
  }

  // ---- background layer reversed: dL/dLt = 1 - front
  for (int k = 0; k < NTAB; ++k) row_bg[k] = 0.0f;
  *act_bg = !front && bg_hit;
  *key_bg = min(max(prim_bg, 0), P - 1);
  if (*act_bg) {
    if (em_show) {
      for (int c = 0; c < 3; ++c) row_bg[R_EM + c] = g[c];
    } else if (!occ_b) {
      float d_hb[3], d_bn[3], d_bdf[3];
      shade_rev(sh_b, bn, bdf, lv, g, ds + 12, d_hb, d_bn, d_bdf);
      for (int k = 0; k < 3; ++k) {
        d_o[k] = d_o[k] + d_hb[k];
        d_d[k] = d_d[k] + t_bg * d_hb[k];
        d_bn[k] = d_bn[k] + 1e-3f * d_hb[k];
      }
      const float d_tbp = (d[0] * d_hb[0] + d[1] * d_hb[1]) + d[2] * d_hb[2];
      const float d_num_b = d_tbp / sden;
      const float d_den = ok ? -(t_bg * d_tbp) / sden : 0.0f;
      for (int k = 0; k < 3; ++k) {
        d_o[k] = d_o[k] - bn[k] * d_num_b;
        d_bn[k] = d_bn[k] - o[k] * d_num_b;
        d_d[k] = d_d[k] + bn[k] * d_den;
        d_bn[k] = d_bn[k] + d[k] * d_den;
        row_bg[R_N + k] = d_bn[k];
        row_bg[R_DF + k] = d_bdf[k];
      }
      row_bg[R_C0] = d_num_b;
    }
  }

  // ---- camera ray: d = r / |r|, o = position
  const float sdot = (d[0] * d_d[0] + d[1] * d_d[1]) + d[2] * d_d[2];
  for (int k = 0; k < 3; ++k) {
    const float d_r = (d_d[k] - d[k] * sdot) / rn;
    ds[k] += d_o[k];
    ds[3 + k] += s * d_r;
    ds[6 + k] += t * d_r;
    ds[9 + k] -= d_r;
  }

  // ---- the sphere row: d diffuse, d emissive, d center, d radius
  *act_s = front || pot;
  *key_s = min(max(p.num_tris + s_idx, 0), P - 1);
  for (int k = 0; k < 4; ++k) row_s[k] = 0.0f;
  for (int c = 0; c < 3; ++c) {
    row_s[R_DF + c] = d_sdf[c];
    row_s[R_EM + c] = front ? g[c] : 0.0f;
    row_s[10 + c] = d_sc[c];
  }
  row_s[13] = d_srad;
}

// One step of scatter_row's reduce-scatter: the lane holds M partial sums
// s[0 .. M) of the columns lo .. lo + M (those at len and above hold none);
// the lanes of each pair OFF apart keep half of them each, the lower lane
// the first H = ceil(M / 2), the upper the rest, and add the partner's.
template <int M, int OFF>
__device__ __forceinline__ void halve(float* s, int lane, int* lo, int* len) {
  constexpr int H = (M + 1) / 2;
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float rest = H + j < M ? s[H + j] : 0.0f;  // the upper half's slot j
    const float got = __shfl_xor_sync(FULL, upper ? s[j] : rest, OFF);
    s[j] = (upper ? rest : s[j]) + got;
  }
  if (upper) {
    *lo += H;
    *len = max(*len - H, 0);
  } else {
    *len = min(*len, H);
  }
}

// Adds columns C0 .. C0 + 10 of row (the ten a row can fill: the background
// row's n, c0, diffuse, emissive; the sphere row's diffuse, emissive, center,
// radius) of every lane with `act` to table[key * NTAB + ...], one key at a
// time in the order of the lowest lane that holds it: the lanes that share
// the key reduce-scatter their rows in five steps of 5, 3, 2, 1 and 1
// shuffles, after which ten lanes each hold one column's sum and add it.
// `rem` is __ballot_sync(FULL, act).  Every lane of the warp must call it.
template <int C0>
__device__ __forceinline__ void scatter_row(unsigned rem, bool act, int key,
                                            const float* row, float* table, int lane) {
  while (rem != 0u) {
    const int leader = __ffs(rem) - 1;
    const int k = __shfl_sync(FULL, key, leader);
    const bool mine = act && (key == k);
    rem &= ~__ballot_sync(FULL, mine);
    float s[10];
    for (int c = 0; c < 10; ++c) s[c] = mine ? row[C0 + c] : 0.0f;
    int lo = 0, len = 10;
    halve<10, 16>(s, lane, &lo, &len);
    halve<5, 8>(s, lane, &lo, &len);
    halve<3, 4>(s, lane, &lo, &len);
    halve<2, 2>(s, lane, &lo, &len);
    halve<1, 1>(s, lane, &lo, &len);
    if (len > 0) table[k * NTAB + C0 + lo] += s[0];
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, BWD_MIN_BLOCKS)
soft_bwd_kernel(const SoftParams p) {
  extern __shared__ float smem[];
  const int P = p.num_prims;
  float* s_tab = smem;                          // [P][16]
  float* s_vec = s_tab + NROWS * P;             // camera 12, light 9
  float* s_wtab = s_vec + NSCAL;                // [WARPS][P][14]
  float* s_wscal = s_wtab + WARPS * P * NTAB;   // [WARPS][21]
  for (int k = threadIdx.x; k < NROWS * P; k += blockDim.x) {
    const int q = k / NROWS, row = k - q * NROWS;
    s_tab[k] = p.table[row * P + q];
  }
  for (int k = threadIdx.x; k < NSCAL; k += blockDim.x) {
    s_vec[k] = k < 12 ? p.cam[k] : p.light[k - 12];
  }
  for (int k = threadIdx.x; k < WARPS * P * NTAB; k += blockDim.x) s_wtab[k] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* my_wtab = s_wtab + warp * P * NTAB;
  // Item n * N + i (sample n of pixel i, the records' order); warp w of the
  // grid takes the 32-item tiles w, w + n_warps, ...  A lane past the last
  // item runs on (the warp's shuffles need every lane) and adds nothing.
  const int items = p.n * p.spp;
  const int tiles = (items + 31) / 32;
  const int n_warps = gridDim.x * WARPS;
  float ds[NSCAL];
  for (int k = 0; k < NSCAL; ++k) ds[k] = 0.0f;
  for (int tile = blockIdx.x * WARPS + warp; tile < tiles; tile += n_warps) {
    const int item = tile * 32 + lane;
    const bool live = item < items;
    const int it = live ? item : 0;
    const int n = it / p.n;
    const int i = it - n * p.n;
    float row_bg[NTAB], row_s[NTAB];
    bool act_bg = false, act_s = false;
    int key_bg = 0, key_s = 0;
    if (live) {
      const float g[3] = {p.g[i], p.g[(size_t)p.n + i], p.g[2 * (size_t)p.n + i]};
      soft_sample(p, s_tab, s_vec, s_vec + 12, p.codes[it],
                  (uint32_t)p.offsets[i] + (uint32_t)n, (float)(i % p.width),
                  (float)(i / p.width), g, ds, row_bg, &act_bg, &key_bg, row_s, &act_s,
                  &key_s);
    }
    unsigned rem = __ballot_sync(FULL, act_bg);
    if (rem != 0u) scatter_row<R_N>(rem, act_bg, key_bg, row_bg, my_wtab, lane);
    rem = __ballot_sync(FULL, act_s);
    if (rem != 0u) scatter_row<R_DF>(rem, act_s, key_s, row_s, my_wtab, lane);
  }

  // ---- block partial: scalars over the warp, then warps in index order
  for (int k = 0; k < NSCAL; ++k) {
    const float v = warp_sum(ds[k]);
    if (lane == 0) s_wscal[warp * NSCAL + k] = v;
  }
  __syncthreads();
  const int ntab_total = P * NTAB;
  float* out = p.partials + (size_t)blockIdx.x * (ntab_total + NSCAL);
  for (int k = threadIdx.x; k < ntab_total + NSCAL; k += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      v += k < ntab_total ? s_wtab[w * ntab_total + k]
                          : s_wscal[w * NSCAL + (k - ntab_total)];
    }
    out[k] = v;
  }
}

// Bytes of dynamic shared memory of one block of silh_kernel: the triangle
// table, the occluder list, the spheres and the triangles' is_emissive.
size_t silh_smem(int num_tris, int n_shadow, int num_spheres) {
  return sizeof(float) * ((size_t)GEO_ROWS * (num_tris + n_shadow)
                          + (size_t)SPH_ROWS * num_spheres + num_tris);
}

// Bytes of dynamic shared memory of one block of soft_bwd_kernel: the table
// [P][16], the 21 scalars, one [P][14] table and 21 scalars per warp.
size_t soft_bwd_smem(int num_prims) {
  return sizeof(float) * ((size_t)NROWS * num_prims + NSCAL
                          + (size_t)WARPS * ((size_t)num_prims * NTAB + NSCAL));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one block of silh_kernel (the wrapper's
// plan cuda_soft.silh_smem_bytes mirrors it).
int grt_silh_smem(int num_tris, int n_shadow, int num_spheres) {
  return (int)silh_smem(num_tris, n_shadow, num_spheres);
}

// Blocks of silh_kernel for n pixels at spp samples: one thread per item.
int grt_silh_blocks(int n, int spp) {
  return (int)(((long long)n * spp + BLOCK_THREADS - 1) / BLOCK_THREADS);
}

// Blocks of silh_kernel that one SM of the current device holds with the
// shared memory of these tables; 0 where the query fails.
int grt_silh_blocks_per_sm(int num_tris, int n_shadow, int num_spheres) {
  return grt::blocks_per_sm(silh_kernel, BLOCK_THREADS,
                            silh_smem(num_tris, n_shadow, num_spheres));
}

// Launches silh_kernel on `stream`; returns cudaGetLastError() as an int.
// codes is [spp, n] int32.
int grt_silh_records(const int32_t* offsets, const float* cam, const float* light,
                     const float* tri, const float* sph, const int32_t* shadow_idx,
                     int32_t* codes, int n, int width, int height, int spp,
                     int num_tris, int num_spheres, int n_shadow, int strat_k,
                     float inv_k, float half_extent, void* stream) {
  SilhParams p;
  p.offsets = offsets; p.cam = cam; p.light = light; p.tri = tri; p.sph = sph;
  p.shadow_idx = shadow_idx; p.codes = codes;
  p.n = n; p.width = width; p.height = height; p.spp = spp; p.num_tris = num_tris;
  p.num_spheres = num_spheres; p.n_shadow = n_shadow; p.strat_k = strat_k;
  p.inv_k = inv_k; p.half_extent = half_extent;
  if (n <= 0 || spp <= 0 || (long long)n * spp > INT32_MAX || num_spheres <= 0
      || num_spheres > 127) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = silh_smem(num_tris, n_shadow, num_spheres);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  silh_kernel<<<grt_silh_blocks(n, spp), BLOCK_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory of one block of soft_bwd_kernel (the
// wrapper's plan cuda_soft.soft_bwd_smem_bytes mirrors it).
int grt_soft_bwd_smem(int num_prims) { return (int)soft_bwd_smem(num_prims); }

// Blocks of soft_bwd_kernel that one SM of the current device holds with the
// shared memory of num_prims primitives; 0 where the query fails.
int grt_soft_bwd_blocks_per_sm(int num_prims) {
  return grt::blocks_per_sm(soft_bwd_kernel, BLOCK_THREADS, soft_bwd_smem(num_prims));
}

// Blocks of soft_bwd_kernel's persistent grid for n pixels at spp samples on
// the current device: the blocks the card holds at once, at most one per
// four 32-item tiles.  The wrapper sizes the partials [blocks, num_prims * 14
// + 21] with it and passes it to grt_soft_bwd; 0 means the occupancy query
// failed.
int grt_soft_bwd_blocks(int n, int spp, int num_prims) {
  if (n <= 0 || spp <= 0 || (long long)n * spp > INT32_MAX || num_prims <= 0
      || num_prims > MAX_PRIMS) {
    return 0;
  }
  const int tiles = (int)(((long long)n * spp + 31) / 32);
  return grt::persistent_blocks(soft_bwd_kernel, BLOCK_THREADS, soft_bwd_smem(num_prims),
                                tiles, (size_t)num_prims * NTAB + NSCAL);
}

// Launches soft_bwd_kernel on `blocks` blocks (grt_soft_bwd_blocks) and
// reduce_partials_kernel on `stream`; returns cudaGetLastError() as an int.
// out is [num_prims * 14 + 21] float32: dtab [P, 14] row-major, then the 21
// scalars.
int grt_soft_bwd(const float* g, const int32_t* codes, const int32_t* offsets,
                 const float* table, const float* cam, const float* light,
                 float* partials, float* out, int n, int width, int height, int spp,
                 int num_prims, int num_tris, int strat_k, float inv_k,
                 float half_extent, float kappa, int blocks, void* stream) {
  SoftParams p;
  p.g = g; p.codes = codes; p.offsets = offsets; p.table = table; p.cam = cam;
  p.light = light; p.partials = partials;
  p.n = n; p.width = width; p.height = height; p.spp = spp; p.num_prims = num_prims;
  p.num_tris = num_tris; p.strat_k = strat_k; p.inv_k = inv_k;
  p.half_extent = half_extent; p.kappa = kappa;
  if (n <= 0 || spp <= 0 || (long long)n * spp > INT32_MAX || num_tris <= 0
      || num_prims <= num_tris || num_prims > MAX_PRIMS || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = soft_bwd_smem(num_prims);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = grt::allow_smem(soft_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  soft_bwd_kernel<<<blocks, BLOCK_THREADS, smem, st>>>(p);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  grt::launch_reduce_partials(partials, blocks, num_prims * NTAB + NSCAL, out, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
