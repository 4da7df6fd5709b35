// CUDA backward kernel of the variant-B path tracer for NVIDIA Hopper (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_shade.py).  Built like
// path_kernels.cu, WITHOUT --use_fast_math and WITH -fmad=false, so that the
// path this kernel rebuilds from the records is the path the trace kernel
// took, operation for operation.
//
// ---------------------------------------------------------------------------
// shade_bwd_kernel  replaces  gpuraytracer_tpu/ops/pallas_shade.py:_shade_bwd_kernel
//                   (static tier: at most 64 triangles, plus analytic spheres;
//                   draws read from planes, or regenerated from the offsets)
// shade_bwd_grouped_kernel  replaces  the same kernel's grouped tier
//                   (grouped=True: any number of primitives up to the record
//                   encoding's limit; pallas_shade.py:174-205, 649-714)
// ---------------------------------------------------------------------------
// Inputs: the cotangent g [3, N] of the image (already scaled by 1/spp), the
// int32 records [spp, bounces, N] of the trace, the six draw planes or the
// per-pixel Halton offsets, and the differentiable parameter views: table
// [11 | 16, P] (n xyz, c0, diffuse, emissive, is_emissive | sphere center,
// radius, is_sphere), camera [12] (position, u * half_width, v * half_height,
// w), light [9] (center, color, normal).  Per (pixel, sample) it rebuilds the
// path from the records — camera ray, then per bounce the recorded
// primitive's plane distance or sphere quadratic, hit point, light sample,
// throughput, cosine direction — and walks the bounces in reverse,
// accumulating the cotangents of the table rows (dtab [P, 10 | 14]: d n, d c0,
// d diffuse, d emissive | d center, d radius) and of the 21 scalars (camera
// 12, light 9).  Visibility is piecewise constant: the records are constants.
//
// Bound on this card: OPERATIONS when the draws are regenerated, BYTES or
// OPERATIONS (close) when they are read — about 700 f32 operations per live
// (sample, bounce, pixel) against 4 B of record and 16 B of draws.  Design:
//   * one thread per pixel, samples looped inside the thread; table, camera
//     and light staged once per block in shared memory, the attribute fetch an
//     indexed shared-memory read;
//   * the forward sweep keeps, per bounce, only the ray at entry, the
//     throughput at entry and the four draws (13 floats, thread-local); the
//     reverse sweep rebuilds everything else of a bounce from them in
//     registers just before it reverses that bounce, so the cost is linear in
//     the bounce count and no residual planes exist;
//   * a lane whose path is dead at a bounce (after a miss or an emissive hit)
//     is skipped there — it adds nothing, rather than garbage times zero;
//   * the sums over all lanes are taken in a FIXED order, without float
//     atomics: the 21 scalars accumulate in registers over a thread's
//     samples; the table rows of a reversed bounce are summed over the lanes
//     of the warp that recorded the same primitive and added once to that
//     warp's own table (reduce.cuh), then per-block partials, a float64
//     second kernel.  Two launches on equal inputs give equal bits;
//   * that scatter was the larger part of the time (the previous design's
//     kernels without it: 0.80 of 1.32 ms at path D, 1.03 of 2.63 at K, 1.75
//     of 3.69 at L; PERF.md), one round of a ballot, a shuffle and ntab
//     five-shuffle sums per distinct primitive.  warp_scatter_peers groups
//     the lanes by __match_any_sync in one pass instead, each group's lowest
//     lane summing the rows the lanes staged in shared memory, in lane order.
//     Above bounce 0 a warp's lanes hit 8-21 primitives, and a reduce-scatter
//     round per primitive (12 or 15 shuffles, ntab lanes adding a column
//     each) was 16-76 % slower there; at bounce 0 they hit 1-7, and it was
//     no faster there (PERF.md);
//   * K3 on the box scene runs 5 blocks of 128 per SM (STATIC_MIN_BLOCKS:
//     9-15 % faster at D than ptxas' own 4), with spheres 4; K3g at ptxas'
//     own.
//
// The grouped tier runs the same per-pixel body (shade_pixel) with two
// changes, because its tables do not fit a block's shared memory (the static
// layout needs 4 (11P + 21 + 4 (10P + 21)) B: 204,828 B at P = 1,002):
//   * the attribute fetch is an indexed load from the [P][rows] table in
//     global memory (read-only path, L2-resident: 44 KB at 1,002 triangles,
//     563 KB at 12,802), made only for a bounce whose record is a hit; a
//     miss fetches nothing;
//   * the scatter keeps its fixed order without memory that grows with
//     pixels x P: a persistent grid of G blocks (resident blocks of the card,
//     capped at 768 MiB of tables), each warp owning one dense [P][ntab] + 21
//     table in global memory that it zeroes, walks the 32-pixel tiles w, w +
//     4G, w + 8G, ... in that order and adds to through warp_scatter_peers
//     (only its staging rows in shared memory); reduce_partials_kernel
//     then sums the 4G tables in float64 in table order.  No float atomics:
//     two launches on equal inputs give equal bits.  The tables cost 4G (P
//     ntab + 21) floats written twice and read once: at L (G = 393, 768 MiB)
//     about 0.29 ms of reduction and as much zeroing.  Tables that are
//     never zeroed, with one bit per row a warp holds and a reduction that
//     reads only marked rows, were slower (the bit tests cost the reduction
//     more than the bytes they save; PERF.md).  Bound as for the static tier.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "halton.cuh"
#include "reduce.cuh"

namespace {

using grt::camera_jitter;
using grt::bounce_draws;
using grt::warp_scatter_peers;
using grt::warp_sum;

constexpr int OCC_BIT = 1 << 20;
constexpr int BLOCK_THREADS = 128;
constexpr int WARPS = BLOCK_THREADS / 32;
constexpr int MAX_BOUNCES = 4;   // the Halton table has 24 bases: 2 + 5 * 3 + 3 < 24
constexpr int NSCAL = 21;        // pos, hu, hv, wb | light center, color, normal
constexpr unsigned FULL = grt::FULL_MASK;
// Blocks per SM that shade_bwd_kernel is compiled for: on the box scene 5
// (96 registers and 12 B of spills, against ptxas' own 109 registers and 4
// blocks: 9-15 % faster at path D); with spheres 4 (127 registers).
constexpr int STATIC_MIN_BLOCKS = 5;
constexpr int STATIC_MIN_BLOCKS_SPH = 4;
// K3g's grid keeps its per-warp tables within 768 MiB: at path L (512 KB a
// table) 393 blocks, about 3 per SM, where the 1 GiB of persistent_blocks
// gives 524: 2.33 against 2.44-2.46 ms, the kernel as fast and a quarter less
// to zero and to reduce; 512 MiB (2 blocks per SM) took 2.70 (PERF.md).
constexpr size_t GROUPED_TABLE_BYTES = (size_t)768 << 20;
// Floats between two lanes' staging rows for warp_scatter_peers: the table
// columns, rounded up to an odd count so that a warp's 32 words of one column
// fall in 32 banks.
template <bool SPH>
constexpr int STAGE = SPH ? 15 : 11;

// Table rows ([rows, P] in global memory, [P, rows] in shared memory).
constexpr int R_N = 0, R_C0 = 3, R_DF = 4, R_EM = 7, R_ISEM = 10;
constexpr int R_SC = 11, R_RAD = 14, R_ISSPH = 15;

struct ShadeParams {
  const float* g;             // [3, n_local] image cotangent / spp
  const int32_t* records;     // [spp, bounces, n_local]
  const float* nee0;          // draw planes (plane mode)
  const float* nee1;
  const float* cos0;
  const float* cos1;
  const float* jx;
  const float* jy;
  const int32_t* offsets;     // [n_local] Halton index offsets (RNG mode)
  const float* table;         // [nrows, P]
  const float* cam;           // [12]
  const float* light;         // [9]
  float* partials;            // [blocks, P * ntab + 21]
  int n_local, rid_base, width, height, spp, bounces, num_prims, strat_k;
  float inv_k, half_extent;
};

// What the reverse pass needs of one bounce, rebuilt from the ray at entry.
struct Bounce {
  int pc;
  bool hit, occ, is_em, surf, hit_light, contrib, ok;
  float tnx, tny, tnz, dfr, dfg, dfb;
  float sden, tt, ts;
  float nhx, nhy, nhz;
  // sphere branch
  bool is_sph, sel, pos_d, t1_ok, qn_ok;
  float ocx, ocy, ocz, srad, a_q, b_q, c_q, sq, t1, t2, t_ns, thx, thy, thz, inv_n;
  // light sample
  float hx, hy, hz, tlx, tly, tlz, dist, invd, cl_raw, cs_raw, cos_l, cos_s, gain;
  // cosine bounce
  float sxl, syl, szl, crn, crxn, cryn, crzn, sdx, sdy, sdz;
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// One bounce forward from the recorded decision `code`, in the operation
// order of the trace kernel and of the plain replay (ops/cuda_shade.py).
template <bool SPH>
__device__ __forceinline__ void bounce_forward(
    Bounce& r, const float* __restrict__ s_tab, int nrows, int P, int code,
    bool alive, float ox, float oy, float oz, float dx, float dy, float dz,
    float u_nee0, float u_nee1, float u0, float u1, const float* __restrict__ lv,
    float he) {
  r.occ = code >= OCC_BIT;
  const int prim = code % OCC_BIT - 1;
  r.hit = prim >= 0;
  r.pc = min(max(prim, 0), P - 1);
  const float* at = s_tab + nrows * r.pc;
  r.tnx = at[R_N]; r.tny = at[R_N + 1]; r.tnz = at[R_N + 2];
  const float c0 = at[R_C0];
  r.dfr = at[R_DF]; r.dfg = at[R_DF + 1]; r.dfb = at[R_DF + 2];
  r.is_em = at[R_ISEM] > 0.5f;

  // Plane distance of the recorded triangle.
  const float den = dx * r.tnx + dy * r.tny + dz * r.tnz;
  r.ok = fabsf(den) >= 1e-12f;
  r.sden = r.ok ? den : 1.0f;
  const float num = c0 - (ox * r.tnx + oy * r.tny + oz * r.tnz);
  r.tt = num / r.sden;

  r.nhx = r.tnx; r.nhy = r.tny; r.nhz = r.tnz;
  if (SPH) {
    // Quadratic of the recorded sphere (intersect.sphere_candidates' order).
    const float scx = at[R_SC], scy = at[R_SC + 1], scz = at[R_SC + 2];
    r.srad = at[R_RAD];
    r.is_sph = at[R_ISSPH] > 0.5f;
    r.ocx = ox - scx; r.ocy = oy - scy; r.ocz = oz - scz;
    r.a_q = dx * dx + dy * dy + dz * dz;
    r.b_q = 2.0f * (r.ocx * dx + r.ocy * dy + r.ocz * dz);
    r.c_q = (r.ocx * r.ocx + r.ocy * r.ocy + r.ocz * r.ocz) - r.srad * r.srad;
    const float disc = r.b_q * r.b_q - 4.0f * r.a_q * r.c_q;
    r.pos_d = disc > 0.0f;
    r.sq = sqrtf(r.pos_d ? disc : 1.0f);
    r.t1 = (-r.b_q - r.sq) / (2.0f * r.a_q);
    r.t2 = (-r.b_q + r.sq) / (2.0f * r.a_q);
    r.t1_ok = (r.t1 > 1e-3f) && (r.t1 < 1e3f);
    const float t_sph = r.t1_ok ? r.t1 : r.t2;
    if (r.is_sph) r.tt = t_sph;
    r.sel = r.hit && r.is_sph;
    r.t_ns = r.sel ? r.tt : 0.0f;
    r.thx = ox + dx * r.t_ns - scx;
    r.thy = oy + dy * r.t_ns - scy;
    r.thz = oz + dz * r.t_ns - scz;
    const float qn = r.thx * r.thx + r.thy * r.thy + r.thz * r.thz;
    r.qn_ok = qn >= 1e-6f;
    r.inv_n = 1.0f / sqrtf(fmaxf(qn, 1e-6f));
    if (r.sel) { r.nhx = r.thx * r.inv_n; r.nhy = r.thy * r.inv_n; r.nhz = r.thz * r.inv_n; }
  }

  const bool active = alive && r.hit;
  r.hit_light = active && r.is_em;
  r.surf = active && !r.is_em;
  r.ts = r.surf ? r.tt : 0.0f;
  r.hx = ox + dx * r.ts + r.nhx * 1e-3f;
  r.hy = oy + dy * r.ts + r.nhy * 1e-3f;
  r.hz = oz + dz * r.ts + r.nhz * 1e-3f;

  // Light sample on the hardcoded half-extent square about the light center.
  const float w0 = u_nee0 * 2.0f - 1.0f;
  const float w1 = u_nee1 * 2.0f - 1.0f;
  r.tlx = (lv[0] + he * w0) - r.hx;
  r.tly = lv[1] - r.hy;
  r.tlz = (lv[2] + he * w1) - r.hz;
  const float q = r.tlx * r.tlx + r.tly * r.tly + r.tlz * r.tlz;
  r.dist = sqrtf(fmaxf(q, 0.0f));
  r.invd = 1.0f / fmaxf(r.dist, 1e-3f);
  const float ldx = r.tlx * r.invd, ldy = r.tly * r.invd, ldz = r.tlz * r.invd;
  r.cl_raw = -(ldx * lv[6] + ldy * lv[7] + ldz * lv[8]);
  r.cs_raw = r.nhx * ldx + r.nhy * ldy + r.nhz * ldz;
  r.cos_l = clamp01(r.cl_raw);
  r.cos_s = clamp01(r.cs_raw);
  r.gain = ((r.invd * r.invd) * r.cos_l) * r.cos_s;
  r.contrib = r.surf && !r.occ;

  // Cosine bounce about the fixed-axis basis.
  const float phi = (float)(2.0 * 3.14159265358979323846) * u0;
  const float cth = sqrtf(u1);
  const float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
  r.sxl = sth * cosf(phi);
  r.syl = cth;
  r.szl = sth * sinf(phi);
  const float ax = 0.0072f, ay = 1.0f, az = 0.0034f;
  const float crx = r.nhy * az - r.nhz * ay;
  const float cry = r.nhz * ax - r.nhx * az;
  const float crz = r.nhx * ay - r.nhy * ax;
  r.crn = sqrtf(crx * crx + cry * cry + crz * crz);
  r.crxn = crx / r.crn; r.cryn = cry / r.crn; r.crzn = crz / r.crn;
  const float fwx = r.cryn * r.nhz - r.crzn * r.nhy;
  const float fwy = r.crzn * r.nhx - r.crxn * r.nhz;
  const float fwz = r.crxn * r.nhy - r.cryn * r.nhx;
  r.sdx = r.sxl * r.crxn + r.syl * r.nhx + r.szl * fwx;
  r.sdy = r.sxl * r.cryn + r.syl * r.nhy + r.szl * fwy;
  r.sdz = r.sxl * r.crzn + r.syl * r.nhz + r.szl * fwz;
}

// Reverse of one bounce of a live lane.  State carried towards the camera:
// d_a (accumulator), d_o, d_d (ray at entry), d_col (throughput).  `rows`
// receives this bounce's table cotangents; ds[12..20] accumulate the light's.
template <bool SPH>
__device__ __forceinline__ void bounce_reverse(
    const Bounce& r, bool last, float ox, float oy, float oz, float dx, float dy,
    float dz, const float* colp, const float* __restrict__ lv, float* d_a,
    float* d_o, float* d_d, float* d_col, float* rows, float* ds) {
  const float nh[3] = {r.nhx, r.nhy, r.nhz};
  const float tn[3] = {r.tnx, r.tny, r.tnz};
  const float df[3] = {r.dfr, r.dfg, r.dfb};
  const float o[3] = {ox, oy, oz};
  const float d[3] = {dx, dy, dz};
  const float* lcol = lv + 3;
  const float* ln = lv + 6;
  float* d_lc = ds + 12;
  float* d_lcol = ds + 15;
  float* d_ln = ds + 18;
  float d_nh[3] = {0.0f, 0.0f, 0.0f};
  float d_h[3] = {0.0f, 0.0f, 0.0f};

  // Ray update and cosine direction (the last bounce's ray is never used).
  if (!last) {
    float d_sd[3] = {0.0f, 0.0f, 0.0f};
    if (r.surf) {
      for (int c = 0; c < 3; ++c) {
        d_h[c] = d_o[c]; d_o[c] = 0.0f;
        d_sd[c] = d_d[c]; d_d[c] = 0.0f;
      }
    }
    float d_crxn = r.sxl * d_sd[0];
    float d_cryn = r.sxl * d_sd[1];
    float d_crzn = r.sxl * d_sd[2];
    for (int c = 0; c < 3; ++c) d_nh[c] += r.syl * d_sd[c];
    const float d_fw[3] = {r.szl * d_sd[0], r.szl * d_sd[1], r.szl * d_sd[2]};
    // fw = cr_n x nh
    d_cryn += r.nhz * d_fw[0];
    d_nh[2] += r.cryn * d_fw[0];
    d_crzn -= r.nhy * d_fw[0];
    d_nh[1] -= r.crzn * d_fw[0];
    d_crzn += r.nhx * d_fw[1];
    d_nh[0] += r.crzn * d_fw[1];
    d_crxn -= r.nhz * d_fw[1];
    d_nh[2] -= r.crxn * d_fw[1];
    d_crxn += r.nhy * d_fw[2];
    d_nh[1] += r.crxn * d_fw[2];
    d_cryn -= r.nhx * d_fw[2];
    d_nh[0] -= r.cryn * d_fw[2];
    // normalize
    const float s_dot = r.crxn * d_crxn + r.cryn * d_cryn + r.crzn * d_crzn;
    const float d_crx = (d_crxn - r.crxn * s_dot) / r.crn;
    const float d_cry = (d_cryn - r.cryn * s_dot) / r.crn;
    const float d_crz = (d_crzn - r.crzn * s_dot) / r.crn;
    // cr = nh x axis
    const float ax = 0.0072f, ay = 1.0f, az = 0.0034f;
    d_nh[1] += az * d_crx;
    d_nh[2] -= ay * d_crx;
    d_nh[2] += ax * d_cry;
    d_nh[0] -= az * d_cry;
    d_nh[0] += ay * d_crz;
    d_nh[1] -= ax * d_crz;
  }

  // a += contrib ? (lcol * gain) * col : 0
  float d_gain = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float col = r.surf ? colp[c] * df[c] : colp[c];
    const float gated = r.contrib ? d_a[c] : 0.0f;
    d_lcol[c] += r.gain * col * gated;
    d_gain += lcol[c] * col * gated;
    d_col[c] += lcol[c] * r.gain * gated;
  }

  // col = surf ? colp * df : colp
  float d_df[3];
  for (int c = 0; c < 3; ++c) {
    d_df[c] = r.surf ? d_col[c] * colp[c] : 0.0f;
    d_col[c] = r.surf ? d_col[c] * df[c] : d_col[c];
  }

  // Light sample.
  const float invd2 = r.invd * r.invd;
  const float d_invd2 = r.cos_l * r.cos_s * d_gain;
  const float d_cos_l = invd2 * r.cos_s * d_gain;
  const float d_cos_s = invd2 * r.cos_l * d_gain;
  const float d_cs_raw = (r.cs_raw >= 0.0f && r.cs_raw <= 1.0f) ? d_cos_s : 0.0f;
  const float d_cl_raw = (r.cl_raw >= 0.0f && r.cl_raw <= 1.0f) ? d_cos_l : 0.0f;
  const float tl[3] = {r.tlx, r.tly, r.tlz};
  const float ld[3] = {r.tlx * r.invd, r.tly * r.invd, r.tlz * r.invd};
  float d_ld[3];
  for (int c = 0; c < 3; ++c) {
    d_nh[c] += ld[c] * d_cs_raw;
    d_ld[c] = nh[c] * d_cs_raw - ln[c] * d_cl_raw;
    d_ln[c] -= ld[c] * d_cl_raw;
  }
  float d_invd = 2.0f * r.invd * d_invd2;
  d_invd += tl[0] * d_ld[0] + tl[1] * d_ld[1] + tl[2] * d_ld[2];
  const float d_maxd = -(r.invd * r.invd) * d_invd;
  const float d_dist = (r.dist >= 1e-3f) ? d_maxd : 0.0f;
  // A lane closer than 1e-3 to its light sample has d_dist == 0: no 0 / 0.
  const float d_q = (r.dist >= 1e-3f) ? d_dist / (2.0f * r.dist) : 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float d_tl = r.invd * d_ld[c] + 2.0f * tl[c] * d_q;
    d_lc[c] += d_tl;
    d_h[c] -= d_tl;
  }

  // h = o + d * ts + nh * 1e-3
  for (int c = 0; c < 3; ++c) {
    d_o[c] += d_h[c];
    d_d[c] += r.ts * d_h[c];
    d_nh[c] += 1e-3f * d_h[c];
  }
  const float d_ts = dx * d_h[0] + dy * d_h[1] + dz * d_h[2];

  // a = hit_light ? emissive : a
  for (int c = 0; c < 3; ++c) {
    rows[R_EM + c] = r.hit_light ? d_a[c] : 0.0f;
    if (r.hit_light) d_a[c] = 0.0f;
  }

  // nh = sel ? th * inv_n : tn, and the sphere normal's chain.
  float d_tn[3] = {d_nh[0], d_nh[1], d_nh[2]};
  float d_tt = r.surf ? d_ts : 0.0f;
  if (SPH) {
    float d_th[3], d_sc[3];
    for (int c = 0; c < 3; ++c) {
      const float d_nh_s = r.sel ? d_nh[c] : 0.0f;
      if (r.sel) d_tn[c] = 0.0f;
      d_th[c] = r.inv_n * d_nh_s;
    }
    const float d_inv_n = r.sel ? (r.thx * d_nh[0] + r.thy * d_nh[1] + r.thz * d_nh[2])
                                : 0.0f;
    // inv_n = rsqrt(max(qn, 1e-6))
    const float d_qn = r.qn_ok ? -0.5f * r.inv_n * r.inv_n * r.inv_n * d_inv_n : 0.0f;
    d_th[0] += 2.0f * r.thx * d_qn;
    d_th[1] += 2.0f * r.thy * d_qn;
    d_th[2] += 2.0f * r.thz * d_qn;
    // th = o + d * t_ns - center
    for (int c = 0; c < 3; ++c) {
      d_o[c] += d_th[c];
      d_d[c] += r.t_ns * d_th[c];
      d_sc[c] = -d_th[c];
    }
    // t_ns = sel ? tt : 0
    if (r.sel) d_tt += dx * d_th[0] + dy * d_th[1] + dz * d_th[2];

    // tt = is_sph ? t_sph : plane distance
    const float d_tsph = r.is_sph ? d_tt : 0.0f;
    if (r.is_sph) d_tt = 0.0f;
    // t_sph = t1_ok ? t1 : t2;  t1, t2 = (-b -+ sq) / (2 a)
    const float d_t1 = r.t1_ok ? d_tsph : 0.0f;
    const float d_t2 = r.t1_ok ? 0.0f : d_tsph;
    const float inv2a = 1.0f / (2.0f * r.a_q);
    float d_b_q = -(d_t1 + d_t2) * inv2a;
    const float d_sq = (d_t2 - d_t1) * inv2a;
    float d_a_q = -(r.t1 * d_t1 + r.t2 * d_t2) / r.a_q;
    // sq = sqrt(pos_d ? disc : 1);  disc = b^2 - 4 a c
    const float d_disc = r.pos_d ? d_sq / (2.0f * r.sq) : 0.0f;
    d_b_q += 2.0f * r.b_q * d_disc;
    d_a_q += -4.0f * r.c_q * d_disc;
    const float d_c_q = -4.0f * r.a_q * d_disc;
    // c = oc.oc - rad^2;  b = 2 oc.d;  a = d.d;  oc = o - center
    const float oc[3] = {r.ocx, r.ocy, r.ocz};
    for (int c = 0; c < 3; ++c) {
      const float d_oc = 2.0f * oc[c] * d_c_q + 2.0f * d[c] * d_b_q;
      d_d[c] += 2.0f * oc[c] * d_b_q + 2.0f * d[c] * d_a_q;
      d_o[c] += d_oc;
      d_sc[c] -= d_oc;
      rows[10 + c] = d_sc[c];
    }
    rows[13] = -2.0f * r.srad * d_c_q;
  }

  // tt = (c0 - o.tn) / sden
  const float d_num = d_tt / r.sden;
  const float d_sden = -(r.tt * d_tt) / r.sden;
  const float d_den = r.ok ? d_sden : 0.0f;
  for (int c = 0; c < 3; ++c) {
    d_o[c] -= tn[c] * d_num;
    d_tn[c] -= o[c] * d_num;
    d_d[c] += tn[c] * d_den;
    d_tn[c] += d[c] * d_den;
    rows[R_N + c] = d_tn[c];
    rows[R_DF + c] = d_df[c];
  }
  rows[R_C0] = d_num;
}

// One pixel's samples: the forward sweep from the records, the reverse sweep,
// the table rows scattered into this warp's table `wtab` [P][NTAB] and the
// camera's and light's cotangents added to ds.  `tab` is the [P][NROWS]
// parameter table (shared memory in the static tier, global in the grouped
// one), `cam` the 12 camera scalars, `lv` the light's 9, `stage` this lane's
// row of the warp's staging rows in shared memory (STAGE floats apart). Every
// lane of the warp calls it (the scatter is warp-wide); a lane past the range
// runs on with no live path.  A reversed bounce's rows are scattered by
// warp_scatter_peers from the staging rows.  A __syncwarp after each scatter
// orders its adds and reads before the next one's, which other lanes may make
// to the same words.
template <bool SPH, bool RNG>
__device__ __forceinline__ void shade_pixel(const ShadeParams& p,
                                            const float* __restrict__ tab,
                                            const float* cam, const float* lv,
                                            float* wtab, float* stage, int i, int lane,
                                            float* ds) {
  constexpr int NROWS = SPH ? 16 : 11;
  constexpr int NTAB = SPH ? 14 : 10;
  const int P = p.num_prims;
  const int n_local = p.n_local;
  const int B = p.bounces;
  const int W = p.width, H = p.height;
  const int rid = p.rid_base + i;               // global pixel id
  // A thread past the range or the image runs on (the warp's shuffles need
  // every lane) with no live path.
  const bool in_image = (i < n_local) && (rid < W * H);
  const int ii = in_image ? i : 0;
  const float px = (float)(rid % W);
  const float py = (float)(rid / W);
  const float fW = (float)W, fH = (float)H;
  const float he = p.half_extent;
  const uint32_t off = RNG ? (uint32_t)p.offsets[ii] : 0u;
  const float g[3] = {p.g[ii], p.g[(size_t)n_local + ii], p.g[2 * (size_t)n_local + ii]};

  for (int n = 0; n < p.spp; ++n) {
    // ---- forward sweep: keep each bounce's entry state
    float st_o[MAX_BOUNCES][3], st_d[MAX_BOUNCES][3], st_col[MAX_BOUNCES][3];
    float st_u[MAX_BOUNCES][4];
    int st_code[MAX_BOUNCES];
    int n_active = 0;     // bounces whose lane is alive and hit something
    float s = 0.0f, t = 0.0f, rn = 1.0f;
    if (in_image) {
      const uint32_t ih = off + (uint32_t)n;
      float jx, jy;
      if (RNG) {
        camera_jitter(ih, p.spp, p.strat_k, p.inv_k, &jx, &jy);
      } else {
        const size_t sn = (size_t)n * n_local + i;
        jx = p.jx[sn];
        jy = p.jy[sn];
      }
      s = ((px + jx) / fW) * 2.0f - 1.0f;
      t = -(((py + jy) / fH) * 2.0f - 1.0f);
      const float rx = s * cam[3] + t * cam[6] - cam[9];
      const float ry = s * cam[4] + t * cam[7] - cam[10];
      const float rz = s * cam[5] + t * cam[8] - cam[11];
      rn = sqrtf(rx * rx + ry * ry + rz * rz);
      float ox = cam[0], oy = cam[1], oz = cam[2];
      float dx = rx / rn, dy = ry / rn, dz = rz / rn;
      float col[3] = {1.0f, 1.0f, 1.0f};
      for (int b = 0; b < B; ++b) {
        const size_t idx = ((size_t)n * B + b) * n_local + i;
        const int code = p.records[idx];
        if (code % OCC_BIT == 0) break;           // a miss: the path is dead
        float u[4];
        if (RNG) {
          bounce_draws(ih, b, u);
        } else {
          u[0] = p.nee0[idx]; u[1] = p.nee1[idx];
          u[2] = p.cos0[idx]; u[3] = p.cos1[idx];
        }
        st_code[b] = code;
        st_o[b][0] = ox; st_o[b][1] = oy; st_o[b][2] = oz;
        st_d[b][0] = dx; st_d[b][1] = dy; st_d[b][2] = dz;
        for (int c = 0; c < 3; ++c) { st_col[b][c] = col[c]; st_u[b][c] = u[c]; }
        st_u[b][3] = u[3];
        n_active = b + 1;
        if (b == B - 1) break;
        Bounce r;
        bounce_forward<SPH>(r, tab, NROWS, P, code, true, ox, oy, oz, dx, dy, dz,
                            u[0], u[1], u[2], u[3], lv, he);
        if (!r.surf) break;                       // an emissive hit ends the path
        col[0] *= r.dfr; col[1] *= r.dfg; col[2] *= r.dfb;
        ox = r.hx; oy = r.hy; oz = r.hz;
        dx = r.sdx; dy = r.sdy; dz = r.sdz;
      }
    }

    // ---- reverse sweep (uniform over the warp: it shuffles)
    float d_a[3] = {g[0], g[1], g[2]};
    float d_o[3] = {0.0f, 0.0f, 0.0f};
    float d_d[3] = {0.0f, 0.0f, 0.0f};
    float d_col[3] = {0.0f, 0.0f, 0.0f};
    for (int b = B - 1; b >= 0; --b) {
      const bool act = b < n_active;
      if (__ballot_sync(FULL, act) == 0u) continue;
      int pc = -1;
      if (act) {
        float rows[NTAB];
        for (int k = 0; k < NTAB; ++k) rows[k] = 0.0f;
        Bounce r;
        bounce_forward<SPH>(r, tab, NROWS, P, st_code[b], true, st_o[b][0],
                            st_o[b][1], st_o[b][2], st_d[b][0], st_d[b][1],
                            st_d[b][2], st_u[b][0], st_u[b][1], st_u[b][2],
                            st_u[b][3], lv, he);
        bounce_reverse<SPH>(r, b == B - 1, st_o[b][0], st_o[b][1], st_o[b][2],
                            st_d[b][0], st_d[b][1], st_d[b][2], st_col[b], lv, d_a,
                            d_o, d_d, d_col, rows, ds);
        pc = r.pc;
        for (int k = 0; k < NTAB; ++k) stage[k] = rows[k];
      }
      // Sum the rows over the lanes that recorded the same primitive and add
      // each sum to this warp's table.
      warp_scatter_peers<NTAB>(act, pc, stage, STAGE<SPH>, wtab, lane);
      __syncwarp();
    }

    // ---- camera: the ray at entry of bounce 0
    if (n_active > 0) {
      const float d0x = st_d[0][0], d0y = st_d[0][1], d0z = st_d[0][2];
      const float s_dot = d0x * d_d[0] + d0y * d_d[1] + d0z * d_d[2];
      const float d_r[3] = {(d_d[0] - d0x * s_dot) / rn, (d_d[1] - d0y * s_dot) / rn,
                            (d_d[2] - d0z * s_dot) / rn};
      for (int c = 0; c < 3; ++c) {
        ds[c] += d_o[c];
        ds[3 + c] += s * d_r[c];
        ds[6 + c] += t * d_r[c];
        ds[9 + c] -= d_r[c];
      }
    }
  }
}

template <bool SPH, bool RNG>
__global__ void __launch_bounds__(BLOCK_THREADS,
                                  SPH ? STATIC_MIN_BLOCKS_SPH : STATIC_MIN_BLOCKS)
shade_bwd_kernel(const ShadeParams p) {
  constexpr int NROWS = SPH ? 16 : 11;
  constexpr int NTAB = SPH ? 14 : 10;
  extern __shared__ float smem[];
  const int P = p.num_prims;
  float* s_tab = smem;                          // [P][NROWS]
  float* s_vec = s_tab + NROWS * P;             // camera 12, light 9
  float* s_wtab = s_vec + NSCAL;                // [WARPS][P][NTAB]
  float* s_wscal = s_wtab + WARPS * P * NTAB;   // [WARPS][NSCAL]
  float* s_stage = s_wscal + WARPS * NSCAL;     // [BLOCK_THREADS][STAGE]

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
  float ds[NSCAL];
  for (int k = 0; k < NSCAL; ++k) ds[k] = 0.0f;
  shade_pixel<SPH, RNG>(
      p, s_tab, s_vec, s_vec + 12, s_wtab + warp * P * NTAB,
      s_stage + threadIdx.x * STAGE<SPH>, blockIdx.x * blockDim.x + threadIdx.x, lane,
      ds);

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

// The grouped tier: a persistent grid; warp w of the grid owns the table
// partials[w] = [P][NTAB] then 21 scalars, and walks the 32-pixel tiles w,
// w + (warps in the grid), ...  p.table is the TRANSPOSED [P][NROWS] table.
template <bool SPH, bool RNG>
__global__ void __launch_bounds__(BLOCK_THREADS)
shade_bwd_grouped_kernel(const ShadeParams p) {
  constexpr int NTAB = SPH ? 14 : 10;
  extern __shared__ float s_stage[];            // [BLOCK_THREADS][STAGE]
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  const size_t row = (size_t)p.num_prims * NTAB + NSCAL;
  float* wtab = p.partials + (size_t)warp * row;
  for (size_t k = lane; k < row; k += 32) wtab[k] = 0.0f;
  __syncwarp();

  float ds[NSCAL];
  for (int k = 0; k < NSCAL; ++k) ds[k] = 0.0f;
  const int tiles = (p.n_local + 31) / 32;
  for (int tile = warp; tile < tiles; tile += n_warps) {
    shade_pixel<SPH, RNG>(p, p.table, p.cam, p.light, wtab,
                          s_stage + threadIdx.x * STAGE<SPH>, tile * 32 + lane, lane,
                          ds);
  }
  for (int k = 0; k < NSCAL; ++k) {
    const float v = warp_sum(ds[k]);
    if (lane == 0) wtab[row - NSCAL + k] = v;
  }
}

// Bytes of shade_bwd_kernel's tables in one block: the table [P][nrows], the
// 21 scalars, one [P][ntab] table and 21 scalars per warp.  The static tier
// takes a scene whose tables fit STATIC_TABLE_SMEM; the staging rows come on
// top of them, opted in past 48 KiB.
constexpr size_t STATIC_TABLE_SMEM = 48 * 1024;
size_t static_table_bytes(int num_prims, int has_spheres) {
  const int nrows = has_spheres ? 16 : 11;
  const int ntab = has_spheres ? 14 : 10;
  return sizeof(float) * ((size_t)nrows * num_prims + NSCAL
                          + (size_t)WARPS * ((size_t)num_prims * ntab + NSCAL));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one block: shade_bwd_kernel (grouped ==
// 0) stages its tables (static_table_bytes) and the staging rows of
// warp_scatter_peers; shade_bwd_grouped_kernel (grouped == 1) the staging
// rows alone.  The wrapper's plans (cuda_shade.static_smem_bytes,
// grouped_smem_bytes) mirror it.
int grt_shade_bwd_smem(int num_prims, int has_spheres, int grouped) {
  const size_t stage = sizeof(float) * BLOCK_THREADS
                       * (has_spheres ? STAGE<true> : STAGE<false>);
  if (grouped) return (int)stage;
  return (int)(static_table_bytes(num_prims, has_spheres) + stage);
}

// Number of blocks shade_bwd_kernel runs for n_local pixels: the wrapper
// sizes the partials buffer [blocks, num_prims * ntab + 21] with it.
int grt_shade_bwd_blocks(int n_local) {
  return (n_local + BLOCK_THREADS - 1) / BLOCK_THREADS;
}

// Blocks of the grouped tier's persistent grid on the current device: the
// blocks the card holds at once, at most one per 128 pixels, and at most as
// many as keep the per-warp tables (WARPS x (num_prims * ntab + 21) floats
// each) within GROUPED_TABLE_BYTES.  The wrapper sizes the partials [blocks *
// 4, ...] with it; 0 means the occupancy query failed.
int grt_shade_bwd_grouped_blocks(int n_local, int num_prims, int has_spheres,
                                 int recompute_rng) {
  const int tiles = (n_local + 31) / 32;
  const size_t row = (size_t)num_prims * (has_spheres ? 14 : 10) + NSCAL;
  const size_t smem = grt_shade_bwd_smem(num_prims, has_spheres, 1);
  const auto blocks = [&](auto kernel) {
    return grt::persistent_blocks(kernel, BLOCK_THREADS, smem, tiles, row,
                                  GROUPED_TABLE_BYTES);
  };
  return has_spheres ? (recompute_rng ? blocks(shade_bwd_grouped_kernel<true, true>)
                                      : blocks(shade_bwd_grouped_kernel<true, false>))
                     : (recompute_rng ? blocks(shade_bwd_grouped_kernel<false, true>)
                                      : blocks(shade_bwd_grouped_kernel<false, false>));
}

// Blocks of shade_bwd_kernel (grouped == 0) or shade_bwd_grouped_kernel
// (grouped == 1) that one SM of the current device holds, in the
// instantiation and at the shared memory of these inputs; 0 where the query
// fails.
int grt_shade_bwd_blocks_per_sm(int num_prims, int has_spheres, int recompute_rng,
                                int grouped) {
  const size_t smem = grt_shade_bwd_smem(num_prims, has_spheres, grouped);
  const auto per_sm = [&](auto kernel) {
    return grt::blocks_per_sm(kernel, BLOCK_THREADS, smem);
  };
  if (grouped) {
    return has_spheres ? (recompute_rng ? per_sm(shade_bwd_grouped_kernel<true, true>)
                                        : per_sm(shade_bwd_grouped_kernel<true, false>))
                       : (recompute_rng ? per_sm(shade_bwd_grouped_kernel<false, true>)
                                        : per_sm(shade_bwd_grouped_kernel<false, false>));
  }
  return has_spheres ? (recompute_rng ? per_sm(shade_bwd_kernel<true, true>)
                                      : per_sm(shade_bwd_kernel<true, false>))
                     : (recompute_rng ? per_sm(shade_bwd_kernel<false, true>)
                                      : per_sm(shade_bwd_kernel<false, false>));
}

// Launches shade_bwd_kernel (grouped == 0: table [nrows, P], partials
// [grt_shade_bwd_blocks, ...]) or shade_bwd_grouped_kernel (grouped == 1:
// table [P, nrows], partials [4 * blocks, ...] with blocks from
// grt_shade_bwd_grouped_blocks), then reduce_partials_kernel, on `stream`;
// returns cudaGetLastError() as an int.  out is [num_prims * ntab + 21]
// float32: dtab [P, ntab] row-major, then the 21 scalars.
int grt_shade_bwd(const float* g, const int32_t* records, const float* nee0,
                  const float* nee1, const float* cos0, const float* cos1,
                  const float* jx, const float* jy, const int32_t* offsets,
                  const float* table, const float* cam, const float* light,
                  float* partials, float* out, int n_local, int rid_base,
                  int width, int height, int spp, int bounces, int num_prims,
                  int has_spheres, int strat_k, float inv_k, float half_extent,
                  int recompute_rng, int grouped, int blocks, void* stream) {
  ShadeParams p;
  p.g = g; p.records = records;
  p.nee0 = nee0; p.nee1 = nee1; p.cos0 = cos0; p.cos1 = cos1; p.jx = jx; p.jy = jy;
  p.offsets = offsets; p.table = table; p.cam = cam; p.light = light;
  p.partials = partials;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.spp = spp; p.bounces = bounces; p.num_prims = num_prims; p.strat_k = strat_k;
  p.inv_k = inv_k; p.half_extent = half_extent;

  if (n_local <= 0 || num_prims <= 0 || spp <= 0 || bounces <= 0
      || bounces > MAX_BOUNCES) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntab = has_spheres ? 14 : 10;
  const int count = num_prims * ntab + NSCAL;
  const size_t smem = grt_shade_bwd_smem(num_prims, has_spheres, grouped);
  cudaStream_t st = (cudaStream_t)stream;
  if (grouped) {
    if (blocks <= 0) return (int)cudaErrorInvalidValue;
    if (has_spheres && recompute_rng) {
      shade_bwd_grouped_kernel<true, true><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    } else if (has_spheres) {
      shade_bwd_grouped_kernel<true, false><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    } else if (recompute_rng) {
      shade_bwd_grouped_kernel<false, true><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    } else {
      shade_bwd_grouped_kernel<false, false><<<blocks, BLOCK_THREADS, smem, st>>>(p);
    }
    int code = (int)cudaGetLastError();
    if (code != 0) return code;
    grt::launch_reduce_partials(partials, blocks * WARPS, count, out, st);
    return (int)cudaGetLastError();
  }
  if (static_table_bytes(num_prims, has_spheres) > STATIC_TABLE_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = grt_shade_bwd_blocks(n_local);
  const auto launch = [&](auto kernel) {
    const cudaError_t err = grt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, BLOCK_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  };
  const int code = has_spheres ? (recompute_rng ? launch(shade_bwd_kernel<true, true>)
                                                : launch(shade_bwd_kernel<true, false>))
                               : (recompute_rng ? launch(shade_bwd_kernel<false, true>)
                                                : launch(shade_bwd_kernel<false, false>));
  if (code != 0) return code;
  grt::launch_reduce_partials(partials, grid, count, out, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
