// CUDA kernels of the variant-B path tracer for NVIDIA Hopper (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_path.py).  Build WITHOUT
// --use_fast_math and WITH -fmad=false: the plain PyTorch versions these
// kernels are held against run every multiply and add as its own rounded
// operation, and a contracted a*b+c changes the last bit of a hit distance,
// which flips closest-hit winners and shadow bits on knife-edge rays.  The
// Halton accumulate spells its two roundings out (radical_inverse in
// halton.cuh), so the draws do not depend on that flag.
//
// ---------------------------------------------------------------------------
// draws_kernel  replaces  gpuraytracer_tpu/ops/pallas_path.py:_draws_kernel
// ---------------------------------------------------------------------------
// Per (pixel, sample): the camera jitter pair (Halton dims 0-1, or the
// stratified grid over spp cells) and per bounce the NEE pair (dims
// 2+5b+{0,1}) and the cosine pair (dims 2+5b+{2,3}), all at Halton index
// offset[pixel] + sample.  Outputs are [spp, bounces, N] and [spp, N] planes
// with the pixel axis minor-most.
//
// Bound on this card: BYTES.  The kernel writes (4*bounces + 2) * spp * N
// floats and reads N offsets.  Design: one thread per (pixel, sample) with
// neighbouring threads on neighbouring pixels, so every store of a warp is
// one contiguous 128-byte line; the kernel is templated on the bounce count,
// so that every Halton dimension is a compile-time constant, and an item
// whose index is below HALTON_SHORT (every item of a render) takes
// halton.cuh's short form of each radical inverse: straight-line code, a
// fixed digit count, constant weights, one multiply-high a quotient, base 2
// a bit reversal (436 SASS instructions an item at three bounces).  Its
// stores alone take within 5-7 % of the kernel's time on the card (PERF.md).
//
// ---------------------------------------------------------------------------
// path_kernel          replaces  gpuraytracer_tpu/ops/pallas_path.py:_path_kernel
//                      static tier (at most 64 triangles, plus analytic spheres)
// path_grouped_kernel  replaces  its grouped tier (any number of triangles up to
//                      the record encoding's limit)
// ---------------------------------------------------------------------------
// Per pixel: spp samples x `bounces` bounces of camera ray -> closest hit over
// all triangles (plane + dual basis) and spheres -> emissive replace / NEE with
// an any-hit shadow probe over the occluder list -> cosine bounce.  Modes:
// hdr only; EMIT (one int32 record (prim+1) + OCC_BIT*occluded per (sample,
// bounce, pixel)); READ_DRAWS (the six draw planes come from draws_kernel
// instead of being radical-inversed in the loop).  Both tiers run the same
// per-pixel body (trace_pixel), which differs only in its two traversals.
//
// Bound on this card: OPERATIONS in hdr mode and records-only mode — per live
// (sample, bounce, pixel) T closest-hit tests, n_shadow any-hit tests and
// 2*S sphere tests, against a few bytes per pixel of traffic; f32 scalar math,
// so the yardstick is the card's non-tensor f32 rate.  With EMIT and
// READ_DRAWS it is the larger of that and the record and draw bytes
// ((4*bounces+2)*4 B read and 4*bounces B written per sample and pixel).
//
// The static tier: one thread per pixel with the sample and bounce loops
// inside the thread and all path state in registers; the scene tables (a few
// KB) are staged once per block in shared memory, triangle-major so that one
// triangle is three 16-byte loads that all threads of a warp take from the
// same address (a broadcast); the winner's attributes are fetched by index.
// The shadow probe runs over a compacted copy of the occluder list
// (any_triangle_filtered at t_min = 0): a test takes the divide, the
// barycentrics and the interval test only where the two exact conditions of
// trace.cuh hold (the plane lies ahead of the hit point, and nearer than the
// light sample), and the loop stops at the first occluder; then the spheres.
// Most occluders of a probe from inside the box lie behind it or beyond the
// light, and the skipped tests are tests that fail (trace.cuh states the
// proof), so the bit is the same.  The closest hit tests every triangle to
// its divide (closest_triangle): with the same prefilters it was slower,
// since the lanes of a warp, on rays that have bounced, rarely all skip a
// triangle.  At least STATIC_MIN_BLOCKS blocks of 128 threads per SM (56
// registers).  PERF.md has the trials.  In hdr mode a dead path leaves the
// bounce loop; with EMIT it runs on masked, because records are defined for
// every (sample, bounce, pixel).
//
// The grouped tier (the TPU kernel's grouped=True branch, pallas_path.py:
// 532-590 closest hit, 643-700 shadow probe) keeps the body above; its scene
// tables do not fit a block's shared memory at a thousand triangles.  The
// geometry (48 B per triangle: 48 KB at 1,002 triangles, 614 KB at 12,802)
// and the dense occluder-culled shadow table stay in global memory and are
// read through the read-only path, where L2 holds them; their two-level box
// tables (32 B a box: 4 KB at 1,002 triangles, 52 KB at 12,802) are staged by
// cp.async in shared memory with the spheres.  The closest hit and the shadow
// probe run trace.cuh's warp-cooperative sweep (closest_grouped_warp, above
// WIDE_SUPERS supers closest_grouped_wide; occluded_grouped_warp at t_min =
// 0): per super of 128 triangles, then per group of 16, a slab test of the
// padded box against the ray's far limit, which tightens with the closest hit
// so far, and the group's triangle tests only where the box is reached, each
// lane walking the groups it reaches; the same decisions as the loop over
// every triangle, lane by lane.  The group loops test every triangle to its
// divide: the lanes of a warp walk different groups, so the prefilters
// skipped work for a whole warp too rarely to pay.
// Grid: a persistent grid of GROUPED_THREADS-thread blocks, as many as the
// card holds at once (2 per SM for the narrow sweep, 3 for the wide one), so
// that the box tables are staged once per block; its
// warps take 32-pixel tiles from a counter (*tiles_taken, 0 at launch) until
// the range is done, so that no SM idles at the end.  The votes take the full
// warp, so every lane reaches every one: with EMIT every lane in range traces
// every (sample, bounce) (records are defined there); in hdr mode a lane off
// a surface stays in the bounce loop, tracing nothing, until no lane of its
// warp is on one.  The attributes ([T + S][13]) are read from global memory
// by the winner's index.  Bound: OPERATIONS, counted from the box and triangle
// tests this frame's lanes execute.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "halton.cuh"
#include "occupancy.cuh"
#include "trace.cuh"

namespace {

using grt::any_triangle_filtered;
using grt::bounce_draws;
using grt::camera_jitter;
using grt::closest_grouped_warp;
using grt::closest_grouped_wide;
using grt::closest_triangle;
using grt::FULL_WARP;
using grt::GEO_ROWS;
using grt::halton_at;
using grt::occluded;
using grt::occluded_grouped_warp;
using grt::SPH_ROWS;
using grt::sphere_roots;
using grt::stratify;
using grt::SUPER;

constexpr int OCC_BIT = 1 << 20;
constexpr float BIG = 1e30f;
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr int ATTR_ROWS = 13;   // normal, diffuse, emissive, is_emissive, sphere center
constexpr int BLOCK_THREADS = 128;
constexpr int DRAWS_THREADS = 128;    // draws_kernel's blocks
constexpr int STATIC_MIN_BLOCKS = 9;    // the static tier's blocks per SM: 56 registers
constexpr int GROUPED_THREADS = 384;    // the grouped tier's persistent blocks
constexpr int GROUPED_WARPS = GROUPED_THREADS / 32;
// The grouped tier's blocks per SM: 2 (80 registers) for the narrow sweep, 3
// (56) for the wide one.
constexpr int GROUPED_MIN_BLOCKS = 2;
constexpr int GROUPED_MIN_BLOCKS_WIDE = 3;
constexpr size_t STATIC_SMEM_BYTES = 48 * 1024;  // the static tier stages at most this
constexpr size_t MAX_SMEM_BYTES = 227 * 1024;    // one block's most on sm_90

// Bounce B's four planes of one (pixel, sample) item, at plane offset o, then
// the next bounce's, n floats on.
template <int B, int BOUNCES, bool SHORT>
__device__ __forceinline__ void bounce_planes(uint32_t ih, size_t o, int n,
                                             float* __restrict__ nee0, float* __restrict__ nee1,
                                             float* __restrict__ cos0, float* __restrict__ cos1) {
  nee0[o] = halton_at<2 + 5 * B + 0, SHORT>(ih);
  nee1[o] = halton_at<2 + 5 * B + 1, SHORT>(ih);
  cos0[o] = halton_at<2 + 5 * B + 2, SHORT>(ih);
  cos1[o] = halton_at<2 + 5 * B + 3, SHORT>(ih);
  if constexpr (B + 1 < BOUNCES) {
    bounce_planes<B + 1, BOUNCES, SHORT>(ih, o + n, n, nee0, nee1, cos0, cos1);
  }
}

// One (pixel, sample) item at Halton index ih: the jitter pair at sn, the
// bounces' planes from o on.
template <int BOUNCES, bool SHORT>
__device__ __forceinline__ void draws_item(uint32_t ih, int spp, int strat_k, float inv_k,
                                           size_t sn, size_t o, int n,
                                           float* __restrict__ nee0, float* __restrict__ nee1,
                                           float* __restrict__ cos0, float* __restrict__ cos1,
                                           float* __restrict__ jx, float* __restrict__ jy) {
  float x = halton_at<0, SHORT>(ih);
  float y = halton_at<1, SHORT>(ih);
  stratify(ih, spp, strat_k, inv_k, &x, &y);
  jx[sn] = x;
  jy[sn] = y;
  bounce_planes<0, BOUNCES, SHORT>(ih, o, n, nee0, nee1, cos0, cos1);
}

// The loop form of an item whose index is at or above HALTON_SHORT, out of
// line: no render makes such an index.
template <int BOUNCES>
__device__ __noinline__ void draws_item_loop(uint32_t ih, int spp, int strat_k, float inv_k,
                                             size_t sn, size_t o, int n, float* nee0,
                                             float* nee1, float* cos0, float* cos1, float* jx,
                                             float* jy) {
  draws_item<BOUNCES, false>(ih, spp, strat_k, inv_k, sn, o, n, nee0, nee1, cos0, cos1, jx,
                             jy);
}

// One thread per (pixel i, sample blockIdx.y); every dimension a compile-time
// constant.  An item whose index is below HALTON_SHORT (every item of a
// render) takes the short form of all its radical inverses (fourteen at
// three bounces): straight-line code whose chains the compiler interleaves.
template <int BOUNCES>
__global__ void __launch_bounds__(DRAWS_THREADS)
draws_kernel(const int32_t* __restrict__ offsets, int n, int spp,
             int strat_k, float inv_k,
             float* __restrict__ nee0, float* __restrict__ nee1,
             float* __restrict__ cos0, float* __restrict__ cos1,
             float* __restrict__ jx, float* __restrict__ jy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (i >= n) return;
  const uint32_t ih = (uint32_t)offsets[i] + (uint32_t)s;
  const size_t sn = (size_t)s * n + i;
  const size_t o = (size_t)s * BOUNCES * n + i;
  if (ih < grt::HALTON_SHORT) {
    draws_item<BOUNCES, true>(ih, spp, strat_k, inv_k, sn, o, n, nee0, nee1, cos0, cos1, jx,
                              jy);
  } else {
    draws_item_loop<BOUNCES>(ih, spp, strat_k, inv_k, sn, o, n, nee0, nee1, cos0, cos1, jx,
                             jy);
  }
}

struct PathParams {
  const int32_t* offsets;     // [n_local] Halton index offset per pixel
  const float* cam;           // [12] position, u*half_w, v*half_h, w
  const float* light;         // [6] center xyz, color rgb
  const float* tri;           // [19, T] packed triangle rows (first 12: geometry)
  const float* sph;           // [11, max(S,1)] packed sphere rows (first 4: geometry)
  const float* atab;          // [13, T + S] attribute rows; grouped: [T + S][13]
  const int32_t* shadow_idx;  // [n_shadow] triangles kept in the shadow loop
  const float4* geo;          // grouped: [P_gpad][12] triangle geometry
  const float4* aabb;         // grouped: [n_super * 8][8] group boxes
  const float4* sup;          // grouped: [n_super][8] super boxes
  const float4* sgeo;         // grouped: the shadow loop's three tables
  const float4* saabb;
  const float4* ssup;
  const float* nee0;          // draw planes (READ_DRAWS only)
  const float* nee1;
  const float* cos0;
  const float* cos1;
  const float* jx;
  const float* jy;
  float* hdr;                 // [3, n_local]
  int32_t* records;           // [spp, bounces, n_local] (EMIT only)
  int* tiles_taken;           // grouped: the tile counter, 0 at launch
  int n_local, rid_base, width, height, spp, bounces;
  int num_tris, num_spheres, n_shadow, strat_k;
  int n_super, n_shadow_super;  // grouped: supers of the two sweeps
  float inv_k, half_extent;
};

// The scene as trace_pixel reads it.  Static tier: [T][12] geometry,
// [n_shadow][12] occluders, [S][4] spheres and [T + S][13] attributes, all in
// shared memory.  Grouped tier: the spheres and the four box tables in shared
// memory, the geometry and the attributes in global memory.
struct Tables {
  const float* geo;
  const float* shadow;
  const float* sph;
  const float* attr;
  const float4* aabb;
  const float4* sup;
  const float4* saabb;
  const float4* ssup;
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// One pixel's spp x bounces paths; pixel i of the range, whose outputs are
// written only where in_range (the grouped tier's last tile runs lanes past
// the range on pixel n_local - 1, which take part in the votes).
template <bool EMIT, bool READ_DRAWS, bool GROUPED, bool WIDE>
__device__ __forceinline__ void trace_pixel(const PathParams& p, const Tables& sc, int i,
                                            bool in_range) {
  const int T = p.num_tris;
  const int S = p.num_spheres;
  const int W = p.width, H = p.height;
  const int n_local = p.n_local;
  const int rid = p.rid_base + i;             // global pixel id
  const float px = (float)(rid % W);
  const float py = (float)(rid / W);
  const bool in_image = rid < W * H;
  const uint32_t off = (uint32_t)p.offsets[i];

  const float posx = p.cam[0], posy = p.cam[1], posz = p.cam[2];
  const float uhx = p.cam[3], uhy = p.cam[4], uhz = p.cam[5];
  const float vhx = p.cam[6], vhy = p.cam[7], vhz = p.cam[8];
  const float wvx = p.cam[9], wvy = p.cam[10], wvz = p.cam[11];
  const float lcx = p.light[0], lcy = p.light[1], lcz = p.light[2];
  const float lr = p.light[3], lg = p.light[4], lb = p.light[5];
  const float he = p.half_extent;
  const float two_pi = (float)(2.0 * 3.14159265358979323846);
  const float fW = (float)W, fH = (float)H;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (int n = 0; n < p.spp; ++n) {
    const uint32_t ih = off + (uint32_t)n;
    float jx, jy;
    if (READ_DRAWS) {
      const size_t sn = (size_t)n * n_local + i;
      jx = p.jx[sn];
      jy = p.jy[sn];
    } else {
      camera_jitter(ih, p.spp, p.strat_k, p.inv_k, &jx, &jy);
    }

    // Camera ray (sampling.metal:125-157); basis prescaled on the host.
    const float s = ((px + jx) / fW) * 2.0f - 1.0f;
    const float t = -(((py + jy) / fH) * 2.0f - 1.0f);
    float dx = s * uhx + t * vhx - wvx;
    float dy = s * uhy + t * vhy - wvy;
    float dz = s * uhz + t * vhz - wvz;
    {
      const float inv = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
      dx *= inv; dy *= inv; dz *= inv;
    }
    float ox = posx, oy = posy, oz = posz;

    float col_r = 1.0f, col_g = 1.0f, col_b = 1.0f;
    float a_r = 0.0f, a_g = 0.0f, a_b = 0.0f;
    bool alive = in_image;
    // Whether the lane traces this bounce: with EMIT every lane in range; in
    // hdr mode until its path leaves the surfaces.
    bool running = in_range;

    for (int bounce = 0; bounce < p.bounces; ++bounce) {
      // ---- closest hit: triangles in index order with strict <, then spheres
      float t_best = BIG;
      int prim = -1;
      if constexpr (!GROUPED) {
        closest_triangle(sc.geo, T, ox, oy, oz, dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best,
                         &prim);
      } else if constexpr (WIDE) {
        closest_grouped_wide(p.geo, sc.aabb, sc.sup, p.n_super, T, running, ox, oy, oz,
                             dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best, &prim);
      } else {
        closest_grouped_warp(p.geo, sc.aabb, sc.sup, p.n_super, T, running, ox, oy, oz,
                             dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best, &prim);
      }
      for (int k = 0; k < S; ++k) {
        float t1, t2;
        const bool pos = sphere_roots(sc.sph + SPH_ROWS * k, ox, oy, oz, dx, dy, dz,
                                      &t1, &t2);
        const bool t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
        const bool t2_ok = (t2 > RAY_TMIN) && (t2 < RAY_TMAX);
        const float tt = t1_ok ? t1 : t2;
        if (pos && (t1_ok || t2_ok) && (tt < t_best)) { t_best = tt; prim = T + k; }
      }
      const bool hit = t_best < BIG * 0.5f;

      // ---- attributes of the winner by index (a miss reads primitive 0;
      // every use below is gated by hit-derived masks)
      const float* at = sc.attr + ATTR_ROWS * (prim < 0 ? 0 : prim);
      float nhx = at[0], nhy = at[1], nhz = at[2];
      const float dfr = at[3], dfg = at[4], dfb = at[5];
      const bool is_em = at[9] > 0.5f;
      if (S > 0) {
        // Sphere normal: (hit point - center) normalized, floor 1e-6.
        const bool sphere_won = hit && (prim >= T);
        const float t_s = sphere_won ? t_best : 0.0f;
        const float nvx = ox + dx * t_s - at[10];
        const float nvy = oy + dy * t_s - at[11];
        const float nvz = oz + dz * t_s - at[12];
        const float inv = 1.0f / sqrtf(fmaxf(nvx * nvx + nvy * nvy + nvz * nvz, 1e-6f));
        if (sphere_won) { nhx = nvx * inv; nhy = nvy * inv; nhz = nvz * inv; }
      }

      const bool active = alive && hit;
      // Emissive hit REPLACES the accumulator and ends the path
      // (raytrace.metal:57-60).
      if (active && is_em) { a_r = at[6]; a_g = at[7]; a_b = at[8]; }
      const bool surf = active && !is_em;
      if (!EMIT) {  // nothing later can change the sums of a lane off a surface
        running = running && surf;
        if constexpr (GROUPED) {
          if (__ballot_sync(FULL_WARP, running) == 0u) break;
        } else if (!running) {
          break;
        }
      }

      const float t_safe = surf ? t_best : 0.0f;
      const float hx = ox + dx * t_safe + nhx * 1e-3f;
      const float hy = oy + dy * t_safe + nhy * 1e-3f;
      const float hz = oz + dz * t_safe + nhz * 1e-3f;

      // ---- NEE (sampleAreaLight, sampling.metal:198-236): hardcoded frame
      // right=(he,0,0), up=(0,0,he), light normal (0,-1,0).
      float u_nee0, u_nee1, u0, u1;
      if (READ_DRAWS) {
        const size_t o = ((size_t)n * p.bounces + bounce) * n_local + i;
        u_nee0 = p.nee0[o]; u_nee1 = p.nee1[o];
        u0 = p.cos0[o]; u1 = p.cos1[o];
      } else {
        float u[4];
        bounce_draws(ih, bounce, u);
        u_nee0 = u[0]; u_nee1 = u[1];
        u0 = u[2]; u1 = u[3];
      }
      const float w0 = u_nee0 * 2.0f - 1.0f;
      const float w1 = u_nee1 * 2.0f - 1.0f;
      const float tlx = lcx + he * w0 - hx;
      const float tly = lcy - hy;
      const float tlz = lcz + he * w1 - hz;
      const float ldist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 0.0f));
      const float inv_d = 1.0f / fmaxf(ldist, 1e-3f);
      const float ldx = tlx * inv_d, ldy = tly * inv_d, ldz = tlz * inv_d;
      const float cos_l = clamp01(ldy);  // -ld . (0,-1,0)
      const float fall = inv_d * inv_d * cos_l;
      const float cos_s = clamp01(nhx * ldx + nhy * ldy + nhz * ldz);
      const float gain = fall * cos_s;

      if (surf) { col_r *= dfr; col_g *= dfg; col_b *= dfb; }

      // ---- shadow probe: any hit in (0, ldist - 1e-3) over the occluder
      // list, triangles (to the first occluder) then spheres
      bool occ;
      if constexpr (GROUPED) {
        occ = occluded_grouped_warp(p.sgeo, sc.saabb, sc.ssup, p.n_shadow_super,
                                    p.n_shadow, running, hx, hy, hz, ldx, ldy, ldz, 0.0f,
                                    ldist - 1e-3f);
      } else {
        occ = any_triangle_filtered(sc.shadow, p.n_shadow, hx, hy, hz, ldx, ldy, ldz, 0.0f,
                                    ldist - 1e-3f);
      }
      occ = occ || occluded(sc.shadow, 0, sc.sph, S, hx, hy, hz, ldx, ldy, ldz,
                            ldist - 1e-3f);
      if (EMIT && in_range) {
        p.records[((size_t)n * p.bounces + bounce) * n_local + i] =
            (prim + 1) + (occ ? OCC_BIT : 0);
      }
      if (!running) {
        // The grouped tier's lanes that trace nothing: in hdr mode the path
        // has ended, so a sphere the unchanged ray meets on a later bounce
        // (which the sphere loop still tests) must not count as a hit.
        alive = false;
        continue;
      }
      const float w_c = (surf && !occ) ? gain : 0.0f;
      a_r = a_r + lr * w_c * col_r;
      a_g = a_g + lg * w_c * col_g;
      a_b = a_b + lb * w_c * col_b;

      // ---- cosine bounce (sampling.metal:39-66) about the fixed-axis basis
      const float phi = two_pi * u0;
      const float cth = sqrtf(u1);
      const float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
      const float lx = sth * cosf(phi);
      const float ly = cth;
      const float lz = sth * sinf(phi);
      const float ax = 0.0072f, ay = 1.0f, az = 0.0034f;
      float rx = nhy * az - nhz * ay;
      float ry = nhz * ax - nhx * az;
      float rz = nhx * ay - nhy * ax;
      {
        const float inv = 1.0f / sqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-12f));
        rx *= inv; ry *= inv; rz *= inv;
      }
      const float fx = ry * nhz - rz * nhy;
      const float fy = rz * nhx - rx * nhz;
      const float fz = rx * nhy - ry * nhx;
      const float sdx = lx * rx + ly * nhx + lz * fx;
      const float sdy = lx * ry + ly * nhy + lz * fy;
      const float sdz = lx * rz + ly * nhz + lz * fz;

      if (surf) { ox = hx; oy = hy; oz = hz; dx = sdx; dy = sdy; dz = sdz; }
      alive = surf;
    }

    acc_r += a_r;
    acc_g += a_g;
    acc_b += a_b;
  }

  if (in_range) {
    const float inv_spp = (float)(1.0 / (double)p.spp);
    p.hdr[i] = acc_r * inv_spp;
    p.hdr[(size_t)n_local + i] = acc_g * inv_spp;
    p.hdr[2 * (size_t)n_local + i] = acc_b * inv_spp;
  }
}

// The static tier (K2): one thread per pixel, blocks of BLOCK_THREADS, at
// least STATIC_MIN_BLOCKS of them per SM, the scene tables staged per block.
template <bool EMIT, bool READ_DRAWS>
__global__ void __launch_bounds__(BLOCK_THREADS, STATIC_MIN_BLOCKS)
    path_kernel(const PathParams p) {
  extern __shared__ float4 smem4[];
  const int T = p.num_tris;
  const int S = p.num_spheres;
  const int P = T + S;
  float* s_geo = reinterpret_cast<float*>(smem4);  // [T][12]
  float* s_shadow = s_geo + GEO_ROWS * T;          // [n_shadow][12]
  float* s_sph = s_shadow + GEO_ROWS * p.n_shadow;  // [S][4]
  float* s_attr = s_sph + SPH_ROWS * S;            // [T + S][13]
  for (int k = threadIdx.x; k < GEO_ROWS * T; k += blockDim.x) {
    const int t = k / GEO_ROWS, r = k - t * GEO_ROWS;
    s_geo[k] = p.tri[r * T + t];
  }
  for (int k = threadIdx.x; k < GEO_ROWS * p.n_shadow; k += blockDim.x) {
    const int j = k / GEO_ROWS, r = k - j * GEO_ROWS;
    s_shadow[k] = p.tri[r * T + p.shadow_idx[j]];
  }
  for (int k = threadIdx.x; k < SPH_ROWS * S; k += blockDim.x) {
    const int s = k / SPH_ROWS, r = k - s * SPH_ROWS;
    s_sph[k] = p.sph[r * S + s];
  }
  for (int k = threadIdx.x; k < ATTR_ROWS * P; k += blockDim.x) {
    const int q = k / ATTR_ROWS, r = k - q * ATTR_ROWS;
    s_attr[k] = p.atab[r * P + q];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_local) return;
  Tables sc{};
  sc.geo = s_geo; sc.shadow = s_shadow; sc.sph = s_sph; sc.attr = s_attr;
  trace_pixel<EMIT, READ_DRAWS, false, false>(p, sc, i, true);
}

// The grouped tier (K2g): a persistent grid of GROUPED_THREADS-thread blocks
// whose warps take 32-pixel tiles from a counter (*tiles_taken, 0 at launch)
// until the range is done.  WIDE: the closest-hit sweep for more than
// WIDE_SUPERS supers.
template <bool EMIT, bool READ_DRAWS, bool WIDE>
__global__ void __launch_bounds__(GROUPED_THREADS,
                                  WIDE ? GROUPED_MIN_BLOCKS_WIDE : GROUPED_MIN_BLOCKS)
    path_grouped_kernel(const PathParams p) {
  extern __shared__ float4 smem4[];
  const int S = p.num_spheres;
  float* s_sph = reinterpret_cast<float*>(smem4);  // [S][4]
  for (int k = threadIdx.x; k < SPH_ROWS * S; k += blockDim.x) {
    const int s = k / SPH_ROWS, r = k - s * SPH_ROWS;
    s_sph[k] = p.sph[r * S + s];
  }
  // [2 n_super] supers, [16 n_super] groups, the same for the shadow sweep
  // (box rows are two float4).
  float4* s_sup = reinterpret_cast<float4*>(s_sph + SPH_ROWS * S);
  float4* s_aabb = s_sup + 2 * p.n_super;
  float4* s_ssup = s_aabb + 2 * SUPER * p.n_super;
  float4* s_saabb = s_ssup + 2 * p.n_shadow_super;
  for (int k = threadIdx.x; k < 2 * p.n_super; k += blockDim.x) {
    grt::cp_async16(s_sup + k, p.sup + k);
  }
  for (int k = threadIdx.x; k < 2 * SUPER * p.n_super; k += blockDim.x) {
    grt::cp_async16(s_aabb + k, p.aabb + k);
  }
  for (int k = threadIdx.x; k < 2 * p.n_shadow_super; k += blockDim.x) {
    grt::cp_async16(s_ssup + k, p.ssup + k);
  }
  for (int k = threadIdx.x; k < 2 * SUPER * p.n_shadow_super; k += blockDim.x) {
    grt::cp_async16(s_saabb + k, p.saabb + k);
  }
  grt::cp_async_wait_all();
  __syncthreads();

  Tables sc{};
  sc.sph = s_sph; sc.attr = p.atab;
  sc.aabb = s_aabb; sc.sup = s_sup; sc.saabb = s_saabb; sc.ssup = s_ssup;
  const int lane = threadIdx.x & 31;
  const int tiles = (p.n_local + 31) / 32;
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(p.tiles_taken, 1);
    tile = __shfl_sync(FULL_WARP, tile, 0);
    if (tile >= tiles) break;
    const int i = tile * 32 + lane;
    const bool in_range = i < p.n_local;
    trace_pixel<EMIT, READ_DRAWS, true, WIDE>(p, sc, in_range ? i : p.n_local - 1,
                                              in_range);
  }
}

// Shared memory of the static tier: the triangles, the shadow list, the
// spheres and the attributes (floats).
size_t static_smem(int num_tris, int n_shadow, int num_spheres) {
  return sizeof(float) * ((size_t)GEO_ROWS * (num_tris + n_shadow)
                          + (size_t)SPH_ROWS * num_spheres
                          + (size_t)ATTR_ROWS * (num_tris + num_spheres));
}

// Shared memory of the grouped tier: the spheres (floats) and the four box
// tables (float4).
size_t grouped_smem(int num_spheres, int n_super, int n_shadow_super) {
  return sizeof(float) * (size_t)SPH_ROWS * num_spheres
         + sizeof(float4) * 2 * (1 + SUPER) * ((size_t)n_super + n_shadow_super);
}

using PathKernel = void (*)(const PathParams);

// The kernel of a tier and mode: path_kernel<EMIT, READ_DRAWS> (static) or
// path_grouped_kernel<EMIT, READ_DRAWS, WIDE>.
template <bool GROUPED, bool WIDE>
PathKernel kernel_of(bool emit, bool read_draws) {
  if constexpr (GROUPED) {
    if (read_draws) return path_grouped_kernel<true, true, WIDE>;
    return emit ? path_grouped_kernel<true, false, WIDE> : path_grouped_kernel<false, false, WIDE>;
  } else {
    if (read_draws) return path_kernel<true, true>;
    return emit ? path_kernel<true, false> : path_kernel<false, false>;
  }
}

PathKernel kernel_for(bool grouped, bool wide, bool emit, bool read_draws) {
  if (!grouped) return kernel_of<false, false>(emit, read_draws);
  return wide ? kernel_of<true, true>(emit, read_draws)
              : kernel_of<true, false>(emit, read_draws);
}

}  // namespace

extern "C" {

// Launches draws_kernel on `stream`; returns cudaGetLastError() as an int.
int grt_pregen_draws(const int32_t* offsets, int n, int spp, int bounces,
                     int strat_k, float inv_k, float* nee0, float* nee1,
                     float* cos0, float* cos1, float* jx, float* jy,
                     void* stream) {
  if (n <= 0 || spp <= 0 || spp > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + DRAWS_THREADS - 1) / DRAWS_THREADS, spp);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bounces) {  // at most 4: the prime bases end at dimension 23
    case 1: draws_kernel<1><<<grid, DRAWS_THREADS, 0, st>>>(
        offsets, n, spp, strat_k, inv_k, nee0, nee1, cos0, cos1, jx, jy); break;
    case 2: draws_kernel<2><<<grid, DRAWS_THREADS, 0, st>>>(
        offsets, n, spp, strat_k, inv_k, nee0, nee1, cos0, cos1, jx, jy); break;
    case 3: draws_kernel<3><<<grid, DRAWS_THREADS, 0, st>>>(
        offsets, n, spp, strat_k, inv_k, nee0, nee1, cos0, cos1, jx, jy); break;
    case 4: draws_kernel<4><<<grid, DRAWS_THREADS, 0, st>>>(
        offsets, n, spp, strat_k, inv_k, nee0, nee1, cos0, cos1, jx, jy); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Blocks of draws_kernel at `bounces` that one SM of the current device
// holds; 0 where the query fails or bounces is not 1 to 4.
int grt_draws_blocks_per_sm(int bounces) {
  switch (bounces) {
    case 1: return grt::blocks_per_sm(draws_kernel<1>, DRAWS_THREADS, 0);
    case 2: return grt::blocks_per_sm(draws_kernel<2>, DRAWS_THREADS, 0);
    case 3: return grt::blocks_per_sm(draws_kernel<3>, DRAWS_THREADS, 0);
    case 4: return grt::blocks_per_sm(draws_kernel<4>, DRAWS_THREADS, 0);
    default: return 0;
  }
}

// Shared memory bytes of the static tier (ops/cuda_path.static_smem_bytes
// mirrors it).
int grt_path_static_smem(int num_tris, int n_shadow, int num_spheres) {
  return (int)static_smem(num_tris, n_shadow, num_spheres);
}

// Shared memory bytes of the grouped tier (ops/cuda_path.grouped_smem_bytes
// mirrors it).
int grt_path_grouped_smem(int num_spheres, int n_super, int n_shadow_super) {
  return (int)grouped_smem(num_spheres, n_super, n_shadow_super);
}

// Blocks of a tier's kernel in a mode that one SM of the current device holds
// at this shape (grouped != 0: the grouped tier, its WIDE instantiation above
// WIDE_SUPERS supers); 0 where the query fails.
int grt_path_blocks_per_sm(int grouped, int emit_records, int read_draws, int num_tris,
                           int n_shadow, int num_spheres, int n_super, int n_shadow_super) {
  if (grouped) {
    return grt::blocks_per_sm(
        kernel_for(true, n_super > grt::WIDE_SUPERS, emit_records, read_draws),
        GROUPED_THREADS, grouped_smem(num_spheres, n_super, n_shadow_super));
  }
  return grt::blocks_per_sm(kernel_for(false, false, emit_records, read_draws),
                            BLOCK_THREADS, static_smem(num_tris, n_shadow, num_spheres));
}

// Launches path_kernel (static tier) or path_grouped_kernel on `stream`;
// returns cudaGetLastError() as an int. grouped != 0 takes the grouped tier:
// geo, aabb, sup, sgeo, saabb, ssup, the two super counts and tiles_taken (one
// int32 that is 0) are read, tri and shadow_idx are not, and atab is
// [T + S][13].
int grt_path_trace(const int32_t* offsets, const float* cam, const float* light,
                   const float* tri, const float* sph, const float* atab,
                   const int32_t* shadow_idx, const float* nee0,
                   const float* nee1, const float* cos0, const float* cos1,
                   const float* jx, const float* jy, float* hdr,
                   int32_t* records, const float* geo, const float* aabb,
                   const float* sup, const float* sgeo, const float* saabb,
                   const float* ssup, int32_t* tiles_taken, int n_local, int rid_base,
                   int width, int height, int spp, int bounces, int num_tris,
                   int num_spheres, int n_shadow, int strat_k, int n_super,
                   int n_shadow_super, float inv_k, float half_extent,
                   int emit_records, int read_draws, int grouped, void* stream) {
  PathParams p;
  p.offsets = offsets; p.cam = cam; p.light = light; p.tri = tri; p.sph = sph;
  p.atab = atab; p.shadow_idx = shadow_idx;
  p.geo = reinterpret_cast<const float4*>(geo);
  p.aabb = reinterpret_cast<const float4*>(aabb);
  p.sup = reinterpret_cast<const float4*>(sup);
  p.sgeo = reinterpret_cast<const float4*>(sgeo);
  p.saabb = reinterpret_cast<const float4*>(saabb);
  p.ssup = reinterpret_cast<const float4*>(ssup);
  p.tiles_taken = tiles_taken;
  p.n_super = n_super; p.n_shadow_super = n_shadow_super;
  p.nee0 = nee0; p.nee1 = nee1; p.cos0 = cos0; p.cos1 = cos1; p.jx = jx; p.jy = jy;
  p.hdr = hdr; p.records = records;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.spp = spp; p.bounces = bounces; p.num_tris = num_tris;
  p.num_spheres = num_spheres; p.n_shadow = n_shadow; p.strat_k = strat_k;
  p.inv_k = inv_k; p.half_extent = half_extent;

  if (n_local <= 0 || (read_draws && !emit_records)) return (int)cudaErrorInvalidValue;
  if (grouped && (geo == nullptr || aabb == nullptr || sup == nullptr || sgeo == nullptr
                  || saabb == nullptr || ssup == nullptr || tiles_taken == nullptr
                  || n_super <= 0 || n_shadow_super <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = grouped ? grouped_smem(num_spheres, n_super, n_shadow_super)
                              : static_smem(num_tris, n_shadow, num_spheres);
  if (smem > (grouped ? MAX_SMEM_BYTES : STATIC_SMEM_BYTES)) {
    return (int)cudaErrorInvalidValue;
  }
  const PathKernel kernel =
      kernel_for(grouped, n_super > grt::WIDE_SUPERS, emit_records, read_draws);
  cudaStream_t st = (cudaStream_t)stream;
  if (!grouped) {
    kernel<<<(n_local + BLOCK_THREADS - 1) / BLOCK_THREADS, BLOCK_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  // The grouped tier's grid: the blocks the card holds at once (allow_smem
  // inside the query opts in above 48 KiB), at most one per GROUPED_WARPS
  // 32-pixel tiles.
  int dev = 0, sms = 0;
  const int per_sm = grt::blocks_per_sm(kernel, GROUPED_THREADS, smem);
  if (per_sm <= 0 || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int wanted = ((n_local + 31) / 32 + GROUPED_WARPS - 1) / GROUPED_WARPS;
  const int grid = sms * per_sm < wanted ? sms * per_sm : wanted;
  kernel<<<grid, GROUPED_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
