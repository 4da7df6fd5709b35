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
// floats and reads N offsets; the radical inverses cost a few hundred integer
// and float operations per (pixel, sample), far below what the memory system
// needs for the 4*(4*bounces+2) bytes they produce.  Design: one thread per
// (pixel, sample) with neighbouring threads on neighbouring pixels, so every
// store of a warp is one contiguous 128-byte line; digit extraction is uint32
// / and % by a compile-time base (the compiler turns them into multiply-shift),
// and the digit loop ends when the index is exhausted.
//
// ---------------------------------------------------------------------------
// path_kernel   replaces  gpuraytracer_tpu/ops/pallas_path.py:_path_kernel
//               static tier (GROUPED = false: at most 64 triangles, plus
//               analytic spheres) and grouped tier (GROUPED = true: any
//               number of triangles up to the record encoding's limit)
// ---------------------------------------------------------------------------
// Per pixel: spp samples x `bounces` bounces of camera ray -> closest hit over
// all triangles (plane + dual basis) and spheres -> emissive replace / NEE with
// an any-hit shadow probe over the occluder list -> cosine bounce.  Modes:
// hdr only; EMIT (one int32 record (prim+1) + OCC_BIT*occluded per (sample,
// bounce, pixel)); READ_DRAWS (the six draw planes come from draws_kernel
// instead of being radical-inversed in the loop).
//
// Bound on this card: OPERATIONS in hdr mode and records-only mode — per live
// (sample, bounce, pixel) T closest-hit tests (49 f32 operations each), n_shadow
// any-hit tests (46 each) and 2*S sphere tests (43 + 39), against a few bytes
// per pixel of traffic; f32 scalar math, so the yardstick is the card's
// non-tensor f32 rate.  With EMIT and READ_DRAWS it is the larger of that and
// the record and draw bytes ((4*bounces+2)*4 B read and 4*bounces B written
// per sample and pixel).  Design: one thread per pixel with the sample and
// bounce loops inside the thread and all path state in registers; the scene
// tables (a few KB) are staged once per block in shared memory, triangle-major
// so that one triangle is three 16-byte loads that all threads of a warp take
// from the same address (a broadcast); the winner's attributes are fetched by
// index; the shadow loop runs over a compacted copy of the occluder list.  In
// hdr mode a dead path leaves the bounce loop; with EMIT it runs on masked,
// because records are defined for every (sample, bounce, pixel).
//
// The grouped tier (the TPU kernel's grouped=True branch, pallas_path.py:
// 532-590 closest hit, 643-700 shadow probe) keeps all of the above except
// the scene tables: the geometry (48 B per triangle: 48 KB at 1,002
// triangles, 614 KB at 12,802) stays in global memory and is read through
// the read-only path, where L2 holds it; each thread runs the reference's
// two-level sweep (trace.cuh closest_grouped / occluded_grouped): per super
// of 128 triangles, then per group of 16, a slab test of the padded box
// against the ray's far limit, which tightens with the closest hit so far,
// and the group's triangle tests only where the box is reached.  The work a
// ray does follows the boxes it reaches, not the triangle count.  A thread
// skips a box on its own (the TPU skipped it only when no lane of a tile
// reached it): the decisions are the same, warps diverge.  Bound: OPERATIONS,
// counted from the box and triangle tests this frame's live lanes execute.
// The attributes ([T + S][13]) are read from global memory by the winner's
// index; the spheres stay in shared memory.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "halton.cuh"
#include "trace.cuh"

namespace {

using grt::camera_jitter;
using grt::closest_grouped;
using grt::closest_triangle;
using grt::GEO_ROWS;
using grt::halton;
using grt::occluded;
using grt::occluded_grouped;
using grt::SPH_ROWS;
using grt::sphere_roots;

constexpr int OCC_BIT = 1 << 20;
constexpr float BIG = 1e30f;
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr int ATTR_ROWS = 13;   // normal, diffuse, emissive, is_emissive, sphere center
constexpr int BLOCK_THREADS = 128;

__global__ void __launch_bounds__(BLOCK_THREADS)
draws_kernel(const int32_t* __restrict__ offsets, int n, int spp, int bounces,
             int strat_k, float inv_k,
             float* __restrict__ nee0, float* __restrict__ nee1,
             float* __restrict__ cos0, float* __restrict__ cos1,
             float* __restrict__ jx, float* __restrict__ jy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (i >= n) return;
  const uint32_t ih = (uint32_t)offsets[i] + (uint32_t)s;
  float x, y;
  camera_jitter(ih, spp, strat_k, inv_k, &x, &y);
  const size_t sn = (size_t)s * n + i;
  jx[sn] = x;
  jy[sn] = y;
  for (int b = 0; b < bounces; ++b) {
    const size_t o = ((size_t)s * bounces + b) * n + i;
    nee0[o] = halton(ih, 2 + 5 * b + 0);
    nee1[o] = halton(ih, 2 + 5 * b + 1);
    cos0[o] = halton(ih, 2 + 5 * b + 2);
    cos1[o] = halton(ih, 2 + 5 * b + 3);
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
  int n_local, rid_base, width, height, spp, bounces;
  int num_tris, num_spheres, n_shadow, strat_k;
  int n_super, n_shadow_super;  // grouped: supers of the two sweeps
  float inv_k, half_extent;
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

template <bool EMIT, bool READ_DRAWS, bool GROUPED>
__global__ void __launch_bounds__(BLOCK_THREADS) path_kernel(const PathParams p) {
  extern __shared__ float4 smem4[];
  const int T = p.num_tris;
  const int S = p.num_spheres;
  const int P = T + S;
  // Static tier: [T][12] geometry, [n_shadow][12] occluders, [S][4] spheres,
  // [T + S][13] attributes.  Grouped tier: the spheres alone.
  float* s_geo = reinterpret_cast<float*>(smem4);
  float* s_shadow = s_geo + (GROUPED ? 0 : GEO_ROWS * T);
  float* s_sph = s_shadow + (GROUPED ? 0 : GEO_ROWS * p.n_shadow);
  float* s_attr = s_sph + SPH_ROWS * S;

  if (!GROUPED) {
    for (int k = threadIdx.x; k < GEO_ROWS * T; k += blockDim.x) {
      const int t = k / GEO_ROWS, r = k - t * GEO_ROWS;
      s_geo[k] = p.tri[r * T + t];
    }
    for (int k = threadIdx.x; k < GEO_ROWS * p.n_shadow; k += blockDim.x) {
      const int j = k / GEO_ROWS, r = k - j * GEO_ROWS;
      s_shadow[k] = p.tri[r * T + p.shadow_idx[j]];
    }
  }
  for (int k = threadIdx.x; k < SPH_ROWS * S; k += blockDim.x) {
    const int s = k / SPH_ROWS, r = k - s * SPH_ROWS;
    s_sph[k] = p.sph[r * S + s];
  }
  if (!GROUPED) {
    for (int k = threadIdx.x; k < ATTR_ROWS * P; k += blockDim.x) {
      const int q = k / ATTR_ROWS, r = k - q * ATTR_ROWS;
      s_attr[k] = p.atab[r * P + q];
    }
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_local) return;

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

    for (int bounce = 0; bounce < p.bounces; ++bounce) {
      // ---- closest hit: triangles in index order with strict <, then spheres
      float t_best = BIG;
      int prim = -1;
      if (GROUPED) {
        closest_grouped(p.geo, p.aabb, p.sup, p.n_super, T, ox, oy, oz, dx, dy, dz,
                        RAY_TMIN, RAY_TMAX, &t_best, &prim);
      } else {
        closest_triangle(s_geo, T, ox, oy, oz, dx, dy, dz, RAY_TMIN, RAY_TMAX,
                         &t_best, &prim);
      }
      for (int k = 0; k < S; ++k) {
        float t1, t2;
        const bool pos = sphere_roots(s_sph + SPH_ROWS * k, ox, oy, oz, dx, dy, dz,
                                      &t1, &t2);
        const bool t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
        const bool t2_ok = (t2 > RAY_TMIN) && (t2 < RAY_TMAX);
        const float tt = t1_ok ? t1 : t2;
        if (pos && (t1_ok || t2_ok) && (tt < t_best)) { t_best = tt; prim = T + k; }
      }
      const bool hit = t_best < BIG * 0.5f;

      // ---- attributes of the winner by index (a miss reads primitive 0;
      // every use below is gated by hit-derived masks)
      const float* at = (GROUPED ? p.atab : s_attr) + ATTR_ROWS * (prim < 0 ? 0 : prim);
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
      if (!EMIT && !surf) break;  // nothing later can change the sums

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
        u_nee0 = halton(ih, 2 + 5 * bounce + 0);
        u_nee1 = halton(ih, 2 + 5 * bounce + 1);
        u0 = halton(ih, 2 + 5 * bounce + 2);
        u1 = halton(ih, 2 + 5 * bounce + 3);
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

      // ---- shadow probe: any hit in (0, ldist - 1e-3) over the occluder list
      bool occ;
      if (GROUPED) {
        // The culled triangles by the sweep, then the spheres (no triangle).
        occ = occluded_grouped(p.sgeo, p.saabb, p.ssup, p.n_shadow_super, p.n_shadow,
                               hx, hy, hz, ldx, ldy, ldz, 0.0f, ldist - 1e-3f)
              || occluded(s_shadow, 0, s_sph, S, hx, hy, hz, ldx, ldy, ldz,
                          ldist - 1e-3f);
      } else {
        occ = occluded(s_shadow, p.n_shadow, s_sph, S, hx, hy, hz, ldx, ldy, ldz,
                       ldist - 1e-3f);
      }
      if (EMIT) {
        p.records[((size_t)n * p.bounces + bounce) * n_local + i] =
            (prim + 1) + (occ ? OCC_BIT : 0);
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

  const float inv_spp = (float)(1.0 / (double)p.spp);
  p.hdr[i] = acc_r * inv_spp;
  p.hdr[(size_t)n_local + i] = acc_g * inv_spp;
  p.hdr[2 * (size_t)n_local + i] = acc_b * inv_spp;
}

}  // namespace

extern "C" {

// Launches draws_kernel on `stream`; returns cudaGetLastError() as an int.
int grt_pregen_draws(const int32_t* offsets, int n, int spp, int bounces,
                     int strat_k, float inv_k, float* nee0, float* nee1,
                     float* cos0, float* cos1, float* jx, float* jy,
                     void* stream) {
  if (n <= 0 || spp <= 0 || spp > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BLOCK_THREADS - 1) / BLOCK_THREADS, spp);
  draws_kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
      offsets, n, spp, bounces, strat_k, inv_k, nee0, nee1, cos0, cos1, jx, jy);
  return (int)cudaGetLastError();
}

// Launches path_kernel on `stream`; returns cudaGetLastError() as an int.
// grouped != 0 takes the grouped tier: geo, aabb, sup, sgeo, saabb, ssup
// and the two super counts are read, tri and shadow_idx are not, and atab is
// [T + S][13].
int grt_path_trace(const int32_t* offsets, const float* cam, const float* light,
                   const float* tri, const float* sph, const float* atab,
                   const int32_t* shadow_idx, const float* nee0,
                   const float* nee1, const float* cos0, const float* cos1,
                   const float* jx, const float* jy, float* hdr,
                   int32_t* records, const float* geo, const float* aabb,
                   const float* sup, const float* sgeo, const float* saabb,
                   const float* ssup, int n_local, int rid_base, int width,
                   int height, int spp, int bounces, int num_tris,
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
  p.n_super = n_super; p.n_shadow_super = n_shadow_super;
  p.nee0 = nee0; p.nee1 = nee1; p.cos0 = cos0; p.cos1 = cos1; p.jx = jx; p.jy = jy;
  p.hdr = hdr; p.records = records;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.spp = spp; p.bounces = bounces; p.num_tris = num_tris;
  p.num_spheres = num_spheres; p.n_shadow = n_shadow; p.strat_k = strat_k;
  p.inv_k = inv_k; p.half_extent = half_extent;

  if (n_local <= 0 || (read_draws && !emit_records)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      grouped ? sizeof(float) * (size_t)SPH_ROWS * num_spheres
              : sizeof(float) * ((size_t)GEO_ROWS * (num_tris + n_shadow)
                                 + (size_t)SPH_ROWS * num_spheres
                                 + (size_t)ATTR_ROWS * (num_tris + num_spheres));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (n_local + BLOCK_THREADS - 1) / BLOCK_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (grouped) {
    if (emit_records && read_draws) {
      path_kernel<true, true, true><<<grid, BLOCK_THREADS, smem, st>>>(p);
    } else if (emit_records) {
      path_kernel<true, false, true><<<grid, BLOCK_THREADS, smem, st>>>(p);
    } else {
      path_kernel<false, false, true><<<grid, BLOCK_THREADS, smem, st>>>(p);
    }
  } else if (emit_records && read_draws) {
    path_kernel<true, true, false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else if (emit_records) {
    path_kernel<true, false, false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else {
    path_kernel<false, false, false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
