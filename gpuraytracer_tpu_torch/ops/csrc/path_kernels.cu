// CUDA kernels of the variant-B path tracer for NVIDIA Hopper (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_path.py).  Build WITHOUT
// --use_fast_math and WITH -fmad=false: the plain PyTorch versions these
// kernels are held against run every multiply and add as its own rounded
// operation, and a contracted a*b+c changes the last bit of a hit distance,
// which flips closest-hit winners and shadow bits on knife-edge rays.  The
// Halton accumulate spells its two roundings out (see radical_inverse), so the
// draws do not depend on that flag.
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
//               (static tier: at most 64 triangles, plus analytic spheres)
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
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OCC_BIT = 1 << 20;
constexpr float BIG = 1e30f;
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr int GEO_ROWS = 12;    // n xyz, c0, s1 xyz, c1, s2 xyz, c2
constexpr int ATTR_ROWS = 13;   // normal, diffuse, emissive, is_emissive, sphere center
constexpr int SPH_ROWS = 4;     // center xyz, radius
constexpr int BLOCK_THREADS = 128;

// Radical inverse of i in base B, accumulated as f *= 1/B; r += f * digit with
// the product and the sum each rounded to float32 (never fused): the plain
// version and the JAX package's draws kernel round the same way, so the draws
// are bit-identical across all three.
template <uint32_t B>
__device__ __forceinline__ float radical_inverse(uint32_t i) {
  const float inv_b = (float)(1.0 / (double)B);
  float f = 1.0f;
  float r = 0.0f;
  while (i > 0u) {
    const uint32_t q = i / B;
    f = __fmul_rn(f, inv_b);
    r = __fadd_rn(r, __fmul_rn(f, (float)(i - q * B)));
    i = q;
  }
  return r;
}

// Halton dimension d uses the d-th prime as its base.
__device__ __forceinline__ float halton(uint32_t i, int d) {
  switch (d) {
    case 0: return radical_inverse<2>(i);
    case 1: return radical_inverse<3>(i);
    case 2: return radical_inverse<5>(i);
    case 3: return radical_inverse<7>(i);
    case 4: return radical_inverse<11>(i);
    case 5: return radical_inverse<13>(i);
    case 6: return radical_inverse<17>(i);
    case 7: return radical_inverse<19>(i);
    case 8: return radical_inverse<23>(i);
    case 9: return radical_inverse<29>(i);
    case 10: return radical_inverse<31>(i);
    case 11: return radical_inverse<37>(i);
    case 12: return radical_inverse<41>(i);
    case 13: return radical_inverse<43>(i);
    case 14: return radical_inverse<47>(i);
    case 15: return radical_inverse<53>(i);
    case 16: return radical_inverse<59>(i);
    case 17: return radical_inverse<61>(i);
    case 18: return radical_inverse<67>(i);
    case 19: return radical_inverse<71>(i);
    case 20: return radical_inverse<73>(i);
    case 21: return radical_inverse<79>(i);
    case 22: return radical_inverse<83>(i);
    default: return radical_inverse<89>(i);
  }
}

// Camera subpixel jitter of Halton index ih: dims 0-1, optionally placed in
// cell (ih % spp) of a k x k grid.
__device__ __forceinline__ void camera_jitter(uint32_t ih, int spp, int strat_k,
                                              float inv_k, float* jx, float* jy) {
  float x = radical_inverse<2>(ih);
  float y = radical_inverse<3>(ih);
  if (strat_k > 0) {
    const uint32_t cell = ih % (uint32_t)spp;
    const uint32_t cy = cell / (uint32_t)strat_k;
    const uint32_t cx = cell - cy * (uint32_t)strat_k;
    x = __fmul_rn(__fadd_rn((float)cx, x), inv_k);
    y = __fmul_rn(__fadd_rn((float)cy, y), inv_k);
  }
  *jx = x;
  *jy = y;
}

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
  const float* atab;          // [13, T + S] attribute rows
  const int32_t* shadow_idx;  // [n_shadow] triangles kept in the shadow loop
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
  float inv_k, half_extent;
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Quadratic ray/sphere roots, in the operation order of the plain version
// (intersect._sphere_candidates).
__device__ __forceinline__ bool sphere_roots(const float* s, float ox, float oy,
                                             float oz, float dx, float dy, float dz,
                                             float* t1, float* t2) {
  const float ocx = ox - s[0], ocy = oy - s[1], ocz = oz - s[2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - s[3] * s[3];
  const float disc = b * b - 4.0f * a * c;
  const bool pos = disc > 0.0f;
  const float sq = sqrtf(pos ? disc : 1.0f);
  *t1 = (-b - sq) / (2.0f * a);
  *t2 = (-b + sq) / (2.0f * a);
  return pos;
}

template <bool EMIT, bool READ_DRAWS>
__global__ void __launch_bounds__(BLOCK_THREADS) path_kernel(const PathParams p) {
  extern __shared__ float4 smem4[];
  float* s_geo = reinterpret_cast<float*>(smem4);          // [T][12]
  float* s_shadow = s_geo + GEO_ROWS * p.num_tris;         // [n_shadow][12]
  float* s_sph = s_shadow + GEO_ROWS * p.n_shadow;         // [S][4]
  float* s_attr = s_sph + SPH_ROWS * p.num_spheres;        // [T + S][13]

  const int T = p.num_tris;
  const int S = p.num_spheres;
  const int P = T + S;
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
      for (int k = 0; k < T; ++k) {
        const float4* g = reinterpret_cast<const float4*>(s_geo + GEO_ROWS * k);
        const float4 pn = g[0], p1 = g[1], p2 = g[2];
        const float den = dx * pn.x + dy * pn.y + dz * pn.z;
        const float num = pn.w - (ox * pn.x + oy * pn.y + oz * pn.z);
        const float tt = num / den;
        const float u = (ox * p1.x + oy * p1.y + oz * p1.z)
                        + tt * (dx * p1.x + dy * p1.y + dz * p1.z) - p1.w;
        const float v = (ox * p2.x + oy * p2.y + oz * p2.z)
                        + tt * (dx * p2.x + dy * p2.y + dz * p2.z) - p2.w;
        const bool closer = (fabsf(den) >= 1e-12f) && (tt > RAY_TMIN)
                            && (tt < RAY_TMAX) && (u >= 0.0f) && (v >= 0.0f)
                            && (u + v <= 1.0f) && (tt < t_best);
        if (closer) { t_best = tt; prim = k; }
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
      const float* at = s_attr + ATTR_ROWS * (prim < 0 ? 0 : prim);
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
      const float t_max = ldist - 1e-3f;
      bool occ = false;
      for (int k = 0; k < p.n_shadow; ++k) {
        const float4* g = reinterpret_cast<const float4*>(s_shadow + GEO_ROWS * k);
        const float4 pn = g[0], p1 = g[1], p2 = g[2];
        const float den = ldx * pn.x + ldy * pn.y + ldz * pn.z;
        const float num = pn.w - (hx * pn.x + hy * pn.y + hz * pn.z);
        const float tt = num / den;
        const float u = (hx * p1.x + hy * p1.y + hz * p1.z)
                        + tt * (ldx * p1.x + ldy * p1.y + ldz * p1.z) - p1.w;
        const float v = (hx * p2.x + hy * p2.y + hz * p2.z)
                        + tt * (ldx * p2.x + ldy * p2.y + ldz * p2.z) - p2.w;
        occ = occ || ((fabsf(den) >= 1e-12f) && (tt > 0.0f) && (tt < t_max)
                      && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f));
      }
      for (int k = 0; k < S; ++k) {
        float t1, t2;
        const bool pos = sphere_roots(s_sph + SPH_ROWS * k, hx, hy, hz, ldx, ldy, ldz,
                                      &t1, &t2);
        const bool t1_ok = (t1 > 0.0f) && (t1 < t_max);
        const bool t2_ok = (t2 > 0.0f) && (t2 < t_max);
        occ = occ || (pos && (t1_ok || t2_ok));
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
int grt_path_trace(const int32_t* offsets, const float* cam, const float* light,
                   const float* tri, const float* sph, const float* atab,
                   const int32_t* shadow_idx, const float* nee0,
                   const float* nee1, const float* cos0, const float* cos1,
                   const float* jx, const float* jy, float* hdr,
                   int32_t* records, int n_local, int rid_base, int width,
                   int height, int spp, int bounces, int num_tris,
                   int num_spheres, int n_shadow, int strat_k, float inv_k,
                   float half_extent, int emit_records, int read_draws,
                   void* stream) {
  PathParams p;
  p.offsets = offsets; p.cam = cam; p.light = light; p.tri = tri; p.sph = sph;
  p.atab = atab; p.shadow_idx = shadow_idx;
  p.nee0 = nee0; p.nee1 = nee1; p.cos0 = cos0; p.cos1 = cos1; p.jx = jx; p.jy = jy;
  p.hdr = hdr; p.records = records;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.spp = spp; p.bounces = bounces; p.num_tris = num_tris;
  p.num_spheres = num_spheres; p.n_shadow = n_shadow; p.strat_k = strat_k;
  p.inv_k = inv_k; p.half_extent = half_extent;

  if (n_local <= 0 || (read_draws && !emit_records)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)GEO_ROWS * (num_tris + n_shadow)
                                       + (size_t)SPH_ROWS * num_spheres
                                       + (size_t)ATTR_ROWS * (num_tris + num_spheres));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (n_local + BLOCK_THREADS - 1) / BLOCK_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (emit_records && read_draws) {
    path_kernel<true, true><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else if (emit_records) {
    path_kernel<true, false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else {
    path_kernel<false, false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
