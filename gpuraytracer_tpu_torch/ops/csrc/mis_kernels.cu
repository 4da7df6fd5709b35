// CUDA kernel of the variant-A 3-strategy MIS integrator for NVIDIA Hopper
// (sm_90a).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// (ops/_build.py) and called through ctypes (ops/cuda_mis.py).  Build WITHOUT
// --use_fast_math and WITH -fmad=false, for the reason given at the top of
// path_kernels.cu: the plain PyTorch version this kernel is held against
// rounds every multiply and add on its own, and the integrator's decisions
// (closest-hit winners, light-probe bits) sit on knife edges — the first
// Halton sample is exactly the light rectangle's corner.
//
// ---------------------------------------------------------------------------
// mis_kernel   replaces  gpuraytracer_tpu/ops/pallas_mis.py:_mis_kernel
//              (static tier: at most 64 triangles, plus analytic spheres)
// ---------------------------------------------------------------------------
// Per pixel: `camera_rays` hash-jittered primary rays; per primary ray that
// lands on a surface, s_per samples of three strategies — the light rectangle,
// a cosine lobe, the GGX visible-normal lobe — each weighted by the beta = 1
// power heuristic over the three pdfs, with the metallic-roughness microfacet
// BRDF; the two lobe strategies trace their ray, add the weighted light term
// when it lands on the light, and take one unweighted light sample where it
// lands on geometry.  Five traversals per sample: the light probe (any hit
// over the occluder list short of the light sample), two closest hits and two
// secondary probes.  The output is the raw accumulated colour, before
// exposure and tone curve.  With EMIT the kernel also writes its decisions:
//   cam_rec  [camera_rays, n]         prim + 1 of the primary hit (0 = miss)
//   samp_rec [camera_rays, s_per, n]  reach1 | reach2 << 1 | reach3 << 2
//                                     | (cos_prim + 1) << 3 | (vndf_prim + 1) << 17
// with the pixel axis minor-most.
//
// Bound on this card: OPERATIONS.  A pixel reads no per-pixel input and
// writes 12 bytes (plus 4 bytes per sample with EMIT) against
// camera_rays * (1 + 5 * s_per) traversals of T triangle tests (about 49 f32
// operations each) and a few hundred operations of BRDF and pdf arithmetic
// with IEEE divides and square roots per sample; f32 scalar math, so the
// yardstick is the card's non-tensor f32 rate.  Design: one thread per pixel
// with the camera-ray and sample loops inside the thread, so one pixel's sum
// is formed in a fixed order (samples ascending, / s_per, camera rays
// ascending) by one thread — no atomics, two launches give equal bits.  The
// scene tables and the per-sample table are staged once per block in shared
// memory, primitive-major and sample-major, so that one triangle is three
// 16-byte loads and one sample four, which all threads of a warp take from the
// same address (a broadcast).  The per-sample sines, cosines and square roots
// of the two lobe directions depend on the sample table alone: the host
// precomputes them as six more rows, and the kernel holds no transcendental.
// The winner's attributes are one indexed load.  The traversals, the BRDF,
// the VNDF pdf and the two lobes' direction chains are real function calls
// (__noinline__), not inlined code: with the chain of six normalizations from
// the surface normal to the VNDF direction inline in the sample loop, nvcc
// 12.9's front end did not finish within ten minutes (it stops being slow the
// moment the chain is cut into functions).  What the calls cost was not
// measured; there is one per 36-triangle loop.  What a mask would discard is
// not computed: a primary ray that misses or lands on the light skips its
// samples, a blocked light sample skips its BRDF, a lobe ray that leaves the
// scene skips its secondary probe.  With EMIT every lane runs every traversal,
// because records are defined for every (camera ray, sample, pixel).  The
// per-primitive dot products of the fixed secondary origin, which the TPU
// kernel hoists out of its sample loop, are recomputed per test here: keeping
// 3 * T of them per thread costs more registers than the multiplies they save.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr float RAY_TMIN = 1e-3f;
constexpr float RAY_TMAX = 1e3f;
constexpr float INV_2_32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr int GEO_ROWS = 12;   // n xyz, c0, s1 xyz, c1, s2 xyz, c2
constexpr int ATTR_ROWS = 12;  // normal, diffuse, metallic, roughness, is_emissive, sphere center
constexpr int SPH_ROWS = 4;    // center xyz, radius
constexpr int TAB_ROWS = 16;   // ten draws and six derived direction scalars per sample
constexpr int REC_SHIFT_C = 3;
constexpr int REC_SHIFT_V = 17;
constexpr int BLOCK_THREADS = 128;
constexpr size_t MAX_SMEM_BYTES = 227 * 1024;  // one block's most on sm_90

struct MisParams {
  const float* cam;           // [12] position, u*half_w, v*half_h, w
  const float* light;         // [17] center, radiance, width, depth, normal, tangent, bitangent
  const float* tri;           // [21, T] packed triangle rows (first 12: geometry)
  const float* sph;           // [4, max(S,1)] center xyz, radius
  const float* atab;          // [12, T + S] attribute rows
  const float* tab;           // [16, s_per] per-sample table
  const int32_t* shadow_idx;  // [n_shadow] triangles kept in the light probes
  float* hdr;                 // [3, n_local]
  int32_t* cam_rec;           // [camera_rays, n_local] (EMIT only)
  int32_t* samp_rec;          // [camera_rays, s_per, n_local] (EMIT only)
  int n_local, rid_base, width, height, camera_rays, s_per;
  int num_tris, num_spheres, n_shadow;
};

// The staged scene, as the device functions see it.
struct Tables {
  const float* geo;     // [T][12]
  const float* shadow;  // [n_shadow][12]
  const float* sph;     // [S][4]
  const float* attr;    // [T + S][12]
  int T, S, n_shadow;
};

struct Light {
  float cx, cy, cz, er, eg, eb, w, d, nx, ny, nz, tx, ty, tz, bx, by, bz;
};

struct V3 {
  float x, y, z;
};

struct Frame {  // what the two lobe samplers need of a surface point, per camera ray
  float tx, ty, tz, bx, by, bz;              // branching basis about the normal
  float vex, vey, vez;                        // stretched, normalized view direction
  float t1x, t1y, t1z, t2x, t2y, t2z, alpha;  // its frame; alpha = roughness^2
};

struct Surface {  // a closest hit with the winner's shading attributes
  bool hit, isem;
  float t;
  int prim;
  float nx, ny, nz, dfr, dfg, dfb, met, rgh;
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// x * (1 / sqrt(max(|x|^2, 1e-12))): the floor of every normalize here.
__device__ __forceinline__ V3 normalize3(float x, float y, float z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-12f));
  V3 r;
  r.x = x * inv; r.y = y * inv; r.z = z * inv;
  return r;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// GGX NDF; takes roughness, not roughness^2 (a quirk of the reference).
__device__ __forceinline__ float d_ggx(float n_dot_h, float a) {
  const float f = (n_dot_h * a * a - n_dot_h) * n_dot_h + 1.0f;
  return (a * a) / (PI_F * f * f + 1e-12f);
}

__device__ __forceinline__ float smith_g1(float n_dot_v, float roughness) {
  const float a = roughness * roughness;
  const float a2 = a * a;
  const float nv2 = fmaxf(n_dot_v * n_dot_v, 1e-12f);
  return 2.0f / (1.0f + sqrtf(1.0f + a2 * (1.0f - nv2) / nv2));
}

// calculateBRDFContribution (shaders.metal:259-289); v = view direction
// (= -incoming), l = light direction.
__device__ __noinline__ V3 brdf(float vx, float vy, float vz, float nx,
                                   float ny, float nz, float dfr, float dfg,
                                   float dfb, float met, float rgh, float lx,
                                   float ly, float lz) {
  const V3 h = normalize3(vx + lx, vy + ly, vz + lz);
  const float n_dot_v = fabsf(dot3(nx, ny, nz, vx, vy, vz)) + 1e-5f;
  const float n_dot_l = clamp01(dot3(nx, ny, nz, lx, ly, lz));
  const float n_dot_h = clamp01(dot3(nx, ny, nz, h.x, h.y, h.z));
  const float l_dot_h = clamp01(dot3(lx, ly, lz, h.x, h.y, h.z));

  const float one_m_met = 1.0f - met;
  const float f0r = 0.04f * one_m_met + dfr * met;
  const float f0g = 0.04f * one_m_met + dfg * met;
  const float f0b = 0.04f * one_m_met + dfb * met;
  const float d = d_ggx(n_dot_h, rgh);
  // (1 - l.h)^5 by multiplies, as the plain version spells it.
  const float q = 1.0f - l_dot_h;
  const float q2 = q * q;
  const float p5 = q2 * q2 * q;
  const float fr = f0r + (1.0f - f0r) * p5;
  const float fg = f0g + (1.0f - f0g) * p5;
  const float fb = f0b + (1.0f - f0b) * p5;
  const float a = rgh * rgh;
  const float ggx_l = n_dot_v * sqrtf(fmaxf((-n_dot_l * a + n_dot_l) * n_dot_l + a, 1e-12f));
  const float ggx_v = n_dot_l * sqrtf(fmaxf((-n_dot_v * a + n_dot_v) * n_dot_v + a, 1e-12f));
  const float vis = 0.5f / (ggx_v + ggx_l + 1e-7f);
  const float spec = (d * vis) / (4.0f * n_dot_v * n_dot_l + 1e-7f);
  V3 out;
  out.x = (1.0f - fr) * one_m_met * (dfr * INV_PI_F + spec * fr) * n_dot_l;
  out.y = (1.0f - fg) * one_m_met * (dfg * INV_PI_F + spec * fg) * n_dot_l;
  out.z = (1.0f - fb) * one_m_met * (dfb * INV_PI_F + spec * fb) * n_dot_l;
  return out;
}

__device__ __forceinline__ float cosine_pdf(float nx, float ny, float nz,
                                            float dx, float dy, float dz) {
  return fmaxf(0.0f, dot3(nx, ny, nz, dx, dy, dz)) * INV_PI_F;
}

// D * G1 * VoH / (4 NoV + 1e-7) (shaders.metal:437-445); v = view direction.
__device__ __noinline__ float vndf_pdf(float vx, float vy, float vz, float nx,
                                          float ny, float nz, float lx, float ly,
                                          float lz, float rgh) {
  const V3 h = normalize3(vx + lx, vy + ly, vz + lz);
  const float n_dot_h = fabsf(dot3(nx, ny, nz, h.x, h.y, h.z));
  const float v_dot_h = fabsf(dot3(vx, vy, vz, h.x, h.y, h.z));
  const float n_dot_v = fabsf(dot3(nx, ny, nz, vx, vy, vz));
  const float d = d_ggx(n_dot_h, rgh);
  const float g1 = smith_g1(n_dot_v, rgh);
  return (d * g1 * v_dot_h) / (4.0f * n_dot_v + 1e-7f);
}

// beta = 1 power heuristic with per-strategy count n (shaders.metal:132-137).
__device__ __forceinline__ float power_heuristic_3(float p1, float p2, float p3,
                                                   float n) {
  const float a = n * p1;
  return a / (a + n * p2 + n * p3 + 1e-6f);
}

// pdf to the light *center* (shaders.metal:315-326 quirk).
__device__ __forceinline__ float square_light_pdf(const Light& L, float px,
                                                  float py, float pz, float dx,
                                                  float dy, float dz) {
  const float tox = L.cx - px, toy = L.cy - py, toz = L.cz - pz;
  const float dist2 = tox * tox + toy * toy + toz * toz;
  const float cos_t = fmaxf(0.0f, -(dx * L.nx + dy * L.ny + dz * L.nz));
  return dist2 / (L.w * L.d * cos_t + 1e-6f);
}

// The sample-invariant part of the two lobe samplers at a surface point with
// normal n, view direction v and the given roughness: the branching basis
// (sampling.metal:159-172) and the stretched view direction with its frame
// (vndfRay, shaders.metal:382-435).  A function of its own, like
// vndf_direction below, for the compile time's sake (see the note at the top).
__device__ __noinline__ Frame surface_frame(float nx, float ny, float nz, float vx,
                                            float vy, float vz, float rgh) {
  Frame f;
  const bool use_y = fabsf(nx) > 0.9f;
  const float ax = use_y ? 0.0f : 1.0f;
  const float ay = use_y ? 1.0f : 0.0f;
  const float an = ax * nx + ay * ny;
  const V3 tg = normalize3(ax - an * nx, ay - an * ny, -an * nz);
  f.tx = tg.x; f.ty = tg.y; f.tz = tg.z;
  f.bx = ny * tg.z - nz * tg.y;
  f.by = nz * tg.x - nx * tg.z;
  f.bz = nx * tg.y - ny * tg.x;
  f.alpha = rgh * rgh;
  const float vtx = dot3(vx, vy, vz, f.tx, f.ty, f.tz);
  const float vtb = dot3(vx, vy, vz, f.bx, f.by, f.bz);
  const float vtn = dot3(vx, vy, vz, nx, ny, nz);
  const V3 ve = normalize3(f.alpha * vtx, f.alpha * vtb, vtn);
  const V3 t1 = normalize3(ve.z, 0.0f, -ve.x);
  f.vex = ve.x; f.vey = ve.y; f.vez = ve.z;
  f.t1x = t1.x; f.t1y = t1.y; f.t1z = t1.z;
  f.t2x = ve.y * t1.z - ve.z * t1.y;
  f.t2y = ve.z * t1.x - ve.x * t1.z;
  f.t2z = ve.x * t1.y - ve.y * t1.x;
  return f;
}

// The cosine lobe's direction (cosineWeightedRay, shaders.metal:355-374);
// w0 = cos(phi) sin(theta), w1 = sin(phi) sin(theta), cth = cos(theta) come
// from the sample table.
__device__ __noinline__ V3 cosine_direction(const Frame& f, float nx, float ny,
                                            float nz, float w0, float w1, float cth) {
  return normalize3(f.tx * w0 + f.bx * w1 + nx * cth, f.ty * w0 + f.by * w1 + ny * cth,
                    f.tz * w0 + f.bz * w1 + nz * cth);
}

// The visible-normal lobe's direction: a point of the spherical cap about the
// stretched view direction (k0, k1, vct from the sample table; cosThetaMax is
// the constant 1/sqrt(2), because the reference takes the length of a
// normalized vector), unstretched, taken to the world, and the incoming
// direction d reflected about it.
__device__ __noinline__ V3 vndf_direction(const Frame& f, float nx, float ny, float nz,
                                          float dx, float dy, float dz, float k0,
                                          float k1, float vct) {
  const V3 hh = normalize3(f.t1x * k0 + f.t2x * k1 + f.vex * vct,
                           f.t1y * k0 + f.t2y * k1 + f.vey * vct,
                           f.t1z * k0 + f.t2z * k1 + f.vez * vct);
  const V3 nl = normalize3(f.alpha * hh.x, f.alpha * hh.y, fmaxf(0.0f, hh.z));
  const V3 wh = normalize3(f.tx * nl.x + f.bx * nl.y + nx * nl.z,
                           f.ty * nl.x + f.by * nl.y + ny * nl.z,
                           f.tz * nl.x + f.bz * nl.y + nz * nl.z);
  const float ddh = dot3(dx, dy, dz, wh.x, wh.y, wh.z);
  V3 vd;
  vd.x = dx - 2.0f * ddh * wh.x;
  vd.y = dy - 2.0f * ddh * wh.y;
  vd.z = dz - 2.0f * ddh * wh.z;
  return vd;
}

// Quadratic ray/sphere roots, in the operation order of the plain version
// (intersect.sphere_candidates).
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

// One ray/triangle test against a staged [12] row: the hit distance, and
// whether it lies in (t_lo, t_hi) inside the triangle.
__device__ __forceinline__ bool triangle_test(const float* row, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float t_lo, float t_hi, float* t_out) {
  const float4* g = reinterpret_cast<const float4*>(row);
  const float4 pn = g[0], p1 = g[1], p2 = g[2];
  const float den = dx * pn.x + dy * pn.y + dz * pn.z;
  const float num = pn.w - (ox * pn.x + oy * pn.y + oz * pn.z);
  const float tt = num / den;  // raw IEEE divide; a parallel ray fails the test below
  const float u = (ox * p1.x + oy * p1.y + oz * p1.z)
                  + tt * (dx * p1.x + dy * p1.y + dz * p1.z) - p1.w;
  const float v = (ox * p2.x + oy * p2.y + oz * p2.z)
                  + tt * (dx * p2.x + dy * p2.y + dz * p2.z) - p2.w;
  *t_out = tt;
  return (fabsf(den) >= 1e-12f) && (tt > t_lo) && (tt < t_hi) && (u >= 0.0f)
         && (v >= 0.0f) && (u + v <= 1.0f);
}

// Closest hit over all triangles (index order, strictly closer wins, so ties
// keep the lower index), then the spheres; the winner's attributes by index.
// A miss reads row 0, as the TPU kernel's clipped fetch does, so that the
// records dead lanes write are the same; every use is gated by `hit`.
__device__ __noinline__ Surface closest_full(const Tables& sc, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz) {
  float t_best = BIG;
  int prim = -1;
  for (int k = 0; k < sc.T; ++k) {
    float tt;
    const bool in = triangle_test(sc.geo + GEO_ROWS * k, ox, oy, oz, dx, dy, dz,
                                  RAY_TMIN, RAY_TMAX, &tt);
    if (in && (tt < t_best)) { t_best = tt; prim = k; }
  }
  for (int k = 0; k < sc.S; ++k) {
    float t1, t2;
    const bool pos = sphere_roots(sc.sph + SPH_ROWS * k, ox, oy, oz, dx, dy, dz,
                                  &t1, &t2);
    const bool t1_ok = (t1 > RAY_TMIN) && (t1 < RAY_TMAX);
    const bool t2_ok = (t2 > RAY_TMIN) && (t2 < RAY_TMAX);
    const float tt = t1_ok ? t1 : t2;
    if (pos && (t1_ok || t2_ok) && (tt < t_best)) { t_best = tt; prim = sc.T + k; }
  }
  Surface h;
  h.hit = t_best < BIG * 0.5f;
  h.t = t_best;
  h.prim = prim;
  const float* at = sc.attr + ATTR_ROWS * (h.hit ? prim : 0);
  h.nx = at[0]; h.ny = at[1]; h.nz = at[2];
  h.dfr = at[3]; h.dfg = at[4]; h.dfb = at[5];
  h.met = at[6]; h.rgh = at[7];
  h.isem = at[8] > 0.5f;
  if (sc.S > 0) {
    // Sphere normal: (hit point - center) normalized, floor 1e-6.
    const bool sphere_won = h.hit && (prim >= sc.T);
    const float t_s = sphere_won ? t_best : 0.0f;
    const float nvx = ox + dx * t_s - at[9];
    const float nvy = oy + dy * t_s - at[10];
    const float nvz = oz + dz * t_s - at[11];
    const float inv = 1.0f / sqrtf(fmaxf(nvx * nvx + nvy * nvy + nvz * nvz, 1e-6f));
    if (sphere_won) { h.nx = nvx * inv; h.ny = nvy * inv; h.nz = nvz * inv; }
  }
  return h;
}

// No occluder strictly short of t_max: any hit in (RAY_TMIN, t_max) over the
// occluder list, spheres always tested.
__device__ __noinline__ bool light_reachable(const Tables& sc, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz, float t_max) {
  for (int k = 0; k < sc.n_shadow; ++k) {
    float tt;
    if (triangle_test(sc.shadow + GEO_ROWS * k, ox, oy, oz, dx, dy, dz, RAY_TMIN,
                      t_max, &tt)) {
      return false;
    }
  }
  for (int k = 0; k < sc.S; ++k) {
    float t1, t2;
    const bool pos = sphere_roots(sc.sph + SPH_ROWS * k, ox, oy, oz, dx, dy, dz,
                                  &t1, &t2);
    const bool t1_ok = (t1 > RAY_TMIN) && (t1 < t_max);
    const bool t2_ok = (t2 > RAY_TMIN) && (t2 < t_max);
    if (pos && (t1_ok || t2_ok)) return false;
  }
  return true;
}

// calculateDirectLightSamplingContribution (shaders.metal:519-541), in the
// occlusion form of the light probe.  Returns the contribution (zero unless
// `active` and the light sample is reachable) and, through *reach, the probe's
// decision.  With NEED_REACH false an inactive lane returns without probing.
template <bool NEED_REACH>
__device__ __forceinline__ V3 direct_light(const Tables& sc, const Light& L,
                                           float px, float py, float pz, float nx,
                                           float ny, float nz, float inx, float iny,
                                           float inz, float dfr, float dfg, float dfb,
                                           float met, float rgh, float u0, float u1,
                                           bool active, bool use_heuristic,
                                           float s_per_f, bool* reach) {
  V3 out;
  out.x = 0.0f; out.y = 0.0f; out.z = 0.0f;
  *reach = false;
  if (!NEED_REACH && !active) return out;
  const float ox = px + nx * 1e-4f;
  const float oy = py + ny * 1e-4f;
  const float oz = pz + nz * 1e-4f;
  const float a = (u0 - 0.5f) * L.w;
  const float b = (u1 - 0.5f) * L.d;
  const float sx = L.cx + L.tx * a + L.bx * b;
  const float sy = L.cy + L.ty * a + L.by * b;
  const float sz = L.cz + L.tz * a + L.bz * b;
  const float tox = sx - ox, toy = sy - oy, toz = sz - oz;
  const float dist = sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-30f));
  // Plain division, not a reciprocal multiply: sample 0 of the Halton table
  // is the light rectangle's corner, and the probe sits on its edge.
  const float ldx = tox / dist, ldy = toy / dist, ldz = toz / dist;
  *reach = light_reachable(sc, ox, oy, oz, ldx, ldy, ldz,
                           dist * (float)(1.0 - 1e-4));
  if (!(active && *reach)) return out;
  const float pdf_l = square_light_pdf(L, px, py, pz, ldx, ldy, ldz);
  const float vx = -inx, vy = -iny, vz = -inz;
  const V3 f = brdf(vx, vy, vz, nx, ny, nz, dfr, dfg, dfb, met, rgh, ldx, ldy, ldz);
  const float inv_pdf = 1.0f / pdf_l;
  out.x = f.x * L.er * inv_pdf;
  out.y = f.y * L.eg * inv_pdf;
  out.z = f.z * L.eb * inv_pdf;
  if (use_heuristic) {
    const float pdf_c = cosine_pdf(nx, ny, nz, ldx, ldy, ldz);
    const float pdf_v = vndf_pdf(vx, vy, vz, nx, ny, nz, ldx, ldy, ldz, rgh);
    const float w = power_heuristic_3(pdf_l, pdf_c, pdf_v, s_per_f);
    out.x *= w; out.y *= w; out.z *= w;
  }
  return out;
}

// Shared body of the cosine and VNDF strategies (shaders.metal:562-623):
// trace the sampled ray; on the light add the weighted light term, on
// geometry one unweighted light sample at the bounce point.  Also returns the
// decisions for the record: the winner and the secondary probe's bit.
template <bool EMIT>
__device__ __forceinline__ V3 bounce_strategy(const Tables& sc, const Light& L,
                                              float px, float py, float pz, float nx,
                                              float ny, float nz, float inx, float iny,
                                              float inz, float dfr, float dfg,
                                              float dfb, float met, float rgh,
                                              bool active, float sdx, float sdy,
                                              float sdz, float pdf_self, float w,
                                              float su0, float su1, int* prim2,
                                              bool* sec_reach) {
  const float ox = px + nx * 1e-4f;
  const float oy = py + ny * 1e-4f;
  const float oz = pz + nz * 1e-4f;
  const Surface h = closest_full(sc, ox, oy, oz, sdx, sdy, sdz);
  *prim2 = h.prim;
  const bool hit_light = active && h.hit && h.isem;
  const bool hit_geo = active && h.hit && !h.isem;
  const float t_safe = hit_geo ? h.t : 0.0f;
  const float bpx = ox + sdx * t_safe;
  const float bpy = oy + sdy * t_safe;
  const float bpz = oz + sdz * t_safe;
  const V3 sec = direct_light<EMIT>(sc, L, bpx, bpy, bpz, h.nx, h.ny, h.nz, sdx, sdy,
                                    sdz, h.dfr, h.dfg, h.dfb, h.met, h.rgh, su0, su1,
                                    hit_geo, false, 1.0f, sec_reach);
  V3 out;
  out.x = 0.0f; out.y = 0.0f; out.z = 0.0f;
  if (!(hit_light || hit_geo)) return out;
  const V3 f = brdf(-inx, -iny, -inz, nx, ny, nz, dfr, dfg, dfb, met, rgh,
                    sdx, sdy, sdz);
  // The VNDF pdf is exactly 0 on roughness-0 lanes; 1/0 would make the
  // weighted product NaN, and pdf == 0 implies weight == 0.
  const float inv_pdf = (pdf_self > 0.0f) ? 1.0f / pdf_self : 0.0f;
  if (hit_light) {
    out.x = w * f.x * L.er * inv_pdf;
    out.y = w * f.y * L.eg * inv_pdf;
    out.z = w * f.z * L.eb * inv_pdf;
  } else {
    out.x = f.x * inv_pdf * sec.x;
    out.y = f.y * inv_pdf * sec.y;
    out.z = f.z * inv_pdf * sec.z;
  }
  return out;
}

template <bool EMIT>
__global__ void __launch_bounds__(BLOCK_THREADS) mis_kernel(const MisParams p) {
  extern __shared__ float4 smem4[];
  float* s_geo = reinterpret_cast<float*>(smem4);          // [T][12]
  float* s_shadow = s_geo + GEO_ROWS * p.num_tris;         // [n_shadow][12]
  float* s_attr = s_shadow + GEO_ROWS * p.n_shadow;        // [T + S][12]
  float* s_tab = s_attr + ATTR_ROWS * (p.num_tris + p.num_spheres);  // [s_per][16]
  float* s_sph = s_tab + TAB_ROWS * p.s_per;               // [S][4]

  const int T = p.num_tris;
  const int S = p.num_spheres;
  const int P = T + S;
  const int s_per = p.s_per;
  for (int k = threadIdx.x; k < GEO_ROWS * T; k += blockDim.x) {
    const int t = k / GEO_ROWS, r = k - t * GEO_ROWS;
    s_geo[k] = p.tri[r * T + t];
  }
  for (int k = threadIdx.x; k < GEO_ROWS * p.n_shadow; k += blockDim.x) {
    const int j = k / GEO_ROWS, r = k - j * GEO_ROWS;
    s_shadow[k] = p.tri[r * T + p.shadow_idx[j]];
  }
  for (int k = threadIdx.x; k < ATTR_ROWS * P; k += blockDim.x) {
    const int q = k / ATTR_ROWS, r = k - q * ATTR_ROWS;
    s_attr[k] = p.atab[r * P + q];
  }
  for (int k = threadIdx.x; k < TAB_ROWS * s_per; k += blockDim.x) {
    const int s = k / TAB_ROWS, r = k - s * TAB_ROWS;
    s_tab[k] = p.tab[r * s_per + s];
  }
  for (int k = threadIdx.x; k < SPH_ROWS * S; k += blockDim.x) {
    const int s = k / SPH_ROWS, r = k - s * SPH_ROWS;
    s_sph[k] = p.sph[r * S + s];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_local) return;

  Tables sc;
  sc.geo = s_geo; sc.shadow = s_shadow; sc.sph = s_sph; sc.attr = s_attr;
  sc.T = T; sc.S = S; sc.n_shadow = p.n_shadow;

  Light L;
  L.cx = p.light[0]; L.cy = p.light[1]; L.cz = p.light[2];
  L.er = p.light[3]; L.eg = p.light[4]; L.eb = p.light[5];
  L.w = p.light[6]; L.d = p.light[7];
  L.nx = p.light[8]; L.ny = p.light[9]; L.nz = p.light[10];
  L.tx = p.light[11]; L.ty = p.light[12]; L.tz = p.light[13];
  L.bx = p.light[14]; L.by = p.light[15]; L.bz = p.light[16];

  const int W = p.width;
  const size_t n_local = (size_t)p.n_local;
  const int rid = p.rid_base + i;  // global pixel id
  const uint32_t xi = (uint32_t)(rid % W);
  const uint32_t yi = (uint32_t)(rid / W);
  const float px = (float)xi;
  const float py = (float)yi;
  const float fW = (float)W, fH = (float)p.height;

  const float posx = p.cam[0], posy = p.cam[1], posz = p.cam[2];
  const float uhx = p.cam[3], uhy = p.cam[4], uhz = p.cam[5];
  const float vhx = p.cam[6], vhy = p.cam[7], vhz = p.cam[8];
  const float wvx = p.cam[9], wvy = p.cam[10], wvz = p.cam[11];
  const float s_per_f = (float)s_per;
  const float inv_s = (float)(1.0 / (double)s_per);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (int cr = 0; cr < p.camera_rays; ++cr) {
    // hashRandom jitter (shaders.metal:71-85): the strides are the literal
    // 800 / 600 of the reference, whatever the resolution.
    const uint32_t sample_id = (yi * 800u + xi) * (uint32_t)cr;
    const float jx = __uint2float_rn(hash_u32(xi + yi * 800u + sample_id)) * INV_2_32;
    const float jy =
        __uint2float_rn(hash_u32(yi + xi * 600u + sample_id + 12345u)) * INV_2_32;

    const float s = ((px + jx) / fW) * 2.0f - 1.0f;
    const float t = -(((py + jy) / fH) * 2.0f - 1.0f);
    const V3 d = normalize3(s * uhx + t * vhx - wvx, s * uhy + t * vhy - wvy,
                            s * uhz + t * vhz - wvz);

    const Surface h = closest_full(sc, posx, posy, posz, d.x, d.y, d.z);
    if (EMIT) p.cam_rec[(size_t)cr * n_local + i] = h.hit ? h.prim + 1 : 0;
    if (h.hit && h.isem) { acc_r += L.er; acc_g += L.eg; acc_b += L.eb; }
    const bool surf = h.hit && !h.isem;
    if (!EMIT && !surf) continue;

    // NOT normal-offset (shaders.metal:497); t clamped on dead lanes.
    const float t_safe = surf ? h.t : 0.0f;
    const float p_x = posx + d.x * t_safe;
    const float p_y = posy + d.y * t_safe;
    const float p_z = posz + d.z * t_safe;
    const float nhx = h.nx, nhy = h.ny, nhz = h.nz;
    const float vx = -d.x, vy = -d.y, vz = -d.z;

    const Frame fr = surface_frame(nhx, nhy, nhz, vx, vy, vz, h.rgh);

    float m_r = 0.0f, m_g = 0.0f, m_b = 0.0f;
    for (int n = 0; n < s_per; ++n) {
      const float4* row = reinterpret_cast<const float4*>(s_tab + TAB_ROWS * n);
      const float4 ta = row[0];  // light u0 u1, cosine u0 u1
      const float4 tb = row[1];  // cosine-secondary u0 u1, vndf u0 u1
      const float4 tc = row[2];  // vndf-secondary u0 u1, cosine w0 w1
      const float4 td = row[3];  // cosine cos(theta), vndf k0 k1 cos(theta)

      // Strategy 1: the light rectangle.
      bool reach1;
      const V3 s1 = direct_light<EMIT>(sc, L, p_x, p_y, p_z, nhx, nhy, nhz, d.x, d.y,
                                       d.z, h.dfr, h.dfg, h.dfb, h.met, h.rgh, ta.x,
                                       ta.y, surf, true, s_per_f, &reach1);

      // Strategy 2: the cosine lobe.
      const V3 cd = cosine_direction(fr, nhx, nhy, nhz, tc.z, tc.w, td.x);
      const float pdf_c = cosine_pdf(nhx, nhy, nhz, cd.x, cd.y, cd.z);
      const float pdf_l = square_light_pdf(L, p_x, p_y, p_z, cd.x, cd.y, cd.z);
      const float pdf_v = vndf_pdf(vx, vy, vz, nhx, nhy, nhz, cd.x, cd.y, cd.z, h.rgh);
      const float w_c = power_heuristic_3(pdf_c, pdf_l, pdf_v, s_per_f);
      int prim_c;
      bool reach2;
      const V3 s2 = bounce_strategy<EMIT>(sc, L, p_x, p_y, p_z, nhx, nhy, nhz, d.x,
                                          d.y, d.z, h.dfr, h.dfg, h.dfb, h.met, h.rgh,
                                          surf, cd.x, cd.y, cd.z, pdf_c, w_c, tb.x,
                                          tb.y, &prim_c, &reach2);

      // Strategy 3: the visible-normal lobe.
      const V3 vd = vndf_direction(fr, nhx, nhy, nhz, d.x, d.y, d.z, td.y, td.z, td.w);
      const float vdx = vd.x, vdy = vd.y, vdz = vd.z;
      const float pdf_v2 = vndf_pdf(vx, vy, vz, nhx, nhy, nhz, vdx, vdy, vdz, h.rgh);
      const float pdf_l2 = square_light_pdf(L, p_x, p_y, p_z, vdx, vdy, vdz);
      const float pdf_c2 = cosine_pdf(nhx, nhy, nhz, vdx, vdy, vdz);
      const float w_v = power_heuristic_3(pdf_v2, pdf_l2, pdf_c2, s_per_f);
      int prim_v;
      bool reach3;
      const V3 s3 = bounce_strategy<EMIT>(sc, L, p_x, p_y, p_z, nhx, nhy, nhz, d.x,
                                          d.y, d.z, h.dfr, h.dfg, h.dfb, h.met, h.rgh,
                                          surf, vdx, vdy, vdz, pdf_v2, w_v, tc.x,
                                          tc.y, &prim_v, &reach3);

      if (EMIT) {
        p.samp_rec[((size_t)cr * s_per + n) * n_local + i] =
            (reach1 ? 1 : 0) | (reach2 ? 2 : 0) | (reach3 ? 4 : 0)
            | ((prim_c + 1) << REC_SHIFT_C) | ((prim_v + 1) << REC_SHIFT_V);
      }
      m_r = m_r + s1.x + s2.x + s3.x;
      m_g = m_g + s1.y + s2.y + s3.y;
      m_b = m_b + s1.z + s2.z + s3.z;
    }
    if (surf) {
      acc_r += m_r * inv_s;
      acc_g += m_g * inv_s;
      acc_b += m_b * inv_s;
    }
  }

  p.hdr[i] = acc_r;
  p.hdr[n_local + i] = acc_g;
  p.hdr[2 * n_local + i] = acc_b;
}

}  // namespace

extern "C" {

// Launches mis_kernel on `stream`; returns cudaGetLastError() as an int.
int grt_mis_trace(const float* cam, const float* light, const float* tri,
                  const float* sph, const float* atab, const float* tab,
                  const int32_t* shadow_idx, float* hdr, int32_t* cam_rec,
                  int32_t* samp_rec, int n_local, int rid_base, int width,
                  int height, int camera_rays, int s_per, int num_tris,
                  int num_spheres, int n_shadow, int emit_records, void* stream) {
  MisParams p;
  p.cam = cam; p.light = light; p.tri = tri; p.sph = sph; p.atab = atab; p.tab = tab;
  p.shadow_idx = shadow_idx; p.hdr = hdr; p.cam_rec = cam_rec; p.samp_rec = samp_rec;
  p.n_local = n_local; p.rid_base = rid_base; p.width = width; p.height = height;
  p.camera_rays = camera_rays; p.s_per = s_per; p.num_tris = num_tris;
  p.num_spheres = num_spheres; p.n_shadow = n_shadow;

  if (n_local <= 0 || camera_rays <= 0 || s_per <= 0 || width <= 0 || height <= 0
      || rid_base < 0 || (long long)rid_base + n_local > (long long)width * height) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)GEO_ROWS * (num_tris + n_shadow)
                                       + (size_t)ATTR_ROWS * (num_tris + num_spheres)
                                       + (size_t)TAB_ROWS * s_per
                                       + (size_t)SPH_ROWS * num_spheres);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  // Beyond the 48 KiB every launch may have, a kernel asks for its size first
  // (a long sample table: more than about 2,000 samples at 36 triangles).
  if (smem > 48 * 1024) {
    const cudaError_t err = emit_records
        ? cudaFuncSetAttribute(mis_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
        : cudaFuncSetAttribute(mis_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n_local + BLOCK_THREADS - 1) / BLOCK_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (emit_records) {
    mis_kernel<true><<<grid, BLOCK_THREADS, smem, st>>>(p);
  } else {
    mis_kernel<false><<<grid, BLOCK_THREADS, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
