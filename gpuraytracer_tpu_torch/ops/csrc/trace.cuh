// Ray-primitive tests shared by the port's trace kernels (sm_90a):
// path_kernel (path_kernels.cu), mis_kernel and mis_grouped_kernel
// (mis_kernels.cu) and silh_kernel (soft_kernels.cu); the prefiltered loops
// (closest_triangle_filtered, any_triangle_filtered) serve mis_kernel, the
// grouped sweep (closest_grouped, occluded_grouped) path_kernel's grouped
// tier, its warp-cooperative form (closest_grouped_warp,
// occluded_grouped_warp) mis_grouped_kernel.
//
// One definition, in the operation order of the plain versions
// (intersect.triangle_candidates / sphere_candidates), so that the kernels
// and their plain versions make the same closest-hit and shadow decisions.
// Triangles are staged triangle-major, [n][GEO_ROWS] floats at a 16-byte
// aligned address (three float4 loads per triangle), spheres [S][SPH_ROWS].
#pragma once

namespace grt {

constexpr int GEO_ROWS = 12;  // n xyz, c0, s1 xyz, c1, s2 xyz, c2
constexpr int SPH_ROWS = 4;   // center xyz, radius

// Quadratic ray/sphere roots t1 <= t2; returns whether the discriminant is
// positive.
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

// One ray/triangle test, the only copy every loop below uses, in two steps:
// triangle_plane gives the plane denominator, the distance tt along d and the
// barycentrics u, v (rows pn = n xyz, c0; p1 = s1 xyz, c1; p2 = s2 xyz, c2);
// triangle_inside says whether that hit lies in (t_min, t_max) inside the
// triangle. Two steps, so that each loop does the arithmetic before its
// short-circuit test: one helper returning the bool made ptxas give the
// static hdr instantiation 64 registers and 84 B of spills instead of 72.
__device__ __forceinline__ void triangle_plane(float4 pn, float4 p1, float4 p2, float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, float* den, float* tt,
                                               float* u, float* v) {
  *den = dx * pn.x + dy * pn.y + dz * pn.z;
  const float num = pn.w - (ox * pn.x + oy * pn.y + oz * pn.z);
  *tt = num / *den;
  *u = (ox * p1.x + oy * p1.y + oz * p1.z) + *tt * (dx * p1.x + dy * p1.y + dz * p1.z)
       - p1.w;
  *v = (ox * p2.x + oy * p2.y + oz * p2.z) + *tt * (dx * p2.x + dy * p2.y + dz * p2.z)
       - p2.w;
}

__device__ __forceinline__ bool triangle_inside(float den, float tt, float u, float v,
                                                float t_min, float t_max) {
  return (fabsf(den) >= 1e-12f) && (tt > t_min) && (tt < t_max) && (u >= 0.0f)
         && (v >= 0.0f) && (u + v <= 1.0f);
}

// Closest triangle hit in (t_min, t_max) over the T staged triangles, in
// index order with strict < (ties keep the lower index): lowers *t_best and
// sets *prim where a triangle is closer than *t_best.
__device__ __forceinline__ void closest_triangle(const float* s_geo, int T, float ox,
                                                 float oy, float oz, float dx, float dy,
                                                 float dz, float t_min, float t_max,
                                                 float* t_best, int* prim) {
  for (int k = 0; k < T; ++k) {
    const float4* g = reinterpret_cast<const float4*>(s_geo + GEO_ROWS * k);
    float den, tt, u, v;
    triangle_plane(g[0], g[1], g[2], ox, oy, oz, dx, dy, dz, &den, &tt, &u, &v);
    const bool closer = triangle_inside(den, tt, u, v, t_min, t_max) && (tt < *t_best);
    if (closer) { *t_best = tt; *prim = k; }
  }
}

// ---------------------------------------------------------------------------
// The same tests with exact prefilters before the divide (mis_kernel, the
// static tier)
// ---------------------------------------------------------------------------
// A test passes only where |den| >= 1e-12 and tt = num / den lies in
// (t_min, t_far): t_far is t_max for a probe, and for a closest hit the nearer
// of t_max and the nearest hit so far.  Two conditions on num and den are
// necessary for that, and the loops below take the divide, the barycentrics
// and the interval test only where both hold; where they hold, they run
// triangle_plane's and triangle_inside's arithmetic in the same order.  So
// the decisions are the same bits.  They take t_min >= 1e-3 (the MIS kernel's
// RAY_TMIN), closest_triangle_filtered also t_max >= 1e-3, so that every
// bound is at least 1e-3.
//
// plane_ahead: the IEEE quotient is NaN where num or den is NaN, +-0 where num
// is +-0 and den is not, and otherwise carries the sign of num xor that of
// den (subnormals included).  A quotient above t_min >= 0 is positive, so
// num is nonzero, not NaN and of den's sign, and |den| >= 1e-12 leaves den
// nonzero and not NaN.
//
// plane_within: with a = |num|, b = |den| and a bound t >= 1e-3 (a probe's
// t_max may be smaller: it takes max(t_max, 1e-3), which only filters less),
// p = b t rounded is at least b t (1 - 2^-24) (b t >= 1e-15 cannot underflow;
// where it overflows, p is inf and the condition holds), and m = p (1 +
// 2^-22) rounded is at least b t (1 - 2^-24)^2 (1 + 2^-22) > b t.  Where
// a >= m, a / b > t, so tt, the quotient rounded, is at least t (t is a
// float): tt < t fails, and with it the test.
constexpr float WITHIN_MARGIN = 1.0f + 0x1p-22f;

__device__ __forceinline__ bool plane_ahead(float den, float num) {
  return fabsf(den) >= 1e-12f && (den > 0.0f ? num > 0.0f : num < 0.0f);
}

__device__ __forceinline__ bool plane_within(float den, float num, float t_far) {
  return fabsf(num) < (fabsf(den) * t_far) * WITHIN_MARGIN;
}

// tt and the barycentrics of one triangle test that passed both prefilters:
// triangle_plane's expressions after its den and num.
__device__ __forceinline__ void plane_hit(float4 p1, float4 p2, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float den, float num, float* tt, float* u,
                                          float* v) {
  *tt = num / den;
  *u = (ox * p1.x + oy * p1.y + oz * p1.z) + *tt * (dx * p1.x + dy * p1.y + dz * p1.z)
       - p1.w;
  *v = (ox * p2.x + oy * p2.y + oz * p2.z) + *tt * (dx * p2.x + dy * p2.y + dz * p2.z)
       - p2.w;
}

// closest_triangle with the prefilters: the same winner and t_best.
__device__ __forceinline__ void closest_triangle_filtered(const float* s_geo, int T,
                                                          float ox, float oy, float oz,
                                                          float dx, float dy, float dz,
                                                          float t_min, float t_max,
                                                          float* t_best, int* prim) {
  float t_far = fminf(*t_best, t_max);
  for (int k = 0; k < T; ++k) {
    const float4* g = reinterpret_cast<const float4*>(s_geo + GEO_ROWS * k);
    const float4 pn = g[0];
    const float den = dx * pn.x + dy * pn.y + dz * pn.z;
    const float num = pn.w - (ox * pn.x + oy * pn.y + oz * pn.z);
    if (!plane_ahead(den, num) || !plane_within(den, num, t_far)) continue;
    float tt, u, v;
    plane_hit(g[1], g[2], ox, oy, oz, dx, dy, dz, den, num, &tt, &u, &v);
    if (triangle_inside(den, tt, u, v, t_min, t_max) && (tt < *t_best)) {
      *t_best = tt;
      *prim = k;
      t_far = tt;
    }
  }
}

// Whether any of n staged triangles is hit in (t_min, t_max), with the
// prefilters; stops at the first hit.
__device__ __forceinline__ bool any_triangle_filtered(const float* s_tri, int n, float ox,
                                                      float oy, float oz, float dx,
                                                      float dy, float dz, float t_min,
                                                      float t_max) {
  const float t_far = fmaxf(t_max, 1e-3f);
  for (int k = 0; k < n; ++k) {
    const float4* g = reinterpret_cast<const float4*>(s_tri + GEO_ROWS * k);
    const float4 pn = g[0];
    const float den = dx * pn.x + dy * pn.y + dz * pn.z;
    const float num = pn.w - (ox * pn.x + oy * pn.y + oz * pn.z);
    if (!plane_ahead(den, num) || !plane_within(den, num, t_far)) continue;
    float tt, u, v;
    plane_hit(g[1], g[2], ox, oy, oz, dx, dy, dz, den, num, &tt, &u, &v);
    if (triangle_inside(den, tt, u, v, t_min, t_max)) return true;
  }
  return false;
}

// Shadow probe: any hit in (0, t_max) over n staged triangles and S spheres.
__device__ __forceinline__ bool occluded(const float* s_tri, int n, const float* s_sph,
                                         int S, float hx, float hy, float hz, float ldx,
                                         float ldy, float ldz, float t_max) {
  bool occ = false;
  for (int k = 0; k < n; ++k) {
    const float4* g = reinterpret_cast<const float4*>(s_tri + GEO_ROWS * k);
    float den, tt, u, v;
    triangle_plane(g[0], g[1], g[2], hx, hy, hz, ldx, ldy, ldz, &den, &tt, &u, &v);
    occ = occ || triangle_inside(den, tt, u, v, 0.0f, t_max);
  }
  for (int k = 0; k < S; ++k) {
    float t1, t2;
    const bool pos = sphere_roots(s_sph + SPH_ROWS * k, hx, hy, hz, ldx, ldy, ldz,
                                  &t1, &t2);
    occ = occ || (pos && (((t1 > 0.0f) && (t1 < t_max))
                          || ((t2 > 0.0f) && (t2 < t_max))));
  }
  return occ;
}

// ---------------------------------------------------------------------------
// The grouped tier: any number of triangles, read from global memory
// ---------------------------------------------------------------------------
// Geometry is triangle-major [P_gpad][GEO_ROWS] (zero past the last
// triangle); the box tables are [n][8]: lo xyz, 0, hi xyz, 0 (two 16-byte
// loads).  Groups of GROUP consecutive triangles, supers of SUPER groups; the
// sweep visits them in index order and tests a group's triangles only where
// the ray's segment reaches the super's and the group's padded box, so the
// winner is the one the loop over every triangle finds (strict < on t: ties
// keep the lower index).  The box margins and the far-limit slack are made on
// the host (ops/cuda_path.group_aabbs) as in the JAX package.

constexpr int GROUP = 16;
constexpr int SUPER = 8;
constexpr float FAR_SCALE = (float)(1.0 + 1e-3);  // 1 + T_FAR_SLACK
constexpr float FAR_SLACK = (float)1e-3;          // T_FAR_SLACK

// 1 / d with |d| < 1e-30 taken as 1e30 (pallas_path._safe_inv).
__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) < 1e-30f ? 1e30f : 1.0f / d;
}

// Whether the ray's segment [0, t_far] meets the box lo, hi (pallas_path.
// _slab_interval and its test, in that order).
__device__ __forceinline__ bool slab_hit(float4 lo, float4 hi, float ox, float oy,
                                         float oz, float ivx, float ivy, float ivz,
                                         float t_far) {
  const float t0x = (lo.x - ox) * ivx;
  const float t1x = (hi.x - ox) * ivx;
  const float t0y = (lo.y - oy) * ivy;
  const float t1y = (hi.y - oy) * ivy;
  const float t0z = (lo.z - oz) * ivz;
  const float t1z = (hi.z - oz) * ivz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.0f));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tmin <= fminf(tmax, t_far);
}

// slab_hit of a box table row in global memory, through the read-only path.
__device__ __forceinline__ bool slab_reach(const float4* __restrict__ box, float ox,
                                           float oy, float oz, float ivx, float ivy,
                                           float ivz, float t_far) {
  return slab_hit(__ldg(box), __ldg(box + 1), ox, oy, oz, ivx, ivy, ivz, t_far);
}

// Closest triangle hit in (t_min, t_max) over T triangles by the grouped
// sweep; the far limit of every box test is min(t_best (1 + slack) + slack,
// t_max) with the t_best of that moment.  Lowers *t_best and sets *prim.
__device__ __forceinline__ void closest_grouped(
    const float4* __restrict__ geo, const float4* __restrict__ aabb,
    const float4* __restrict__ sup, int n_super, int T, float ox, float oy,
    float oz, float dx, float dy, float dz, float t_min, float t_max, float* t_best,
    int* prim) {
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  for (int sg = 0; sg < n_super; ++sg) {
    if (!slab_reach(sup + 2 * sg, ox, oy, oz, ivx, ivy, ivz,
                    fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max))) {
      continue;
    }
    for (int g = sg * SUPER; g < (sg + 1) * SUPER; ++g) {
      if (!slab_reach(aabb + 2 * g, ox, oy, oz, ivx, ivy, ivz,
                      fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max))) {
        continue;
      }
      const int top = min((g + 1) * GROUP, T);
#pragma unroll 1
      for (int k = g * GROUP; k < top; ++k) {
        float den, tt, u, v;
        triangle_plane(__ldg(geo + 3 * k), __ldg(geo + 3 * k + 1), __ldg(geo + 3 * k + 2),
                       ox, oy, oz, dx, dy, dz, &den, &tt, &u, &v);
        const bool closer = triangle_inside(den, tt, u, v, t_min, t_max)
                            && (tt < *t_best);
        if (closer) { *t_best = tt; *prim = k; }
      }
    }
  }
}

// Shadow probe over n triangles by the grouped sweep: any hit in (t_min,
// t_max) (the path tracer's probe takes t_min = 0, the MIS light probe
// RAY_TMIN); the boxes are tested against t_max (1 + slack) + slack, and the
// sweep ends at the first occluder.
__device__ __forceinline__ bool occluded_grouped(
    const float4* __restrict__ geo, const float4* __restrict__ aabb,
    const float4* __restrict__ sup, int n_super, int n, float hx, float hy, float hz,
    float ldx, float ldy, float ldz, float t_min, float t_max) {
  const float ivx = safe_inv(ldx), ivy = safe_inv(ldy), ivz = safe_inv(ldz);
  const float t_seg = t_max * FAR_SCALE + FAR_SLACK;
  for (int sg = 0; sg < n_super; ++sg) {
    if (!slab_reach(sup + 2 * sg, hx, hy, hz, ivx, ivy, ivz, t_seg)) continue;
    for (int g = sg * SUPER; g < (sg + 1) * SUPER; ++g) {
      if (!slab_reach(aabb + 2 * g, hx, hy, hz, ivx, ivy, ivz, t_seg)) continue;
      const int top = min((g + 1) * GROUP, n);
#pragma unroll 1
      for (int k = g * GROUP; k < top; ++k) {
        float den, tt, u, v;
        triangle_plane(__ldg(geo + 3 * k), __ldg(geo + 3 * k + 1), __ldg(geo + 3 * k + 2),
                       hx, hy, hz, ldx, ldy, ldz, &den, &tt, &u, &v);
        if (triangle_inside(den, tt, u, v, t_min, t_max)) return true;
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// The warp-cooperative grouped sweep (mis_grouped_kernel)
// ---------------------------------------------------------------------------
// The same decisions as closest_grouped / occluded_grouped, lane by lane, with
// the box tables in shared memory.  Per super, in index order: each lane tests
// the super's box against its own far limit and, where it reaches it, the
// eight group boxes against the same limit, into a mask (the warp skips a
// super that no lane reaches, by a vote); then it walks the mask's groups in
// index order, each lane its own, so that lanes in different groups run side
// by side rather than in turn, and tests their triangles through the
// read-only path.  The far limit only falls while a lane tests triangles and
// slab_hit is monotone in the far limit, so a group that the lane reaches
// later in the super is in its mask; where the far limit has moved since the
// mask was made, the lane tests the box again.  So the lane's box tests that
// decide, its triangle tests, their order and their arithmetic are those of
// closest_grouped.  Every lane of the warp calls these functions at the same
// point of its program (the votes take the full mask); a lane with `live`
// false takes part in the votes and tests nothing.

constexpr unsigned FULL_WARP = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bit g set where the segment [0, t_far] meets group box sg * SUPER + g.
__device__ __forceinline__ unsigned group_mask(const float4* aabb, int sg, float ox,
                                               float oy, float oz, float ivx, float ivy,
                                               float ivz, float t_far) {
  unsigned m = 0u;
  for (int g = 0; g < SUPER; ++g) {
    const float4* b = aabb + 2 * (sg * SUPER + g);
    if (slab_hit(b[0], b[1], ox, oy, oz, ivx, ivy, ivz, t_far)) m |= 1u << g;
  }
  return m;
}

// closest_grouped with the box tables `aabb`, `sup` in shared memory; geo
// stays in global memory.
__device__ __forceinline__ void closest_grouped_warp(
    const float4* __restrict__ geo, const float4* aabb, const float4* sup, int n_super,
    int T, bool live, float ox, float oy, float oz, float dx, float dy, float dz,
    float t_min, float t_max, float* t_best, int* prim) {
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  for (int sg = 0; sg < n_super; ++sg) {
    const float far = fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max);
    const bool reach = live && slab_hit(sup[2 * sg], sup[2 * sg + 1], ox, oy, oz, ivx,
                                        ivy, ivz, far);
    if (__ballot_sync(FULL_WARP, reach) == 0u) continue;
    const float t_seen = *t_best;
    const unsigned mine = reach ? group_mask(aabb, sg, ox, oy, oz, ivx, ivy, ivz, far) : 0u;
    for (unsigned m = mine; m != 0u; m &= m - 1u) {
      const int g = __ffs(m) - 1;
      // The lane's own test of this group with its t_best of this moment;
      // the mask's test stands where t_best has not moved since.
      const float4* b = aabb + 2 * (sg * SUPER + g);
      if (*t_best != t_seen
          && !slab_hit(b[0], b[1], ox, oy, oz, ivx, ivy, ivz,
                       fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max))) {
        continue;
      }
      const int base = (sg * SUPER + g) * GROUP;
      const int top = min(GROUP, T - base);
      const float4* s = geo + (size_t)base * 3;
#pragma unroll 1
      for (int j = 0; j < top; ++j) {
        float den, tt, u, v;
        triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * j + 2), ox, oy,
                       oz, dx, dy, dz, &den, &tt, &u, &v);
        const bool closer = triangle_inside(den, tt, u, v, t_min, t_max)
                            && (tt < *t_best);
        if (closer) { *t_best = tt; *prim = base + j; }
      }
    }
  }
}

// closest_grouped_warp for scenes of many supers, where a lane reaches few of
// them: the lane first tests the boxes of up to 32 supers against its far
// limit of that moment, in a tight loop without votes, then walks the supers
// it reached, each lane its own, testing a super's box again where its far
// limit has fallen since; within a super as closest_grouped_warp.  The same
// decisions; the walks diverge where the lanes' supers differ, so it pays
// only above WIDE_SUPERS supers.
constexpr int WIDE_SUPERS = 32;

__device__ __forceinline__ void closest_grouped_wide(
    const float4* __restrict__ geo, const float4* aabb, const float4* sup, int n_super,
    int T, bool live, float ox, float oy, float oz, float dx, float dy, float dz,
    float t_min, float t_max, float* t_best, int* prim) {
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  for (int s0 = 0; s0 < n_super; s0 += 32) {
    const float t_seen = *t_best;
    const float far = fminf(t_seen * FAR_SCALE + FAR_SLACK, t_max);
    unsigned sups = 0u;
    for (int c = 0; c < 32 && s0 + c < n_super; ++c) {
      const int sg = s0 + c;
      if (live && slab_hit(sup[2 * sg], sup[2 * sg + 1], ox, oy, oz, ivx, ivy, ivz, far)) {
        sups |= 1u << c;
      }
    }
    for (unsigned ms = sups; ms != 0u; ms &= ms - 1u) {
      const int sg = s0 + __ffs(ms) - 1;
      const float far_now = fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max);
      if (*t_best != t_seen
          && !slab_hit(sup[2 * sg], sup[2 * sg + 1], ox, oy, oz, ivx, ivy, ivz, far_now)) {
        continue;
      }
      const float t_arrive = *t_best;
      const unsigned mine = group_mask(aabb, sg, ox, oy, oz, ivx, ivy, ivz, far_now);
      for (unsigned m = mine; m != 0u; m &= m - 1u) {
        const int g = __ffs(m) - 1;
        const float4* b = aabb + 2 * (sg * SUPER + g);
        if (*t_best != t_arrive
            && !slab_hit(b[0], b[1], ox, oy, oz, ivx, ivy, ivz,
                         fminf(*t_best * FAR_SCALE + FAR_SLACK, t_max))) {
          continue;
        }
        const int base = (sg * SUPER + g) * GROUP;
        const int top = min(GROUP, T - base);
        const float4* s = geo + (size_t)base * 3;
#pragma unroll 1
        for (int j = 0; j < top; ++j) {
          float den, tt, u, v;
          triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * j + 2), ox,
                         oy, oz, dx, dy, dz, &den, &tt, &u, &v);
          const bool closer = triangle_inside(den, tt, u, v, t_min, t_max)
                              && (tt < *t_best);
          if (closer) { *t_best = tt; *prim = base + j; }
        }
      }
    }
  }
}

// occluded_grouped with the box tables in shared memory: any hit in (t_min,
// t_max) over n triangles.  The far limit is fixed, so a lane makes the masks
// of SHADOW_CHUNK supers at once (32 groups), exactly those it reaches, and
// walks them; it stops at its first occluder, and the warp leaves the sweep
// when every lane has stopped.
constexpr int SHADOW_CHUNK = 8;

__device__ __forceinline__ bool occluded_grouped_warp(
    const float4* __restrict__ geo, const float4* aabb, const float4* sup, int n_super,
    int n, bool live, float hx, float hy, float hz, float ldx, float ldy, float ldz,
    float t_min, float t_max) {
  const float ivx = safe_inv(ldx), ivy = safe_inv(ldy), ivz = safe_inv(ldz);
  const float t_seg = t_max * FAR_SCALE + FAR_SLACK;
  bool open = live;
  for (int s0 = 0; s0 < n_super; s0 += SHADOW_CHUNK) {
    if (__ballot_sync(FULL_WARP, open) == 0u) break;
    unsigned long long mine = 0ull;
    for (int c = 0; c < SHADOW_CHUNK && s0 + c < n_super; ++c) {
      const int sg = s0 + c;
      if (open && slab_hit(sup[2 * sg], sup[2 * sg + 1], hx, hy, hz, ivx, ivy, ivz, t_seg)) {
        mine |= (unsigned long long)group_mask(aabb, sg, hx, hy, hz, ivx, ivy, ivz, t_seg) << (SUPER * c);
      }
    }
    for (unsigned long long m = mine; m != 0ull && open; m &= m - 1ull) {
      const int base = (s0 * SUPER + __ffsll((long long)m) - 1) * GROUP;
      const int top = min(GROUP, n - base);
      const float4* s = geo + (size_t)base * 3;
#pragma unroll 1
      for (int j = 0; j < top; ++j) {
        float den, tt, u, v;
        triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * j + 2), hx, hy,
                       hz, ldx, ldy, ldz, &den, &tt, &u, &v);
        if (triangle_inside(den, tt, u, v, t_min, t_max)) { open = false; break; }
      }
    }
  }
  return live && !open;
}

}  // namespace grt
