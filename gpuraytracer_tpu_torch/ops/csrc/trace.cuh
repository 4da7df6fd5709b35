// Ray-primitive tests shared by the port's trace kernels (sm_90a):
// path_kernel (path_kernels.cu) and silh_kernel (soft_kernels.cu).
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

// Closest triangle hit in (t_min, t_max) over the T staged triangles, in
// index order with strict < (ties keep the lower index): lowers *t_best and
// sets *prim where a triangle is closer than *t_best.
__device__ __forceinline__ void closest_triangle(const float* s_geo, int T, float ox,
                                                 float oy, float oz, float dx, float dy,
                                                 float dz, float t_min, float t_max,
                                                 float* t_best, int* prim) {
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
    const bool closer = (fabsf(den) >= 1e-12f) && (tt > t_min) && (tt < t_max)
                        && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f)
                        && (tt < *t_best);
    if (closer) { *t_best = tt; *prim = k; }
  }
}

// Shadow probe: any hit in (0, t_max) over n staged triangles and S spheres.
__device__ __forceinline__ bool occluded(const float* s_tri, int n, const float* s_sph,
                                         int S, float hx, float hy, float hz, float ldx,
                                         float ldy, float ldz, float t_max) {
  bool occ = false;
  for (int k = 0; k < n; ++k) {
    const float4* g = reinterpret_cast<const float4*>(s_tri + GEO_ROWS * k);
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
    occ = occ || (pos && (((t1 > 0.0f) && (t1 < t_max))
                          || ((t2 > 0.0f) && (t2 < t_max))));
  }
  return occ;
}

}  // namespace grt
