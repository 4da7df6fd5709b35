"""Batched ray-scene intersection in plain PyTorch.

Counterpart of ``gpuraytracer_tpu/intersect.py``: a brute-force test of every
ray against every triangle (plane + dual-basis form) and every analytic
sphere, with closest-hit as an argmin over the primitive axis. This is the
oracle's intersection code and the ``[N, T]`` candidate code of the trace
kernel's plain version; the CUDA kernel (``ops/csrc/path_kernels.cu``) does
the same arithmetic in the same order, one thread per pixel.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .sampling import build_orthonormal_basis, cross, dot, rsqrt
from .types import CompiledScene, Spheres, TriangleScene

RAY_TMIN = 1e-3
RAY_TMAX = 1e3
_BIG = 1e30


def _broadcast_limits(t_min, t_max):
    """Give per-ray t limits a trailing primitive axis."""
    if isinstance(t_min, torch.Tensor) and t_min.ndim:
        t_min = t_min[..., None]
    if isinstance(t_max, torch.Tensor) and t_max.ndim:
        t_max = t_max[..., None]
    return t_min, t_max


def compile_scene(tri: TriangleScene) -> CompiledScene:
    """Precompute the per-triangle intersection constants."""
    v0 = tri.verts[:, 0, :]
    e1 = tri.verts[:, 1, :] - v0
    e2 = tri.verts[:, 2, :] - v0
    n_raw = cross(e1, e2)
    n = n_raw * rsqrt(torch.clamp_min(dot(n_raw, n_raw), 1e-30))[..., None]
    c0 = dot(n, v0)

    # Dual basis of (e1, e2) in the triangle plane: u = (h - v0) . s1 etc.
    e11 = dot(e1, e1)
    e22 = dot(e2, e2)
    e12 = dot(e1, e2)
    denom = torch.clamp_min(e11 * e22 - e12 * e12, 1e-30)
    s1 = (e22[..., None] * e1 - e12[..., None] * e2) / denom[..., None]
    s2 = (e11[..., None] * e2 - e12[..., None] * e1) / denom[..., None]
    c1 = dot(v0, s1)
    c2 = dot(v0, s2)

    return CompiledScene(
        n=n, c0=c0, s1=s1, s2=s2, c1=c1, c2=c2,
        diffuse=tri.diffuse, metallic=tri.metallic, roughness=tri.roughness,
        emissive=tri.emissive,
        is_emissive=torch.linalg.norm(tri.emissive, dim=-1) > 0.0,
    )


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays. ``hit`` False => miss.

    ``prim`` indexes the triangle array (or, for sphere hits, the triangle
    count + sphere index; 0 on a miss). Shading attributes are gathered by
    that index."""

    hit: torch.Tensor        # [...] bool
    t: torch.Tensor          # [...] f32 (BIG on miss)
    prim: torch.Tensor       # [...] i64
    normal: torch.Tensor     # [..., 3] f32 geometric normal
    diffuse: torch.Tensor    # [..., 3] f32
    metallic: torch.Tensor   # [...] f32
    roughness: torch.Tensor  # [...] f32
    emissive: torch.Tensor   # [..., 3] f32
    is_emissive: torch.Tensor  # [...] bool


def triangle_candidates(
    n: torch.Tensor, c0: torch.Tensor, s1: torch.Tensor, c1: torch.Tensor,
    s2: torch.Tensor, c2: torch.Tensor,
    origin: torch.Tensor, direction: torch.Tensor, t_min, t_max,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs ray/triangle test against plane constants (n [T, 3], c0 [T])
    and dual-basis constants (s1, s2 [T, 3]; c1, c2 [T]). origin/direction
    are [..., 3]; returns (t_vals[..., T], valid[..., T]). t_min/t_max may be
    scalars or per-ray tensors [...]."""
    t_min, t_max = _broadcast_limits(t_min, t_max)
    o = origin[..., None, :]   # [..., 1, 3]
    d = direction[..., None, :]

    den = dot(d, n)                 # [..., T]
    num = c0 - dot(o, n)
    # Where the ray is parallel, force a miss through the validity mask.
    parallel = den.abs() < 1e-12
    t = num / torch.where(parallel, torch.ones_like(den), den)
    # Barycentric u, v: affine in (o, t*d).
    u = dot(o, s1) + t * dot(d, s1) - c1
    v = dot(o, s2) + t * dot(d, s2) - c2

    valid = (
        ~parallel
        & (t > t_min)
        & (t < t_max)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    return t, valid


def _triangle_candidates(scene: CompiledScene, origin, direction,
                         t_min, t_max):
    return triangle_candidates(scene.n, scene.c0, scene.s1, scene.c1,
                               scene.s2, scene.c2, origin, direction,
                               t_min, t_max)


def sphere_candidates(
    center: torch.Tensor, radius: torch.Tensor,
    origin: torch.Tensor, direction: torch.Tensor, t_min, t_max,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic quadratic ray/sphere test (intersectSphere,
    shaders_old.metal:108-136) against center [S, 3] and radius [S], taking
    the smallest root within [t_min, t_max] (hits from inside use the far
    root)."""
    t_min, t_max = _broadcast_limits(t_min, t_max)
    oc = origin[..., None, :] - center        # [..., S, 3]
    d = direction[..., None, :]
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t1_ok = (t1 > t_min) & (t1 < t_max)
    t2_ok = (t2 > t_min) & (t2 < t_max)
    t = torch.where(t1_ok, t1, t2)
    valid = pos & (t1_ok | t2_ok)
    return t, valid


def _sphere_candidates(spheres: Spheres, origin, direction, t_min, t_max):
    return sphere_candidates(spheres.center, spheres.radius, origin,
                             direction, t_min, t_max)


def closest_hit(
    scene: CompiledScene, origin: torch.Tensor, direction: torch.Tensor,
    t_min: float = RAY_TMIN, t_max: float = RAY_TMAX,
    spheres: Optional[Spheres] = None,
) -> Hit:
    """Closest-hit query over triangles (+ optional spheres): first-minimum
    argmin over [triangles..., spheres...], so ties keep the lower index and
    a triangle beats a sphere."""
    t_tri, valid_tri = _triangle_candidates(scene, origin, direction,
                                            t_min, t_max)
    t_all, valid_all = t_tri, valid_tri
    num_tri = t_tri.shape[-1]

    has_spheres = spheres is not None and spheres.num_spheres > 0
    if has_spheres:
        t_sph, valid_sph = _sphere_candidates(spheres, origin, direction,
                                              t_min, t_max)
        t_all = torch.cat([t_tri, t_sph], dim=-1)
        valid_all = torch.cat([valid_tri, valid_sph], dim=-1)

    t_masked = torch.where(valid_all, t_all, torch.full_like(t_all, _BIG))
    prim = torch.argmin(t_masked, dim=-1)
    hit = torch.gather(valid_all, -1, prim[..., None])[..., 0]
    t_hit = torch.gather(t_all, -1, prim[..., None])[..., 0]
    t_hit = torch.where(hit, t_hit, torch.full_like(t_hit, _BIG))

    if not has_spheres:
        normal = scene.n[prim]
        diffuse = scene.diffuse[prim]
        emissive = scene.emissive[prim]
        metallic = scene.metallic[prim]
        roughness = scene.roughness[prim]
        is_em = scene.is_emissive[prim]
    else:
        is_sphere = prim >= num_tri
        sph_idx = torch.clamp(prim - num_tri, 0, spheres.num_spheres - 1)
        tri_idx = torch.clamp(prim, 0, num_tri - 1)
        # Sphere normal: (hit_point - center) normalized
        # (shaders_old.metal:122-123); t is clamped to 0 where no sphere won.
        t_safe = torch.where(hit & is_sphere, t_hit, torch.zeros_like(t_hit))
        hit_point = origin + t_safe[..., None] * direction
        to_hit = hit_point - spheres.center[sph_idx]
        sph_normal = to_hit * rsqrt(
            torch.clamp_min(dot(to_hit, to_hit), 1e-6))[..., None]
        sel = is_sphere[..., None]
        normal = torch.where(sel, sph_normal, scene.n[tri_idx])
        diffuse = torch.where(sel, spheres.diffuse[sph_idx],
                              scene.diffuse[tri_idx])
        emissive = torch.where(sel, spheres.emissive[sph_idx],
                               scene.emissive[tri_idx])
        metallic = torch.where(is_sphere, spheres.metallic[sph_idx],
                               scene.metallic[tri_idx])
        roughness = torch.where(is_sphere, spheres.roughness[sph_idx],
                                scene.roughness[tri_idx])
        is_em = torch.linalg.norm(emissive, dim=-1) > 0.0

    return Hit(hit=hit, t=t_hit, prim=prim, normal=normal, diffuse=diffuse,
               metallic=metallic, roughness=roughness, emissive=emissive,
               is_emissive=is_em)


def any_hit(
    scene: CompiledScene, origin: torch.Tensor, direction: torch.Tensor,
    t_min: float = RAY_TMIN, t_max=RAY_TMAX,
    spheres: Optional[Spheres] = None,
) -> torch.Tensor:
    """Shadow-ray occlusion query: a masked ``any`` over all primitives with
    a per-ray maximum distance (raytrace.metal:79-85)."""
    _, valid = _triangle_candidates(scene, origin, direction, t_min, t_max)
    occluded = valid.any(dim=-1)
    if spheres is not None and spheres.num_spheres > 0:
        _, valid_s = _sphere_candidates(spheres, origin, direction,
                                        t_min, t_max)
        occluded = occluded | valid_s.any(dim=-1)
    return occluded


def potential_occluders(scene, config=None, tol_scale: float = 1e-6,
                        sphere_slack: float = 0.0):
    """Static shadow-probe culling mask: ``mask[t]`` is False when triangle
    t provably CANNOT occlude any segment between a scene surface point and
    an area-light sample point, because every such endpoint lies in one
    closed half-space of t's plane (a segment with both endpoints on one
    side of a plane never crosses it; endpoint-grazing hits fall outside the
    probes' open t-window). In the Cornell box this culls the 10 convex-hull
    wall triangles and the 2 light-panel triangles from every shadow probe,
    while the box and sphere primitives are kept.

    Runs on the host in numpy float64 — call it once per concrete scene and
    pass the resulting tuple to the render entry points. The mask is tied to
    the geometry it was computed from. Endpoint set covered: every triangle
    vertex, every sphere's center +- radius along each plane normal, the
    light quad corners (true frame), the variant-B hardcoded half-extent
    square, and the camera position (dead lanes probe from there). Returns a
    tuple of bools, True = keep in the shadow loop.

    ``tol_scale``: slack on the half-space test, absorbing only the f32->f64
    conversion noise of the endpoint coordinates. It must stay well below
    the kernels' geometric epsilons (1e-3 shadow-origin offset along the
    normal; 1e-3 t_max shrink); when the scene's extent would push it past
    1e-4, culling is disabled for the scene (all True) with a warning.

    ``sphere_slack``: inflates every sphere's radius by this amount in the
    endpoint set, so the mask stays conservative while sphere centers move
    by up to that much."""
    verts = scene.triangles.verts.detach().cpu().numpy().astype(np.float64)
    T = verts.shape[0]
    v0 = verts[:, 0]
    n = np.cross(verts[:, 1] - v0, verts[:, 2] - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)
    c0 = np.sum(n * v0, axis=-1)  # [T]

    def host64(x):
        return x.detach().cpu().numpy().astype(np.float64)

    pts = [verts.reshape(-1, 3)]
    light = scene.light
    lc = host64(light.center)
    # True light frame corners (float32 basis, as the samplers build it).
    lt, lb = (host64(x) for x in build_orthonormal_basis(
        light.normal.detach().cpu().to(torch.float32)))
    w2 = float(light.width) / 2.0
    d2 = float(light.depth) / 2.0
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            pts.append((lc + sx * w2 * lt + sy * d2 * lb)[None])
    # Variant-B hardcoded half-extent square (x/z frame).
    he = float(config.area_light_half_extent) if config is not None else 0.25
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            pts.append((lc + np.array([sx * he, 0.0, sy * he]))[None])
    pts.append(host64(scene.camera.position)[None])
    pts = np.concatenate(pts, axis=0)  # [P, 3]

    d = pts @ n.T - c0[None, :]  # [P, T] signed distances
    scale = max(1.0, np.abs(pts).max())
    tol = tol_scale * scale
    if tol >= 1e-4:
        warnings.warn(
            f"potential_occluders: tol {tol:.3g} (scene extent {scale:.3g})"
            " would exceed the kernels' 1e-3 shadow epsilons; disabling"
            " static occluder culling for this scene", stacklevel=2)
        return tuple(True for _ in range(T))
    below = np.all(d <= tol, axis=0)
    above = np.all(d >= -tol, axis=0)
    sp = scene.spheres
    if sp.num_spheres:
        c = host64(sp.center)   # [S, 3]
        r = host64(sp.radius) + float(sphere_slack)  # [S]
        ds = c @ n.T - c0[None, :]              # [S, T]
        below &= np.all(ds + r[:, None] <= tol, axis=0)
        above &= np.all(ds - r[:, None] >= -tol, axis=0)
    return tuple(bool(x) for x in ~(below | above))
