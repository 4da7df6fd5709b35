"""Low-discrepancy sampling, PRNG, samplers and PDFs.

Counterpart of ``gpuraytracer_tpu/sampling.py``: the samplers of the
variant-B path tracer, and the hash jitter, sample tables, MIS heuristic,
cosine / VNDF samplers and GGX terms of the variant-A MIS integrator. Every
function is vectorized over arbitrary leading batch dimensions; vectors use a
trailing axis of size 3. All randomness is a pure function of (pixel, sample,
bounce, dimension).

Integer state is carried as int64 masked to 32 bits: CPU ``torch`` has no
shift, remainder or floor-division for ``torch.uint32``, and the hash relies
on uint32 wrap-around. The results are bit-identical to the JAX package's
uint32 arithmetic.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

# Prime bases for the Halton sequence (sampling.metal:97-104).
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37,
          41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89)

_MASK32 = 0xFFFFFFFF
INV_2_32 = float(1.0 / 4294967296.0)


def _f32(x: float) -> float:
    """Round a Python float to float32 and back, so that a scalar constant
    enters tensor arithmetic with exactly the bits a float32 constant has."""
    return torch.tensor(x, dtype=torch.float32).item()


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot over the trailing axis, summed left to right
    (the order the CUDA kernels use)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) from the two correctly rounded operations, so that the
    CPU, the card's eager operators and the CUDA kernels agree bit for bit
    (a hardware ``rsqrt`` approximation differs between them by an ulp)."""
    return 1.0 / torch.sqrt(x)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize with a 1e-12 floor on the squared length (the floor the JAX
    package and the kernels use)."""
    return v * rsqrt(torch.clamp_min(dot(v, v), 1e-12))[..., None]


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Hash PRNG (xorshift-multiply; sampling.metal:68-79)
# ---------------------------------------------------------------------------

def as_u32(x) -> torch.Tensor:
    """Integer tensor -> int64 carrying a uint32 value."""
    return torch.as_tensor(x).to(torch.int64) & _MASK32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 xorshift-multiply hash, carried as int64 in [0, 2^32)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    x = x ^ (x >> 16)
    return x


def hash_random_2d(x, y, i, stride_x: int = 800,
                   stride_y: int = 600) -> torch.Tensor:
    """Variant-A per-pixel jitter, ``hashRandom`` (shaders.metal:71-85). The
    strides are the literal 800/600 baked into the reference kernel, kept as
    defaults whatever the actual resolution. uint32 arithmetic carried as
    int64 (a product may wrap int64; its low 32 bits are still the uint32
    product's). Returns [..., 2] float32 in [0, 1]."""
    x, y, i = as_u32(x), as_u32(y), as_u32(i)
    sample_id = (((y * stride_x + x) & _MASK32) * i) & _MASK32
    seed1 = hash_u32(x + y * stride_x + sample_id)
    seed2 = hash_u32(y + x * stride_y + sample_id + 12345)
    inv = _f32(INV_2_32)
    return torch.stack([seed1.to(torch.float32) * inv,
                        seed2.to(torch.float32) * inv], dim=-1)


# ---------------------------------------------------------------------------
# Halton / radical inverse
# ---------------------------------------------------------------------------

def _halton_digits(base: int) -> int:
    """Digits needed to exhaust a uint32 index in the given base."""
    return int(math.ceil(32.0 / math.log2(base)))


def halton(i: torch.Tensor, d: int) -> torch.Tensor:
    """Radical inverse of index ``i`` in base PRIMES[d]
    (sampling.metal:107-122), float32: per digit ``f *= 1/b; r += f * digit``
    with the product and the sum each rounded to float32. No fused
    multiply-add: the CUDA kernels spell the two roundings out, and the JAX
    package's draws kernel computes the same, so the draws are bit-identical
    across the packages. Once the index is exhausted every further digit
    adds exactly 0."""
    b = PRIMES[d]
    i = as_u32(i)
    inv_b = _f32(1.0 / b)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.ones_like(r)
    for _ in range(_halton_digits(b)):
        f = f * inv_b
        r = r + f * (i % b).to(torch.float32)
        i = i // b
    return r


def halton2(i: torch.Tensor, d: int) -> torch.Tensor:
    """``haltonRandom``: adjacent-dimension pair (shaders.metal:49-56).
    Returns [..., 2]."""
    return torch.stack([halton(i, d), halton(i, d + 1)], dim=-1)


def stratified2(i: torch.Tensor, d: int, n_total: int) -> torch.Tensor:
    """Stratified (jittered-grid) 2-D points: the unit square is split into
    sqrt(n) x sqrt(n) cells; sample ``i`` lands in cell ``i % n`` jittered by
    the Halton pair at dims (d, d+1). Returns [..., 2]. ``n_total`` must be
    a perfect square."""
    k = int(round(math.sqrt(n_total)))
    if k * k != n_total:
        raise ValueError(f"stratified2 needs a square sample count, "
                         f"got {n_total}")
    i = as_u32(i)
    cell = i % n_total
    cx = (cell % k).to(torch.float32)
    cy = (cell // k).to(torch.float32)
    inv_k = _f32(1.0 / k)
    ux = halton(i, d)
    uy = halton(i, d + 1)
    return torch.stack([(cx + ux) * inv_k, (cy + uy) * inv_k], dim=-1)


def mis_sample_table_rows(mis_samples: int,
                          sampler: str = "halton") -> torch.Tensor:
    """The MIS integrator's pixel-independent per-sample random table,
    [10, S] float32 on the CPU, rows in kernel order: light (u0, u1), cosine,
    cosine-secondary, VNDF, VNDF-secondary. Shared by the eager oracle
    (``render._mis_sample_tables``) and the kernel (``ops/cuda_mis.py``).

    ``sampler``: "halton" replicates the reference's haltonRandom draws
    (shaders.metal:557,564,584,595,617); "stratified" jitter-grids the same
    index/dim layout (requires a square samples-per-strategy count)."""
    s = mis_samples // 3
    i = torch.arange(s, dtype=torch.int64)
    if sampler == "halton":
        pair = halton2
    elif sampler == "stratified":
        def pair(idx, d):
            return stratified2(idx, d, s)
    else:
        raise ValueError(f"unknown sampler: {sampler!r}")
    rows = [
        pair(i, 0),          # light
        pair(i + s, 2),      # cosine
        pair(i, 6),          # cosine secondary NEE
        pair(i + 2 * s, 4),  # vndf
        pair(i + s, 6),      # vndf secondary NEE
    ]
    return torch.cat([r.T for r in rows], dim=0)


# ---------------------------------------------------------------------------
# MIS heuristic (shaders.metal:131-137)
# ---------------------------------------------------------------------------

def power_heuristic_3(pdf1, pdf2, pdf3, samples_per_strategy, beta=1.0):
    """3-strategy power heuristic with per-strategy sample count
    (shaders.metal:132-137); every call site of the reference passes
    beta = 1. beta == 1 skips ``pow`` (value-identical, and pow's derivative
    beta * x^(beta-1) is NaN-prone at x = 0, which ``cosine_pdf`` produces on
    every backfacing lane)."""
    n = float(samples_per_strategy)
    if float(beta) == 1.0:
        p1 = n * pdf1
        s = p1 + n * pdf2 + n * pdf3
    else:
        p1 = torch.pow(n * pdf1, beta)
        s = p1 + torch.pow(n * pdf2, beta) + torch.pow(n * pdf3, beta)
    return p1 / (s + 1e-6)


# ---------------------------------------------------------------------------
# Camera (generateCameraRay; sampling.metal:125-157)
# ---------------------------------------------------------------------------

def camera_basis(direction: torch.Tensor, up: torch.Tensor):
    w = -normalize(direction)
    u = normalize(cross(up, w))
    v = normalize(cross(w, u))
    return u, v, w


def generate_camera_ray(
    position: torch.Tensor, direction: torch.Tensor, up: torch.Tensor,
    resolution: Tuple[int, int], horizontal_fov,
    px: torch.Tensor, py: torch.Tensor, jitter: torch.Tensor,
    integer_aspect: bool = True,
):
    """Pinhole camera ray for pixel (px, py) with subpixel jitter [..., 2].

    ``integer_aspect`` replicates ``float(camera.resolution.x /
    camera.resolution.y)`` — integer division, so 800x600 gives aspect 1.0,
    not 1.333 (sampling.metal:132). Returns (origin[...,3], dir[...,3])."""
    res_x, res_y = resolution
    aspect = float(res_x // res_y) if integer_aspect else res_x / res_y
    half_width = torch.tan(horizontal_fov / 2.0)
    half_height = half_width / aspect
    u, v, w = camera_basis(direction, up)

    s = ((px.to(torch.float32) + jitter[..., 0]) / float(res_x)) * 2.0 - 1.0
    t = -(((py.to(torch.float32) + jitter[..., 1]) / float(res_y)) * 2.0 - 1.0)
    d = normalize(
        s[..., None] * (half_width * u) + t[..., None] * (half_height * v) - w
    )
    origin = position.expand(d.shape)
    return origin, d


# ---------------------------------------------------------------------------
# Bases and hemisphere samplers
# ---------------------------------------------------------------------------

def align_hemisphere_with_normal(sample: torch.Tensor, normal: torch.Tensor):
    """Variant-B fixed-axis basis (sampling.metal:51-66): up = n, right =
    normalize(cross(n, (0.0072, 1, 0.0034))), forward = cross(right, up)."""
    axis = torch.tensor([0.0072, 1.0, 0.0034], dtype=torch.float32,
                        device=normal.device)
    right = normalize(cross(normal, axis.expand(normal.shape)))
    forward = cross(right, normal)
    return (sample[..., 0:1] * right + sample[..., 1:2] * normal
            + sample[..., 2:3] * forward)


def build_orthonormal_basis(normal: torch.Tensor):
    """Branching basis (sampling.metal:159-172): the reference picks (0,1,0)
    when |n.x| > 0.9 else (1,0,0), then Gram-Schmidts. Returns
    (tangent, bitangent)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                      device=normal.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                      device=normal.device)
    a = torch.where((normal[..., 0].abs() > 0.9)[..., None], ey, ex)
    tangent = normalize(a - dot(a, normal)[..., None] * normal)
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def cosine_hemisphere_y_up(u: torch.Tensor) -> torch.Tensor:
    """Variant-B cosine sample in y-up local frame (sampling.metal:39-49)."""
    phi = _f32(2.0 * math.pi) * u[..., 0]
    cos_theta = torch.sqrt(u[..., 1])
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)],
        dim=-1)


def cosine_weighted_dir(normal: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Variant-A cosine sample about ``normal`` via the branching basis
    (cosineWeightedRay, shaders.metal:355-374)."""
    phi = _f32(2.0 * math.pi) * u[..., 0]
    cos_theta = torch.sqrt(u[..., 1])
    sin_theta = torch.sqrt(1.0 - u[..., 1])
    tangent, bitangent = build_orthonormal_basis(normal)
    return normalize(
        tangent * (torch.cos(phi) * sin_theta)[..., None]
        + bitangent * (torch.sin(phi) * sin_theta)[..., None]
        + normal * cos_theta[..., None]
    )


def cosine_pdf(normal: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """cos(theta)/pi (shaders.metal:376-380)."""
    return torch.clamp_min(dot(normal, direction), 0.0) / math.pi


# ---------------------------------------------------------------------------
# Area-light sampling
# ---------------------------------------------------------------------------

def sample_area_light(
    light_center: torch.Tensor, light_color: torch.Tensor,
    light_normal: torch.Tensor, position: torch.Tensor, u: torch.Tensor,
    half_extent: float = 0.25,
):
    """Variant-B ``sampleAreaLight`` (sampling.metal:198-236).

    The reference hardcodes right=(0.25,0,0), up=(0,0,0.25) — a 0.5x0.5
    sampling rect even though the scene light is 1x1; ``half_extent`` keeps
    that quirk configurable. Returns (light_color_falloff[...,3],
    light_dir[...,3], light_dist[...])."""
    uu = u * 2.0 - 1.0
    he = _f32(half_extent)
    right = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                         device=u.device) * he
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                      device=u.device) * he
    sample_pos = light_center + right * uu[..., 0:1] + up * uu[..., 1:2]
    to_light = sample_pos - position
    dist = torch.sqrt(torch.clamp_min(dot(to_light, to_light), 0.0))
    inv_dist = 1.0 / torch.clamp_min(dist, 1e-3)
    direction = to_light * inv_dist[..., None]
    color = light_color * (inv_dist * inv_dist)[..., None]
    color = color * saturate(dot(-direction, light_normal))[..., None]
    return color, direction, dist


def direct_square_light_sample(
    origin: torch.Tensor, light_center: torch.Tensor, light_width,
    light_depth, light_normal: torch.Tensor, u: torch.Tensor,
):
    """Variant-A ``directSquareLightRay`` (shaders.metal:291-313): uniform
    point on the full rectangle via the branching basis of the light normal.
    Returns (direction[...,3], distance[...]). The direction is a plain
    division by the distance: sample 0 of the Halton table is the
    rectangle's corner, where an ulp decides the light probe."""
    tangent, bitangent = build_orthonormal_basis(
        light_normal.expand(origin.shape))
    x = (u[..., 0] - 0.5) * light_width
    y = (u[..., 1] - 0.5) * light_depth
    sample_pos = (light_center + tangent * x[..., None]
                  + bitangent * y[..., None])
    to_light = sample_pos - origin
    dist = torch.sqrt(torch.clamp_min(dot(to_light, to_light), 1e-30))
    return to_light / dist[..., None], dist


def square_light_pdf(
    origin: torch.Tensor, light_center: torch.Tensor, light_width,
    light_depth, light_normal: torch.Tensor, direction: torch.Tensor,
):
    """Area-light pdf measured to the light *center*, not the actual hit
    point — a deliberate reference quirk (calculateSquareLightPdf,
    shaders.metal:315-326)."""
    to_light = light_center - origin
    dist2 = dot(to_light, to_light)
    cos_theta = torch.clamp_min(dot(-direction, light_normal), 0.0)
    area = light_width * light_depth
    return dist2 / (area * cos_theta + 1e-6)


# ---------------------------------------------------------------------------
# GGX / VNDF (shaders.metal:186-208, 382-445)
#
# The floors below (1e-12, +1e-12, +1e-7) are value-preserving on live lanes
# and keep 0/0 and overflowing derivatives off masked lanes in the backward
# pass: the light material has roughness 0, and lanes that hit it are masked
# out of the image but still differentiated through.
# ---------------------------------------------------------------------------

def smith_g1_ggx(n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    a = roughness * roughness
    a2 = a * a
    nv2 = torch.clamp_min(n_dot_v * n_dot_v, 1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))


def d_ggx(n_dot_h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """GGX NDF. The reference passes *roughness* (not roughness^2) as ``a``
    at every call site (shaders.metal:273,442) — replicated. The +1e-12
    keeps 0/0 (a == 0 with n.h == 1, masked lanes only) finite forward and
    backward; a smaller guard underflows when the division's derivative
    squares the denominator."""
    a2 = a * a
    f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (math.pi * f * f + 1e-12)


def f_schlick(l_dot_h: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    return f0 + (1.0 - f0) * torch.pow(1.0 - l_dot_h, 5.0)[..., None]


def v_smith_ggx_correlated(n_dot_v, n_dot_l, a):
    a2 = a * a
    ggx_l = n_dot_v * torch.sqrt(torch.clamp_min(
        (-n_dot_l * a2 + n_dot_l) * n_dot_l + a2, 1e-12))
    ggx_v = n_dot_l * torch.sqrt(torch.clamp_min(
        (-n_dot_v * a2 + n_dot_v) * n_dot_v + a2, 1e-12))
    return 0.5 / (ggx_v + ggx_l + 1e-7)


def fd_lambert() -> float:
    return 1.0 / math.pi


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize by division, with the 1e-12 floor on the squared length."""
    return v / torch.sqrt(torch.clamp_min(dot(v, v), 1e-12))[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def vndf_dir(view_dir: torch.Tensor, normal: torch.Tensor,
             roughness: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Heitz-style VNDF GGX sample: stretch the view direction, sample the
    spherical cap, unstretch, reflect (vndfRay, shaders.metal:382-435)."""
    alpha = (roughness * roughness)[..., None]
    tangent, bitangent = build_orthonormal_basis(normal)
    ve = _safe_normalize(torch.cat([
        alpha * dot(view_dir, tangent)[..., None],
        alpha * dot(view_dir, bitangent)[..., None],
        dot(view_dir, normal)[..., None]], dim=-1))
    t1 = _safe_normalize(torch.stack(
        [ve[..., 2], torch.zeros_like(ve[..., 0]), -ve[..., 0]], dim=-1))
    t2 = cross(ve, t1)
    phi = _f32(2.0 * math.pi) * u[..., 0]
    # The reference normalizes Ve and then takes length(Ve): the length is 1
    # and cosThetaMax = 1/sqrt(2); replicated by computing it after the
    # normalize.
    len_ve = torch.sqrt(dot(ve, ve))
    cos_theta_max = len_ve / torch.sqrt(1.0 + len_ve * len_ve)
    cos_theta = cos_theta_max + (1.0 - cos_theta_max) * u[..., 1]
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    h = _safe_normalize(
        t1 * (torch.cos(phi) * sin_theta)[..., None]
        + t2 * (torch.sin(phi) * sin_theta)[..., None]
        + ve * cos_theta[..., None])
    nh = _safe_normalize(torch.cat(
        [alpha * h[..., 0:1], alpha * h[..., 1:2],
         torch.clamp_min(h[..., 2:3], 0.0)], dim=-1))
    world_h = _safe_normalize(
        tangent * nh[..., 0:1] + bitangent * nh[..., 1:2]
        + normal * nh[..., 2:3])
    return reflect(-view_dir, world_h)


def vndf_pdf(view_dir: torch.Tensor, normal: torch.Tensor,
             light_dir: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """D * G1 * VoH / (4 * NoV) (calculateVNDFPdf, shaders.metal:437-445);
    +1e-7 in the denominator keeps exact grazing (n.v == 0) finite."""
    h = _safe_normalize(view_dir + light_dir)
    n_dot_h = dot(normal, h).abs()
    v_dot_h = dot(view_dir, h).abs()
    n_dot_v = dot(normal, view_dir).abs()
    d = d_ggx(n_dot_h, roughness)
    g1 = smith_g1_ggx(n_dot_v, roughness)
    return (d * g1 * v_dot_h) / (4.0 * n_dot_v + 1e-7)
