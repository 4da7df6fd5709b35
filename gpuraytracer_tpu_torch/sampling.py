"""Low-discrepancy sampling, PRNG and samplers of the variant-B path tracer.

Counterpart of ``gpuraytracer_tpu/sampling.py`` (path subset). Every function
is vectorized over arbitrary leading batch dimensions; vectors use a trailing
axis of size 3. All randomness is a pure function of (pixel, sample, bounce,
dimension).

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
