"""Frozen copy of the sampling arithmetic the two integrators need.

Copied from ``gpuraytracer_tpu_torch/sampling.py`` (itself after the
reference's sampling.metal and shaders.metal): the Halton radical inverse,
the hash jitter, the pinhole camera, the hemisphere and light samplers, the
GGX terms and the power heuristic. Plain ``torch`` only. Every function works
in the dtype of its float inputs; those that make floats from integers take
``dtype``, so the whole reference can run in a lower precision (the
control of ``portbench/check.py``).
"""
from __future__ import annotations

import functools
import math

import torch

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37,
          41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89)
_MASK32 = 0xFFFFFFFF
TWO_PI = float(torch.tensor(2.0 * math.pi, dtype=torch.float32).item())
INV_2_32 = 1.0 / 4294967296.0


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor, made once per dtype and device (a fresh
    one would be a copy to the card on every call)."""
    return torch.tensor(values, dtype=dtype, device=device)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(v):
    return v * (1.0 / torch.sqrt(torch.clamp_min(dot(v, v), 1e-12)))[..., None]


def safe_normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot(v, v), 1e-12))[..., None]


def hash_u32(x):
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def pixel_offsets(n_pixels: int, seed: int, device):
    """Per-pixel Halton index offsets in [0, 2^20), from (pixel, seed)."""
    idx = torch.arange(n_pixels, dtype=torch.int64, device=device)
    seed_term = (seed * 0x9E3779B9) & _MASK32
    return hash_u32((idx * 9781 + seed_term) & _MASK32) % (1024 * 1024)


def hash_random_2d(x, y, i: int, dtype):
    """Variant A's per-pixel jitter with the reference's literal 800 / 600
    strides (shaders.metal:71-85)."""
    sample_id = (((y * 800 + x) & _MASK32) * i) & _MASK32
    seed1 = hash_u32(x + y * 800 + sample_id)
    seed2 = hash_u32(y + x * 600 + sample_id + 12345)
    return torch.stack([seed1.to(dtype) * INV_2_32,
                        seed2.to(dtype) * INV_2_32], dim=-1)


def halton(i, d: int, dtype):
    """Radical inverse of ``i`` in base PRIMES[d], digit by digit."""
    b = PRIMES[d]
    inv_b = float(torch.tensor(1.0 / b, dtype=torch.float32).item())
    r = torch.zeros(i.shape, dtype=dtype, device=i.device)
    f = torch.ones_like(r)
    i = i & _MASK32
    for _ in range(int(math.ceil(32.0 / math.log2(b)))):
        f = f * inv_b
        r = r + f * (i % b).to(dtype)
        i = i // b
    return r


def halton2(i, d: int, dtype):
    return torch.stack([halton(i, d, dtype), halton(i, d + 1, dtype)], -1)


def mis_sample_tables(mis_samples: int, device, dtype):
    """The MIS integrator's pixel-independent draws, [S, 2] per strategy:
    light, cosine, cosine secondary, VNDF, VNDF secondary."""
    s = mis_samples // 3
    i = torch.arange(s, dtype=torch.int64, device=device)
    return (halton2(i, 0, dtype), halton2(i + s, 2, dtype),
            halton2(i, 6, dtype), halton2(i + 2 * s, 4, dtype),
            halton2(i + s, 6, dtype))


def power_heuristic_3(pdf1, pdf2, pdf3, n: int):
    p1 = n * pdf1
    return p1 / (p1 + n * pdf2 + n * pdf3 + 1e-6)


def camera_ray(cam, resolution, px, py, jitter):
    """Pinhole ray through pixel (px, py) + jitter; the aspect is the
    reference's integer division of the resolution."""
    res_x, res_y = resolution
    aspect = float(res_x // res_y)
    half_width = torch.tan(cam["horizontal_fov"] / 2.0)
    half_height = half_width / aspect
    w = -normalize(cam["direction"])
    u = normalize(cross(cam["up"], w))
    v = normalize(cross(w, u))
    dt = jitter.dtype
    s = ((px.to(dt) + jitter[..., 0]) / float(res_x)) * 2.0 - 1.0
    t = -(((py.to(dt) + jitter[..., 1]) / float(res_y)) * 2.0 - 1.0)
    d = normalize(s[..., None] * (half_width * u)
                  + t[..., None] * (half_height * v) - w)
    return cam["position"].expand(d.shape), d


def align_hemisphere(sample, normal):
    """Variant B's fixed-axis basis (sampling.metal:51-66)."""
    axis = _const((0.0072, 1.0, 0.0034), normal.dtype, normal.device)
    right = normalize(cross(normal, axis.expand(normal.shape)))
    forward = cross(right, normal)
    return (sample[..., 0:1] * right + sample[..., 1:2] * normal
            + sample[..., 2:3] * forward)


def orthonormal_basis(normal):
    """Variant A's branching basis (sampling.metal:159-172)."""
    ex = _const((1.0, 0.0, 0.0), normal.dtype, normal.device)
    ey = _const((0.0, 1.0, 0.0), normal.dtype, normal.device)
    a = torch.where((normal[..., 0].abs() > 0.9)[..., None], ey, ex)
    tangent = normalize(a - dot(a, normal)[..., None] * normal)
    return tangent, cross(normal, tangent)


def cosine_hemisphere_y_up(u):
    phi = TWO_PI * u[..., 0]
    cos_theta = torch.sqrt(u[..., 1])
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi), cos_theta,
                        sin_theta * torch.sin(phi)], dim=-1)


def cosine_weighted_dir(normal, u):
    phi = TWO_PI * u[..., 0]
    cos_theta = torch.sqrt(u[..., 1])
    sin_theta = torch.sqrt(1.0 - u[..., 1])
    tangent, bitangent = orthonormal_basis(normal)
    return normalize(tangent * (torch.cos(phi) * sin_theta)[..., None]
                     + bitangent * (torch.sin(phi) * sin_theta)[..., None]
                     + normal * cos_theta[..., None])


def cosine_pdf(normal, direction):
    return torch.clamp_min(dot(normal, direction), 0.0) / math.pi


def sample_area_light(light, position, u, half_extent: float = 0.25):
    """Variant B's ``sampleAreaLight`` with the reference's hard-coded
    0.25 half extents (sampling.metal:198-236): (colour, direction,
    distance)."""
    uu = u * 2.0 - 1.0
    dt, dev = u.dtype, u.device
    right = _const((half_extent, 0.0, 0.0), dt, dev)
    up = _const((0.0, 0.0, half_extent), dt, dev)
    to_light = (light["center"] + right * uu[..., 0:1] + up * uu[..., 1:2]
                - position)
    dist = torch.sqrt(torch.clamp_min(dot(to_light, to_light), 0.0))
    inv_dist = 1.0 / torch.clamp_min(dist, 1e-3)
    direction = to_light * inv_dist[..., None]
    color = light["color"] * (inv_dist * inv_dist)[..., None]
    color = color * torch.clamp(dot(-direction, light["normal"]),
                                0.0, 1.0)[..., None]
    return color, direction, dist


def direct_square_light_sample(origin, light, u):
    """Variant A's uniform point on the light rectangle: (direction,
    distance)."""
    tangent, bitangent = orthonormal_basis(light["normal"].expand(origin.shape))
    x = (u[..., 0] - 0.5) * light["width"]
    y = (u[..., 1] - 0.5) * light["depth"]
    to_light = (light["center"] + tangent * x[..., None]
                + bitangent * y[..., None] - origin)
    dist = torch.sqrt(torch.clamp_min(dot(to_light, to_light), 1e-30))
    return to_light / dist[..., None], dist


def square_light_pdf(origin, light, direction):
    """The reference's light pdf, measured to the light's centre."""
    to_light = light["center"] - origin
    cos_theta = torch.clamp_min(dot(-direction, light["normal"]), 0.0)
    return dot(to_light, to_light) / (
        light["width"] * light["depth"] * cos_theta + 1e-6)


def smith_g1_ggx(n_dot_v, roughness):
    a = roughness * roughness
    a2 = a * a
    nv2 = torch.clamp_min(n_dot_v * n_dot_v, 1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))


def d_ggx(n_dot_h, a):
    a2 = a * a
    f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (math.pi * f * f + 1e-12)


def vndf_dir(view_dir, normal, roughness, u):
    """Heitz's VNDF sample of GGX (shaders.metal:382-435)."""
    alpha = (roughness * roughness)[..., None]
    tangent, bitangent = orthonormal_basis(normal)
    ve = safe_normalize(torch.cat([
        alpha * dot(view_dir, tangent)[..., None],
        alpha * dot(view_dir, bitangent)[..., None],
        dot(view_dir, normal)[..., None]], dim=-1))
    t1 = safe_normalize(torch.stack(
        [ve[..., 2], torch.zeros_like(ve[..., 0]), -ve[..., 0]], dim=-1))
    t2 = cross(ve, t1)
    phi = TWO_PI * u[..., 0]
    len_ve = torch.sqrt(dot(ve, ve))
    cos_theta_max = len_ve / torch.sqrt(1.0 + len_ve * len_ve)
    cos_theta = cos_theta_max + (1.0 - cos_theta_max) * u[..., 1]
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    h = safe_normalize(t1 * (torch.cos(phi) * sin_theta)[..., None]
                       + t2 * (torch.sin(phi) * sin_theta)[..., None]
                       + ve * cos_theta[..., None])
    nh = safe_normalize(torch.cat([alpha * h[..., 0:1], alpha * h[..., 1:2],
                                   torch.clamp_min(h[..., 2:3], 0.0)], -1))
    world_h = safe_normalize(tangent * nh[..., 0:1] + bitangent * nh[..., 1:2]
                             + normal * nh[..., 2:3])
    incident = -view_dir
    return incident - 2.0 * dot(incident, world_h)[..., None] * world_h


def vndf_pdf(view_dir, normal, light_dir, roughness):
    h = safe_normalize(view_dir + light_dir)
    n_dot_v = dot(normal, view_dir).abs()
    return (d_ggx(dot(normal, h).abs(), roughness)
            * smith_g1_ggx(n_dot_v, roughness) * dot(view_dir, h).abs()) / (
                4.0 * n_dot_v + 1e-7)


def brdf(incoming_dir, normal, diffuse, metallic, roughness, light_dir):
    """kD * (Fd + Fr) * NoL with f0 = mix(0.04, diffuse, metallic), the
    reference's un-squared roughness in D and V (shaders.metal:259-289)."""
    v = -normalize(incoming_dir)
    h = safe_normalize(v + light_dir)
    n_dot_v = dot(normal, v).abs() + 1e-5
    n_dot_l = torch.clamp(dot(normal, light_dir), 0.0, 1.0)
    n_dot_h = torch.clamp(dot(normal, h), 0.0, 1.0)
    l_dot_h = torch.clamp(dot(light_dir, h), 0.0, 1.0)
    m = metallic[..., None]
    f0 = 0.04 * (1.0 - m) + diffuse * m
    d = d_ggx(n_dot_h, roughness)
    f = f0 + (1.0 - f0) * torch.pow(1.0 - l_dot_h, 5.0)[..., None]
    a2 = roughness * roughness
    ggx_l = n_dot_v * torch.sqrt(torch.clamp_min(
        (-n_dot_l * a2 + n_dot_l) * n_dot_l + a2, 1e-12))
    ggx_v = n_dot_l * torch.sqrt(torch.clamp_min(
        (-n_dot_v * a2 + n_dot_v) * n_dot_v + a2, 1e-12))
    g = 0.5 / (ggx_v + ggx_l + 1e-7)
    fr = (d * g)[..., None] * f / (4.0 * n_dot_v * n_dot_l + 1e-7)[..., None]
    k_d = (1.0 - f) * (1.0 - m)
    return k_d * (diffuse * (1.0 / math.pi) + fr) * n_dot_l[..., None]
