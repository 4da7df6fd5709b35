"""Metallic-roughness microfacet BRDF (calculateBRDFContribution,
Sources/gpuRaytracer/shaders.metal:259-289).

Counterpart of ``gpuraytracer_tpu/brdf.py``."""
from __future__ import annotations

import torch

from .sampling import (_safe_normalize, d_ggx, dot, f_schlick, fd_lambert,
                       normalize, v_smith_ggx_correlated)


def brdf_contribution(
    incoming_dir: torch.Tensor,  # [..., 3] ray direction toward the surface
    normal: torch.Tensor,        # [..., 3]
    diffuse: torch.Tensor,       # [..., 3]
    metallic: torch.Tensor,      # [...]
    roughness: torch.Tensor,     # [...]
    light_dir: torch.Tensor,     # [..., 3] normalized
) -> torch.Tensor:
    """kD * (Fd + Fr) * NoL with f0 = mix(0.04, diffuse, metallic).

    Mirrors the reference including its quirks: D_GGX receives roughness
    (not alpha = roughness^2), and the GGX visibility term uses the same
    un-squared roughness (shaders.metal:273-275)."""
    v = -normalize(incoming_dir)
    n = normal
    l = light_dir
    h = _safe_normalize(v + l)  # l == -v (masked lanes) must stay finite

    n_dot_v = dot(n, v).abs() + 1e-5
    n_dot_l = torch.clamp(dot(n, l), 0.0, 1.0)
    n_dot_h = torch.clamp(dot(n, h), 0.0, 1.0)
    l_dot_h = torch.clamp(dot(l, h), 0.0, 1.0)

    # mix(0.04, diffuse, metallic), elementwise over rgb.
    f0 = 0.04 * (1.0 - metallic[..., None]) + diffuse * metallic[..., None]
    d = d_ggx(n_dot_h, roughness)
    f = f_schlick(l_dot_h, f0)
    g = v_smith_ggx_correlated(n_dot_v, n_dot_l, roughness)

    fr = (d * g)[..., None] * f / (4.0 * n_dot_v * n_dot_l + 1e-7)[..., None]
    fd = diffuse * fd_lambert()

    k_d = (1.0 - f) * (1.0 - metallic[..., None])
    return k_d * (fd + fr) * n_dot_l[..., None]
