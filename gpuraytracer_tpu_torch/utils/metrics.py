"""Ray accounting: one formula for rays per frame and Mrays/s."""
from __future__ import annotations

from ..types import RenderConfig


def nominal_rays(config: RenderConfig) -> int:
    """Rays per frame of the variant-B path tracer: every (pixel, sample,
    bounce) is one closest-hit query and one shadow query, counted whether
    or not the path is still alive."""
    if config.integrator in ("path", "direct"):
        bounces = 1 if config.integrator == "direct" else config.bounces
        return config.num_pixels * config.spp * bounces * 2
    raise ValueError(
        f"no ray accounting for integrator {config.integrator!r} in this "
        "port yet")


def mrays_per_s(config: RenderConfig, seconds: float) -> float:
    return nominal_rays(config) / seconds / 1e6
