"""Ray accounting: one formula for rays per frame and Mrays/s."""
from __future__ import annotations

from ..types import RenderConfig


def nominal_rays(config: RenderConfig) -> int:
    """Rays per frame, counted whether or not a path is still alive.

    Variant-B path tracer: every (pixel, sample, bounce) is one closest-hit
    query and one shadow query. Variant-A MIS: every (pixel, camera ray) is
    one primary ray plus, per sample of the ``mis_samples // 3`` it takes,
    the five traversals the integrator executes (the light probe, and a
    closest hit with a secondary probe for each of the cosine and VNDF
    strategies)."""
    if config.integrator in ("path", "direct"):
        bounces = 1 if config.integrator == "direct" else config.bounces
        return config.num_pixels * config.spp * bounces * 2
    if config.integrator == "mis":
        return (config.num_pixels * config.camera_rays
                * (1 + (config.mis_samples // 3) * 5))
    raise ValueError(
        f"no ray accounting for integrator {config.integrator!r} in this "
        "port yet")


def mrays_per_s(config: RenderConfig, seconds: float) -> float:
    return nominal_rays(config) / seconds / 1e6
