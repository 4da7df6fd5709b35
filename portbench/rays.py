"""Nominal rays of one frame or one fit step, from the traffic alone.

A frozen copy of ``gpuraytracer_tpu_torch.utils.metrics.nominal_rays``:
variant B (``path``) counts every (pixel, sample, bounce) as one closest-hit
query and one shadow query; variant A (``mis``) counts every (pixel, camera
ray) as one primary ray plus, for each of its ``mis_samples // 3`` samples,
the five traversals the integrator makes (the light probe, and a closest hit
with a secondary probe for each of the cosine and VNDF strategies). A ray is
counted whether or not its path is still alive, so the count does not depend
on the scene or on how a kernel traverses it.
"""
from __future__ import annotations

from typing import Dict


def nominal_rays(traffic: Dict) -> int:
    pixels = traffic["width"] * traffic["height"]
    if traffic["integrator"] == "path":
        return pixels * traffic["spp"] * traffic["bounces"] * 2
    if traffic["integrator"] == "mis":
        return pixels * traffic["camera_rays"] * (
            1 + (traffic["mis_samples"] // 3) * 5)
    raise ValueError(f"no ray count for integrator {traffic['integrator']!r}")
