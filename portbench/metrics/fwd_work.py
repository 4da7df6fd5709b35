"""The work of one forward render, from the cell's shapes and scene alone.

Each nominal ray (``portbench.rays``) is charged one primitive test; each
(pixel, sample, bounce) or (pixel, camera ray, sample) the shading
arithmetic its integrator's equations need. The counts never read a kernel,
a traversal's tests, a prefilter's pass shares or a launch: whatever kernels
the program runs, this is the work they are held to. Operations count each
add, multiply, divide, square root, compare and transcendental as one; the
random draws are not counted. Bytes count the scene once and the image the
user receives once (float32).
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..rays import nominal_rays

# One ray against one triangle in the plane and dual-basis form: d.n (5),
# c0 - o.n (6), t (1), u = o.s1 + t d.s1 - c1 (13), v (13), the window and
# the barycentric bounds (6).
TRIANGLE_TEST = 44

# Variant B. A camera ray: the image-plane point (8) and the normalized
# direction (14). A bounce: the hit point offset along the normal (12), the
# light sample's position, distance, direction, fall-off and cosine (38),
# the surface cosine (10), the throughput (3), the contribution and its sum
# (6), the cosine-weighted direction in the fixed-axis basis (47).
PATH_CAMERA = 22
PATH_BOUNCE = 12 + 38 + 10 + 3 + 6 + 47

# Variant A. A camera ray as above, the hit point (6) and the emitter's
# term (3). A sample: the light sample with its pdfs, BRDF, heuristic and
# gate (165); the cosine strategy's direction, pdfs, heuristic, BRDF, light
# term, bounce point and secondary light sample (314); the VNDF strategy's,
# with the stretched half-vector sample (359); the sum (9).
MIS_CAMERA = 22 + 6 + 3
MIS_SAMPLE = 165 + 314 + 359 + 9

SCENE_BYTES_PER_TRIANGLE = 4 * (9 + 3 + 1 + 1 + 3)


def shading_ops(traffic: Dict) -> int:
    """Shading operations of one render (no traversal)."""
    pixels = traffic["width"] * traffic["height"]
    if traffic["integrator"] == "path":
        return pixels * traffic["spp"] * (
            PATH_CAMERA + traffic["bounces"] * PATH_BOUNCE)
    return pixels * traffic["camera_rays"] * (
        MIS_CAMERA + (traffic["mis_samples"] // 3) * MIS_SAMPLE)


def count(traffic: Dict, num_triangles: int) -> Tuple[int, int]:
    """(operations, bytes) of one forward render."""
    ops = nominal_rays(traffic) * TRIANGLE_TEST + shading_ops(traffic)
    image = traffic["width"] * traffic["height"] * 3 * 4
    return ops, num_triangles * SCENE_BYTES_PER_TRIANGLE + image
