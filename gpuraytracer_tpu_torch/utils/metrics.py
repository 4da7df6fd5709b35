"""Observability: ray accounting, structured metrics, timing, profiler
traces, and the H100 roofline.

Counterpart of ``gpuraytracer_tpu/utils/metrics.py``: one formula for rays
per frame and Mrays/s, a JSON-lines metric logger, a timing context, a
``torch.profiler`` trace, and the "speed-of-light" model that says what share
of the card's floor a measured time reaches. The card's figures replace the
JAX module's TPU v5e figures, and the operation counts are the hand counts
``chip_smoke.py`` charges its kernels (it imports them from here).
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..sampling import PRIMES
from ..types import RenderConfig


def nominal_rays(config: RenderConfig) -> int:
    """Rays per frame, counted whether or not a path is still alive.

    Variant-B path tracer: every (pixel, sample, bounce) is one closest-hit
    query and one shadow query. Variant-A MIS: every (pixel, camera ray) is
    one primary ray plus, per sample of the ``mis_samples // 3`` it takes,
    the five traversals the integrator executes (the light probe, and a
    closest hit with a secondary probe for each of the cosine and VNDF
    strategies). The legacy tier has no count (nor in the JAX package): its
    recursion makes the count a product of its sample counts."""
    if config.integrator in ("path", "direct"):
        bounces = 1 if config.integrator == "direct" else config.bounces
        return config.num_pixels * config.spp * bounces * 2
    if config.integrator == "mis":
        return (config.num_pixels * config.camera_rays
                * (1 + (config.mis_samples // 3) * 5))
    raise ValueError(
        f"no ray accounting for integrator {config.integrator!r}")


def mrays_per_s(config: RenderConfig, seconds: float) -> float:
    return nominal_rays(config) / seconds / 1e6


@dataclass
class MetricLogger:
    """JSON-lines metric sink: a file, or standard error."""

    path: Optional[str] = None
    records: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, name: str, value: Any, **tags: Any) -> None:
        rec = {"metric": name, "value": value, "time": time.time(), **tags}
        self.records.append(rec)
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            print(line, file=sys.stderr)


@contextmanager
def timed(logger: Optional[MetricLogger], name: str, **tags: Any):
    """Wall-clock a block into ``logger`` (seconds). The caller waits for
    the device inside the block (``torch.cuda.synchronize()``)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log(name, dt, unit="s", **tags)


@contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` over the block, the card's activity included where
    there is a card; writes a Chrome trace (``trace_<pid>_<ns>.json``, for
    chrome://tracing or Perfetto) into ``log_dir`` and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# Roofline: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores. Bounds are stated against these
# whatever power limit the card runs at. The float32 rate counts a fused
# multiply-add as two operations; the kernels are built with -fmad=false, so
# each of their multiplies and adds issues on its own, and their floor is at
# least twice an operation bound.
H100 = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}

# Float32 operations per primitive test, counted from path_kernels.cu (one
# per multiply, add, divide, compare or select): triangle closest-hit test,
# triangle any-hit test, sphere closest-hit test, sphere any-hit test; and
# the camera ray per sample and the shading of one bounce (hit point, light
# sample, accumulate, cosine bounce; a transcendental counted as one).
OPS_TRI_CLOSEST, OPS_TRI_SHADOW = 49, 46
# The part of a triangle test that the static tiers (K2, K4) and K2g's group
# loops run on every test (trace.cuh: den 5, num 6, |den| >= 1e-12 2, the
# signs of num and den 2, |num| < |den| t_far (1 + 2^-22) 4); the rest of
# OPS_TRI_CLOSEST or OPS_TRI_SHADOW runs only on a test that passes both
# conditions.
OPS_TRI_PREFILTER = 19
OPS_SPH_CLOSEST, OPS_SPH_SHADOW = 43, 39
OPS_CAMERA, OPS_SHADE = 30, 130
# Operations of a radical inverse as halton.cuh's short form runs it (SASS of
# draws_kernel): per digit a multiply-high (the quotient), a multiply-add
# (the remainder), a conversion, a multiply and an add; the first digit needs
# no add and the last no quotient or remainder (3 fewer a dimension); base 2
# a bit reversal, a conversion and a multiply.
OPS_HALTON_DIGIT, OPS_HALTON_SPARED, OPS_HALTON_BASE2 = 5, 3, 3

# Float32 operations of the backward kernel, counted the same way from
# shade_kernels.cu: one live bounce forward (134) and reversed (255); what a
# sphere hit adds (68 + 116); the camera ray per live sample, forward and
# reversed (29 + 32). Shuffles and adds of the reduction are not counted: they
# are how this kernel sums, not work the function needs.
OPS_BWD_BOUNCE, OPS_BWD_SPHERE, OPS_BWD_CAMERA = 389, 184, 61

# Float32 operations of the MIS kernel besides its primitive tests, counted
# from mis_kernels.cu like the counts above: per camera ray (hash jitter, ray,
# basis, the stretched view frame); per sample whose primary ray landed on a
# surface (three directions, seven pdfs, three heuristics, the light sample
# with its BRDF, two lobe BRDFs); per light sample at a bounce point, reached
# (with its BRDF) and blocked.
OPS_MIS_CAMERA, OPS_MIS_SAMPLE = 140, 832
OPS_MIS_SECONDARY, OPS_MIS_SECONDARY_BLOCKED = 182, 36
# Float32 operations of the MIS backward kernel per path through it, counted
# from mis_bwd_kernels.cu (one per multiply, add, divide, square root, compare,
# min, max or |x|; selects not counted) by running its device functions on the
# host with a counting float type: the hoisted stage forward and reversed,
# per camera ray on a surface; strategy 1 per reached light sample; the cosine
# and VNDF strategies per lobe ray on the light and per lobe ray on geometry
# whose light sample was reached (with the secondary light sample); what a
# recorded sphere winner adds (its quadratic and point normal, forward and
# reversed). A lane whose camera ray missed or landed on the light, a blocked
# light sample and a lobe ray that left the scene or was blocked need none.
OPS_K5_HOIST, OPS_K5_LIGHT = 493, 603
OPS_K5_COS_ON_LIGHT, OPS_K5_COS_ON_GEO = 686, 1241
OPS_K5_VNDF_ON_LIGHT, OPS_K5_VNDF_ON_GEO = 850, 1405
OPS_K5_SPHERE_HIT = 139

# Float32 operations of the silhouette kernels, counted by hand from
# soft_kernels.cu like the counts above (one per multiply, add, divide,
# square root, exp, compare, min, max or |x|; selects and negations not
# counted). silh_kernel per (sample, pixel) besides its primitive tests
# (OPS_TRI_* / OPS_SPH_*): camera ray and draws, candidate gates, the two
# probe points, two light samples, the code. soft_bwd_kernel per (sample,
# pixel): camera ray forward and reversed; a light sample forward and
# reversed; the sphere layer's quadratic, normal and point forward and
# reversed; the coverage forward and reversed; the background's plane
# distance, its point, and their reverse.
OPS_SILH_LANE = 136
OPS_K7_CAMERA, OPS_K7_SHADE_FWD, OPS_K7_SHADE_REV = 65, 43, 87
OPS_K7_SPHERE_FWD, OPS_K7_SPHERE_REV, OPS_K7_COVER = 70, 123, 74
OPS_K7_BG_HIT, OPS_K7_BG_SURF, OPS_K7_BG_REV = 15, 12, 47

# Float32 operations of the grouped sweep, counted from trace.cuh like the
# counts above: one padded-box slab test (six subtracts, six multiplies,
# eleven min / max, the min with the far limit and the compare: 25); in the
# closest-hit loop each box also makes its far limit from the t_best of that
# moment (a multiply, an add and a min: 28). Per ray, the three safe
# reciprocals (an |x|, a compare and a divide each: 9), and for a shadow ray
# its one far limit (a multiply and an add: 2).
OPS_BOX_CLOSEST, OPS_BOX_SHADOW = 28, 25
OPS_SWEEP_RAY, OPS_SHADOW_RAY = 9, 2


def roofline(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / H100["hbm_bytes_per_s"]
    t_ops = ops / H100["f32_ops_per_s"]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def halton_digits(base: int, max_index: int) -> int:
    return max(1, math.ceil(math.log(max_index + 1, base)))


def halton_dim_ops(dims, cfg: RenderConfig) -> int:
    """Operations of the radical inverses at Halton dimensions ``dims`` for
    one (pixel, sample), at indices below 2^20 + spp."""
    return sum(OPS_HALTON_BASE2 if PRIMES[d] == 2 else
               OPS_HALTON_DIGIT * halton_digits(PRIMES[d], (1 << 20) + cfg.spp)
               - OPS_HALTON_SPARED for d in dims)


def halton_ops(cfg: RenderConfig, n: int) -> int:
    """Operations of one frame's radical inverses: the jitter pair and four
    draws per bounce, per (pixel, sample)."""
    dims = [0, 1] + [2 + 5 * b + k for b in range(cfg.bounces)
                     for k in range(4)]
    return halton_dim_ops(dims, cfg) * cfg.spp * n


def _model(nbytes: int, ops: int) -> dict:
    t_ops = ops / H100["f32_ops_per_s"]
    t_hbm = nbytes / H100["hbm_bytes_per_s"]
    return {"t_ops_s": t_ops, "t_hbm_s": t_hbm, "t_floor_s": max(t_ops, t_hbm),
            "bound_by": "operations" if t_ops > t_hbm else "bytes",
            "ops": int(ops), "bytes": int(nbytes)}


def _path_cfg(config: RenderConfig) -> RenderConfig:
    return (config.replace(bounces=1) if config.integrator == "direct"
            else config)


# The four helpers below are a model of a frame on its config alone: every
# lane live at every bounce or sample, every primitive test counted whole.
# The bounds chip_smoke.py prints (and PERF.md keeps) count what a run's data
# needs instead: the live lanes, and in K2 and K4 the prefilter's share of a
# triangle test where the rest does not run. Those bounds are lower.

def roofline_path_fwd(config: RenderConfig, num_tris: int = 36,
                      num_spheres: int = 0, in_kernel_rng: bool = True,
                      shadow_tris: Optional[int] = None) -> dict:
    """Floor of the variant-B trace kernel (K2) on a frame of ``config``,
    every lane live at every bounce and every test counted whole: per
    (pixel, sample, bounce) a closest hit over every primitive, a shadow
    probe over ``shadow_tris`` triangles (those the occluder cull keeps;
    default all) and every sphere, and the shading; per (pixel, sample) the
    camera ray and, with ``in_kernel_rng``, the radical inverses. Bytes: the
    pixel offsets in, the hdr out. Returns t_ops_s, t_hbm_s, t_floor_s,
    bound_by, ops, bytes. The whole-test model: above the prefilter-aware
    bound chip_smoke.py prints for K2."""
    config = _path_cfg(config)
    if shadow_tris is None:
        shadow_tris = num_tris
    n = config.num_pixels
    per_bounce = (num_tris * OPS_TRI_CLOSEST + shadow_tris * OPS_TRI_SHADOW
                  + num_spheres * (OPS_SPH_CLOSEST + OPS_SPH_SHADOW)
                  + OPS_SHADE)
    ops = n * config.spp * (config.bounces * per_bounce + OPS_CAMERA)
    if in_kernel_rng:
        ops += halton_ops(config, n)
    return _model(n * (4 + 12), ops)


def roofline_path_bwd(config: RenderConfig, num_spheres: int = 0,
                      recompute_rng: bool = False) -> dict:
    """Floor of the variant-B backward kernel (K3): no ray tests (the
    records replay the decisions); per (pixel, sample, bounce) one live
    bounce forward and reversed, a sphere's share of them where
    ``num_spheres``, per (pixel, sample) the camera ray, and with
    ``recompute_rng`` the radical inverses. Bytes: the records, the hdr
    cotangent, and the draw planes (or, regenerated, the offsets). Every
    bounce counted live: above the bound chip_smoke.py prints for K3, which
    counts the live bounces of the run's records."""
    config = _path_cfg(config)
    n = config.num_pixels
    nsb = n * config.spp * config.bounces
    ops = nsb * OPS_BWD_BOUNCE + n * config.spp * OPS_BWD_CAMERA
    if num_spheres:
        ops += nsb * OPS_BWD_SPHERE
    nbytes = 4 * nsb + 12 * n
    if recompute_rng:
        ops += halton_ops(config, n)
        nbytes += 4 * n
    else:
        nbytes += 4 * (4 * config.bounces + 2) * config.spp * n
    return _model(nbytes, ops)


def roofline_mis_fwd(config: RenderConfig, num_tris: int = 34,
                     num_spheres: int = 0,
                     shadow_tris: Optional[int] = None) -> dict:
    """Floor of the variant-A MIS kernel (K4): per (pixel, camera ray) the
    primary closest hit and its shading; per sample (``mis_samples // 3``)
    the light probe, two lobe closest hits and two secondary probes over
    every primitive, the sample's shading and two reached secondary light
    samples. Bytes: the hdr out. The whole-test model: above the
    prefilter-aware bound chip_smoke.py prints for K4."""
    if shadow_tris is None:
        shadow_tris = num_tris
    rays = config.num_pixels * config.camera_rays
    closest = num_tris * OPS_TRI_CLOSEST + num_spheres * OPS_SPH_CLOSEST
    probe = shadow_tris * OPS_TRI_SHADOW + num_spheres * OPS_SPH_SHADOW
    per_sample = (3 * probe + 2 * closest + OPS_MIS_SAMPLE
                  + 2 * OPS_MIS_SECONDARY)
    ops = rays * (closest + OPS_MIS_CAMERA
                  + (config.mis_samples // 3) * per_sample)
    return _model(12 * config.num_pixels, ops)


def roofline_mis_bwd(config: RenderConfig, num_spheres: int = 0) -> dict:
    """Floor of the MIS backward kernel (K5): per (pixel, camera ray) the
    hoisted stage, per sample the light strategy and both lobe strategies on
    geometry (their costliest paths), a sphere winner's share where
    ``num_spheres``. Bytes: the camera and sample records, the hdr
    cotangent. Every path counted at its costliest: above the bound
    chip_smoke.py prints for K5, which counts the paths of the run's
    records."""
    rays = config.num_pixels * config.camera_rays
    s = config.mis_samples // 3
    per_sample = OPS_K5_LIGHT + OPS_K5_COS_ON_GEO + OPS_K5_VNDF_ON_GEO
    ops = rays * (OPS_K5_HOIST + s * per_sample)
    if num_spheres:
        ops += rays * (1 + 2 * s) * OPS_K5_SPHERE_HIT
    nbytes = 4 * rays * (1 + s) + 12 * config.num_pixels
    return _model(nbytes, ops)


def roofline_pct(measured_s: float, model: dict) -> float:
    """Achieved share of the modelled floor, in percent."""
    return 100.0 * model["t_floor_s"] / measured_s
