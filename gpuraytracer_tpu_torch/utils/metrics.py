"""Observability: ray accounting, the program's spans, profiler traces, and
the H100 roofline.

Counterpart of ``gpuraytracer_tpu/utils/metrics.py``: one formula for rays
per frame and Mrays/s, spans at the port's layer boundaries (``span``,
``traced``), a ``torch.profiler`` trace, and the "speed-of-light" bound of a
kernel's work. The card's figures replace the JAX module's TPU v5e figures,
and the operation counts are the hand counts ``chip_smoke.py`` charges its
kernels (it imports them from here).
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import time

import torch

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


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` over the block, the card's activity included where
    there is a card; writes a Chrome trace (``trace_<pid>_<ns>.json``, for
    chrome://tracing or Perfetto) into ``log_dir`` and yields the profiler.
    The trace holds the program's ``grt.`` spans (``span``) beside the
    kernels and copies."""
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


# The program's spans. Each opens a ``torch.profiler.record_function`` named
# "grt." + name while torch's profiler records, and does nothing otherwise:
# the profiler is the only switch. They land in the profiler's Chrome trace
# beside the card's kernels and copies, on the same clock. Three classes, by
# what the host does inside: work (render, plan, pack, pack.grouped,
# pack.samples, pack_diff, attach), a kernel launch (launch.<LAUNCHES key>),
# a wait on the stream (upload, fetch, sync).
_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the span "grt." + ``name`` while the profiler
    records, else a shared no-op (one C call)."""
    if _profiling():
        return torch.profiler.record_function("grt." + name)
    return _OFF


def traced(name: str):
    """Decorator form of ``span``: the whole call is the span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
