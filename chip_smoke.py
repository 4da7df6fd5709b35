#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, renders six frames through the
command-line entry point (three with the path tracer, three with the MIS
integrator) and trains through the library entry points (the main paths),
times the kernels, and prints

  * a ``kernels`` JSON line (time, bound, plain-version time, launches on the
    main path, largest difference from the plain version, per kernel),
  * the card's name and power limit as ``nvidia-smi`` gives them,
  * as the last line ``{"ok": true, "device": {...}}``.

It needs a card: without one it exits non-zero and prints no result. Every
failed check raises, so a run that ends in the ``ok`` line passed them all.

Phases
  build   nvcc builds ops/csrc/path_kernels.cu, shade_kernels.cu and
          mis_kernels.cu side by side; registers and spills printed.
  small   128 x 96, 4 spp, 3 bounces, both scenes, both samplers: draws
          kernel bit-equal to its plain version; trace kernel in its three
          modes against the plain version (records equal except a printed
          share, image within tolerance where the records agree); backward
          kernel, draws read and draws regenerated, against its plain
          version (autograd through the replay) on the same records and a
          seeded cotangent, and two launches bit-equal.
  mis     128 x 96, 2 camera rays, 12 MIS samples; box, sphere and glossy
          scenes; Halton and stratified tables; light probes culled and not:
          the MIS kernel against its plain version — both record streams
          field by field, the image where the decisions agree — records-on
          image bit-equal to records-off image, two launches bit-equal.
          Once more with 2,700 samples (a sample table beyond 48 KiB of
          shared memory).
  A, B    ``cli.main([png, "--kernel", "cuda"])`` at the reference's frame,
          800 x 600 x 400 spp x 3 bounces, box scene and sphere scene.
  C       ``--kernel decoupled`` at 512 x 512 x 16 spp x 3 bounces: draws
          kernel + record-emitting trace with the occluder cull.
  D       the training workload at full width: gradients of
          ``render_path_decoupled(scene).mean()`` for every float tensor of
          the box scene at 512 x 512 x 16 spp x 3 bounces, draws and occluder
          mask made once, four chained steps; launches counted per step;
          four more under ``torch.profiler`` for the card's busy share.
  E       ``grad.inverse.inverse_render(fast=True)`` on the sphere scene at
          256 x 256 x 4 spp x 2 bounces, 20 Adam steps from perturbed
          centers, albedo and emission: the loss is finite and falls. The
          fit is then run twice more, warm: for the steady step time, and
          under ``torch.profiler`` for the share of it the card is busy.
  F, G    ``cli.main([png, "--integrator", "mis", "--kernel", "cuda"])`` at
          the reference's variant-A settings, 800 x 600 x 6 camera rays x 300
          MIS samples, box scene and sphere scene; F once more under
          ``torch.profiler`` for the card's busy share.
  H       ``--integrator mis --kernel decoupled`` at 512 x 512 x 6 x 300:
          records on, light probes culled.
  MIS gradients
          ``render_mis_cuda`` on a scene that asks for gradients, 128 x 96:
          the backward (autograd through the eager oracle) in three pixel
          ranges against the whole frame's graph; then one range near the
          default budget, for its time and the memory it holds.
  full    the kernels at the shapes of A to H against their plain versions
          (the MIS kernel's on the whole frame, records and all), and their
          times.

Tolerances. Draws: bit-equal (the radical inverse spells out each rounding).
Records: a share of at most 0.5 % of the decisions may differ — the kernel and
the plain version round alike (no fused multiply-add, IEEE divide and square
root), but sin, cos and a few compiler choices differ by an ulp, which flips a
closest hit or a shadow bit on knife-edge rays. A record is a decision where
its path is alive; the records dead lanes still write feed nothing, and their
share is printed, not limited. Image: atol 2e-5 / rtol 1e-4 (f32 sums over a
few bounces) on the pixels all of whose decisions agree. Backward kernel: per
output group (d normal, d c0, d diffuse, d emissive, camera position and
basis, light center, color, normal) atol 1e-6 + rtol 1e-4 of the group's
largest magnitude — the kernel consumes the same records as the plain version,
so only the order of the f32 sums differs; d center and d radius of the spheres
are held at 5e-3 of their largest magnitude, because their per-lane terms
cancel a few hundred to one and the summation order alone moves them (the
measured value is printed). To each of these limits is added four times the
distance the plain version itself moves when one of its draw planes is changed
by one ulp: a few grazing lanes (a ray almost parallel to a wall, or tangent
to a sphere) carry most of a geometry gradient and amplify the last bit of a
sine or a square root ten-thousandfold, in the plain version as in the kernel;
both the difference and that distance are printed, and beside them how far
the kernel and the plain version each lie from the same function evaluated in
float64. Draws read against draws
regenerated: atol 5e-8 + rtol 1e-6 of the group's largest magnitude, nothing
added. MIS kernel: the same 0.5 % limit on differing decisions (a decision is
the primary hit everywhere, the three sample decisions where the primary ray
landed on a surface, a secondary probe's bit where its lobe ray landed on
geometry); image atol 2e-5 / rtol 1e-4 on the pixels whose decisions all
agree — the kernel and its plain version read the same host-made sample
table and hold no transcendental, so they run the same correctly rounded
operations in the same order — and the largest difference over all pixels is
printed against the integrator's own atol 5e-4 / rtol 1e-3.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gpuraytracer_tpu_torch import cli, image
from gpuraytracer_tpu_torch.grad import inverse
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import (_build, cuda_mis, cuda_path, cuda_shade,
                                        decoupled)
from gpuraytracer_tpu_torch.render import pixel_rng_offsets, render_mis
from gpuraytracer_tpu_torch.sampling import PRIMES
from gpuraytracer_tpu_torch.scene import (cornell_box, cornell_box_glossy,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils.metrics import mrays_per_s, nominal_rays

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores. The bounds below are stated against
# these whatever power limit the card runs at; the limit is printed beside.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FLIP_SHARE_MAX = 0.005
HDR_ATOL, HDR_RTOL = 2e-5, 1e-4

# Float32 operations per primitive test, counted from path_kernels.cu (one
# per multiply, add, divide, compare or select): triangle closest-hit test,
# triangle any-hit test, sphere closest-hit test, sphere any-hit test; and
# the camera ray per sample and the shading of one bounce (hit point, light
# sample, accumulate, cosine bounce; a transcendental counted as one).
OPS_TRI_CLOSEST, OPS_TRI_SHADOW = 49, 46
OPS_SPH_CLOSEST, OPS_SPH_SHADOW = 43, 39
OPS_CAMERA, OPS_SHADE = 30, 130
# Integer and float operations per Halton digit (multiply-shift divide,
# remainder, convert, two multiplies, one add).
OPS_HALTON_DIGIT = 8

# Float32 operations of the backward kernel, counted the same way from
# shade_kernels.cu: one live bounce forward (134) and reversed (255); what a
# sphere hit adds (68 + 116); the camera ray per live sample, forward and
# reversed (29 + 32). Shuffles and adds of the reduction are not counted: they
# are how this kernel sums, not work the function needs.
OPS_BWD_BOUNCE, OPS_BWD_SPHERE, OPS_BWD_CAMERA = 389, 184, 61

GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
SPHERE_GEOMETRY_RTOL = 5e-3
MODES_ATOL, MODES_RTOL = 5e-8, 1e-6
# Added to a gradient limit: this many times the distance the plain version
# moves under a one-ulp change of a draw plane (its own conditioning).
CONDITION_FACTOR = 4.0

SCENES = {"cornell": cornell_box, "cornell-spheres": cornell_box_with_spheres}
FRAME = dict(width=800, height=600, spp=400, bounces=3)   # cli.py defaults
BENCH = dict(width=512, height=512, spp=16, bounces=3)    # training-loop size
SMALL = dict(width=128, height=96, spp=4, bounces=3)
INVERSE = dict(width=256, height=256, spp=4, bounces=2)   # inverse-render size
# Variant A: the reference's own settings, the 512 x 512 training-loop size,
# and the small comparison size.
MIS_FRAME = dict(width=800, height=600, camera_rays=6, mis_samples=300)
MIS_BENCH = dict(width=512, height=512, camera_rays=6, mis_samples=300)
MIS_SMALL = dict(width=128, height=96, camera_rays=2, mis_samples=12)
# A sample table beyond 48 KiB of shared memory; one pixel range of the
# oracle backward.
MIS_LONG = dict(width=32, height=24, camera_rays=1, mis_samples=2700)
MIS_GRAD_RANGE = dict(width=320, height=216, camera_rays=6, mis_samples=15,
                      pixel_chunk=320 * 216)
# Backward in pixel ranges against the whole frame's graph: the same per-pixel
# terms, summed over pixels in another order.
MIS_GRAD_ATOL, MIS_GRAD_RTOL = 1e-5, 1e-4
MIS_SCENES = dict(SCENES, **{"cornell-glossy": cornell_box_glossy})
MIS_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/mis_kernels.cu"
MIS_REPLACES = "gpuraytracer_tpu/ops/pallas_mis.py:217"
MIS_HDR_ATOL, MIS_HDR_RTOL = 5e-4, 1e-3   # the integrator's own tolerance
# Float32 operations of the MIS kernel besides its primitive tests, counted
# from mis_kernels.cu like the counts above: per camera ray (hash jitter, ray,
# basis, the stretched view frame); per sample whose primary ray landed on a
# surface (three directions, seven pdfs, three heuristics, the light sample
# with its BRDF, two lobe BRDFs); per light sample at a bounce point, reached
# (with its BRDF) and blocked.
OPS_MIS_CAMERA, OPS_MIS_SAMPLE = 140, 832
OPS_MIS_SECONDARY, OPS_MIS_SECONDARY_BLOCKED = 182, 36
SHADE_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/shade_kernels.cu"
SHADE_REPLACES = "gpuraytracer_tpu/ops/pallas_shade.py:72"

# The gradient groups that must be non-zero on the box scene.
GRAD_GROUPS = ("light.color", "light.center", "light.normal",
               "triangles.verts", "triangles.diffuse", "triangles.emissive",
               "camera.position", "camera.direction", "camera.up")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, repeats: int = 5, warmup: int = 1):
    """(min, median, max) milliseconds of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), statistics.median(times), max(times)


def device_busy(fn):
    """Run ``fn`` under ``torch.profiler``: (wall ms, ms during which a
    kernel or copy ran on the card, the three names with most device time).
    The busy time is 0.0 where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    by_name = {}
    for event in prof.events():
        if (event.device_type == DeviceType.CUDA
                and not getattr(event, "is_user_annotation", False)):
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return wall_ms, sum(by_name.values()), [(n[:48], ms) for n, ms in top]


# ---------------------------------------------------------------------------
# Kernel inputs and comparisons
# ---------------------------------------------------------------------------

class TraceInputs:
    """What the trace wrapper and its plain version take, on the card."""

    def __init__(self, scene_name: str, cfg: RenderConfig, cull: bool,
                 device="cuda"):
        dev = torch.device(device)
        self.cfg = cfg
        self.scene = SCENES[scene_name](resolution=cfg.resolution)
        self.packed = cuda_path._pack_inputs(self.scene.to(dev), cfg)
        self.offsets = pixel_rng_offsets(cfg, dev)
        self.offsets_i32 = self.offsets.to(torch.int32).contiguous()
        self.num_tris = self.scene.triangles.num_triangles
        occ = potential_occluders(self.scene, cfg) if cull else None
        self.shadow_idx = cuda_path.shadow_indices(occ, self.num_tris, dev)

    def kernel(self, draws=None, emit=False):
        return cuda_path.path_trace_kernel(
            self.offsets_i32, 0, self.packed, self.shadow_idx, draws,
            self.cfg, emit)

    def plain(self, draws=None, emit=False, whole_frame=False):
        cfg = (self.cfg.replace(pixel_chunk=self.cfg.num_pixels)
               if whole_frame else self.cfg)
        return cuda_path.render_path_plain(
            self.offsets, 0, self.packed, self.shadow_idx, draws, cfg, emit)


def compare_trace(what, hdr_k, rec_k, hdr_p, rec_p, packed):
    """Flip-aware comparison of a trace with the plain version's. A record
    counts where it is a decision: the winner on every lane whose path is
    alive, the shadow bit on every shaded lane (``live_lanes``). Returns
    (share of decisions that differ, largest image difference on the pixels
    all of whose decisions agree); the share over all records, dead lanes
    included, is printed beside it."""
    alive, shaded = live_lanes(rec_p, packed)
    mask = cuda_path.OCC_BIT - 1
    differ = (((rec_k & mask) != (rec_p & mask)) & alive) | (
        (rec_k != rec_p) & shaded)
    flip_share = differ.float().mean().item()
    raw_share = (rec_k != rec_p).float().mean().item()
    agree = ~differ.any(dim=0).any(dim=0)          # [n] pixels
    diff = (hdr_k - hdr_p).abs()[:, agree]
    bound = HDR_ATOL + HDR_RTOL * hdr_p.abs()[:, agree]
    max_err = diff.max().item() if diff.numel() else 0.0
    log(f"  {what}: decisions differ {flip_share:.3e} of {rec_k.numel()} "
        f"records (all records, dead lanes too: {raw_share:.3e}), pixels "
        f"compared {int(agree.sum())}/{agree.numel()}, max |hdr - plain| "
        f"{max_err:.3e}")
    check(flip_share <= FLIP_SHARE_MAX,
          f"{what}: {flip_share:.4%} of the decisions differ from the plain "
          f"version (limit {FLIP_SHARE_MAX:.2%})")
    check(bool((diff <= bound).all()),
          f"{what}: image differs from the plain version beyond atol "
          f"{HDR_ATOL} / rtol {HDR_RTOL} on pixels whose decisions agree "
          f"(max {max_err:.3e})")
    check(bool(torch.isfinite(hdr_k).all()), f"{what}: non-finite radiance")
    return flip_share, max_err


def compare_draws(what, got, ref):
    worst = 0.0
    for name, g, r in zip(("nee_u0", "nee_u1", "cos_u0", "cos_u1",
                           "jitter_x", "jitter_y"), got, ref):
        check(g.shape == r.shape and g.dtype == r.dtype, f"{what}: {name} "
              f"shape/dtype {tuple(g.shape)} {g.dtype}")
        worst = max(worst, (g - r).abs().max().item())
        check(torch.equal(g, r), f"{what}: {name} is not bit-equal to the "
              "plain version")
    log(f"  {what}: six planes bit-equal to the plain version")
    return worst


def reset_launches() -> None:
    for counts in (cuda_path.LAUNCHES, cuda_shade.LAUNCHES,
                   cuda_mis.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    return {**cuda_path.LAUNCHES, **cuda_shade.LAUNCHES,
            **cuda_mis.LAUNCHES}


class ShadeInputs:
    """What the backward wrapper and its plain version take, on the card: the
    records of a trace of ``scene_name`` (draws read, occluder cull), the
    draws, the parameter views, and a cotangent from a seeded generator,
    divided by spp as the autograd glue hands it over."""

    def __init__(self, scene_name: str, cfg: RenderConfig):
        self.cfg = cfg
        self.trace = TraceInputs(scene_name, cfg, cull=True)
        self.draws = cuda_path.pregen_draws_kernel(self.trace.offsets_i32,
                                                   cfg)
        _, self.records = self.trace.kernel(self.draws, emit=True)
        views = cuda_shade._pack_diff_inputs(self.trace.scene.to("cuda"), cfg)
        self.table, self.cam, self.light = (v.contiguous() for v in views)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        self.g = torch.randn((3, cfg.num_pixels), generator=gen,
                             device="cuda") / cfg.spp

    def _args(self, regenerate):
        return (self.g, self.records, None if regenerate else self.draws,
                self.trace.offsets_i32 if regenerate else None, self.table,
                self.cam, self.light, self.cfg)

    def kernel(self, regenerate=False):
        return cuda_shade.shade_bwd_kernel(*self._args(regenerate))

    def plain(self, nudge=False):
        """The plain version; with ``nudge`` on draws of which one plane is
        one ulp off, to measure how well conditioned the sums are."""
        args = list(self._args(False))
        if nudge:
            args[2] = nudged_draws(self.draws)
        return cuda_shade.shade_bwd_plain(*args)

    def exact(self):
        """The same function evaluated in float64 on the same float32
        inputs: what the kernel and the plain version both approximate."""
        views = [v.double().requires_grad_(True)
                 for v in (self.table, self.cam, self.light)]
        lum = cuda_shade.replay_packed(*views, self.records, self.draws,
                                       self.cfg)
        d_table, d_cam, d_light = torch.autograd.grad(
            (self.g.double() * lum).sum(), views)
        rows = [r for r in range(d_table.shape[0])
                if r not in (10, 15)]  # the selector rows have no cotangent
        return d_table[rows].T.contiguous(), torch.cat([d_cam, d_light])


def nudged_draws(draws):
    """The draw planes with the cosine bounce's angle draw one ulp up."""
    draws = list(draws)
    draws[2] = torch.nextafter(draws[2], torch.ones_like(draws[2]))
    return tuple(draws)


def grad_groups(dtab, dscal):
    """The backward's outputs by what they are the cotangent of."""
    groups = {"d normal": dtab[:, 0:3], "d c0": dtab[:, 3:4],
              "d diffuse": dtab[:, 4:7], "d emissive": dtab[:, 7:10]}
    if dtab.shape[1] == cuda_shade.NTAB_SPH:
        groups["d center"] = dtab[:, 10:13]
        groups["d radius"] = dtab[:, 13:14]
    for k, name in enumerate(("camera position", "camera u", "camera v",
                              "camera w", "light center", "light color",
                              "light normal")):
        groups[name] = dscal[3 * k:3 * k + 3]
    return groups


def compare_groups(what, got, ref, atol, rtol, sphere_rtol, nudged=None):
    """Each group of ``got`` within atol + rtol * (the group's largest
    magnitude in ``ref``), ``sphere_rtol`` for the sphere geometry, plus
    CONDITION_FACTOR times the distance from ``ref`` to ``nudged`` (the
    reference on inputs one ulp off) where that is given. Returns the
    largest absolute difference."""
    worst, parts = 0.0, []
    for name, r in ref.items():
        k = got[name]
        check(k.shape == r.shape, f"{what}: {name} shape {tuple(k.shape)}")
        check(bool(torch.isfinite(k).all()), f"{what}: {name} is not finite")
        scale = r.abs().max().item()
        err = (k - r).abs().max().item()
        limit = atol + (sphere_rtol if name in ("d center", "d radius",
                                                "spheres.center",
                                                "spheres.radius")
                        else rtol) * scale
        part = f"{name} {err / scale if scale else err:.1e}"
        if nudged is not None:
            moved = (nudged[name] - r).abs().max().item()
            limit += CONDITION_FACTOR * moved
            part += f" ({moved / scale if scale else moved:.1e})"
        parts.append(part)
        check(err <= limit, f"{what}: {name} differs by {err:.3e} "
              f"(largest magnitude {scale:.3e}, limit {limit:.3e})")
        worst = max(worst, err)
    log(f"  {what}: largest difference over largest magnitude"
        + (" (and how far one ulp in a draw moves the reference)"
           if nudged is not None else "") + ": " + ", ".join(parts))
    return worst


def report_rounding(what, kernel, plain, exact):
    """Print, per group, how far the kernel and the plain version each lie
    from the float64 evaluation, over the group's largest magnitude: where
    both are equally far, their difference is float32 rounding of an
    ill-conditioned sum, not a fault of either."""
    k, p, e = (grad_groups(*x) for x in (kernel, plain, exact))
    parts = []
    for name, r in e.items():
        scale = r.abs().max().item() or 1.0
        parts.append(f"{name} {(k[name] - r).abs().max().item() / scale:.1e}"
                     f" / {(p[name] - r).abs().max().item() / scale:.1e}")
    log(f"  {what}: distance from the float64 evaluation, kernel / plain: "
        + ", ".join(parts))


def compare_grads(what, got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                  sphere_rtol=SPHERE_GEOMETRY_RTOL, nudged=None):
    return compare_groups(what, grad_groups(*got), grad_groups(*ref), atol,
                          rtol, sphere_rtol,
                          None if nudged is None else grad_groups(*nudged))


def with_grad(scene):
    """``scene`` on the card, every float tensor a leaf that asks for a
    gradient."""
    return scene.to("cuda").map(
        lambda t: t.detach().clone().requires_grad_(t.is_floating_point()))


def scene_grads(scene, hdr):
    """Gradients of ``hdr.mean()`` by the scene's float tensors, by name;
    tensors the image does not depend on are left out."""
    named = [(f"{part.name}.{f.name}", getattr(getattr(scene, part.name),
                                               f.name))
             for part in dataclasses.fields(scene)
             for f in dataclasses.fields(getattr(scene, part.name))]
    named = [(name, t) for name, t in named if t.requires_grad]
    grads = torch.autograd.grad(hdr.mean(), [t for _, t in named],
                                allow_unused=True)
    return {name: g for (name, _), g in zip(named, grads) if g is not None}


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def halton_digits(base: int, max_index: int) -> int:
    return max(1, math.ceil(math.log(max_index + 1, base)))


def halton_ops(cfg: RenderConfig, n: int) -> int:
    """Operations of one frame's radical inverses: the jitter pair and four
    draws per bounce, per (pixel, sample), at indices below 2^20 + spp."""
    dims = [0, 1] + [2 + 5 * b + k for b in range(cfg.bounces)
                     for k in range(4)]
    digits = sum(halton_digits(PRIMES[d], (1 << 20) + cfg.spp) for d in dims)
    return OPS_HALTON_DIGIT * digits * cfg.spp * n


def roofline(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def draws_bound(cfg: RenderConfig, n: int):
    """Bound of the draws kernel: each offset read once, each draw written
    once, against the digit arithmetic of the radical inverses."""
    nbytes = 4 * n + 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    return roofline(nbytes, halton_ops(cfg, n))


def live_lanes(records, packed):
    """From a record stream [spp, bounces, n]: ``alive`` marks the (sample,
    bounce, pixel) iterations that start with a live path (closest-hit
    runs), ``shaded`` those of them that land on a non-emissive surface
    (shading and the shadow probe run). A path dies at a miss or at an
    emissive hit; dead lanes still write records."""
    prim = (records & (cuda_path.OCC_BIT - 1)).long()
    is_em = packed.atab[9] > 0.5
    alive = torch.ones_like(prim, dtype=torch.bool)
    shaded = torch.zeros_like(alive)
    for b in range(prim.shape[1]):
        if b:
            alive[:, b] = shaded[:, b - 1]
        hit = prim[:, b] > 0
        shaded[:, b] = (alive[:, b] & hit
                        & ~is_em[(prim[:, b] - 1).clamp_min(0)])
    return alive, shaded


def check_same_decisions(what, rec_a, rec_b, packed):
    """Two record streams of one frame, traced with and without the
    occluder cull, hold the same winners everywhere and the same shadow
    bits on every shaded lane. (On a dead lane the probe starts on the
    surface it last left, where a culled triangle may graze it: that bit
    feeds nothing.)"""
    mask = cuda_path.OCC_BIT - 1
    check(torch.equal(rec_a & mask, rec_b & mask),
          f"{what}: winners differ")
    _, shaded = live_lanes(rec_a, packed)
    check(torch.equal(rec_a[shaded], rec_b[shaded]),
          f"{what}: shadow bits differ on shaded lanes")


def trace_bound(inp: TraceInputs, closest_iters, shade_iters, emit,
                reads_draws):
    """(bound_ms, bound_by) of one trace: the primitive tests and shading
    that this frame's paths need, against the bytes in and out."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    t, s, n_shadow = inp.num_tris, inp.packed.num_spheres, len(inp.shadow_idx)
    ops = (closest_iters * (t * OPS_TRI_CLOSEST + s * OPS_SPH_CLOSEST)
           + shade_iters * (n_shadow * OPS_TRI_SHADOW + s * OPS_SPH_SHADOW
                            + OPS_SHADE)
           + cfg.spp * n * OPS_CAMERA)
    if not reads_draws:  # the draws are radical-inversed in the loop
        ops += halton_ops(cfg, n)
    tables = 4 * (inp.packed.tri.numel() + inp.packed.sph.numel()
                  + inp.packed.atab.numel() + 18 + n_shadow)
    nbytes = 4 * n + 12 * n + tables
    if emit:
        nbytes += 4 * cfg.spp * cfg.bounces * n
    if reads_draws:
        nbytes += 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    return roofline(nbytes, ops)


def shade_bound(sh: ShadeInputs, regenerate: bool):
    """(bound_ms, bound_by) of one backward: every input read once (records,
    cotangent, the draws or the offsets, the views), the outputs written
    once, against the arithmetic of the live lanes of these records — a lane
    is live at a bounce when its path is alive and hit something. Regenerated
    draws count their radical inverses in the live share of the frame."""
    cfg, n = sh.cfg, sh.cfg.num_pixels
    alive, _ = live_lanes(sh.records, sh.trace.packed)
    prim = sh.records & (cuda_path.OCC_BIT - 1)
    active = alive & (prim > 0)
    iters = int(active.sum())
    sphere_iters = int((active & (prim > sh.trace.num_tris)).sum())
    live_samples = int(active[:, 0].sum())
    ops = (iters * OPS_BWD_BOUNCE + sphere_iters * OPS_BWD_SPHERE
           + live_samples * OPS_BWD_CAMERA)
    ntab = (cuda_shade.NTAB_SPH if sh.table.shape[0] == cuda_shade.NROWS_TAB_SPH
            else cuda_shade.NTAB)
    outputs = sh.table.shape[1] * ntab + cuda_shade.NSCAL
    nbytes = (4 * sh.records.numel() + 12 * n + 4 * outputs
              + 4 * (sh.table.numel() + cuda_shade.NSCAL))
    if regenerate:
        nbytes += 4 * n
        ops += int(halton_ops(cfg, n) * iters / active.numel())
    else:
        nbytes += 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    return roofline(nbytes, ops), iters


# ---------------------------------------------------------------------------
# The MIS kernel: inputs, comparison, bound
# ---------------------------------------------------------------------------

class MisInputs:
    """What the MIS wrapper and its plain version take, on the card."""

    def __init__(self, scene_name: str, cfg: RenderConfig, cull: bool):
        dev = torch.device("cuda")
        self.cfg = cfg
        self.scene = MIS_SCENES[scene_name](resolution=cfg.resolution)
        self.packed = cuda_mis._pack_inputs(self.scene.to(dev), cfg)
        self.num_tris = self.scene.triangles.num_triangles
        occ = potential_occluders(self.scene, cfg) if cull else None
        self.shadow_idx = cuda_path.shadow_indices(occ, self.num_tris, dev)

    def kernel(self, emit=False):
        return cuda_mis.mis_trace_kernel(
            self.cfg.num_pixels, 0, self.packed, self.shadow_idx, self.cfg,
            emit)

    def plain(self, emit=False, pixel_chunk=None):
        cfg = (self.cfg if pixel_chunk is None
               else self.cfg.replace(pixel_chunk=pixel_chunk))
        return cuda_mis.render_mis_plain(
            cfg.num_pixels, 0, self.packed, self.shadow_idx, cfg, emit)


def mis_fields(rec: cuda_mis.MisRecords):
    """The sample record's five decisions: three probe bits and the two lobe
    rays' winners (prim + 1, 0 = miss)."""
    r = rec.samples
    mask = cuda_mis.REC_CODE_MASK
    return dict(reach1=(r & 1) != 0, reach2=(r & 2) != 0, reach3=(r & 4) != 0,
                cos_prim=(r >> cuda_mis.REC_SHIFT_C) & mask,
                vndf_prim=(r >> cuda_mis.REC_SHIFT_V) & mask)


def mis_live(rec: cuda_mis.MisRecords, packed):
    """Where each decision of a record stream feeds the image: the primary
    hit everywhere; the light probe and the two lobe winners where the
    primary ray landed on a non-emissive surface (``surf`` [rays, 1, n]); a
    secondary probe where, besides, its lobe ray landed on non-emissive
    geometry. Dead lanes write records too; they feed nothing."""
    is_em = packed.atab[8] > 0.5

    def on_geometry(code):
        return (code > 0) & ~is_em[(code.long() - 1).clamp_min(0)]

    f = mis_fields(rec)
    surf = on_geometry(rec.camera)[:, None, :]
    return surf, dict(reach1=surf, cos_prim=surf, vndf_prim=surf,
                      reach2=surf & on_geometry(f["cos_prim"]),
                      reach3=surf & on_geometry(f["vndf_prim"]))


def compare_mis(what, hdr_k, rec_k, hdr_p, rec_p, packed):
    """Flip-aware comparison of an MIS trace with the plain version's, field
    by field. Returns (share of live decisions that differ, largest image
    difference on the pixels all of whose decisions agree)."""
    surf, live = mis_live(rec_p, packed)
    cam_differ = rec_k.camera != rec_p.camera
    fk, fp = mis_fields(rec_k), mis_fields(rec_p)
    n_live = cam_differ.numel()
    n_differ = int(cam_differ.sum())
    bad_pixel = cam_differ.any(dim=0)
    parts = [f"camera {n_differ}/{n_live}"]
    for name, where in live.items():
        where = where.expand_as(fk[name])
        differ = (fk[name] != fp[name]) & where
        n_live += int(where.sum())
        n_differ += int(differ.sum())
        bad_pixel |= differ.any(dim=0).any(dim=0)
        parts.append(f"{name} {int(differ.sum())}/{int(where.sum())}")
    flip_share = n_differ / n_live
    raw_share = (rec_k.samples != rec_p.samples).float().mean().item()
    agree = ~bad_pixel
    diff_all = (hdr_k - hdr_p).abs()
    loose = MIS_HDR_ATOL + MIS_HDR_RTOL * hdr_p.abs()
    diff = diff_all[:, agree]
    bound = HDR_ATOL + HDR_RTOL * hdr_p.abs()[:, agree]
    max_err = diff.max().item() if diff.numel() else 0.0
    log(f"  {what}: live decisions differ {flip_share:.3e} ("
        + ", ".join(parts) + f"; all sample records, dead lanes too: "
        f"{raw_share:.3e}); pixels compared {int(agree.sum())}/"
        f"{agree.numel()}, max |hdr - plain| there {max_err:.3e}, over all "
        f"pixels {diff_all.max().item():.3e} ({int((diff_all > loose).sum())}"
        f" values beyond atol {MIS_HDR_ATOL} / rtol {MIS_HDR_RTOL})")
    check(flip_share <= FLIP_SHARE_MAX,
          f"{what}: {flip_share:.4%} of the decisions differ from the plain "
          f"version (limit {FLIP_SHARE_MAX:.2%})")
    check(bool((diff <= bound).all()),
          f"{what}: image differs from the plain version beyond atol "
          f"{HDR_ATOL} / rtol {HDR_RTOL} on pixels whose decisions agree "
          f"(max {max_err:.3e})")
    check(bool(torch.isfinite(hdr_k).all()), f"{what}: non-finite radiance")
    return flip_share, max_err


def mis_bound(inp: MisInputs, rec: cuda_mis.MisRecords, emit: bool):
    """(bound_ms, bound_by, counts) of one MIS trace from the records of
    this frame: the primitive tests its rays need — a closest hit tests
    every primitive, a probe that reaches the light every occluder, a
    blocked probe at least one — and the shading of its live samples,
    against the bytes in and out. Only live lanes count, with records as
    without: a lane whose primary ray missed or landed on the light still
    writes records, but nothing reads them (``mis_live``), so the function
    needs none of its traversals; ``emit`` adds the records' bytes alone."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    t, s, n_shadow = inp.num_tris, inp.packed.num_spheres, len(inp.shadow_idx)
    s_per = cfg.mis_samples // 3
    closest = t * OPS_TRI_CLOSEST + s * OPS_SPH_CLOSEST
    probe = n_shadow * OPS_TRI_SHADOW + s * OPS_SPH_SHADOW
    rays = cfg.camera_rays * n
    f = mis_fields(rec)
    surf, live = mis_live(rec, inp.packed)
    samples = int(surf.sum()) * s_per
    ops = rays * (closest + OPS_MIS_CAMERA)
    ops += samples * (2 * closest + OPS_MIS_SAMPLE)
    probes = dict(reached=0, blocked=0)
    for name in ("reach1", "reach2", "reach3"):
        where = live[name].expand_as(f[name])
        reached = int((f[name] & where).sum())
        blocked = int(where.sum()) - reached
        probes["reached"] += reached
        probes["blocked"] += blocked
        ops += reached * probe + blocked * OPS_TRI_SHADOW
        if name != "reach1":
            ops += (reached * OPS_MIS_SECONDARY
                    + blocked * OPS_MIS_SECONDARY_BLOCKED)
    tables = 4 * sum(x.numel() for x in inp.packed[:6]) + 4 * n_shadow
    nbytes = 12 * n + tables
    if emit:
        nbytes += 4 * rays * (1 + s_per)
    bound, by = roofline(nbytes, ops)
    counts = dict(live_samples=samples, probes_reached=probes["reached"],
                  probes_blocked=probes["blocked"],
                  traversals=rays + 2 * samples + sum(probes.values()))
    return bound, by, counts


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def ptxas_resources(log_text: str):
    """Registers, stack and spill bytes per kernel from ``-Xptxas -v``."""
    resources, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = ("reduce_partials_kernel"
                    if "reduce_partials_kernel" in mangled else "draws_kernel")
            m = re.search(r"mis_kernelILb(\d)E", mangled)
            if m:
                name = f"mis_kernel<EMIT={m.group(1)}>"
            m = re.search(r"path_kernelILb(\d)ELb(\d)E", mangled)
            if m:
                name = (f"path_kernel<EMIT={m.group(1)}, "
                        f"READ_DRAWS={m.group(2)}>")
            m = re.search(r"shade_bwd_kernelILb(\d)ELb(\d)E", mangled)
            if m:
                name = (f"shade_bwd_kernel<SPH={m.group(1)}, "
                        f"RNG={m.group(2)}>")
            resources[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and "stack_bytes" not in resources[name]:
            # The entry's own line comes first; the lines of the device
            # functions it calls follow and are not the kernel's.
            resources[name].update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            resources[name]["registers"] = int(m.group(1))
    return resources


def phase_build():
    log("== build")
    libs = _build.load_libraries()
    built = libs[0]
    version = subprocess.run([built.nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    log("  " + version.splitlines()[-2] + " | " + version.splitlines()[-1])
    log(f"  nvcc {' '.join(_build.NVCC_FLAGS)}")
    for lib in libs:
        log(f"  built {lib.path.name} in {lib.seconds:.1f} s")
    logs = "\n".join(lib.log for lib in libs)
    resources = ptxas_resources(logs)
    for name, res in resources.items():
        log(f"  ptxas: {name}: {res['registers']} registers, "
            f"{res['stack_bytes']} B stack, {res['spill_store_bytes']} B "
            f"spill stores, {res['spill_load_bytes']} B spill loads")
    check(len(resources) == 11, "ptxas did not report the draws kernel, the "
          "three trace-kernel instantiations, the four backward-kernel "
          "instantiations, the reduction and the two MIS-kernel "
          f"instantiations: {resources}\n{logs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  card: {smi}")
    return resources, smi


def check_glue(tag, sh: ShadeInputs):
    """The differentiable entry point end to end at the small size: the
    gradients ``render_path_decoupled`` gives every scene tensor (trace
    kernel, backward kernel, autograd chain through the packing) against
    autograd through ``shade_replay`` on records of the same trace. Both
    hold the same decisions, so the tolerance is the backward kernel's."""
    cfg = sh.cfg
    scene = with_grad(sh.trace.scene)
    hdr = decoupled.render_path_decoupled(scene, cfg)
    got = scene_grads(scene, hdr)
    ref_scene = with_grad(sh.trace.scene)
    hdr_t, aux = decoupled.trace_records(ref_scene.detach(), cfg)
    check(torch.equal(hdr, hdr_t), f"glue {tag}: the differentiable path's "
          "image is not the trace kernel's")
    ref = scene_grads(ref_scene, decoupled.shade_replay(ref_scene, aux, cfg))
    off = aux._replace(cos_u0=nudged_draws(aux[1:])[2])
    nudged = scene_grads(ref_scene,
                         decoupled.shade_replay(ref_scene, off, cfg))
    check(sorted(got) == sorted(ref), f"glue {tag}: gradients for "
          f"{sorted(got)}, expected {sorted(ref)}")
    compare_groups(f"glue {tag} scene gradients", got, ref, GRAD_ATOL,
                   GRAD_RTOL, SPHERE_GEOMETRY_RTOL, nudged)


def phase_small():
    log("== small: kernels against their plain versions, 128 x 96 x 4 spp "
        "x 3 bounces")
    plain_ms = {}
    for scene_name in SCENES:
        for sampler in ("halton", "stratified"):
            cfg = RenderConfig(sampler=sampler, **SMALL)
            tag = f"{scene_name}/{sampler}"
            inp = TraceInputs(scene_name, cfg, cull=True)
            full = TraceInputs(scene_name, cfg, cull=False)

            draws_k = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
            draws_p = cuda_path.pregen_draws_plain(inp.offsets, cfg)
            compare_draws(f"K1 {tag}", draws_k, draws_p)

            hdr_h, none = full.kernel()
            hdr_e, rec_e = inp.kernel(draws_k, emit=True)
            hdr_r, rec_r = full.kernel(emit=True)
            torch.cuda.synchronize()
            check(none is None, "hdr mode returned records")
            check(torch.equal(hdr_h, hdr_e) and torch.equal(hdr_h, hdr_r),
                  f"K2 {tag}: the three modes do not give the same image")
            check_same_decisions(f"K2 {tag}: read draws + cull vs "
                                 "regenerated draws, no cull", rec_e, rec_r,
                                 inp.packed)
            hdr_p, rec_p = inp.plain(draws_p, emit=True)
            compare_trace(f"K2 {tag} emit+draws+cull", hdr_e, rec_e,
                          hdr_p, rec_p, inp.packed)
            hdr_q, rec_q = full.plain(emit=True)
            compare_trace(f"K2 {tag} records_only", hdr_r, rec_r,
                          hdr_q, rec_q, inp.packed)

            sh = ShadeInputs(scene_name, cfg)
            k_read, k_again = sh.kernel(), sh.kernel()
            k_regen = sh.kernel(regenerate=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k_read, k_again)),
                  f"K3 {tag}: two launches on the same inputs differ")
            ref, nudged = sh.plain(), sh.plain(nudge=True)
            compare_grads(f"K3 {tag} draws read", k_read, ref, nudged=nudged)
            report_rounding(f"K3 {tag}", k_read, ref, sh.exact())
            compare_grads(f"K3 {tag} draws regenerated", k_regen, ref,
                          nudged=nudged)
            compare_grads(f"K3 {tag} regenerated vs read", k_regen, k_read,
                          MODES_ATOL, MODES_RTOL, MODES_RTOL)
            check_glue(tag, sh)
            if tag == "cornell/halton":
                plain_ms["bwd"] = time_ms(sh.plain, repeats=5)
                plain_ms["k_bwd"] = time_ms(sh.kernel, repeats=5)
                plain_ms["draws"] = time_ms(
                    lambda: cuda_path.pregen_draws_plain(inp.offsets, cfg),
                    repeats=5)
                plain_ms["hdr"] = time_ms(lambda: full.plain(), repeats=5)
                plain_ms["emit"] = time_ms(
                    lambda: inp.plain(draws_p, emit=True), repeats=5)
                plain_ms["k_draws"] = time_ms(
                    lambda: cuda_path.pregen_draws_kernel(inp.offsets_i32,
                                                          cfg), repeats=5)
                plain_ms["k_hdr"] = time_ms(lambda: full.kernel(), repeats=5)
                plain_ms["k_emit"] = time_ms(
                    lambda: inp.kernel(draws_k, emit=True), repeats=5)
    for key in ("draws", "hdr", "emit", "bwd"):
        log(f"  128 x 96 x 4 spp, cornell: {key}: plain "
            f"{plain_ms[key][1]:.3f} ms, kernel "
            f"{plain_ms['k_' + key][1]:.3f} ms (median of 5)")
    return plain_ms


def phase_mis_small():
    cfg0 = RenderConfig(integrator="mis", **MIS_SMALL)
    log(f"== mis: the MIS kernel against its plain version, {cfg0.width} x "
        f"{cfg0.height}, {cfg0.camera_rays} camera rays, {cfg0.mis_samples} "
        "MIS samples")
    times = {}
    for scene_name in MIS_SCENES:
        for sampler in ("halton", "stratified"):
            cfg = cfg0.replace(sampler=sampler)
            tag = f"{scene_name}/{sampler}"
            full = MisInputs(scene_name, cfg, cull=False)
            culled = MisInputs(scene_name, cfg, cull=True)
            check(len(culled.shadow_idx) < len(full.shadow_idx),
                  f"K4 {tag}: the occluder cull kept every triangle")
            hdr_h, none = full.kernel()
            hdr_e, rec_e = full.kernel(emit=True)
            hdr_again, rec_again = full.kernel(emit=True)
            hdr_c, rec_c = culled.kernel(emit=True)
            torch.cuda.synchronize()
            check(none is None, "hdr mode returned records")
            check(torch.equal(hdr_h, hdr_e), f"K4 {tag}: the image with "
                  "records on is not bit-equal to the image with records off")
            check(torch.equal(hdr_e, hdr_again)
                  and torch.equal(rec_e.camera, rec_again.camera)
                  and torch.equal(rec_e.samples, rec_again.samples),
                  f"K4 {tag}: two launches on the same inputs differ")
            hdr_p, rec_p = full.plain(emit=True)
            compare_mis(f"K4 {tag}", hdr_e, rec_e, hdr_p, rec_p, full.packed)
            hdr_q, rec_q = culled.plain(emit=True)
            compare_mis(f"K4 {tag} culled probes", hdr_c, rec_c, hdr_q,
                        rec_q, full.packed)
            # The cull changes no decision that feeds the image.
            compare_mis(f"K4 {tag} culled vs all probes (kernel)", hdr_c,
                        rec_c, hdr_e, rec_e, full.packed)
            check(torch.allclose(hdr_c, hdr_e, atol=5e-8, rtol=1e-6),
                  f"K4 {tag}: the occluder cull changes the image")
            if tag == "cornell/halton":
                times["mis_plain"] = time_ms(lambda: full.plain(), repeats=3)
                times["mis_kernel"] = time_ms(lambda: full.kernel())
                times["mis_kernel_records"] = time_ms(
                    lambda: full.kernel(emit=True))
    log(f"  {cfg0.width} x {cfg0.height} x {cfg0.camera_rays} x "
        f"{cfg0.mis_samples}, cornell: plain {times['mis_plain'][1]:.1f} ms, "
        f"kernel {times['mis_kernel'][1]:.3f} ms, with records "
        f"{times['mis_kernel_records'][1]:.3f} ms")

    # A sample table longer than the 48 KiB of shared memory every launch
    # may have: the launcher asks for the larger size.
    cfg = RenderConfig(integrator="mis", **MIS_LONG)
    long = MisInputs("cornell-spheres", cfg, cull=True)
    staged = 4 * cuda_mis.NTAB_EXT * (cfg.mis_samples // 3)
    check(staged > 48 * 1024, "the long sample table fits the default size")
    hdr_h, _ = long.kernel()
    hdr_k, rec_k = long.kernel(emit=True)
    check(torch.equal(hdr_h, hdr_k), "K4, long sample table: records on and "
          "off give different images")
    hdr_p, rec_p = long.plain(emit=True)
    compare_mis(f"K4 {cfg.width} x {cfg.height} x {cfg.camera_rays} x "
                f"{cfg.mis_samples} ({staged} B of sample table)", hdr_k,
                rec_k, hdr_p, rec_p, long.packed)
    return times


def phase_mis_grad():
    """``render_mis_cuda`` on a scene that asks for gradients, on the card:
    the kernel's image forward, the oracle's gradients backward, one pixel
    range at a time — against autograd through the whole frame of the eager
    oracle; then the memory and time of one full range of the backward."""
    cfg = RenderConfig(integrator="mis", **MIS_SMALL)
    steps = cfg.camera_rays * (cfg.mis_samples // 3)
    log(f"== MIS gradients: render_mis_cuda(scene).mean() on the card, glossy "
        f"box, {cfg.width} x {cfg.height} x {cfg.camera_rays} x "
        f"{cfg.mis_samples}")
    budget = cuda_mis.BACKWARD_LANE_STEPS
    weight = torch.rand((cfg.height, cfg.width, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
    try:
        # Room for 5,000 of the 12,288 pixels: three ranges.
        cuda_mis.BACKWARD_LANE_STEPS = 5000 * steps
        scene = with_grad(cornell_box_glossy(resolution=cfg.resolution))
        reset_launches()
        hdr = cuda_mis.render_mis_cuda(scene, cfg)
        got = scene_grads(scene, hdr * weight)
        launched = read_launches()
    finally:
        cuda_mis.BACKWARD_LANE_STEPS = budget
    check(launched["mis_kernel"] == 1,
          f"render_mis_cuda with gradients launched {launched}")
    ref_scene = with_grad(cornell_box_glossy(resolution=cfg.resolution))
    ref = scene_grads(ref_scene, render_mis(ref_scene, cfg).hdr * weight)
    check(set(got) == set(ref) and len(ref) >= 12,
          f"gradient groups {sorted(got)} against {sorted(ref)}")
    worst = 0.0
    for name, r in ref.items():
        scale = max(r.abs().max().item(), 1.0)
        err = (got[name] - r).abs().max().item() / scale
        worst = max(worst, err)
        check(bool(torch.isfinite(got[name]).all()), f"{name}: not finite")
        check(bool(torch.allclose(got[name], r, atol=MIS_GRAD_ATOL * scale,
                                  rtol=MIS_GRAD_RTOL)),
              f"d {name}: in pixel ranges differs from the whole frame by "
              f"{err:.3e} of its largest magnitude")
    log(f"  {len(ref)} gradient groups, three pixel ranges against the whole "
        f"frame's graph: largest difference {worst:.3e} of a group's largest "
        f"magnitude (atol {MIS_GRAD_ATOL} of it, rtol {MIS_GRAD_RTOL})")

    # One range of the backward near the default budget, at the reference's
    # scene: what the graph of that many sample steps takes.
    cfg = RenderConfig(integrator="mis", **MIS_GRAD_RANGE)
    lane_steps = cfg.num_pixels * cfg.camera_rays * (cfg.mis_samples // 3)
    check(lane_steps <= budget, "the timed backward is more than one range")
    scene = with_grad(cornell_box(resolution=cfg.resolution))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    grads = scene_grads(scene, cuda_mis.render_mis_cuda(scene, cfg))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    held = torch.cuda.max_memory_allocated() - before
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "non-finite gradient")
    log(f"  one range, {cfg.width} x {cfg.height} x {cfg.camera_rays} x "
        f"{cfg.mis_samples} = {lane_steps} sample steps of the budget's "
        f"{budget}: {seconds:.2f} s forward and backward, {held / 2**30:.2f} "
        f"GiB held at the peak, {held / lane_steps:.0f} B per sample step")
    return dict(lane_steps=lane_steps, seconds=seconds, peak_bytes=held,
                budget_lane_steps=budget, max_rel_err_vs_whole_frame=worst)


def check_frame(png_path, debug_path, cfg):
    """The frame is a Cornell box: right shape, finite rows, red left wall,
    green right wall, the light's rows brightest."""
    rgb = image.read_png(png_path).astype(np.float64)
    check(rgb.shape == (cfg.height, cfg.width, 3), f"PNG shape {rgb.shape}")
    # Back to linear radiance (image.tonemap: exposure 2, Reinhard, gamma
    # 2.2): the tone curve compresses the ratios between channels.
    v = np.clip(rgb / 255.0, 0.0, 0.999) ** 2.2
    rgb = v / (1.0 - v) / 2.0
    rows = np.loadtxt(debug_path)
    check(rows.shape == (cfg.height, 3), f"debug rows {rows.shape}")
    check(bool(np.isfinite(rows).all()), "non-finite row means")
    h, w = cfg.height, cfg.width
    band = slice(int(0.35 * h), int(0.65 * h))
    # The side walls as the camera sees them: between the image border and
    # the back wall, which spans the middle half of the frame.
    left = rgb[band, int(0.08 * w):int(0.18 * w)].mean(axis=(0, 1))
    right = rgb[band, int(0.80 * w):int(0.90 * w)].mean(axis=(0, 1))
    check(left[0] > 2.0 * left[1] and left[0] > 2.0 * left[2],
          f"left wall is not red: {left}")
    check(right[1] > 2.0 * right[0] and right[1] > 2.0 * right[2],
          f"right wall is not green: {right}")
    lum = rows.mean(axis=1)
    check(int(lum.argmax()) < 0.4 * h,
          f"brightest row {int(lum.argmax())} is not in the upper part")
    check(lum[:h // 4].mean() > 1.2 * lum[h // 2:].mean(),
          "the top quarter is not the brightest part of the frame")
    return rows


def drive_cli(label, tmp, kernel, scene_name, size):
    """One frame through the command line, with the launch counts reset
    just before and read just after. ``size`` with ``camera_rays`` in it is
    a frame of the MIS integrator."""
    mis = "camera_rays" in size
    cfg = RenderConfig(integrator="mis" if mis else "path", **size)
    png = os.path.join(tmp, f"{label}.png")
    dbg = os.path.join(tmp, f"{label}.txt")
    if mis:
        flags = ["--integrator", "mis", "--camera-rays", str(cfg.camera_rays),
                 "--mis-samples", str(cfg.mis_samples)]
        depth = f"{cfg.camera_rays} camera rays x {cfg.mis_samples} samples"
    else:
        flags = ["--spp", str(cfg.spp), "--bounces", str(cfg.bounces)]
        depth = f"{cfg.spp} spp x {cfg.bounces}"
    reset_launches()
    start = time.perf_counter()
    rc = cli.main([png, "--kernel", kernel, "--scene", scene_name,
                   "--width", str(cfg.width), "--height", str(cfg.height),
                   "--debug-output", dbg] + flags)
    seconds = time.perf_counter() - start
    launches = read_launches()
    check(rc == 0, f"path {label}: cli.main returned {rc}")
    rows = check_frame(png, dbg, cfg)
    if mis:
        # Raw accumulated colour: the sum over the camera rays of a few
        # units of radiance per ray on the walls (the light itself is 38).
        mean = rows.mean() / cfg.camera_rays
        check(0.3 < mean < 10.0, f"path {label}: mean radiance per camera "
              f"ray {mean:.3f} is not a lit Cornell box's")
    log(f"  path {label}: {kernel} {scene_name} {cfg.width}x{cfg.height} "
        f"x {depth}: {seconds:.3f} s with PNG, launches {launches}")
    return launches


def phase_main_path(tmp):
    log("== main path through cli.main")
    launches = {
        "A": drive_cli("A", tmp, "cuda", "cornell", FRAME),
        "B": drive_cli("B", tmp, "cuda", "cornell-spheres", FRAME),
        "C": drive_cli("C", tmp, "decoupled", "cornell", BENCH),
    }
    check(launches["A"]["path_kernel"] > 0 and launches["B"]["path_kernel"]
          > 0, "paths A/B did not launch the trace kernel")
    check(launches["C"]["draws_kernel"] > 0 and launches["C"]["path_kernel"]
          > 0, "path C did not launch both kernels")
    return launches


def phase_mis_path(tmp):
    log("== MIS paths through cli.main")
    launches = {
        "F": drive_cli("F", tmp, "cuda", "cornell", MIS_FRAME),
        "G": drive_cli("G", tmp, "cuda", "cornell-spheres", MIS_FRAME),
        "H": drive_cli("H", tmp, "decoupled", "cornell", MIS_BENCH),
    }
    for label, counts in launches.items():
        check(counts["mis_kernel"] == 1 and counts["path_kernel"] == 0,
              f"path {label}: launches {counts}, expected one MIS kernel")
    # Path F's library call once more, under the profiler: one kernel is
    # the frame, so the card should be busy nearly all of it.
    cfg = RenderConfig(integrator="mis", **MIS_FRAME)
    scene = cornell_box(resolution=cfg.resolution)
    wall_ms, busy_ms, top = device_busy(
        lambda: cuda_mis.render_mis_cuda(scene, cfg))
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    log(f"  path F, render_mis_cuda under the profiler: {wall_ms:.1f} ms of "
        f"which the card is busy {busy_ms:.1f} ms ({share}); most device "
        "time: " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top))
    return launches, dict(profiled_ms=wall_ms, device_busy_ms=busy_ms)


def phase_train():
    """Path D: the training workload at full width, through
    ``render_path_decoupled`` and ``torch.autograd.grad``."""
    cfg = RenderConfig(**BENCH)
    log(f"== D: gradients of render_path_decoupled(scene).mean(), box scene, "
        f"{cfg.width}x{cfg.height} x {cfg.spp} spp x {cfg.bounces} bounces")
    scene = with_grad(cornell_box(resolution=cfg.resolution))
    reset_launches()
    # Made once, outside the loop: the draws depend on the config alone, the
    # occluder mask on the geometry, which these steps do not move.
    draws = cuda_path.pregen_draws(cfg)
    occluders = potential_occluders(scene, cfg)

    def one_step(loss):
        # Each step's light depends on the loss before it, as in a fit.
        light = dataclasses.replace(
            scene.light, color=scene.light.color * (1.0 + loss.detach() * 1e-7))
        hdr = decoupled.render_path_decoupled(
            dataclasses.replace(scene, light=light), cfg, draws=draws,
            occluders=occluders)
        return hdr, scene_grads(scene, hdr)

    loss = torch.zeros((), device="cuda")
    step_ms, grads = [], {}
    for step in range(4):
        before = read_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr, grads = one_step(loss)
        loss = hdr.mean()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        after = read_launches()
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == {"draws_kernel": 0, "path_kernel": 1,
                           "shade_bwd_kernel": 1, "mis_kernel": 0},
              f"path D step {step}: launches {per_step}, expected one trace "
              "and one backward")
    launches = read_launches()
    check(hdr.shape == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(hdr).all()), "path D: image")
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"path D: d {name} not finite")
    for name in GRAD_GROUPS:
        check(name in grads and grads[name].abs().max().item() > 0.0,
              f"path D: gradient of {name} is missing or all zero")
    log(f"  path D: loss {loss.item():.6f}; step times "
        + ", ".join(f"{t:.2f}" for t in step_ms) + " ms (host clock, first "
        f"step includes warm-up); launches {launches}; gradients for "
        f"{len(grads)} tensors, all finite")

    def four_more():
        chained = loss
        for _ in range(4):
            chained = one_step(chained)[0].mean()

    wall_ms, busy_ms, top = device_busy(four_more)
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    log(f"  path D, under the profiler: {wall_ms / 4:.2f} ms per step of "
        f"which the card is busy {busy_ms / 4:.3f} ms ({share}); most device "
        "time: " + ", ".join(f"{name} {ms / 4:.3f} ms" for name, ms in top))
    return launches, dict(steps_ms=step_ms, profiled_ms=wall_ms / 4,
                          device_busy_ms=busy_ms / 4)


def phase_inverse():
    """Path E: the inverse-rendering entry point on the sphere scene."""
    cfg = RenderConfig(pixel_chunk=65536, **INVERSE)
    steps = 20
    log(f"== E: inverse_render(fast=True), sphere scene, {cfg.width}x"
        f"{cfg.height} x {cfg.spp} spp x {cfg.bounces} bounces, {steps} Adam "
        "steps")
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    true = inverse.extract_params(scene)
    target = inverse.render_hdr(scene, cfg)
    init = inverse.SceneParams(
        sphere_centers=true.sphere_centers + 0.05,
        sphere_diffuse=true.sphere_diffuse * 0.8,
        light_emission=true.light_emission * 1.2)
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = inverse.inverse_render(scene, target, init, cfg, steps=steps,
                                    learning_rate=1e-2, fast=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    losses = result.losses.cpu()
    check(losses.shape == (steps,) and bool(torch.isfinite(losses).all()),
          f"path E: losses {losses.tolist()}")
    check(losses[-1].item() < losses[0].item(),
          f"path E: the loss did not fall: {losses.tolist()}")
    for name, value in zip(result.params._fields, result.params):
        check(bool(torch.isfinite(value).all()), f"path E: {name} not finite")
    check(launches == {"draws_kernel": 1, "path_kernel": steps,
                       "shade_bwd_kernel": steps, "mis_kernel": 0},
          f"path E: launches {launches}")
    log(f"  path E: loss {losses[0].item():.4e} -> {losses[-1].item():.4e} "
        f"in {steps} steps, {1e3 * seconds / steps:.2f} ms per step (host "
        f"clock, hoisting and warm-up included); launches {launches}")

    # The same fit again, warm: the steady step time, and how much of it the
    # card is busy (launches made here are not the main path's count).
    def fit(n):
        inverse.inverse_render(scene, target, init, cfg, steps=n,
                               learning_rate=1e-2, fast=True)
        torch.cuda.synchronize()

    start = time.perf_counter()
    fit(steps)
    steady_ms = 1e3 * (time.perf_counter() - start) / steps
    wall_ms, busy_ms, top = device_busy(lambda: fit(steps))
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    log(f"  path E, warm: {steady_ms:.2f} ms per step; under the profiler "
        f"{wall_ms / steps:.2f} ms per step of which the card is busy "
        f"{busy_ms / steps:.3f} ms ({share}); most device time: "
        + ", ".join(f"{name} {ms / steps:.3f} ms" for name, ms in top))
    return launches, dict(first_call_ms=1e3 * seconds / steps,
                          warm_ms=steady_ms, profiled_ms=wall_ms / steps,
                          device_busy_ms=busy_ms / steps)


def shade_rows(launches):
    """The backward kernel at the shapes of paths D and E, as those paths
    launch it (draws read): against its plain version, and its time. At D
    also with the draws regenerated, the mode frames above 2 GiB of draw
    planes take; no main path here launches it, so its numbers ride on D's
    row."""
    rows = []
    for label, scene_name, size in (("D", "cornell", BENCH),
                                    ("E", "cornell-spheres", INVERSE)):
        cfg = RenderConfig(**size)
        sh = ShadeInputs(scene_name, cfg)
        ref, nudged = sh.plain(), sh.plain(nudge=True)
        p_ms = time_ms(sh.plain, repeats=2, warmup=0)
        measured = {}
        for regenerate in ((False, True) if label == "D" else (False,)):
            mode = "draws regenerated" if regenerate else "draws read"
            got = sh.kernel(regenerate)
            again = sh.kernel(regenerate)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K3 at {label}, {mode}: two launches differ")
            err = compare_grads(f"K3 at {label}, {mode}", got, ref,
                                nudged=nudged)
            k_ms = time_ms(lambda: sh.kernel(regenerate))
            (bound, by), iters = shade_bound(sh, regenerate)
            measured[regenerate] = (err, k_ms, bound, by)
        err, k_ms, bound, by = measured[False]
        row = dict(
            name=f"shade_bwd_kernel[draws read, {scene_name}]", route="cuda",
            source=SHADE_SOURCE, replaces=SHADE_REPLACES,
            shape=f"{label}: {cfg.width}x{cfg.height} x {cfg.spp} spp x "
                  f"{cfg.bounces} bounces, {sh.table.shape[1]} primitives",
            launches=launches[label]["shade_bwd_kernel"], max_abs_err=err,
            ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=p_ms[1],
            bound_ms=bound, bound_by=by, library_ms=None,
            live_iterations=iters)
        if True in measured:
            err, k_ms, bound, by = measured[True]
            row.update(regenerated_ms=k_ms[1], regenerated_bound_ms=bound,
                       regenerated_bound_by=by, regenerated_max_abs_err=err)
            log(f"  K3 at {label}, draws regenerated: kernel {k_ms[1]:.3f} "
                f"ms (min {k_ms[0]:.3f}, max {k_ms[2]:.3f}), bound "
                f"{bound:.3f} ms by {by}")
        rows.append(row)
        del sh, ref, nudged
        torch.cuda.empty_cache()
    return rows


def mis_rows(launches):
    """The MIS kernel at the shapes of paths F, G and H, as those paths
    launch it, against its plain version on the whole frame: its time and
    its bound from the records of the same frame."""
    rows = []
    # The plain version at two lighter shapes as well: the reference's frame
    # with 1 camera ray and 30 samples, and the small frame at the
    # reference's depth (600 sample steps, launch-bound).
    plain = {}
    for key, size in (
            ("800x600 x 1 x 30", dict(MIS_FRAME, camera_rays=1,
                                      mis_samples=30)),
            ("128x96 x 6 x 300", dict(MIS_FRAME, width=128, height=96))):
        cfg = RenderConfig(integrator="mis", **size)
        inp = MisInputs("cornell", cfg, cull=False)
        hdr_k, rec_k = inp.kernel(emit=True)
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr_p, rec_p = inp.plain(emit=True, pixel_chunk=cfg.num_pixels)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        flips, err = compare_mis(f"K4 at {key}", hdr_k, rec_k, hdr_p, rec_p,
                                 inp.packed)
        k_ms = time_ms(lambda: inp.kernel())
        plain[key] = dict(plain_ms=plain_ms, kernel_ms=k_ms[1],
                          flip_share=flips, max_abs_err=err)
        log(f"  K4 at {key}, cornell: plain {plain_ms:.1f} ms, kernel "
            f"{k_ms[1]:.3f} ms")
        del hdr_p, rec_p, rec_k
        torch.cuda.empty_cache()

    for label, scene_name, size, emit, cull in (
            ("F", "cornell", MIS_FRAME, False, False),
            ("G", "cornell-spheres", MIS_FRAME, False, False),
            ("H", "cornell", MIS_BENCH, True, True)):
        cfg = RenderConfig(integrator="mis", **size)
        inp = MisInputs(scene_name, cfg, cull=cull)
        hdr_h, _ = inp.kernel()
        hdr_e, rec = inp.kernel(emit=True)
        torch.cuda.synchronize()
        check(torch.equal(hdr_h, hdr_e), f"K4 at {label}: records on and off "
              "give different images")
        # The plain version on the whole frame, records and all.
        start = time.perf_counter()
        hdr_p, rec_p = inp.plain(emit=True, pixel_chunk=cfg.num_pixels)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        flips, err = compare_mis(f"K4 at {label}", hdr_e, rec, hdr_p, rec_p,
                                 inp.packed)
        del hdr_p, rec_p
        bound, by, counts = mis_bound(inp, rec, emit)
        del rec, hdr_e
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: inp.kernel(emit=emit))
        other_ms = time_ms(lambda: inp.kernel(emit=not emit), repeats=3)
        row = dict(
            name=f"mis_kernel[{'records, occluder cull' if emit else 'hdr'}, "
                 f"{scene_name}]", route="cuda", source=MIS_SOURCE,
            replaces=MIS_REPLACES,
            shape=f"{label}: {cfg.width}x{cfg.height} x {cfg.camera_rays} "
                  f"camera rays x {cfg.mis_samples} samples, {inp.num_tris} "
                  f"triangles, {inp.packed.num_spheres} spheres",
            launches=launches[label]["mis_kernel"], max_abs_err=err,
            flip_share=flips, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            mrays_per_s=nominal_rays(cfg) / k_ms[1] / 1e3, **counts)
        row["records_on_ms" if not emit else "records_off_ms"] = other_ms[1]
        rows.append(row)
        log(f"  K4 at {label}: {counts}; the other mode (records "
            f"{'off' if emit else 'on'}) {other_ms[1]:.3f} ms")
    return rows, plain


def phase_full(launches, plain_small):
    log("== full: kernels at the main paths' shapes")
    rows = []

    # ---- path C: draws kernel, and the trace reading them with the cull
    cfg = RenderConfig(**BENCH)
    n = cfg.num_pixels
    inp = TraceInputs("cornell", cfg, cull=True)
    draws_k = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
    draws_p = cuda_path.pregen_draws_plain(inp.offsets, cfg)
    err = compare_draws("K1 at C", draws_k, draws_p)
    k_ms = time_ms(lambda: cuda_path.pregen_draws_kernel(inp.offsets_i32,
                                                         cfg))
    p_ms = time_ms(lambda: cuda_path.pregen_draws_plain(inp.offsets, cfg),
                   repeats=2, warmup=0)
    bound, by = draws_bound(cfg, n)
    rows.append(dict(
        name="draws_kernel", route="cuda",
        source="gpuraytracer_tpu_torch/ops/csrc/path_kernels.cu",
        replaces="gpuraytracer_tpu/ops/pallas_path.py:275",
        shape="C: 512x512 x 16 spp x 3 bounces",
        launches=launches["C"]["draws_kernel"], max_abs_err=err,
        ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=p_ms[1],
        bound_ms=bound, bound_by=by, library_ms=None))

    hdr_k, rec_k = inp.kernel(draws_k, emit=True)
    hdr_p, rec_p = inp.plain(draws_p, emit=True, whole_frame=True)
    flips, err = compare_trace("K2 at C emit+draws+cull", hdr_k, rec_k,
                               hdr_p, rec_p, inp.packed)
    # The image the decoupled path returns is the hdr-mode kernel's.
    hdr_cuda = cuda_path.render_path_cuda(inp.scene, cfg)
    hdr_dec = decoupled.render_path_decoupled(
        inp.scene, cfg, draws=draws_k,
        occluders=potential_occluders(inp.scene, cfg))
    gap = (hdr_cuda - hdr_dec).abs().max().item()
    log(f"  path C image vs --kernel cuda image: max difference {gap:.3e}")
    check(gap <= HDR_ATOL, "decoupled and cuda paths disagree")
    k_ms = time_ms(lambda: inp.kernel(draws_k, emit=True))
    p_ms = time_ms(lambda: inp.plain(draws_p, emit=True, whole_frame=True),
                   repeats=2, warmup=0)
    total = cfg.spp * cfg.bounces * n
    bound, by = trace_bound(inp, total, total, emit=True, reads_draws=True)
    rows.append(dict(
        name="path_kernel[emit_records, draws read, occluder cull]",
        route="cuda",
        source="gpuraytracer_tpu_torch/ops/csrc/path_kernels.cu",
        replaces="gpuraytracer_tpu/ops/pallas_path.py:316",
        shape="C: 512x512 x 16 spp x 3 bounces, 36 triangles",
        launches=launches["C"]["path_kernel"], max_abs_err=err,
        flip_share=flips, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
        plain_ms=p_ms[1], bound_ms=bound, bound_by=by, library_ms=None,
        mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3)))
    del draws_k, draws_p, hdr_p, rec_p, rec_k

    # ---- paths A and B: hdr mode at the reference's frame
    cfg = RenderConfig(**FRAME)
    for label, scene_name in (("A", "cornell"), ("B", "cornell-spheres")):
        inp = TraceInputs(scene_name, cfg, cull=False)
        hdr_h, _ = inp.kernel()
        # Records of the same frame, for the flip-aware comparison and for
        # counting the work its paths need.
        hdr_r, rec_r = inp.kernel(emit=True)
        check(torch.equal(hdr_h, hdr_r), f"K2 at {label}: hdr mode and "
              "records_only mode give different images")
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr_p, rec_p = inp.plain(emit=True, whole_frame=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - start
        flips, err = compare_trace(f"K2 at {label} hdr/records_only", hdr_r,
                                   rec_r, hdr_p, rec_p, inp.packed)
        alive, shaded = live_lanes(rec_r, inp.packed)
        closest, shade = int(alive.sum()), int(shaded.sum())
        del alive, shaded
        del rec_p, hdr_p
        k_ms = time_ms(lambda: inp.kernel())
        r_ms = time_ms(lambda: inp.kernel(emit=True), repeats=3)
        bound, by = trace_bound(inp, closest, shade, emit=False,
                                reads_draws=False)
        total = cfg.spp * cfg.bounces * cfg.num_pixels
        # With records on, dead lanes run on masked: every iteration counts.
        r_bound, r_by = trace_bound(inp, total, total, emit=True,
                                    reads_draws=False)
        log(f"  K2 at {label}: live closest-hit iterations {closest} and "
            f"shaded {shade} of {total}; records_only mode "
            f"{r_ms[1]:.1f} ms, bound {r_bound:.3f} ms by {r_by}")
        rows.append(dict(
            name=f"path_kernel[hdr, {scene_name}]", route="cuda",
            source="gpuraytracer_tpu_torch/ops/csrc/path_kernels.cu",
            replaces="gpuraytracer_tpu/ops/pallas_path.py:316",
            shape=f"{label}: 800x600 x 400 spp x 3 bounces, "
                  f"{inp.num_tris} triangles, "
                  f"{inp.packed.num_spheres} spheres",
            launches=launches[label]["path_kernel"], max_abs_err=err,
            flip_share=flips, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            plain_ms=1e3 * plain_s, bound_ms=bound, bound_by=by,
            library_ms=None, records_only_ms=r_ms[1],
            records_only_bound_ms=r_bound, records_only_bound_by=r_by,
            live_closest_iterations=closest, live_shaded_iterations=shade,
            mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3)))
        del rec_r, hdr_r
        torch.cuda.empty_cache()

    rows += shade_rows(launches)
    k4_rows, mis_plain = mis_rows(launches)
    rows += k4_rows
    for row in rows:
        log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}), bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain "
            f"{row['plain_ms']:.1f} ms, launches {row['launches']}")
    row_small = {k: v[1] for k, v in plain_small.items()}
    return rows, row_small, mis_plain


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    started = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        resources, smi = phase_build()
        plain_small = phase_small()
        plain_small.update(phase_mis_small())
        launches = phase_main_path(tmp)
        launches["D"], step_ms = phase_train()
        launches["E"], inverse_ms = phase_inverse()
        mis_launches, mis_frame_ms = phase_mis_path(tmp)
        launches.update(mis_launches)
        mis_grad = phase_mis_grad()
        rows, small_ms, mis_plain = phase_full(launches, plain_small)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"== done in {time.perf_counter() - started:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": rows, "small_128x96_ms": small_ms,
                      "path_D_step_ms": step_ms,
                      "path_E_step_ms": inverse_ms,
                      "path_F_profiled_ms": mis_frame_ms,
                      "mis_plain_ms": mis_plain,
                      "mis_oracle_backward": mis_grad,
                      "ptxas": resources}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
