#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --count-drift
    python3 chip_smoke.py --split [K2 K2g K3 K3g K4 K4g K5 K5g K6 K7]

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, renders six frames through the
command-line entry point (three with the path tracer, three with the MIS
integrator), drives the host side (``Renderer``, progressive accumulation and
checkpoints, the legacy tier, debug checks, profiler traces, the native
library) and trains through the library entry points (the main paths:
the path tracer's and the MIS integrator's gradients, the silhouette path's
sphere-center recovery, and the gradients of both integrators on tessellated
scenes of 1,002 and 12,802 triangles through the grouped tiers, and the
same steps sharded over torch.distributed), times the kernels, and prints

  * a ``sharded`` JSON line (phase sharded: the checks' margins, the step
    times unsharded, on two ranks sharing the card, and at a world of one
    over NCCL),
  * a ``kernels`` JSON line (time, bound, plain-version time, launches on the
    main path, largest difference from the plain version, per kernel),
  * the card's name and power limit as ``nvidia-smi`` gives them,
  * as the last line ``{"ok": true, "device": {...}}``.

It needs a card: without one it exits non-zero and prints no result. Every
failed check raises, so a run that ends in the ``ok`` line passed them all.

``--count-drift`` runs only a measurement for two bounds: how far the plain
grouped sweep's box and triangle tests per sample move between the sample
count the ``full`` phase counts them at and the 300 samples it scales them
to (the grouped MIS kernel's), and how far K2's prefilter pass shares at
paths A and B move between the SHARE_SPP samples they are counted at and
the frame's 400 (``count_drift``). ``--split`` runs only a measurement of
where the kernels' time goes: each rebuilt from a copy of the sources with
one part taken out or changed (``SPLIT_EDITS``) and timed beside the
unedited build, K2 at paths A-C, K2g at K and L, K3 at D and E, K3g at K and
L, K4 at F-H, K5 at I, K4g and K5g at M and N, K6 and K7 at J, at the
recovery and at 800 x 600 x 16 (only the kernels named, where any are).

Phases
  build   nvcc builds ops/csrc/path_kernels.cu, shade_kernels.cu,
          mis_kernels.cu, mis_bwd_kernels.cu and soft_kernels.cu side by
          side; registers and spills printed. Where ``g++`` is found, the
          native host library (``native.py``) is built here too, so that no
          timed PNG write pays for its build.
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
  host    the host side and the legacy tier: (a) ``Renderer(kernel=
          "decoupled")`` at C's shape, the draws made once in __init__, one
          trace launch per draw, two draws bit-equal to each other and to
          ``render_path_decoupled`` as C calls it, ``draw()``'s PNG a
          Cornell box; (b) ``Renderer(kernel="cuda")`` with the MIS
          integrator at 128 x 96 x 2 x 12, one MIS launch per draw; (c)
          ``draw_accumulate`` through the decoupled route, four batches of
          16 spp at 512 x 512 saved and loaded after the second, bit-equal
          to the four frames at seeds 0-3 summed in order; (d) the legacy
          tier: the reference's 800 x 600 frame at its defaults (30 / 2 /
          30, sphere light, no_grad; timed), the three light kinds at 48 x 32
          x 6 / 2 / 6 on the card against the CPU (atol 2e-5 / rtol 1e-4),
          the gradients at 16 x 16 on the card against the CPU (atol 1e-6 /
          rtol 1e-4); (e) ``cli.main`` with ``--integrator legacy --scene
          legacy-box`` at 128 x 96 and with ``--debug-nans`` (path tracer,
          128 x 96 x 16 spp), both Cornell boxes; (f) ``debug_checks``
          stops at a NaN on the card; (g) ``profiler_trace`` around a new
          decoupled Renderer and its first draw names ``draws_kernel`` and
          ``path_kernel``; (h) where ``g++`` is found, the native library
          builds and its PNG decodes to the pure-python writer's pixels.
  F, G    ``cli.main([png, "--integrator", "mis", "--kernel", "cuda"])`` at
          the reference's variant-A settings, 800 x 600 x 6 camera rays x 300
          MIS samples, box scene and sphere scene; F once more under
          ``torch.profiler`` for the card's busy share.
  H       ``--integrator mis --kernel decoupled`` at 512 x 512 x 6 x 300:
          records on, light probes culled.
  mis_bwd the MIS backward kernel against its plain version on the records
          of the MIS kernel and a seeded cotangent, three scenes at 128 x 96
          x 2 x 12 and 256 x 192 x 2 x 30, two launches bit-equal; then the
          gradients ``render_mis_decoupled`` gives every scene tensor at 128 x
          96, against autograd through ``cuda_mis_bwd.replay_mis`` on the
          same records (three scenes), and against ``render_mis_cuda``'s
          oracle backward (held on the two triangle scenes, printed on the
          sphere scene).
  I       the MIS training workload at full width: gradients of
          ``render_mis_decoupled(scene).mean()`` for every float tensor at
          512 x 512 x 6 camera rays x 300 samples (``bench.py``'s second
          line), occluder mask made once, box and sphere scene; four steps,
          one MIS kernel and one MIS backward launch each; two more under
          ``torch.profiler`` for the card's busy share.
  MIS gradients
          ``render_mis_cuda`` on a scene that asks for gradients, 128 x 96:
          the backward (autograd through the eager oracle) in three pixel
          ranges against the whole frame's graph; then one range near the
          default budget, for its time and the memory it holds.
  soft    the silhouette record kernel against its plain version at 128 x
          96 x 4, 256 x 256 x 4 and 800 x 600 x 16 spp (direct lighting,
          sphere scene), with and without the occluder cull; the silhouette
          backward against its plain version on those records and a seeded
          cotangent, two launches bit-equal; the gradients
          ``render_direct_soft_fused`` gives every scene tensor at 128 x 96,
          against autograd through ``cuda_soft.soft_replay`` on the same
          records and through the eager oracle ``render_direct_soft``; its
          value against the trace kernel's at one bounce. Both kernels and
          the entry point at the most primitives the path takes, 64
          triangles and 127 spheres (K7's block past 48 KiB of shared
          memory).
  J       ``grad.inverse.inverse_render(soft=True, fast=True)`` at 256 x 256
          x 4 spp, direct, kappa 0.1, 20 Adam steps from perturbed centers,
          albedo and emission (benchmarks/bench_config4.py's soft-fast line):
          one trace, one record and one backward launch per step, the loss
          finite and falling; then warm, and under ``torch.profiler``.
  recovery
          tests/test_soft_fused.py's sphere-center recovery on the card: 32 x
          32 x 2 spp, 600 SGD steps at 3.5e2 with momentum 0.9, held to the
          JAX package's criteria (last loss below a tenth of the first,
          center error halved); the trajectory is printed; one trace, one
          record and one backward launch per step, counted; 10 more steps
          under ``torch.profiler`` for the card's time per step.
  grouped the grouped tier (more than 64 triangles) at 128 x 96 x 4 spp x 3
          bounces on the tessellated box (252 and 1,002 triangles) and on
          its 252-triangle walls with two analytic spheres, cull on and off:
          the grouped trace kernel in its three modes against its plain
          version (the same sweep in PyTorch), both against the brute-force
          plain version (decisions equal on live lanes); the grouped
          backward against its plain version, draws read and regenerated,
          two launches bit-equal, and the differentiable entry's gradients;
          the hidden-emitter scene (an emissive sphere behind the light
          panel): hdr mode against records_only and the plain version, and
          the grouped backward against its plain version, where the lanes of
          a warp end at different bounces on different emitters;
          then both forced onto the box and sphere scenes: records and
          images bit-equal to the static trace kernel's, the grouped
          backward within the static one's limits of it.
  K, L    the tessellated box at 512 x 512 x 16 spp x 3 bounces
          (benchmarks/bench_grouped.py's variant-B workload): K 1,002
          triangles, L 12,802 (wall_subdiv 16, sphere_subdiv 4,
          BASELINE.md:139). ``render_path_cuda_impl`` in hdr mode and with
          records + draws + occluder cull, then gradients of
          ``render_path_decoupled_fused(scene, draws=..., occluders=...)
          .mean()`` for every float tensor (K four steps, L two), one grouped
          trace and one grouped backward launch each, counted; two more
          under ``torch.profiler``; the shadow table's size after the cull
          and the peak device memory.
  mis_grouped
          the MIS grouped tier at 128 x 96 x 2 camera rays x 12 samples on
          the tessellated walls (252 triangles) with and without the two
          analytic spheres, cull on and off: the grouped MIS kernel with
          records on and off against its plain version (the same sweep in
          PyTorch), both against the brute-force plain version (the same
          winners on every lane, the probe bits where they feed the image,
          the image within atol 5e-8 / rtol 1e-6), two launches bit-equal;
          the grouped MIS backward against its plain version, two launches
          bit-equal; both forced onto the box and sphere scenes (images and
          records bit-equal to the static MIS kernel's on every lane, the
          backward within the static one's limits of it); both at 1,282
          triangles on a 32 x 24 frame, whose records hold primitive codes
          above 10 bits.
  M, N    benchmarks/bench_grouped.py --mis: the tessellated box at 512 x 512
          x 6 camera rays x 300 samples, M 1,002 triangles (and the same
          scene with the two analytic spheres), N 12,802
          (BASELINE.md:139). ``render_mis_cuda_impl`` in hdr mode and with
          records + occluder cull, then gradients of
          ``render_mis_decoupled(scene, occluders=...).mean()`` for every
          float tensor (M four steps, N two), one grouped MIS kernel and one
          grouped MIS backward launch each, counted; two more under
          ``torch.profiler``; the seconds of the phase, the paths and their
          rows are printed.
  spheres the box with many small spheres (cornell-spheres with seeded
          spheres of radii 0.05-0.2 inside the box, seed MANY_SPHERES_SEED):
          box+300 (314 primitives, one added sphere emissive) stays on the
          static tier, K3's block opted in past 48 KiB; on box+1000
          (1,014) the routes that run a backward go to the grouped tier by
          the table-size rule (``cuda_path.grouped_tier`` with the route's
          plans: ``cuda_shade.fused_tier``, ``cuda_mis_bwd.fused_tier``),
          and so does the path trace alone (K2's tables past
          ``cuda_path.TRACE_ALONE_BYTES``); the MIS trace alone stays
          static (K4's within ``cuda_mis.TRACE_ALONE_BYTES``). On each:
          K1, K2 or K2g and K3 or K3g at 128 x 96 x 4 spp x 3 bounces, K4 or
          K4g and K5 or K5g at 128 x 96 x 2 x 30 against their plain
          versions, K4 and K4g timed on the same image, one
          ``render_mis_decoupled`` step with gradients against autograd
          through the replay of its records; on box+1000 the static K2
          forced onto it gives K2g's images and records by sha256; a frame
          of ``render_path_cuda`` at 800 x 600 x 16 spp x 3 bounces,
          timed beside the same frame forced onto the other tier; four Adam
          steps of ``inverse_render(fast=True)`` at 512 x 512 x 16 spp x 3
          bounces, launches counted, then warm and under the profiler; K2, K3
          (box+300), K2g, K3g (box+1000) rows at the fit's shape
          (``tier_rows``, as paths K and L). The traces alone on both
          tiers at TIER_SWEEP sphere counts (``tier_sweep``: the same
          image, each one's time, the rule's tier). Then K3 on the in-view
          probe scene (169 primitives, ``spheres_at_static_limit(in_view=
          True)``): kernel and plain version each against the float64
          evaluation, on
          the whole frame and on the pixels whose paths meet no added
          sphere (held to compare_grads), meet one with the camera ray, or
          only later; and the light centre's cotangent lane by lane.
  sharded parallel/ over torch.distributed, after the rows: (a) pixel
          ranges in one process through the sharded functions' local halves
          at D's (4 ranges), K's and I's (2) shapes: the image equal to the
          single render's by sha256, the gradients summed over the ranges in
          rank order within the JAX package's sharded limits (path atol 1e-8
          / rtol 1e-5, MIS atol 1e-5 of the largest magnitude / rtol 1e-4),
          one K1 / K2 / K3 (K2g / K3g, K4 / K5) launch per range; (b) two
          ranks of this script (``--sharded-rank gloo``) on the one card over
          gloo: two ``make_train_step_fused`` steps at D, E and K, one eager
          oracle step at 64 x 64, the MIS gradient at I, the overlapped
          gradient against the plain one at D (atol 1e-6 / rtol 1e-4); the
          gathered images equal the single-process frames by sha256, the
          parameters and gradients are equal by bits on both ranks; (c) one
          rank over NCCL (``--sharded-rank nccl``): steps at D and I
          unsharded, sharded without a group (the autograd Functions alone)
          and sharded with the NCCL world group, in turns, images and
          gradients equal by bits; their times go into the ``sharded`` line.
          A rank that fails or runs past SHARDED_TIMEOUT fails the run.
  full    the kernels at the shapes of A to N against their plain versions
          (K2 also at E's: records, draws read, the cull inverse_render
          makes; its rows and K2g's carry bounds that charge a triangle test
          the prefilter's operations and the rest only where it passes, the
          pass shares counted by the plain versions)
          (the MIS kernels' on the whole frame, records and all; the grouped
          trace's on the whole frame at K, on every 128th pixel at L; the
          grouped MIS kernel's timed launch against the brute-force plain
          version on every 127th pixel at M and every 509th at N, at the
          full 6 x 300 — decisions and image as in mis_grouped — and
          against the plain grouped sweep on the same pixels at 2 camera
          rays x 30 samples, whose box and triangle counts
          estimate its bound; the grouped MIS backward's on the whole
          frame), and their times. The MIS rows (K4, K4g, K5, K5g) also
          give registers, stack, shared memory and blocks per SM, and K5's
          the share of a warp's lanes open where each of its three strategy
          calls issues (``k5_lane_shares``).

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
printed against the integrator's own atol 5e-4 / rtol 1e-3. MIS backward
kernel: per output group atol 1e-6 max(scale, 1) + rtol 1e-4 of the group's
largest magnitude (same records: only the order of the sums over lanes
differs), plus four times the distance the plain version moves under a
one-ulp change of a sample-table row. Its path: against autograd through
the replay of the same records, the same atol and rtol without the
addition; against the oracle backward, which makes its own decisions, the
JAX package's MIS gradient tolerance atol 1e-5 max(scale, 1) + rtol 2e-4 on
the triangle scenes (on the sphere scene an ulp flips grazing decisions
that carry large geometry gradients: that distance is printed, not held).
Grouped trace: as the trace kernel, and against the brute-force plain
version the decisions on live lanes equal (the sweep's boxes are padded, so
it skips no box that holds the winner); its image within atol 5e-8 / rtol
1e-6 of the brute force's. Grouped backward: the backward kernel's limits;
forced onto the static tier's scenes, within them of the static kernel
(the plain version's one-ulp movement added). Silhouette records: the share
of records that differ from the plain
version's is held to the same 0.5 % and printed field by field (kernel and
plain version hold no transcendental and round alike). Silhouette backward:
per group atol 1e-6 max(scale, 1) + rtol 1e-4 of its largest magnitude plus
four times what a one-ulp nudge of the camera's w vector moves the plain
version; its path against autograd through the replay of the same records
at the same atol and rtol, and against the eager oracle at the same
tolerance except for the spheres' center and radius, whose distance is
printed: the oracle traces its own rays, normalized another way, and a
grazing sphere decision that flips between them carries a large geometry
gradient.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gpuraytracer_tpu_torch import cli, image, native
from gpuraytracer_tpu_torch.grad import inverse
from gpuraytracer_tpu_torch.grad.diff_render import render_direct_soft
from gpuraytracer_tpu_torch.intersect import (RAY_TMAX, RAY_TMIN,
                                              potential_occluders,
                                              sphere_candidates)
from gpuraytracer_tpu_torch.ops import (_build, cuda_mis, cuda_mis_bwd,
                                        cuda_path, cuda_shade, cuda_soft,
                                        decoupled)
from gpuraytracer_tpu_torch.parallel import fast, mesh, multihost, train
from gpuraytracer_tpu_torch.render import pixel_rng_offsets, render_mis
from gpuraytracer_tpu_torch.render_legacy import render_legacy
from gpuraytracer_tpu_torch.renderer import Renderer
from gpuraytracer_tpu_torch.sampling import PRIMES
from gpuraytracer_tpu_torch.scene import (cornell_box, cornell_box_glossy,
                                          cornell_box_tessellated,
                                          cornell_box_with_spheres,
                                          legacy_cornell, make_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils import checkpoint, debug
from gpuraytracer_tpu_torch.utils.host import fetch
from gpuraytracer_tpu_torch.utils.metrics import (
    OPS_BOX_CLOSEST, OPS_BOX_SHADOW,
    OPS_BWD_BOUNCE, OPS_BWD_CAMERA, OPS_BWD_SPHERE, OPS_CAMERA,
    OPS_K5_COS_ON_GEO, OPS_K5_COS_ON_LIGHT, OPS_K5_HOIST, OPS_K5_LIGHT,
    OPS_K5_SPHERE_HIT, OPS_K5_VNDF_ON_GEO, OPS_K5_VNDF_ON_LIGHT, OPS_K7_BG_HIT, OPS_K7_BG_REV,
    OPS_K7_BG_SURF, OPS_K7_CAMERA, OPS_K7_COVER, OPS_K7_SHADE_FWD,
    OPS_K7_SHADE_REV, OPS_K7_SPHERE_FWD, OPS_K7_SPHERE_REV, OPS_MIS_CAMERA,
    OPS_MIS_SAMPLE, OPS_MIS_SECONDARY, OPS_MIS_SECONDARY_BLOCKED,
    OPS_SHADE, OPS_SHADOW_RAY, OPS_SILH_LANE, OPS_SPH_CLOSEST, OPS_SPH_SHADOW,
    OPS_SWEEP_RAY, OPS_TRI_CLOSEST, OPS_TRI_PREFILTER, OPS_TRI_SHADOW,
    halton_dim_ops, halton_ops, mrays_per_s, nominal_rays, profiler_trace,
    roofline)

# The H100's published peaks (utils/metrics.H100: 3.35 TB/s of HBM, 67
# TFLOP/s of float32), the float32 operation counts of the kernels (OPS_*),
# the radical inverse's count (halton_ops) and roofline() come from
# utils/metrics.py; the bounds are stated against those peaks whatever power
# limit the card runs at, and the limit is printed beside.
# The H100's SMs and the warp schedulers of each, one warp instruction a clock each.
SMS, SCHEDULERS = 132, 4
# K1 (a tenth of a millisecond) is timed over K1_BATCH launches back to back,
# K1_REPEATS times after K1_WARMUP such batches.
K1_BATCH, K1_REPEATS, K1_WARMUP = 10, 20, 2

FLIP_SHARE_MAX = 0.005
HDR_ATOL, HDR_RTOL = 2e-5, 1e-4

# A triangle test runs OPS_TRI_PREFILTER operations of its OPS_TRI_CLOSEST or
# OPS_TRI_SHADOW on every test, the rest only on a test that passes both
# prefilter conditions (utils/metrics.py). For the static tiers the share
# that passes is counted by the plain version on every PREFILTER_STRIDE-th
# pixel (prime, so that the pixels spread over the frame's columns), K2's at
# no more than SHARE_SPP samples per pixel (a share, not a count:
# ``--count-drift`` measures how far it moves at the 400 of paths A and B);
# K2g's plain sweep counts its passes beside its tests.
PREFILTER_STRIDE = 13
SHARE_SPP = 16

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
MIS_BWD_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/mis_bwd_kernels.cu"
MIS_BWD_REPLACES = "gpuraytracer_tpu/ops/pallas_mis_bwd.py:1099"
# The MIS backward against its plain version at a second, mid size.
MIS_BWD_MID = dict(width=256, height=192, camera_rays=2, mis_samples=30)
# The MIS backward kernel's path against the oracle backward on the triangle
# scenes: the JAX package's MIS gradient tolerance (tests/test_mis_fused.py).
MIS_ORACLE_ATOL, MIS_ORACLE_RTOL = 1e-5, 2e-4
SHADE_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/shade_kernels.cu"
SHADE_REPLACES = "gpuraytracer_tpu/ops/pallas_shade.py:72"
# The silhouette path (direct lighting, one bounce, sphere scene, kappa 0.1):
# the comparison sizes and the reference's frame at 16 spp; path J,
# benchmarks/bench_config4.py's soft-fast line; the center recovery of
# tests/test_soft_fused.py.
SOFT_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/soft_kernels.cu"
SILH_REPLACES = "gpuraytracer_tpu/ops/pallas_soft.py:90"
SOFT_BWD_REPLACES = "gpuraytracer_tpu/ops/pallas_soft.py:305"
SOFT_KAPPA = 0.1
SOFT_SIZES = (dict(width=128, height=96, spp=4),
              dict(width=256, height=256, spp=4),
              dict(width=800, height=600, spp=16))
SOFT_J = dict(width=256, height=256, spp=4, pixel_chunk=65536)
SOFT_RECOVERY = dict(width=32, height=32, spp=2, pixel_chunk=1024)
RECOVERY_SHIFTS = [[0.15, 0.0, -0.1], [-0.1, 0.05, 0.1]]
RECOVERY_STEPS, RECOVERY_LR = 600, 3.5e2
# The recovery's steps under the profiler (each profiled step costs about
# a quarter of a second of the profiler's own host work).
RECOVERY_PROFILED_STEPS = 10

# The grouped tier (more than 64 triangles): the tessellated Cornell box of
# benchmarks/bench_grouped.py (walls cut into cells, icosphere meshes), at the
# test size (252 triangles), its default (1,002) and BASELINE.md:139's 12,802;
# and the 252-triangle walls with the two analytic spheres of
# cornell_box_with_spheres added (tests/test_mis_grouped.py:69-77).
PATH_SOURCE = "gpuraytracer_tpu_torch/ops/csrc/path_kernels.cu"
K2_REPLACES = "gpuraytracer_tpu/ops/pallas_path.py:316"
K2G_REPLACES = "gpuraytracer_tpu/ops/pallas_path.py:532"
K3G_REPLACES = "gpuraytracer_tpu/ops/pallas_shade.py:174"
TESS_SMALL = dict(wall_subdiv=3, sphere_subdiv=1)
TESS_K = dict(wall_subdiv=6, sphere_subdiv=2)
TESS_L = dict(wall_subdiv=16, sphere_subdiv=4)


def tess_with_spheres(resolution, tess_kw=TESS_SMALL):
    tess = cornell_box_tessellated(resolution=resolution, **tess_kw)
    return dataclasses.replace(
        tess, spheres=cornell_box_with_spheres(resolution=resolution).spheres)


def tess_with_hidden_emitter(resolution):
    """tess_with_spheres and a third, emissive sphere above the ceiling,
    behind the light panel as the camera sees it: a camera ray that ends at
    the panel would meet it next (at 128 x 96, every pixel center whose ray
    ends at the panel does)."""
    scene = tess_with_spheres(resolution)
    hidden = make_spheres(centers=[(0.0, 3.6, -3.0)], radii=[1.0], materials=[
        dict(diffuse=(0.5, 0.5, 0.5), emissive=(0.0, 40.0, 0.0))])
    spheres = dataclasses.replace(scene.spheres, **{
        f.name: torch.cat([getattr(scene.spheres, f.name), getattr(hidden, f.name)])
        for f in dataclasses.fields(hidden)})
    return dataclasses.replace(scene, spheres=spheres)


def static_bwd_max_sph() -> int:
    """The most primitives K3's static tier takes with spheres, from its
    plan: its tables and staging rows fill one block's shared memory (opted
    in past 48 KiB)."""
    prims = cuda_path.STATIC_TIER_MAX
    while True:
        try:
            cuda_shade.static_smem_bytes(prims + 1, True)
        except ValueError:
            return prims
        prims += 1


# PR 11's probe scene: cornell-spheres with 155 seeded spheres, 169
# primitives (the static tier's limit until it opted in past 48 KiB).
PROBE_PRIMS = 169


def box_sphere_arrays(n, seed, radii, in_view=True, emissive=0):
    """(centers [n, 3], radii [n], materials) of ``n`` spheres drawn from
    ``seed`` with numpy, radii uniform in ``radii``: inside the box, or
    behind its back wall where no ray reaches them. The first ``emissive``
    of them emit. Plain numpy, so that the JAX package's scene and the
    port's are built from the same numbers."""
    rng = np.random.default_rng(seed)
    low, high = ((-2.2, -2.2, -2.2), (2.2, 2.0, 2.2)) if in_view else (
        (-2.0, -2.0, -4.0), (2.0, 2.0, -3.0))
    centers = rng.uniform(low, high, (n, 3))
    radius = rng.uniform(*radii, n)
    materials = [dict(diffuse=tuple(rng.uniform(0.2, 0.9, 3)),
                      metallic=float(rng.uniform(0.0, 0.5)),
                      roughness=float(rng.uniform(0.2, 0.8))) for _ in range(n)]
    for m in materials[:emissive]:
        m["emissive"] = BOX_SPHERE_EMISSION
    return centers, radius, materials


def with_box_spheres(resolution, n, seed, radii, in_view=True, emissive=0):
    """cornell-spheres with ``box_sphere_arrays`` before its own two spheres
    (the box's two take the table's last rows)."""
    scene = cornell_box_with_spheres(resolution=resolution)
    own = scene.spheres
    extra = make_spheres(*box_sphere_arrays(n, seed, radii, in_view, emissive))
    return dataclasses.replace(scene, spheres=dataclasses.replace(own, **{
        f.name: torch.cat([getattr(extra, f.name), getattr(own, f.name)])
        for f in dataclasses.fields(own)}))


def spheres_at_static_limit(resolution, in_view=False, prims=PROBE_PRIMS):
    """cornell-spheres with spheres of radii 0.1-0.3 drawn from seed
    ``prims``, to ``prims`` primitives: inside the box, or by default behind
    its back wall, where no ray reaches them."""
    n = prims - cornell_box_with_spheres(resolution=(1, 1)).triangles.num_triangles - 2
    return with_box_spheres(resolution, n, prims, (0.1, 0.3), in_view)


# The box with many small spheres (radii 0.05-0.2, seed MANY_SPHERES_SEED)
# inside it: box+300 (314 primitives, one of the added spheres emissive)
# stays on the static tier, its K3 block opted in to about 98 KB; box+1000
# (1,014) goes to the grouped tier by the table-size rule (K3's static tables
# would take about 300 KB, K5's 305-311 KB).
MANY_SPHERES_SEED = 16
MANY_SPHERES_RADII = (0.05, 0.2)
BOX_SPHERE_EMISSION = (6.0, 5.0, 4.0)
MANY_SPHERES = {"box+300": (300, 1), "box+1000": (1000, 0)}


def box_with_many_spheres(name, resolution):
    n, emissive = MANY_SPHERES[name]
    return with_box_spheres(resolution, n, MANY_SPHERES_SEED,
                            MANY_SPHERES_RADII, emissive=emissive)


GROUPED_SCENES = {
    "tess-252": lambda resolution: cornell_box_tessellated(
        resolution=resolution, **TESS_SMALL),
    "tess-1002": lambda resolution: cornell_box_tessellated(
        resolution=resolution, **TESS_K),
    "tess-252+spheres": tess_with_spheres,
}
ALL_SCENES = dict(SCENES, **GROUPED_SCENES)
MIS_ALL_SCENES = dict(MIS_SCENES, **GROUPED_SCENES)
# At path L the plain sweep runs on every L_PIXEL_STRIDE-th pixel: its counts
# of box and triangle tests there, scaled to the frame, give K2g's bound at L
# (at K it runs on the whole frame).
L_PIXEL_STRIDE = 128

# The MIS grouped tier (K4g, K5g): benchmarks/bench_grouped.py --mis at
# 512 x 512 x 6 x 300 on the tessellated box (path M: 1,002 triangles, with
# and without the two analytic spheres; path N: 12,802), and a scene of
# 1,282 triangles (wall_subdiv 8, sphere_subdiv 2) whose records hold
# primitive codes above 10 bits, on a small frame. At M and N the timed K4g
# launch (6 x 300, records + cull) is held on every ``stride``-th pixel
# against the brute-force plain version at the same shape. The plain grouped
# sweep is launch-bound (a Python loop over the groups): it runs on the same
# pixels at fewer camera rays and samples, against K4g at that shape, and its
# counts of box and triangle tests, scaled to the frame, estimate K4g's bound
# (the rows' ``est_`` fields; ``--count-drift`` measures how far the counts
# per sample move between the sample counts). The strides are prime, so that
# the pixels spread over the frame's columns (a stride of 512 would take
# column 0 only).
K4G_REPLACES = "gpuraytracer_tpu/ops/pallas_mis.py:328"
K5G_REPLACES = "gpuraytracer_tpu/ops/pallas_mis_bwd.py:1163"
TESS_1282 = dict(wall_subdiv=8, sphere_subdiv=2)
MIS_1282 = dict(width=32, height=24, camera_rays=2, mis_samples=12)
MIS_GROUPED_CHECK = {"M": dict(stride=127, camera_rays=2, mis_samples=30),
                     "N": dict(stride=509, camera_rays=2, mis_samples=30)}


def mis_grouped_path_scenes(resolution):
    """Paths M and N: label, scene name, scene."""
    return (("M", "tess-1002", cornell_box_tessellated(resolution=resolution,
                                                      **TESS_K)),
            ("M", "tess-1002+spheres", tess_with_spheres(resolution, TESS_K)),
            ("N", "tess-12802", cornell_box_tessellated(resolution=resolution,
                                                       **TESS_L)))


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


LAST_PROFILE = {}  # device milliseconds by kernel name, last profiler window


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
    LAST_PROFILE.clear()
    LAST_PROFILE.update(by_name)
    return wall_ms, sum(by_name.values()), [(n[:48], ms) for n, ms in top]


def profiled_ms(kernel: str) -> float:
    """Device milliseconds of the kernels whose name holds ``kernel`` in the
    last ``device_busy`` window."""
    return sum(ms for name, ms in LAST_PROFILE.items() if kernel in name)


# ---------------------------------------------------------------------------
# Kernel inputs and comparisons
# ---------------------------------------------------------------------------

class TraceInputs:
    """What the trace wrapper and its plain version take, on the card.
    ``grouped``: pack for the grouped tier (K2g and its plain sweep); the
    occluder cull then lives in the shadow table."""

    def __init__(self, scene_name: str, cfg: RenderConfig, cull: bool,
                 device="cuda", grouped=False, scene=None, sphere_slack=0.0):
        dev = torch.device(device)
        self.cfg = cfg
        self.scene = (ALL_SCENES[scene_name](resolution=cfg.resolution)
                      if scene is None else scene)
        self.num_tris = self.scene.triangles.num_triangles
        self.occluders = (potential_occluders(self.scene, cfg,
                                              sphere_slack=sphere_slack)
                          if cull else None)
        self.grouped = grouped
        self.packed = cuda_path._pack_inputs(self.scene.to(dev), cfg, grouped,
                                             self.occluders)
        self.offsets = pixel_rng_offsets(cfg, dev)
        self.offsets_i32 = self.offsets.to(torch.int32).contiguous()
        self.shadow_idx = cuda_path.shadow_indices(self.occluders,
                                                   self.num_tris, dev)

    def kernel(self, draws=None, emit=False):
        return cuda_path.path_trace_kernel(
            self.offsets_i32, 0, self.packed, self.shadow_idx, draws,
            self.cfg, emit)

    def plain(self, draws=None, emit=False, whole_frame=False):
        cfg = (self.cfg.replace(pixel_chunk=self.cfg.num_pixels)
               if whole_frame else self.cfg)
        return cuda_path.render_path_plain(
            self.offsets, 0, self.packed, self.shadow_idx, draws, cfg, emit)

    def brute(self, draws=None, emit=False):
        """The brute-force plain version (every triangle tested) on the
        same scene, draws and cull."""
        packed = self.packed._replace(grouped=None)
        return cuda_path.render_path_plain(
            self.offsets, 0, packed, self.shadow_idx, draws, self.cfg, emit)


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
                   cuda_mis.LAUNCHES, cuda_mis_bwd.LAUNCHES,
                   cuda_soft.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    return {**cuda_path.LAUNCHES, **cuda_shade.LAUNCHES,
            **cuda_mis.LAUNCHES, **cuda_mis_bwd.LAUNCHES,
            **cuda_soft.LAUNCHES}


def launches_of(**counts) -> dict:
    """Every kernel's launch count: those given, 0 for the rest."""
    expect = {key: 0 for key in read_launches()}
    expect.update(counts)
    return expect


class ShadeInputs:
    """What the backward wrapper and its plain version take, on the card: the
    records of a trace of ``scene_name`` (draws read, occluder cull), the
    draws, the parameter views, and a cotangent from a seeded generator,
    divided by spp as the autograd glue hands it over."""

    def __init__(self, scene_name: str, cfg: RenderConfig, grouped=False,
                 scene=None):
        self.cfg = cfg
        self.grouped = grouped
        self.trace = TraceInputs(scene_name, cfg, cull=True, grouped=grouped,
                                 scene=scene)
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

    def kernel(self, regenerate=False, grouped=None):
        return cuda_shade.shade_bwd_kernel(
            *self._args(regenerate),
            grouped=self.grouped if grouped is None else grouped)

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
    return grads_of(scene, hdr.mean())


def grads_of(scene, value):
    """Gradients of the scalar ``value`` by the scene's tensors that ask for
    them, by name; tensors it does not depend on are left out."""
    named = [(f"{part.name}.{f.name}", getattr(getattr(scene, part.name),
                                               f.name))
             for part in dataclasses.fields(scene)
             for f in dataclasses.fields(getattr(scene, part.name))]
    named = [(name, t) for name, t in named if t.requires_grad]
    grads = torch.autograd.grad(value, [t for _, t in named],
                                allow_unused=True)
    return {name: g for (name, _), g in zip(named, grads) if g is not None}


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def draws_bound(cfg: RenderConfig, n: int):
    """Bound of the draws kernel: each offset read once, each draw written
    once, against the digit arithmetic of the radical inverses."""
    nbytes = 4 * n + 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    return roofline(nbytes, halton_ops(cfg, n))


def time_draws(launch):
    """K1's (min, median, max) ms a launch by CUDA events around K1_BATCH
    launches back to back (one launch alone would time the host's call as
    well)."""
    def batch():
        for _ in range(K1_BATCH):
            launch()
    return tuple(t / K1_BATCH for t in time_ms(batch, repeats=K1_REPEATS, warmup=K1_WARMUP))


def draws_device_ms(launch) -> float:
    """K1's device ms a launch by the profiler, over K1_BATCH launches."""
    device_busy(lambda: [launch() for _ in range(K1_BATCH)])
    return profiled_ms("draws_kernel") / K1_BATCH


def sm_clock_mhz(fn, launches: int = 10000) -> int:
    """The SM clock (MHz) nvidia-smi reads while ``launches`` calls of ``fn``
    run back to back."""
    for _ in range(launches):
        fn()
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return int(mhz)


def draws_issue_floor(cfg: RenderConfig, n: int, offsets):
    """K1's issue floor: the SASS instructions a thread of
    ``draws_kernel<bounces>`` runs on the short form (``sass_short_path``:
    straight-line code, the loop form out of line) per (pixel, sample) item,
    over 32 lanes and SMS x SCHEDULERS issue slots a clock at the SM clock
    read while the kernel runs."""
    per_item = len(sass_short_path(_build.load_library("path_kernels").path,
                                   f"draws_kernelILi{cfg.bounces}E"))
    mhz = sm_clock_mhz(lambda: cuda_path.pregen_draws_kernel(offsets, cfg))
    warp_instructions = per_item * cfg.spp * n / 32
    return dict(sass_per_item=per_item, sm_clock_mhz=mhz,
                issue_floor_ms=1e3 * warp_instructions / (SMS * SCHEDULERS * mhz * 1e6))


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
    occluder cull or by the two tiers, hold the same winners everywhere and
    the same shadow bits on every shaded lane. (On a dead lane the probe
    starts on the surface it last left, where a culled triangle may graze
    it: that bit feeds nothing.)"""
    mask = cuda_path.OCC_BIT - 1
    check(torch.equal(rec_a & mask, rec_b & mask),
          f"{what}: winners differ")
    _, shaded = live_lanes(rec_a, packed)
    check(torch.equal(rec_a[shaded], rec_b[shaded]),
          f"{what}: shadow bits differ on shaded lanes")


def k2_prefilter_shares(inp: TraceInputs, spp=SHARE_SPP):
    """The shares of K2's triangle tests that pass both of its prefilters
    (``cuda_path.plane_ahead``, ``plane_within``), counted by the plain
    version on every PREFILTER_STRIDE-th pixel of the frame at the full
    bounces and at most ``spp`` samples per pixel: {"closest": closest hits,
    "shadow": shadow probes that reach the light}, on live lanes, and with
    the suffix "_all" on every lane (records on: dead lanes run on)."""
    pix = torch.arange(0, inp.cfg.num_pixels, PREFILTER_STRIDE,
                       device=inp.offsets.device)
    stats = {}
    cuda_path.render_path_plain(
        inp.offsets[pix], pix, inp.packed, inp.shadow_idx, None,
        inp.cfg.replace(pixel_chunk=pix.numel(), spp=min(inp.cfg.spp, spp)),
        False, stats)
    return {f"{loop}{key}": st["passed" + key] / max(st["triangles" + key], 1)
            for loop, st in stats.items() for key in ("", "_all")}


def trace_bound(inp: TraceInputs, rec, shares, emit, reads_draws):
    """(bound_ms, bound_by, counts) of one K2 trace, from the records of
    this frame: the primitive tests and shading its lanes need (live lanes
    in hdr mode, every lane with records on, where dead lanes run on) — a
    closest hit tests every primitive, a probe that reaches the light every
    occluder and sphere, a blocked probe at least one whole triangle test —
    against the bytes in and out. Every other triangle test costs
    OPS_TRI_PREFILTER, and the rest of a whole test only the ``shares``
    (``k2_prefilter_shares``) that pass the prefilters, estimates and so
    named ``est_``. ``whole_tests_bound_ms``: the same with every test whole
    and every probe testing every occluder, as if no test were prefiltered."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    t, s, n_shadow = inp.num_tris, inp.packed.num_spheres, len(inp.shadow_idx)
    alive, shaded = live_lanes(rec, inp.packed)
    if emit:
        alive = shaded = torch.ones_like(alive)
    occ = (rec & cuda_path.OCC_BIT) != 0
    closest = int(alive.sum())
    reached, blocked = int((shaded & ~occ).sum()), int((shaded & occ).sum())
    key = "_all" if emit else ""
    tests = dict(closest=closest * t, shadow=reached * n_shadow)
    passed = {k: int(v * shares[k + key]) for k, v in tests.items()}
    rest = (closest * s * OPS_SPH_CLOSEST + (reached + blocked) * OPS_SHADE
            + cfg.spp * n * OPS_CAMERA
            + (0 if reads_draws else halton_ops(cfg, n)))
    ops = (sum(tests.values()) * OPS_TRI_PREFILTER
           + passed["closest"] * (OPS_TRI_CLOSEST - OPS_TRI_PREFILTER)
           + passed["shadow"] * (OPS_TRI_SHADOW - OPS_TRI_PREFILTER)
           + blocked * OPS_TRI_SHADOW + reached * s * OPS_SPH_SHADOW + rest)
    whole_ops = (closest * t * OPS_TRI_CLOSEST
                 + (reached + blocked) * (n_shadow * OPS_TRI_SHADOW
                                          + s * OPS_SPH_SHADOW) + rest)
    tables = 4 * (inp.packed.tri.numel() + inp.packed.sph.numel()
                  + inp.packed.atab.numel() + 18 + n_shadow)
    nbytes = 4 * n + 12 * n + tables
    if emit:
        nbytes += 4 * cfg.spp * cfg.bounces * n
    if reads_draws:
        nbytes += 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    bound, by = roofline(nbytes, ops)
    counts = dict(closest_iterations=closest, probes_reached=reached,
                  probes_blocked=blocked,
                  triangle_tests=sum(tests.values()) + blocked,
                  operations=int(ops),
                  whole_tests_bound_ms=roofline(nbytes, whole_ops)[0])
    counts.update({f"est_passed_{k}": v for k, v in passed.items()})
    counts.update({f"est_pass_share_{k}": shares[k + key] for k in tests})
    return bound, by, counts


def path_occupancy(inp: TraceInputs, emit: bool, reads_draws: bool):
    """K2's or K2g's shared memory per block at ``inp``'s shape, from the
    library (held against the wrapper's plan), and the blocks one SM holds
    in this mode."""
    lib = cuda_path._library()
    s, grp = inp.packed.num_spheres, inp.packed.grouped
    if grp is None:
        shape = (inp.num_tris, len(inp.shadow_idx), s)
        smem, plan = (lib.grt_path_static_smem(*shape),
                      cuda_path.static_smem_bytes(*shape))
        supers = (0, 0)
    else:
        supers = (grp.sup.shape[1], grp.shadow_sup.shape[1])
        smem, plan = (lib.grt_path_grouped_smem(s, *supers),
                      cuda_path.grouped_smem_bytes(s, *supers))
    check(smem == plan, f"trace kernel's shared memory {smem} B is not the "
          f"wrapper's plan {plan} B")
    per_sm = lib.grt_path_blocks_per_sm(
        int(grp is not None), int(emit), int(reads_draws), inp.num_tris,
        len(inp.shadow_idx), s, *supers)
    check(per_sm > 0, "the trace kernel's occupancy query failed")
    return smem, per_sm


def resource_fields(res):
    """A ptxas report as a row's fields."""
    return dict(registers=res["registers"], stack_bytes=res["stack_bytes"],
                spill_store_bytes=res["spill_store_bytes"],
                spill_load_bytes=res["spill_load_bytes"])


def shade_occupancy(sh: ShadeInputs, regenerate: bool):
    """K3's or K3g's shared memory per block and blocks per SM for these
    inputs; the exported plans (shared memory, K3g's grid) are held against
    the wrapper's."""
    lib = cuda_shade._library()
    P = sh.table.shape[1]
    sph = sh.table.shape[0] == cuda_shade.NROWS_TAB_SPH
    smem = lib.grt_shade_bwd_smem(P, int(sph), int(sh.grouped))
    plan = (cuda_shade.grouped_smem_bytes(sph) if sh.grouped
            else cuda_shade.static_smem_bytes(P, sph))
    check(smem == plan, f"K3's shared memory {smem} B is not the wrapper's plan "
          f"{plan} B")
    per_sm = lib.grt_shade_bwd_blocks_per_sm(P, int(sph), int(regenerate),
                                             int(sh.grouped))
    check(per_sm > 0, "K3's occupancy query failed")
    if sh.grouped:
        n = sh.cfg.num_pixels
        blocks = lib.grt_shade_bwd_grouped_blocks(n, P, int(sph), int(regenerate))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        check(blocks == cuda_shade.grouped_blocks(n, P, sph, per_sm, sms),
              f"K3g's grid of {blocks} blocks is not the wrapper's plan")
    return smem, per_sm


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
    """What the MIS wrapper and its plain version take, on the card.
    ``grouped``: pack for the grouped tier (K4g and its plain sweep); the
    occluder cull then lives in the shadow table."""

    def __init__(self, scene_name: str, cfg: RenderConfig, cull: bool,
                 grouped=False, scene=None):
        dev = torch.device("cuda")
        self.cfg = cfg
        self.scene = (MIS_ALL_SCENES[scene_name](resolution=cfg.resolution)
                      if scene is None else scene)
        self.num_tris = self.scene.triangles.num_triangles
        occ = potential_occluders(self.scene, cfg) if cull else None
        self.packed = cuda_mis._pack_inputs(self.scene.to(dev), cfg, grouped,
                                            occ)
        self.shadow_idx = cuda_path.shadow_indices(occ, self.num_tris, dev)

    def kernel(self, emit=False):
        return cuda_mis.mis_trace_kernel(
            self.cfg.num_pixels, 0, self.packed, self.shadow_idx, self.cfg,
            emit)

    def plain(self, emit=False, pixel_chunk=None, pix=None, stats=None):
        """The plain version on the whole frame, or on the pixels ``pix``
        (ids, one chunk); ``stats`` takes the grouped sweep's counts."""
        cfg = (self.cfg if pixel_chunk is None
               else self.cfg.replace(pixel_chunk=pixel_chunk))
        if pix is None:
            return cuda_mis.render_mis_plain(
                cfg.num_pixels, 0, self.packed, self.shadow_idx, cfg, emit,
                stats)
        return cuda_mis.render_mis_plain(
            pix.numel(), pix, self.packed, self.shadow_idx,
            cfg.replace(pixel_chunk=pix.numel()), emit, stats)

    def brute(self, emit=False, pix=None):
        """The brute-force plain version (every triangle tested) on the same
        scene and cull, on the whole frame or on the pixels ``pix`` (ids, one
        chunk)."""
        packed = self.packed._replace(grouped=None)
        if pix is None:
            return cuda_mis.render_mis_plain(
                self.cfg.num_pixels, 0, packed, self.shadow_idx, self.cfg,
                emit)
        return cuda_mis.render_mis_plain(
            pix.numel(), pix, packed, self.shadow_idx,
            self.cfg.replace(pixel_chunk=pix.numel()), emit)


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


def check_same_mis_decisions(what, rec_a, rec_b, packed):
    """Two MIS record streams of one frame, traced by the two tiers (or by
    a kernel and the plain version of the other tier), on the same cull:
    the same winners on every lane (primary hit and both lobe rays), the
    same probe bits wherever they feed the image (``mis_live``). Returns the
    number of probe bits that differ on dead lanes (printed, not held: such
    a probe starts from a point nothing reads)."""
    check(torch.equal(rec_a.camera, rec_b.camera),
          f"{what}: primary winners differ")
    fa, fb = mis_fields(rec_a), mis_fields(rec_b)
    for name in ("cos_prim", "vndf_prim"):
        check(torch.equal(fa[name], fb[name]), f"{what}: {name} differs")
    _, live = mis_live(rec_b, packed)
    dead = 0
    for name in ("reach1", "reach2", "reach3"):
        differ = fa[name] != fb[name]
        check(not bool((differ & live[name]).any()),
              f"{what}: {name} differs where it feeds the image")
        dead += int(differ.sum())
    return dead


def mis_work(inp: MisInputs, rec: cuda_mis.MisRecords):
    """What one MIS frame's live lanes need, from its records: the closest
    hits (primary rays, two lobe rays per live sample), the light probes
    that reach the light and those that are blocked, and the operations of
    the shading around them (OPS_MIS_*). Only live lanes count, with records
    as without: a lane whose primary ray missed or landed on the light still
    writes records, but nothing reads them (``mis_live``)."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    rays = cfg.camera_rays * n
    f = mis_fields(rec)
    surf, live = mis_live(rec, inp.packed)
    samples = int(surf.sum()) * (cfg.mis_samples // 3)
    work = dict(rays=rays, live_samples=samples, probes_reached=0,
                probes_blocked=0,
                shading_ops=rays * OPS_MIS_CAMERA + samples * OPS_MIS_SAMPLE)
    for name in ("reach1", "reach2", "reach3"):
        where = live[name].expand_as(f[name])
        reached = int((f[name] & where).sum())
        blocked = int(where.sum()) - reached
        work["probes_reached"] += reached
        work["probes_blocked"] += blocked
        if name != "reach1":
            work["shading_ops"] += (reached * OPS_MIS_SECONDARY
                                    + blocked * OPS_MIS_SECONDARY_BLOCKED)
    return work


def prefilter_shares(inp: MisInputs):
    """The shares of the static tier's triangle tests that pass both of its
    prefilters (``cuda_path.plane_ahead``, ``plane_within``), counted by the
    plain version on every PREFILTER_STRIDE-th pixel of the frame at the
    full camera rays and samples, on live lanes: {"camera": primary rays,
    "closest": lobe rays, "shadow": light probes that reach the light}."""
    pix = torch.arange(0, inp.cfg.num_pixels, PREFILTER_STRIDE,
                       device="cuda")
    stats = {}
    inp.plain(pix=pix, stats=stats)
    return {key: st["passed"] / st["triangles"] for key, st in stats.items()}


def mis_bound(inp: MisInputs, rec: cuda_mis.MisRecords, emit: bool,
              shares: dict):
    """(bound_ms, bound_by, counts) of one static MIS trace from the
    records of this frame: the primitive tests its live rays need — a
    closest hit tests every primitive, a probe that reaches the light every
    occluder, a blocked probe at least one — and the shading of its live
    samples (``mis_work``), against the bytes in and out; ``emit`` adds the
    records' bytes alone. Every triangle test costs OPS_TRI_PREFILTER, and
    the rest of a whole test only the ``shares`` (``prefilter_shares``) that
    pass the prefilters, estimates and so named ``est_``; the one test that
    blocks a probe costs a whole test."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    t, s, n_shadow = inp.num_tris, inp.packed.num_spheres, len(inp.shadow_idx)
    w = mis_work(inp, rec)
    tests = dict(camera=w["rays"] * t, closest=2 * w["live_samples"] * t,
                 shadow=w["probes_reached"] * n_shadow)
    passed = {key: int(tests[key] * shares[key]) for key in tests}
    ops = (sum(tests.values()) * OPS_TRI_PREFILTER
           + (passed["camera"] + passed["closest"])
           * (OPS_TRI_CLOSEST - OPS_TRI_PREFILTER)
           + passed["shadow"] * (OPS_TRI_SHADOW - OPS_TRI_PREFILTER)
           + (w["rays"] + 2 * w["live_samples"]) * s * OPS_SPH_CLOSEST
           + w["probes_reached"] * s * OPS_SPH_SHADOW
           + w["probes_blocked"] * OPS_TRI_SHADOW + w["shading_ops"])
    tables = 4 * sum(x.numel() for x in inp.packed[:6]) + 4 * n_shadow
    nbytes = 12 * n + tables
    if emit:
        nbytes += 4 * w["rays"] * (1 + cfg.mis_samples // 3)
    bound, by = roofline(nbytes, ops)
    counts = dict(live_samples=w["live_samples"],
                  probes_reached=w["probes_reached"],
                  probes_blocked=w["probes_blocked"],
                  traversals=w["rays"] + 2 * w["live_samples"]
                  + w["probes_reached"] + w["probes_blocked"],
                  triangle_tests=sum(tests.values()) + w["probes_blocked"])
    counts.update({f"est_passed_{key}": v for key, v in passed.items()})
    counts.update({f"est_pass_share_{key}": v for key, v in shares.items()})
    return bound, by, counts


def mis_grouped_bound(inp: MisInputs, rec: cuda_mis.MisRecords, stats,
                      scale_rays, scale_samples, emit: bool):
    """(bound_ms, bound_by, counts) of one K4g trace: the box and triangle
    tests on live lanes that the plain sweep counted on a sample of the
    frame at fewer camera rays and samples (``stats`` of
    ``render_mis_plain``: its primary rays times ``scale_rays``, its lobe
    rays and light probes times ``scale_samples``), estimates and so named
    ``est_``; the sphere tests and the shading of this frame's live lanes
    (``mis_work``), counted; against the bytes in and out. The operations
    per test are K2g's (OPS_BOX_*, OPS_SWEEP_RAY, OPS_SHADOW_RAY,
    OPS_TRI_*)."""
    cfg, n, s = inp.cfg, inp.cfg.num_pixels, inp.packed.num_spheres
    scale = dict(camera=scale_rays, closest=scale_samples,
                 shadow=scale_samples)
    est = {f"{loop}_{k}": int(scale[loop] * stats[loop].get(k, 0))
           for loop in scale for k in ("rays", "boxes", "triangles")}
    w = mis_work(inp, rec)
    ops = ((est["camera_boxes"] + est["closest_boxes"]) * OPS_BOX_CLOSEST
           + est["shadow_boxes"] * OPS_BOX_SHADOW
           + (est["camera_rays"] + est["closest_rays"] + est["shadow_rays"])
           * OPS_SWEEP_RAY
           + est["shadow_rays"] * OPS_SHADOW_RAY
           + (est["camera_triangles"] + est["closest_triangles"])
           * OPS_TRI_CLOSEST
           + est["shadow_triangles"] * OPS_TRI_SHADOW
           + (w["rays"] + 2 * w["live_samples"]) * s * OPS_SPH_CLOSEST
           + w["probes_reached"] * s * OPS_SPH_SHADOW + w["shading_ops"])
    grp = inp.packed.grouped
    tables = (sum(t.numel() for t in grp[:6]) + inp.packed.atab.numel()
              + inp.packed.sph.numel() + inp.packed.tabs.numel()
              + cuda_mis.NLIGHT + 12)
    nbytes = 12 * n + 4 * tables
    if emit:
        nbytes += 4 * w["rays"] * (1 + cfg.mis_samples // 3)
    bound, by = roofline(nbytes, int(ops))
    counts = {f"est_{k}": v for k, v in est.items()}
    counts.update(live_samples=w["live_samples"],
                  probes_reached=w["probes_reached"],
                  probes_blocked=w["probes_blocked"], est_operations=int(ops))
    return bound, by, counts


# ---------------------------------------------------------------------------
# The MIS backward kernel: inputs, comparison, bound
# ---------------------------------------------------------------------------

class MisBwdInputs:
    """What the MIS backward wrapper and its plain version take, on the card:
    the records of the MIS kernel's trace of ``scene_name`` (light probes
    culled, as the differentiable path traces), the parameter views, the
    sample table and a cotangent from a seeded generator."""

    def __init__(self, scene_name: str, cfg: RenderConfig, grouped=False,
                 scene=None):
        self.cfg = cfg
        self.grouped = grouped
        self.trace = MisInputs(scene_name, cfg, cull=True, grouped=grouped,
                               scene=scene)
        _, self.records = self.trace.kernel(emit=True)
        views = cuda_mis_bwd._pack_diff_inputs_mis(
            self.trace.scene.to("cuda"), cfg)
        self.table, self.cam, self.light = (v.contiguous() for v in views)
        self.stab = cuda_mis.sample_table(cfg).cuda()
        gen = torch.Generator(device="cuda").manual_seed(4321)
        self.g = torch.randn((3, cfg.num_pixels), generator=gen,
                             device="cuda")

    def _args(self, stab):
        return (self.g, self.records, self.table, self.cam, self.light, stab,
                self.cfg)

    def kernel(self, grouped=None):
        """K5, or K5g where the inputs were traced by K4g (``grouped``
        forces a tier)."""
        return cuda_mis_bwd.mis_bwd_kernel(
            *self._args(self.stab),
            grouped=self.grouped if grouped is None else grouped)

    def plain(self, nudge=False, whole_frame=False):
        """The plain version; with ``nudge`` on a sample table whose cosine
        lobe's w0 row is one ulp up, to measure how well conditioned the
        sums are."""
        stab = self.stab
        if nudge:
            stab = stab.clone()
            row = stab[cuda_mis.TAB_W0C]
            stab[cuda_mis.TAB_W0C] = torch.nextafter(row, row + 1.0)
        args = list(self._args(stab))
        if whole_frame:
            args[-1] = self.cfg.replace(pixel_chunk=self.cfg.num_pixels)
        return cuda_mis_bwd.mis_bwd_plain(*args)


def k5_groups(dtab, dscal):
    """The MIS backward's outputs by what they are the cotangent of."""
    groups = {"d normal": dtab[:, 0:3], "d c0": dtab[:, 3:4],
              "d diffuse": dtab[:, 4:7], "d metallic": dtab[:, 7:8],
              "d roughness": dtab[:, 8:9]}
    if dtab.shape[1] == cuda_mis_bwd.NDIF_SPH:
        groups["d center"] = dtab[:, 10:13]
        groups["d radius"] = dtab[:, 13:14]
    names = ("camera position", "camera u", "camera v", "camera w",
             "light center", "light radiance", "light width", "light depth",
             "light normal", "light tangent", "light bitangent")
    sizes = (3, 3, 3, 3, 3, 3, 1, 1, 3, 3, 3)
    start = 0
    for name, size in zip(names, sizes):
        groups[name] = dscal[start:start + size]
        start += size
    return groups


def compare_scaled(what, k, r, m):
    """Each group of ``k`` within 1e-6 max(scale, 1) + 1e-4 scale of ``r``
    (scale: the group's largest magnitude in ``r``), plus CONDITION_FACTOR
    times the distance from ``r`` to ``m`` (the reference on inputs one ulp
    off); both distances are printed. Returns the largest absolute
    difference."""
    worst, parts = 0.0, []
    for name in r:
        check(bool(torch.isfinite(k[name]).all()),
              f"{what}: {name} not finite")
        scale = r[name].abs().max().item()
        err = (k[name] - r[name]).abs().max().item()
        moved = (m[name] - r[name]).abs().max().item()
        limit = (GRAD_ATOL * max(scale, 1.0) + GRAD_RTOL * scale
                 + CONDITION_FACTOR * moved)
        parts.append(f"{name} {err / (scale or 1.0):.1e} "
                     f"({moved / (scale or 1.0):.1e})")
        check(err <= limit, f"{what}: {name} differs by {err:.3e} (largest "
              f"magnitude {scale:.3e}, limit {limit:.3e})")
        worst = max(worst, err)
    log(f"  {what}: largest difference over largest magnitude (and how far "
        "a one-ulp nudge of an input moves the plain version): "
        + ", ".join(parts))
    return worst


def compare_k5(what, got, ref, nudged):
    """``compare_scaled`` by K5's groups, the nudge on a sample-table row.
    The selector columns must be zero."""
    dtab = got[0]
    check(not dtab[:, 9].any() and (dtab.shape[1] == cuda_mis_bwd.NDIF
                                    or not dtab[:, 14].any()),
          f"{what}: a selector column has a cotangent")
    return compare_scaled(what, *(k5_groups(*x) for x in (got, ref, nudged)))


def k5_bound(inp: MisBwdInputs):
    """(bound_ms, bound_by, counts) of one MIS backward from the records it
    replays: the operations of the paths these records need (OPS_K5_*)
    against the cotangent, the camera records, the sample records of the
    camera rays on a surface and the tables read once, the outputs written
    once."""
    cfg, rec = inp.cfg, inp.records
    is_em = inp.table[9] > 0.5
    n_tris = inp.trace.num_tris

    def on_geometry(code):
        return (code > 0) & ~is_em[(code.long() - 1).clamp_min(0)]

    surf = on_geometry(rec.camera)                     # [rays, n]
    f = mis_fields(rec)
    live = surf[:, None, :]
    counts = dict(surf_rays=int(surf.sum()),
                  live_samples=int(surf.sum()) * (cfg.mis_samples // 3),
                  light=int((f["reach1"] & live).sum()))
    ops = (counts["surf_rays"] * OPS_K5_HOIST
           + counts["light"] * OPS_K5_LIGHT
           + int((surf & (rec.camera > n_tris)).sum()) * OPS_K5_SPHERE_HIT)
    for lobe, reach, on_light_ops, on_geo_ops in (
            ("cos_prim", "reach2", OPS_K5_COS_ON_LIGHT, OPS_K5_COS_ON_GEO),
            ("vndf_prim", "reach3", OPS_K5_VNDF_ON_LIGHT, OPS_K5_VNDF_ON_GEO)):
        code = f[lobe]
        geo = on_geometry(code) & live & f[reach]
        on_light = (code > 0) & live & ~on_geometry(code)
        counts[f"{lobe[:-5]}_on_light"] = int(on_light.sum())
        counts[f"{lobe[:-5]}_on_geometry"] = int(geo.sum())
        ops += (int(on_light.sum()) * on_light_ops + int(geo.sum()) * on_geo_ops
                + int((geo & (code > n_tris)).sum()) * OPS_K5_SPHERE_HIT)
    outputs = inp.table.numel() + cuda_mis_bwd.NSCAL
    nbytes = (12 * cfg.num_pixels + 4 * rec.camera.numel()
              + 4 * counts["live_samples"] + 4 * outputs
              + 4 * (inp.stab.numel() + cuda_mis_bwd.NSCAL))
    bound, by = roofline(nbytes, ops)
    counts["operations"] = ops
    return bound, by, counts


def k5_lane_shares(inp: MisBwdInputs):
    """How full K5's warps are in its three strategy calls, from the records
    it replays. A warp is 32 consecutive pixels of one camera ray; at each
    sample a strategy's call issues where the gate of any of its lanes is
    open (the light: the camera ray on a surface and the light sample
    reached; a lobe: the camera ray on a surface and the lobe ray on the
    light, or on geometry whose light sample was reached). Per strategy:
    the open lanes over 32 x the warp-samples in which the call issues
    (``lane_share_*``), and the share of warp-samples in which it issues
    (``issue_share_*``)."""
    rec = inp.records
    is_em = inp.table[9] > 0.5

    def winner(code, emissive):
        return (code > 0) & (is_em[(code.long() - 1).clamp_min(0)] == emissive)

    surf = winner(rec.camera, False)[:, None, :]
    f = mis_fields(rec)
    gates = dict(
        light=surf & f["reach1"],
        cos=surf & (winner(f["cos_prim"], True)
                    | (winner(f["cos_prim"], False) & f["reach2"])),
        vndf=surf & (winner(f["vndf_prim"], True)
                     | (winner(f["vndf_prim"], False) & f["reach3"])))
    out = {}
    for name, gate in gates.items():
        pad = -gate.shape[-1] % 32
        warps = torch.nn.functional.pad(gate, (0, pad)).unflatten(-1, (-1, 32))
        issued = int(warps.any(dim=-1).sum())
        out[f"lane_share_{name}"] = (int(warps.sum()) / (32 * issued)
                                     if issued else 0.0)
        out[f"issue_share_{name}"] = issued / warps[..., 0].numel()
    return out


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
            for kernel in ("silh_kernel", "soft_bwd_kernel"):
                if kernel in mangled:
                    name = kernel
            m = re.search(r"draws_kernelILi(\d)EE", mangled)
            if m:
                name = f"draws_kernel<BOUNCES={m.group(1)}>"
            m = re.search(r"mis_kernelILb(\d)EE", mangled)
            if m:
                name = f"mis_kernel<EMIT={m.group(1)}>"
            m = re.search(r"mis_grouped_kernelILb(\d)ELb(\d)EE", mangled)
            if m:
                name = (f"mis_grouped_kernel<EMIT={m.group(1)}, "
                        f"WIDE={m.group(2)}>")
            m = re.search(r"mis_bwd(_grouped)?_kernelILb(\d)E", mangled)
            if m:
                name = f"mis_bwd{m.group(1) or ''}_kernel<SPH={m.group(2)}>"
            m = re.search(r"path_kernelILb(\d)ELb(\d)EE", mangled)
            if m:
                name = (f"path_kernel<EMIT={m.group(1)}, "
                        f"READ_DRAWS={m.group(2)}>")
            m = re.search(r"path_grouped_kernelILb(\d)ELb(\d)ELb(\d)EE",
                          mangled)
            if m:
                name = (f"path_grouped_kernel<EMIT={m.group(1)}, "
                        f"READ_DRAWS={m.group(2)}, WIDE={m.group(3)}>")
            m = re.search(r"shade_bwd(_grouped)?_kernelILb(\d)ELb(\d)E",
                          mangled)
            if m:
                name = (f"shade_bwd{m.group(1) or ''}_kernel<SPH="
                        f"{m.group(2)}, RNG={m.group(3)}>")
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


def sass_by_function(lib_path) -> dict:
    """{mangled kernel name: its SASS text} of a built library. nvcc names a
    source's anonymous namespace after a hash of the file's path, so that
    name is replaced by one that two checkouts share; blanks are collapsed."""
    cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", text)
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        # A function's listing ends at a line of dots; what follows the last
        # one (the rest of the file's listing) is not its code. cuobjdump pads
        # every line to the widest instruction of the whole file, so runs of
        # blanks count as one.
        body = re.split(r"\n\s*\.{5,}\s*(?:\n|$)", body)[0]
        out[name.strip()] = re.sub(r"[ \t]+", " ", body)
    return out


def sass_opcodes(lib_path, kernel: str) -> dict:
    """{opcode with its modifiers: count} over the SASS of the kernels of a
    library whose name holds ``kernel``, NOPs left out."""
    counts = {}
    for name, body in sass_by_function(lib_path).items():
        if kernel not in name:
            continue
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/ (?:@!?U?P[T0-9] )?([A-Z][A-Z0-9_.]*)",
                             body):
            if m.group(1) != "NOP":
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def sass_short_path(lib_path, kernel: str) -> list:
    """[(address, opcode)] of the SASS a thread of the first kernel whose
    name holds ``kernel`` runs when it takes every forward conditional
    branch and never calls out: the instructions before the kernel's
    out-of-line callee (the target of its first CALL), less each block that
    such a branch skips. For K1 at the Halton sampler and an index below
    HALTON_SHORT those blocks are the call to the loop form and the
    stratified sampler's cell placement. NOPs left out."""
    body = next(b for name, b in sass_by_function(lib_path).items() if kernel in name)
    ins = [(int(a, 16), guard, op, rest) for a, guard, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/ (@!?U?P[T0-9] )?([A-Z][A-Z0-9_.]*)([^;]*);", body)
        if op != "NOP"]
    end = min([int(rest.split()[0], 16) for _, _, op, rest in ins if op.startswith("CALL")]
              or [ins[-1][0] + 16])
    skipped = [(a + 16, int(rest.split()[0], 16)) for a, guard, op, rest in ins
               if op == "BRA" and guard and a < end and int(rest.split()[0], 16) > a]
    return [(a, op) for a, _, op, _ in ins
            if a < end and not any(lo <= a < hi for lo, hi in skipped)]


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
    resources = {}
    for lib in libs:
        # Three libraries hold a reduce_partials_kernel (reduce.cuh).
        source = lib.path.name.split("-")[0][3:]
        for name, res in ptxas_resources(lib.log).items():
            resources[name if name not in resources
                      else f"{name} ({source})"] = res
    for name, res in resources.items():
        log(f"  ptxas: {name}: {res['registers']} registers, "
            f"{res['stack_bytes']} B stack, {res['spill_store_bytes']} B "
            f"spill stores, {res['spill_load_bytes']} B spill loads")
    check(len(resources) == 36, "ptxas did not report the draws kernel's four "
          "instantiations (1 to 4 bounces), the "
          "three static trace-kernel instantiations, the six grouped ones "
          "(with and without the wide sweep), the eight "
          "backward-kernel instantiations (static and grouped), the three "
          "reductions, the "
          "six MIS-kernel instantiations (static, grouped, "
          "grouped with the wide sweep), the four MIS-backward "
          "instantiations (static and grouped), the silhouette record kernel "
          f"and its backward: {resources}\n{logs}")
    if shutil.which("g++"):
        start = time.perf_counter()
        native.load(strict=True)
        log(f"  native library {native.library_path().name} loaded in "
            f"{time.perf_counter() - start:.1f} s (g++ build included)")
    smi = card_name_and_limit()
    log(f"  card: {smi}")
    return resources, smi


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


# K1's exhaustive check: one sample at four bounces (dims 0-5, 7-10, 12-15,
# 17-20: every dimension a render draws from), at every index below
# EXHAUSTIVE_SPAN, at as many seeded random int32 offsets (the kernel reads an
# offset as uint32, so they reach 2^32 - 1), and at every base's boundaries
# B^k - 1 and B^k below 2^32, with 2^32 - 1 itself.
EXHAUSTIVE_SPAN = 1 << 22
EXHAUSTIVE_SEED = 13


def halton_boundaries() -> list:
    """B^k - 1 and B^k below 2^32 for every prime base, and 2^32 - 1."""
    out = [(1 << 32) - 1]
    for b in PRIMES:
        p = b
        while p < (1 << 32):
            out += [p - 1, p]
            p *= b
    return out


def check_draws_exhaustive():
    """K1's six planes bit-equal to the plain version's on the card at the
    indices above, at one sample and four bounces."""
    cfg = RenderConfig(width=1, height=1, spp=1, bounces=4)
    gen = torch.Generator(device="cuda").manual_seed(EXHAUSTIVE_SEED)
    bounds = torch.tensor(halton_boundaries(), dtype=torch.int64, device="cuda")
    offsets = torch.cat([
        torch.arange(EXHAUSTIVE_SPAN, dtype=torch.int32, device="cuda"),
        torch.randint(-(1 << 31), 1 << 31, (EXHAUSTIVE_SPAN,), generator=gen,
                      dtype=torch.int32, device="cuda"),
        (bounds - (bounds >= (1 << 31)).long() * (1 << 32)).to(torch.int32)])
    start = time.perf_counter()
    compare_draws(f"K1 exhaustive: {offsets.numel()} indices (all below "
                  f"{EXHAUSTIVE_SPAN}, as many random uint32, the bases' "
                  "boundaries), 1 sample x 4 bounces",
                  cuda_path.pregen_draws_kernel(offsets, cfg),
                  cuda_path.pregen_draws_plain(offsets, cfg))
    log(f"  K1 exhaustive check took {time.perf_counter() - start:.1f} s")


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
    check_static_limit()
    check_draws_exhaustive()
    for key in ("draws", "hdr", "emit", "bwd"):
        log(f"  128 x 96 x 4 spp, cornell: {key}: plain "
            f"{plain_ms[key][1]:.3f} ms, kernel "
            f"{plain_ms['k_' + key][1]:.3f} ms (median of 5)")
    return plain_ms


def check_static_limit():
    """K3 at the most primitives its static tier takes with spheres, whose
    block fills one block's most of shared memory (opted in past 48 KiB),
    against its plain version; the rows of the spheres behind the back wall
    stay 0."""
    cfg = RenderConfig(**SMALL)
    most = static_bwd_max_sph()
    sh = ShadeInputs(None, cfg, scene=spheres_at_static_limit(
        cfg.resolution, prims=most))
    P, hidden = sh.table.shape[1], slice(12, most - 2)
    check(P == most, f"the scene at the static limit has {P} primitives")
    smem, per_sm = shade_occupancy(sh, regenerate=False)
    check(smem > 48 * 1024, f"K3 at the static limit takes {smem} B")
    k, again = sh.kernel(), sh.kernel()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k, again)),
          "K3 at the static limit: two launches on the same inputs differ")
    ref = sh.plain()
    check(not k[0][hidden].any() and not ref[0][hidden].any(),
          "K3 at the static limit: a sphere no ray reaches has a cotangent")
    check(ref[0][P - 2:].abs().sum() > 0, "K3 at the static limit: the box's "
          "spheres in the table's last rows have no cotangent")
    tag = f"K3 cornell-spheres + {P - 14} hidden spheres ({smem} B, {per_sm} per SM)"
    compare_grads(tag, k, ref, nudged=sh.plain(nudge=True))


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


def phase_mis_bwd():
    """The MIS backward kernel against its plain version on the same records
    and cotangent, three scenes at two sizes, and two launches bit-equal;
    then its path, ``render_mis_decoupled``, against the oracle backward of
    ``render_mis_cuda`` on scenes that ask for gradients."""
    log("== mis_bwd: the MIS backward kernel against its plain version")
    worst = {}
    for size in (MIS_SMALL, MIS_BWD_MID):
        cfg = RenderConfig(integrator="mis", **size)
        for scene_name in MIS_SCENES:
            tag = (f"K5 {scene_name} {cfg.width}x{cfg.height} x "
                   f"{cfg.camera_rays} x {cfg.mis_samples}")
            inp = MisBwdInputs(scene_name, cfg)
            got, again = inp.kernel(), inp.kernel()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{tag}: two launches on the same inputs differ")
            worst[tag] = compare_k5(tag, got, inp.plain(),
                                    inp.plain(nudge=True))

    cfg = RenderConfig(integrator="mis", **MIS_SMALL)
    log(f"== mis_bwd: the gradients of render_mis_decoupled(scene).mean(), "
        f"{cfg.width} x {cfg.height} x {cfg.camera_rays} x {cfg.mis_samples}")
    for scene_name in MIS_SCENES:
        ctor = MIS_SCENES[scene_name]
        scene = with_grad(ctor(resolution=cfg.resolution))
        occluders = potential_occluders(scene, cfg)
        reset_launches()
        got = scene_grads(scene, cuda_mis_bwd.render_mis_decoupled(
            scene, cfg, occluders=occluders))
        launched = read_launches()
        check(launched["mis_kernel"] == 1 and launched["mis_bwd_kernel"] == 1,
              f"render_mis_decoupled with gradients launched {launched}")
        # The same records, autograd through the replay built from the
        # forwards alone.
        ref_scene = with_grad(ctor(resolution=cfg.resolution))
        _, rec = cuda_mis.render_mis_cuda_impl(
            ref_scene.detach(), cfg, emit_records=True, occluders=occluders)
        views = cuda_mis_bwd._pack_diff_inputs_mis(ref_scene, cfg)
        replay = cuda_mis_bwd.replay_mis(*views, rec,
                                         cuda_mis.sample_table(cfg).cuda(),
                                         cfg)
        ref = scene_grads(ref_scene, replay.T.reshape(cfg.height, cfg.width,
                                                      3))
        check(set(got) == set(ref) and len(ref) >= 12,
              f"gradient groups {sorted(got)} against {sorted(ref)}")
        parts = []
        for name, r in ref.items():
            scale = r.abs().max().item()
            err = (got[name] - r).abs().max().item()
            check(bool(torch.isfinite(got[name]).all()), f"{name}: not finite")
            check(err <= GRAD_ATOL * max(scale, 1.0) + GRAD_RTOL * scale,
                  f"K5 path, {scene_name}: d {name} differs from autograd "
                  f"through the replay by {err:.3e} (largest magnitude "
                  f"{scale:.3e})")
            parts.append(f"{name} {err / max(scale, 1.0):.1e}")
        log(f"  K5 path vs autograd through the replay of the same records, "
            f"{scene_name}, {len(ref)} groups, largest difference over "
            "max(largest magnitude, 1): " + ", ".join(parts))

        # The oracle backward retraces with the eager oracle's own
        # decisions. On the triangle scenes they are the trace kernel's; on
        # the sphere scene an ulp flips grazing sphere decisions, which carry
        # large geometry gradients: the distance is printed there.
        o_scene = with_grad(ctor(resolution=cfg.resolution))
        oracle = scene_grads(o_scene, cuda_mis.render_mis_cuda(o_scene, cfg))
        parts, n_beyond = [], 0
        for name, r in oracle.items():
            scale = max(r.abs().max().item(), 1.0)
            d = (got[name] - r).abs()
            n_out = int((d > MIS_ORACLE_ATOL * scale
                         + MIS_ORACLE_RTOL * r.abs()).sum())
            n_beyond += n_out
            parts.append(f"{name} {d.max().item() / scale:.1e}"
                         + (f" ({n_out} beyond)" if n_out else ""))
        log(f"  K5 path vs the oracle backward, {scene_name}: "
            + ", ".join(parts))
        if scene_name != "cornell-spheres":
            check(n_beyond == 0, f"K5 path, {scene_name}: {n_beyond} "
                  f"gradient elements differ from the oracle backward beyond "
                  f"atol {MIS_ORACLE_ATOL} max(scale, 1) / rtol "
                  f"{MIS_ORACLE_RTOL}")
    return worst


def phase_mis_train():
    """Path I: gradients of ``render_mis_decoupled(scene).mean()`` for every
    float tensor of the scene at 512 x 512 x 6 camera rays x 300 samples,
    occluder mask made once; warm steps on the host clock, one MIS kernel and
    one MIS backward launch per step; then steps under the profiler for the
    card's busy share. Box scene and sphere scene."""
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    out = {}
    for scene_name in ("cornell", "cornell-spheres"):
        log(f"== I: gradients of render_mis_decoupled(scene).mean(), "
            f"{scene_name}, {cfg.width}x{cfg.height} x {cfg.camera_rays} x "
            f"{cfg.mis_samples}")
        scene = with_grad(SCENES[scene_name](resolution=cfg.resolution))
        occluders = potential_occluders(scene, cfg)

        def one_step():
            hdr = cuda_mis_bwd.render_mis_decoupled(scene, cfg,
                                                    occluders=occluders)
            return hdr, scene_grads(scene, hdr)

        reset_launches()
        step_ms, grads, hdr = [], {}, None
        for step in range(4):
            before = read_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            hdr, grads = one_step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - start))
            after = read_launches()
            per_step = {k: after[k] - before[k] for k in after}
            check(per_step == launches_of(mis_kernel=1, mis_bwd_kernel=1),
                  f"path I step {step}: launches {per_step}")
        launches = read_launches()
        check(hdr.shape == (cfg.height, cfg.width, 3)
              and bool(torch.isfinite(hdr).all()), "path I: image")
        check(len(grads) >= 12 and all(bool(torch.isfinite(g).all())
                                       for g in grads.values()),
              f"path I: gradients {sorted(grads)}")
        for name in ("light.emitted_radiance", "light.center",
                     "triangles.verts", "triangles.roughness",
                     "camera.position"):
            check(grads[name].abs().max().item() > 0.0,
                  f"path I: gradient of {name} is all zero")
        warm = step_ms[1:]
        mrays = [nominal_rays(cfg) / (ms / 1e3) / 1e6 for ms in warm]
        wall_ms, busy_ms, top = device_busy(lambda: [one_step()
                                                     for _ in range(2)])
        share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
        log(f"  path I {scene_name}: step times " + ", ".join(
            f"{t:.1f}" for t in step_ms) + " ms (host clock, the first with "
            "warm-up), " + ", ".join(f"{m:.1f}" for m in mrays) + " Mrays/s "
            f"warm; under the profiler {wall_ms / 2:.1f} ms per step of which "
            f"the card is busy {busy_ms / 2:.1f} ms ({share}); most device "
            "time: " + ", ".join(f"{name} {ms / 2:.3f} ms" for name, ms in top)
            + f"; launches {launches}")
        out[scene_name] = dict(steps_ms=step_ms, warm_mrays_per_s=mrays,
                               profiled_ms=wall_ms / 2,
                               device_busy_ms=busy_ms / 2, launches=launches)
    return out


def mis_bwd_rows(path_i, resources):
    """The MIS backward kernel at path I's shapes, as path I launches it:
    against its plain version on the whole frame, its time and its bound
    from the records of the same frame."""
    rows = []
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    for scene_name in ("cornell", "cornell-spheres"):
        inp = MisBwdInputs(scene_name, cfg)
        got, again = inp.kernel(), inp.kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 at I, {scene_name}: two launches differ")
        start = time.perf_counter()
        ref = inp.plain(whole_frame=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        err = compare_k5(f"K5 at I, {scene_name}", got, ref,
                         inp.plain(nudge=True, whole_frame=True))
        del ref
        torch.cuda.empty_cache()
        k_ms = time_ms(inp.kernel)
        bound, by, counts = k5_bound(inp)
        shares = k5_lane_shares(inp)
        smem, per_sm = static_bwd_occupancy(inp)
        sph = int(inp.table.shape[0] == cuda_mis_bwd.NDIF_SPH)
        res = resources[f"mis_bwd_kernel<SPH={sph}>"]
        row = dict(
            name=f"mis_bwd_kernel[{scene_name}]", route="cuda",
            source=MIS_BWD_SOURCE, replaces=MIS_BWD_REPLACES,
            shape=f"I: {cfg.width}x{cfg.height} x {cfg.camera_rays} camera "
                  f"rays x {cfg.mis_samples} samples, {inp.trace.num_tris} "
                  f"triangles, {inp.trace.packed.num_spheres} spheres",
            launches=path_i[scene_name]["launches"]["mis_bwd_kernel"],
            max_abs_err=err, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            registers=res["registers"], stack_bytes=res["stack_bytes"],
            spill_store_bytes=res["spill_store_bytes"],
            spill_load_bytes=res["spill_load_bytes"], smem_bytes=smem,
            blocks_per_sm=per_sm, **shares, **counts)
        rows.append(row)
        log(f"  {row['name']} @ {row['shape']}: kernel {k_ms[1]:.3f} ms (min "
            f"{k_ms[0]:.3f}, max {k_ms[2]:.3f}), bound {bound:.3f} ms by {by}, "
            f"plain {plain_ms:.1f} ms, launches {row['launches']}, "
            f"{res['registers']} registers, {res['stack_bytes']} B stack, "
            f"{smem} B shared, {per_sm} blocks per SM; lanes "
            + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
            + f"; {counts}")
        del inp, got, again
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The silhouette kernels: inputs, comparisons, bounds, phases
# ---------------------------------------------------------------------------

def soft_cfg(size) -> RenderConfig:
    return RenderConfig(integrator="direct", bounces=1, **size)


class SoftInputs:
    """What the silhouette kernels and their plain versions take, on the
    card, for the sphere scene: the packed tables, offsets and shadow list
    (occluder cull or not), ``silh_kernel``'s own records of the frame, the
    parameter views and a cotangent from a seeded generator, divided by spp
    as the autograd glue hands it over."""

    def __init__(self, cfg: RenderConfig, cull: bool, scene=None):
        dev = torch.device("cuda")
        self.cfg = cfg
        self.scene = scene or cornell_box_with_spheres(resolution=cfg.resolution)
        self.packed = cuda_path._pack_inputs(self.scene.to(dev), cfg)
        self.offsets = pixel_rng_offsets(cfg, dev)
        self.offsets_i32 = self.offsets.to(torch.int32).contiguous()
        self.num_tris = self.scene.triangles.num_triangles
        occ = potential_occluders(self.scene, cfg) if cull else None
        self.shadow_idx = cuda_path.shadow_indices(occ, self.num_tris, dev)
        self.codes = self.silh_kernel()
        views = cuda_shade._pack_diff_inputs(self.scene.to(dev), cfg)
        self.table, self.cam, self.light = (v.contiguous() for v in views)
        gen = torch.Generator(device="cuda").manual_seed(2468)
        self.g = torch.randn((3, cfg.num_pixels), generator=gen,
                             device="cuda") / cfg.spp

    def silh_kernel(self):
        return cuda_soft.silh_records_kernel(self.offsets_i32, self.packed,
                                             self.shadow_idx, self.cfg)

    def silh_plain(self):
        return cuda_soft.silh_records_plain(self.offsets, self.packed,
                                            self.shadow_idx, self.cfg)

    def bwd_kernel(self):
        return cuda_soft.soft_bwd_kernel(
            self.g, self.codes, self.offsets_i32, self.table, self.cam,
            self.light, self.cfg, SOFT_KAPPA, self.num_tris)

    def bwd_plain(self, nudge=False):
        """The plain version; with ``nudge`` on a camera whose w vector is
        one ulp up (every ray moves by about an ulp), to measure how well
        conditioned the sums are."""
        cam = self.cam
        if nudge:
            cam = cam.clone()
            cam[9:12] = torch.nextafter(cam[9:12], cam[9:12] + 1.0)
        return cuda_soft.soft_bwd_plain(
            self.g, self.codes, self.offsets, self.table, cam, self.light,
            self.cfg, SOFT_KAPPA, self.num_tris)


def compare_codes(what, got, ref):
    """Silhouette records of the kernel against the plain version's, field
    by field. Every record is a decision the backward reads; the share that
    differs is held to FLIP_SHARE_MAX and printed. Returns (share, largest
    difference of the codes as integers)."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: records {tuple(got.shape)} {got.dtype}")
    differ = got != ref
    share = differ.float().mean().item()
    fields = {"background winner": cuda_soft.B_OCCB - 1,
              "occ_bg": cuda_soft.B_OCCB, "occ_s": cuda_soft.B_OCCS,
              "sphere_front": cuda_soft.B_FRONT,
              "potential": cuda_soft.B_POT, "s*": -cuda_soft.B_SIDX}
    counts = {name: int(((got & m) != (ref & m)).sum())
              for name, m in fields.items()}
    err = float((got.long() - ref.long()).abs().max()) if share else 0.0
    log(f"  {what}: {int(differ.sum())} of {got.numel()} records differ "
        f"({share:.3e}; by field {counts})"
        + ("; bit-equal" if not share else ""))
    check(share <= FLIP_SHARE_MAX, f"{what}: {share:.4%} of the records "
          f"differ from the plain version (limit {FLIP_SHARE_MAX:.2%})")
    return share, err


def silh_probe_counts(inp: SoftInputs):
    """K6's shadow probes as it runs them, counted by its plain version on
    every PREFILTER_STRIDE-th pixel of the frame: the share of the probes
    that reach the light (of both probes of every item), and of their
    triangle tests (every occluder) the share that passes both prefilters."""
    pix = torch.arange(0, inp.cfg.num_pixels, PREFILTER_STRIDE,
                       device=inp.offsets.device)
    stats = {}
    cuda_soft.silh_records_plain(inp.offsets[pix], inp.packed, inp.shadow_idx,
                                 inp.cfg.replace(pixel_chunk=pix.numel()),
                                 pix=pix, stats=stats)
    return dict(reached=stats["reached"] / (stats["reached"] + stats["blocked"]),
                passed=stats["passed"] / max(stats["triangles"], 1))


def silh_bound(inp: SoftInputs):
    """(bound_ms, bound_by, counts) of one silhouette record pass: every
    (sample, pixel) needs its record, so every lane's tests count: T
    closest-hit tests (each to its divide) and S sphere tests, two shadow
    probes, the rest of the lane and its four radical inverses, against the
    offsets read and the records written once. A probe that reaches the
    light tests every occluder at OPS_TRI_PREFILTER and the rest of a whole
    test only where both prefilters pass, then every sphere; a blocked probe
    at least one whole test (the records give both counts; the share that
    passes is ``silh_probe_counts``', an estimate and so named ``est_``).
    ``whole_tests_bound_ms``: every probe testing every occluder and sphere
    to its divide, the count of the previous design."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    t, s, n_shadow = inp.num_tris, inp.packed.num_spheres, len(inp.shadow_idx)
    _, occ_b, occ_s, _, _, _ = cuda_soft._decode(inp.codes)
    blocked = int(occ_b.sum() + occ_s.sum())
    reached = 2 * cfg.spp * n - blocked
    share = silh_probe_counts(inp)["passed"]
    lane = (t * OPS_TRI_CLOSEST + s * OPS_SPH_CLOSEST + OPS_SILH_LANE
            + halton_dim_ops(range(4), cfg))
    passed = int(reached * n_shadow * share)
    ops = (cfg.spp * n * lane
           + reached * (n_shadow * OPS_TRI_PREFILTER + s * OPS_SPH_SHADOW)
           + passed * (OPS_TRI_SHADOW - OPS_TRI_PREFILTER)
           + blocked * OPS_TRI_SHADOW)
    whole_ops = cfg.spp * n * (lane + 2 * (n_shadow * OPS_TRI_SHADOW
                                           + s * OPS_SPH_SHADOW))
    tables = 4 * (inp.packed.tri.numel() + inp.packed.sph.numel() + 18
                  + n_shadow)
    nbytes = 4 * n + 4 * cfg.spp * n + tables
    bound, by = roofline(nbytes, ops)
    return bound, by, dict(probes_reached=reached, probes_blocked=blocked,
                           est_pass_share_probe=share, est_passed_probe=passed,
                           operations=int(ops),
                           whole_tests_bound_ms=roofline(nbytes, whole_ops)[0])


def soft_bwd_bound(inp: SoftInputs):
    """(bound_ms, bound_by, counts) of one silhouette backward from the
    records it replays: per (sample, pixel) the camera ray and the jitter
    and light draws; the sphere layer where the sphere is in front or the
    coverage counts; its reverse where it is in front (with the light
    sample's unless blocked); the coverage where ``potential``; the
    background where its value counts (a hit not behind a front sphere, or
    under a coverage lane) and its reverse on a visible, unblocked surface.
    Bytes: cotangent, records, offsets and tables read, outputs written."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    prim, occ_b, occ_s, front, pot, _ = cuda_soft._decode(inp.codes)
    bg_hit = prim >= 0
    surf = bg_hit & ~(inp.table[10, prim.clamp_min(0)] > 0.5)
    bg_needed = bg_hit & (pot | ~front)
    counts = dict(
        lanes=cfg.spp * n, sphere=int((front | pot).sum()),
        front=int(front.sum()), front_lit=int((front & ~occ_s).sum()),
        potential=int(pot.sum()), background=int(bg_needed.sum()),
        background_surface=int((bg_needed & surf).sum()),
        background_reversed=int((~front & surf & ~occ_b).sum()))
    ops = (counts["lanes"] * (OPS_K7_CAMERA + halton_dim_ops(range(4), cfg))
           + counts["sphere"] * (OPS_K7_SPHERE_FWD + OPS_K7_SHADE_FWD)
           + counts["front"] * OPS_K7_SPHERE_REV
           + counts["front_lit"] * OPS_K7_SHADE_REV
           + counts["potential"] * OPS_K7_COVER
           + counts["background"] * OPS_K7_BG_HIT
           + counts["background_surface"] * (OPS_K7_BG_SURF
                                             + OPS_K7_SHADE_FWD)
           + counts["background_reversed"] * (OPS_K7_BG_REV
                                              + OPS_K7_SHADE_REV))
    P = inp.table.shape[1]
    nbytes = (12 * n + 4 * inp.codes.numel() + 4 * n
              + 4 * (inp.table.numel() + cuda_soft.NSCAL_SOFT)
              + 4 * (P * cuda_shade.NTAB_SPH + cuda_soft.NSCAL_SOFT))
    bound, by = roofline(nbytes, ops)
    counts["operations"] = ops
    return bound, by, counts


def soft_scene_at_limit(resolution):
    """cornell-spheres with seeded small triangles and spheres after its own
    (its primitives keep their rows), to the most the silhouette path takes:
    64 triangles and 127 spheres, P = 191. The added ones lie behind the back
    wall, where no camera ray or shadow probe reaches them, so that no
    silhouette of theirs grazes a pixel."""
    scene = cornell_box_with_spheres(resolution=resolution)
    tris, own = scene.triangles, scene.spheres
    n_tri = cuda_path.STATIC_TIER_MAX - tris.num_triangles
    n_sph = cuda_soft.MAX_SPHERES - own.center.shape[0]
    rng = np.random.default_rng(cuda_soft.MAX_PRIMS)
    behind = ((-2.0, -2.0, -4.0), (2.0, 2.0, -3.0))
    verts = (rng.uniform(*behind, (n_tri, 1, 3))
             + rng.uniform(-0.2, 0.2, (n_tri, 3, 3))).astype(np.float32)
    extra = dict(verts=verts, diffuse=rng.uniform(0.2, 0.9, (n_tri, 3)),
                 metallic=np.zeros(n_tri), roughness=np.full(n_tri, 0.5),
                 emissive=np.zeros((n_tri, 3)))
    tris = dataclasses.replace(tris, **{
        name: torch.cat([getattr(tris, name),
                         torch.as_tensor(value, dtype=torch.float32)])
        for name, value in extra.items()})
    spheres = make_spheres(
        centers=rng.uniform(*behind, (n_sph, 3)), radii=rng.uniform(0.1, 0.3, n_sph),
        materials=[dict(diffuse=tuple(rng.uniform(0.2, 0.9, 3)),
                        roughness=float(rng.uniform(0.2, 0.8))) for _ in range(n_sph)])
    spheres = dataclasses.replace(own, **{
        f.name: torch.cat([getattr(own, f.name), getattr(spheres, f.name)])
        for f in dataclasses.fields(own)})
    return dataclasses.replace(scene, triangles=tris, spheres=spheres)


def check_soft_limit():
    """The silhouette path at the most primitives it takes (64 triangles and
    127 spheres, ``soft_scene_at_limit``), where K7's block opts in past 48
    KiB of shared memory: ``render_direct_soft_fused`` with gradients
    launches K2, K6 and K7 once each and gives finite gradients; K6 against
    its plain version, K7 against its plain version, two launches of each
    equal; the rows of the added primitives, which no ray reaches, stay 0."""
    cfg = soft_cfg(SOFT_SIZES[0])
    scene = soft_scene_at_limit(cfg.resolution)
    shape = f"{cfg.width}x{cfg.height} x {cfg.spp}"
    grad_scene = with_grad(scene)
    reset_launches()
    hdr = cuda_soft.render_direct_soft_fused(grad_scene, cfg, SOFT_KAPPA)
    grads = scene_grads(grad_scene, hdr)
    launched = read_launches()
    check(launched == launches_of(path_kernel=1, silh_kernel=1,
                                  soft_bwd_kernel=1),
          f"render_direct_soft_fused at the limit launched {launched}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "render_direct_soft_fused at the limit: a gradient is not finite")
    inp = SoftInputs(cfg, cull=False, scene=scene)
    P = inp.table.shape[1]
    check(P == cuda_soft.MAX_PRIMS, f"the scene at the limit has {P} primitives")
    occ = soft_occupancy(inp)
    check(occ["bwd_smem_bytes"] > 48 * 1024,
          f"K7 at the limit takes {occ['bwd_smem_bytes']} B")
    again = inp.silh_kernel()
    torch.cuda.synchronize()
    check(torch.equal(again, inp.codes), f"K6 at the limit {shape}: two launches differ")
    compare_codes(f"K6 at the limit {shape}", inp.codes, inp.silh_plain())
    got, again = inp.bwd_kernel(), inp.bwd_kernel()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K7 at the limit {shape}: two launches differ")
    ref = inp.bwd_plain()
    own = cornell_box_with_spheres(resolution=cfg.resolution)
    tris, spheres = own.triangles.num_triangles, own.spheres.num_spheres
    added = torch.cat([torch.arange(tris, inp.num_tris),
                       torch.arange(inp.num_tris + spheres, P)])
    check(not got[0][added].any() and not ref[0][added].any(),
          "K7 at the limit: a primitive no ray reaches has a cotangent")
    compare_scaled(f"K7 at the limit {shape} ({P} primitives, "
                   f"{occ['bwd_smem_bytes']} B, {occ['bwd_blocks_per_sm']} blocks "
                   f"per SM, grid {occ['bwd_grid']})", grad_groups(*got),
                   grad_groups(*ref), grad_groups(*inp.bwd_plain(nudge=True)))


def phase_soft():
    """K6 against its plain version at three sizes, with and without the
    occluder cull; K7 against its plain version on K6's records and a seeded
    cotangent, two launches bit-equal; then ``render_direct_soft_fused``'s
    gradients against autograd through ``soft_replay`` of the same records
    (held) and through the eager oracle (printed; held except for sphere
    geometry), and its value against the trace kernel's."""
    log("== soft: the silhouette kernels against their plain versions")
    worst = {}
    for size in SOFT_SIZES:
        cfg = soft_cfg(size)
        shape = f"{cfg.width}x{cfg.height} x {cfg.spp}"
        for cull in (True, False):
            inp = SoftInputs(cfg, cull)
            again = inp.silh_kernel()
            torch.cuda.synchronize()
            check(torch.equal(again, inp.codes),
                  f"K6 {shape}: two launches differ")
            compare_codes(f"K6 {shape}{', occluder cull' if cull else ''}",
                          inp.codes, inp.silh_plain())
        got, again = inp.bwd_kernel(), inp.bwd_kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K7 {shape}: two launches on the same inputs differ")
        worst[f"K7 {shape}"] = compare_scaled(
            f"K7 {shape}", grad_groups(*got), grad_groups(*inp.bwd_plain()),
            grad_groups(*inp.bwd_plain(nudge=True)))
        del inp, got, again
        torch.cuda.empty_cache()
    check_soft_limit()

    cfg = soft_cfg(SOFT_SIZES[0])
    log(f"== soft: gradients of render_direct_soft_fused(scene).mean(), "
        f"{cfg.width} x {cfg.height} x {cfg.spp}, kappa {SOFT_KAPPA}")
    base = cornell_box_with_spheres(resolution=cfg.resolution)
    scene = with_grad(base)
    reset_launches()
    hdr = cuda_soft.render_direct_soft_fused(scene, cfg, SOFT_KAPPA)
    got = scene_grads(scene, hdr)
    launched = read_launches()
    check(launched == launches_of(path_kernel=1, silh_kernel=1,
                                  soft_bwd_kernel=1),
          f"render_direct_soft_fused with gradients launched {launched}")
    check(torch.equal(hdr, cuda_path.render_path_cuda(base, cfg)),
          "the soft value is not the trace kernel's hdr at bounces=1")

    ref_scene = with_grad(base)
    codes = cuda_soft.silh_records(ref_scene, cfg)
    views = cuda_shade._pack_diff_inputs(ref_scene, cfg)
    lum = cuda_soft.soft_replay(*views, codes, pixel_rng_offsets(cfg, "cuda"),
                                cfg, SOFT_KAPPA,
                                base.triangles.num_triangles)
    replay = scene_grads(ref_scene, (lum / cfg.spp).T.reshape(
        cfg.height, cfg.width, 3))
    o_scene = with_grad(base)
    oracle = scene_grads(o_scene, render_direct_soft(o_scene, cfg,
                                                     SOFT_KAPPA))
    check(set(got) == set(replay) == set(oracle) and len(got) >= 11,
          f"gradient groups {sorted(got)}, {sorted(replay)}, "
          f"{sorted(oracle)}")
    out = {}
    for label, ref, held in (("soft_replay of the same records", replay,
                              set(got)),
                             ("the eager oracle", oracle,
                              set(got) - {"spheres.center",
                                          "spheres.radius"})):
        parts = []
        for name in sorted(ref):
            scale = ref[name].abs().max().item()
            err = (got[name] - ref[name]).abs().max().item()
            check(bool(torch.isfinite(got[name]).all()), f"{name} not finite")
            rel = err / max(scale, 1e-30)
            parts.append(f"{name} {rel:.1e}"
                         + ("" if name in held else " (not held)"))
            out[f"{label}: {name}"] = rel
            if name in held:
                check(err <= GRAD_ATOL * max(scale, 1.0) + GRAD_RTOL * scale,
                      f"K7 path: d {name} differs from autograd through "
                      f"{label} by {err:.3e} (largest magnitude {scale:.3e})")
        log(f"  K7 path vs autograd through {label}, largest difference "
            "over largest magnitude: " + ", ".join(parts))
    log("  (the eager oracle traces its own rays: its camera ray is "
        "normalized by a reciprocal square root, the records' by a "
        "division, so a grazing sphere decision can flip between them, and "
        "the sphere's center and radius gradients carry that flip)")
    return worst, out


def phase_soft_train():
    """Path J: ``inverse_render(soft=True, fast=True)`` on the sphere scene
    at 256 x 256 x 4 spp, direct lighting, kappa 0.1, 20 Adam steps from
    perturbed centers, albedo and emission (benchmarks/bench_config4.py's
    soft-fast line): one trace, one record and one backward launch per
    step; the loss is finite and falls. Then the fit again, warm, for the
    step time and under the profiler for the card's busy share."""
    cfg = soft_cfg(SOFT_J)
    steps = 20
    log(f"== J: inverse_render(soft=True, fast=True), sphere scene, "
        f"{cfg.width}x{cfg.height} x {cfg.spp} spp, direct, kappa "
        f"{SOFT_KAPPA}, {steps} Adam steps")
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    true = inverse.extract_params(scene)
    target = inverse.render_hdr(scene, cfg)
    init = inverse.SceneParams(
        sphere_centers=true.sphere_centers + 0.05,
        sphere_diffuse=true.sphere_diffuse * 0.8,
        light_emission=true.light_emission * 1.2)

    counts = []

    class CountingAdam(torch.optim.Adam):
        """Adam that notes the launch counts at each step."""

        def step(self, closure=None):
            counts.append(read_launches())
            return super().step(closure)

    def fit(n):
        result = inverse.inverse_render(
            scene, target, init, cfg, steps=n, soft=True, fast=True,
            kappa=SOFT_KAPPA,
            optimizer=lambda params: CountingAdam(params, lr=1e-2))
        torch.cuda.synchronize()
        return result

    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fit(steps)
    first_ms = 1e3 * (time.perf_counter() - start) / steps
    launches = read_launches()
    for step, (before, after) in enumerate(zip([launches_of()] + counts,
                                               counts)):
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == launches_of(path_kernel=1, silh_kernel=1,
                                      soft_bwd_kernel=1),
              f"path J step {step}: launches {per_step}")
    losses = result.losses.cpu()
    check(losses.shape == (steps,) and bool(torch.isfinite(losses).all()),
          f"path J: losses {losses.tolist()}")
    check(losses[-1].item() < losses[0].item(),
          f"path J: the loss did not fall: {losses.tolist()}")
    check(launches == launches_of(path_kernel=steps, silh_kernel=steps,
                                  soft_bwd_kernel=steps),
          f"path J: launches {launches}, expected one trace, one record "
          "pass and one backward per step")
    start = time.perf_counter()
    fit(steps)
    warm_ms = 1e3 * (time.perf_counter() - start) / steps
    wall_ms, busy_ms, top = device_busy(lambda: fit(steps))
    k2_ms = profiled_ms("path_kernel") / steps
    k6_ms = profiled_ms("silh_kernel") / steps
    k7_ms = profiled_ms("soft_bwd_kernel") / steps
    k7_reduction_ms = profiled_ms("reduce_partials") / steps
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    log(f"  path J: under the profiler per step K2 {k2_ms:.4f} ms, K6 "
        f"{k6_ms:.4f} ms, K7 {k7_ms:.4f} ms")
    log(f"  path J: loss {losses[0].item():.4e} -> {losses[-1].item():.4e} "
        f"in {steps} steps; {first_ms:.2f} ms per step in the first fit, "
        f"{warm_ms:.2f} ms warm (host clock); under the profiler "
        f"{wall_ms / steps:.2f} ms per step of which the card is busy "
        f"{busy_ms / steps:.3f} ms ({share}); most device time: "
        + ", ".join(f"{name} {ms / steps:.3f} ms" for name, ms in top)
        + f"; launches {launches}")
    return launches, dict(first_call_ms=first_ms, warm_ms=warm_ms,
                          profiled_ms=wall_ms / steps,
                          device_busy_ms=busy_ms / steps,
                          k2_profiled_ms=k2_ms, k6_profiled_ms=k6_ms,
                          k7_profiled_ms=k7_ms,
                          k7_reduction_profiled_ms=k7_reduction_ms,
                          loss_first=losses[0].item(),
                          loss_last=losses[-1].item())


def phase_soft_recovery():
    """The sphere-center recovery of tests/test_soft_fused.py on the card:
    ``inverse_render(soft=True, fast=True)`` at 32 x 32 x 2 spp, kappa 0.1,
    SGD 3.5e2 with momentum 0.9, 600 steps, from centers shifted by
    RECOVERY_SHIFTS. The JAX package's criteria: the last loss below a
    tenth of the first, the largest center error halved. The trajectory is
    printed; the script fails if the criteria are not met."""
    cfg = soft_cfg(SOFT_RECOVERY)
    log(f"== soft: center recovery, {cfg.width}x{cfg.height} x {cfg.spp}, "
        f"{RECOVERY_STEPS} SGD steps at {RECOVERY_LR} with momentum 0.9")
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    true = inverse.extract_params(scene)
    target = inverse.render_hdr(scene, cfg)
    init = true._replace(sphere_centers=true.sphere_centers
                         + torch.tensor(RECOVERY_SHIFTS))

    def fit(steps):
        result = inverse.inverse_render(
            scene, target, init, cfg, steps=steps, soft=True, fast=True,
            kappa=SOFT_KAPPA, optimizer=lambda params: torch.optim.SGD(
                params, lr=RECOVERY_LR, momentum=0.9))
        torch.cuda.synchronize()
        return result

    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fit(RECOVERY_STEPS)
    seconds = time.perf_counter() - start
    launches = read_launches()
    check(launches == launches_of(path_kernel=RECOVERY_STEPS,
                                  silh_kernel=RECOVERY_STEPS,
                                  soft_bwd_kernel=RECOVERY_STEPS),
          f"recovery: launches {launches}, expected one trace, one record "
          "pass and one backward per step")
    wall_ms, busy_ms, top = device_busy(lambda: fit(RECOVERY_PROFILED_STEPS))
    per_step = {f"{key}_profiled_ms": profiled_ms(name) / RECOVERY_PROFILED_STEPS
                for key, name in (("k2", "path_kernel"), ("k6", "silh_kernel"),
                                  ("k7", "soft_bwd_kernel"),
                                  ("k7_reduction", "reduce_partials"))}
    log(f"  recovery under the profiler, {RECOVERY_PROFILED_STEPS} steps: "
        f"{wall_ms / RECOVERY_PROFILED_STEPS:.3f} ms per step of which the card "
        f"is busy {busy_ms / RECOVERY_PROFILED_STEPS:.4f} ms; per step "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items()))
    losses = result.losses.cpu()
    centers = result.params.sphere_centers.cpu()
    err0 = (init.sphere_centers - true.sphere_centers).abs().max().item()
    err1 = (centers - true.sphere_centers).abs().max().item()
    trajectory = ", ".join(f"{k}: {losses[k].item():.3e}"
                           for k in range(0, RECOVERY_STEPS, 50))
    log(f"  recovery: loss {losses[0].item():.4e} -> {losses[-1].item():.4e}"
        f" ({losses[-1].item() / losses[0].item():.3e} of the first), center "
        f"error {err0:.4f} -> {err1:.4f}, in {seconds:.1f} s; losses by "
        f"step: {trajectory}; final centers {centers.tolist()}")
    check(bool(torch.isfinite(losses).all()), "recovery: a loss is not finite")
    check(losses[-1].item() < 0.1 * losses[0].item() and err1 < 0.5 * err0,
          f"recovery left the basin: loss {losses[0].item():.4e} -> "
          f"{losses[-1].item():.4e}, center error {err0:.4f} -> {err1:.4f}")
    return launches, dict(
        loss_first=losses[0].item(), loss_last=losses[-1].item(),
        center_error_first=err0, center_error_last=err1, seconds=seconds,
        profiled_step_ms=wall_ms / RECOVERY_PROFILED_STEPS,
        device_busy_step_ms=busy_ms / RECOVERY_PROFILED_STEPS,
        **per_step)


def soft_occupancy(inp: SoftInputs):
    """K6's and K7's launch plans at ``inp``'s shape from the library, each
    held against the wrapper's mirror: shared memory per block, blocks per
    SM, grid (K7's partials are one row per block)."""
    lib = cuda_soft._library()
    tables = (inp.num_tris, len(inp.shadow_idx), inp.packed.num_spheres)
    n, spp, prims = inp.cfg.num_pixels, inp.cfg.spp, inp.table.shape[1]
    out = dict(silh_smem_bytes=lib.grt_silh_smem(*tables),
               silh_blocks_per_sm=lib.grt_silh_blocks_per_sm(*tables),
               silh_grid=lib.grt_silh_blocks(n, spp),
               bwd_smem_bytes=lib.grt_soft_bwd_smem(prims),
               bwd_blocks_per_sm=lib.grt_soft_bwd_blocks_per_sm(prims),
               bwd_grid=lib.grt_soft_bwd_blocks(n, spp, prims))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(out["silh_blocks_per_sm"] > 0 and out["bwd_blocks_per_sm"] > 0,
          f"an occupancy query of the silhouette kernels failed: {out}")
    plan = dict(silh_smem_bytes=cuda_soft.silh_smem_bytes(*tables),
                silh_grid=cuda_soft.silh_blocks(n, spp),
                bwd_smem_bytes=cuda_soft.soft_bwd_smem_bytes(prims),
                bwd_grid=cuda_soft.soft_bwd_blocks(
                    n, spp, out["bwd_blocks_per_sm"], sms))
    check(all(out[k] == v for k, v in plan.items()),
          f"the silhouette kernels' plans {out} are not the wrapper's {plan}")
    return out


def soft_rows(launches_j, launches_recovery, path_j, recovery, resources):
    """K6 and K7 at path J's shape and at the recovery's, as those paths
    launch them (no occluder cull in soft mode): against their plain
    versions on the whole frame, their times by CUDA events and by the
    profiler's device time per step of that path's profiled fit (K7 apart
    from its reduction), their launch plans and bounds from the records of
    the same frame."""
    rows = []
    for label, size, launches, path in (
            ("J", SOFT_J, launches_j, path_j),
            ("recovery", SOFT_RECOVERY, launches_recovery, recovery)):
        cfg = soft_cfg(size)
        inp = SoftInputs(cfg, cull=False)
        shape = (f"{label}: {cfg.width}x{cfg.height} x {cfg.spp} spp, direct, "
                 f"{inp.num_tris} triangles, {inp.packed.num_spheres} spheres")
        occ = soft_occupancy(inp)
        start = time.perf_counter()
        ref = inp.silh_plain()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        share, err = compare_codes(f"K6 at {label}", inp.codes, ref)
        k_ms = time_ms(inp.silh_kernel)
        bound, by, counts = silh_bound(inp)
        res = resources["silh_kernel"]
        rows.append(dict(
            name="silh_kernel", route="cuda", source=SOFT_SOURCE,
            replaces=SILH_REPLACES, shape=shape,
            launches=launches["silh_kernel"], launches_per_step=1,
            max_abs_err=err, flip_share=share, ms=k_ms[1], ms_min=k_ms[0],
            ms_max=k_ms[2], profiled_ms=path["k6_profiled_ms"], plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            smem_bytes=occ["silh_smem_bytes"],
            blocks_per_sm=occ["silh_blocks_per_sm"], grid=occ["silh_grid"],
            **resource_fields(res), **counts))

        got, again = inp.bwd_kernel(), inp.bwd_kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K7 at {label}: two launches differ")
        start = time.perf_counter()
        ref = inp.bwd_plain()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        err = compare_scaled(f"K7 at {label}", grad_groups(*got),
                             grad_groups(*ref),
                             grad_groups(*inp.bwd_plain(nudge=True)))
        k_ms = time_ms(inp.bwd_kernel)
        bound, by, counts = soft_bwd_bound(inp)
        res = resources["soft_bwd_kernel"]
        rows.append(dict(
            name="soft_bwd_kernel", route="cuda", source=SOFT_SOURCE,
            replaces=SOFT_BWD_REPLACES, shape=shape,
            launches=launches["soft_bwd_kernel"], launches_per_step=1,
            max_abs_err=err, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            profiled_ms=path["k7_profiled_ms"],
            reduction_profiled_ms=path["k7_reduction_profiled_ms"],
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            smem_bytes=occ["bwd_smem_bytes"],
            blocks_per_sm=occ["bwd_blocks_per_sm"], grid=occ["bwd_grid"],
            partials=occ["bwd_grid"], **resource_fields(res), **counts))
        for row in rows[-2:]:
            log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.4f} ms "
                f"(min {row['ms_min']:.4f}, max {row['ms_max']:.4f}) by events, "
                f"{row['profiled_ms']:.4f} ms device time"
                + (f" + reduction {row['reduction_profiled_ms']:.4f}"
                   if "reduction_profiled_ms" in row else "")
                + f", bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"plain {row['plain_ms']:.1f} ms, launches {row['launches']}, "
                f"{row['registers']} registers, {row['stack_bytes']} B stack, "
                f"{row['spill_store_bytes']} B spill stores, {row['smem_bytes']} B "
                f"shared, {row['blocks_per_sm']} blocks per SM, grid {row['grid']}")
        log(f"  K6 at {label}: {rows[-2]['probes_reached']} probes reach the light, "
            f"{rows[-2]['probes_blocked']} blocked, prefilter pass share "
            f"{rows[-2]['est_pass_share_probe']:.4f}; bound "
            f"{rows[-2]['bound_ms']:.5f} ms, every test whole "
            f"{rows[-2]['whole_tests_bound_ms']:.5f}")
        log(f"  K7 at {label}: {counts}")
        del inp, got, again, ref
    return rows


def check_frame(png_path, debug_path, cfg, ratio=2.0, stat=np.mean):
    """The frame is a Cornell box: right shape, finite rows, red left wall,
    green right wall (the wall's channel ``ratio`` times the others, in
    ``stat`` over the wall's pixels), the light's rows brightest."""
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
    left = stat(rgb[band, int(0.08 * w):int(0.18 * w)].reshape(-1, 3), axis=0)
    right = stat(rgb[band, int(0.80 * w):int(0.90 * w)].reshape(-1, 3),
                 axis=0)
    check(left[0] > ratio * left[1] and left[0] > ratio * left[2],
          f"left wall is not red: {left}")
    check(right[1] > ratio * right[0] and right[1] > ratio * right[2],
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
        check(per_step == launches_of(path_kernel=1, shade_bwd_kernel=1),
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


def inverse_fit(label, scene, cfg, steps, grouped=False):
    """``inverse_render(fast=True)`` on ``scene`` from perturbed sphere
    centres and albedo and light emission, ``steps`` Adam steps: the loss
    must fall, one K2 and one K3 launch per step (K2g and K3g where
    ``grouped``), counted; then the same fit warm, and under the profiler
    for the card's busy share and K2's and K3's device time."""
    trace = f"path_kernel{'_grouped' * grouped}"
    shade = f"shade_bwd{'_grouped' * grouped}_kernel"
    log(f"== {label}: inverse_render(fast=True), {cfg.width}x{cfg.height} x "
        f"{cfg.spp} spp x {cfg.bounces} bounces, {steps} Adam steps")
    true = inverse.extract_params(scene)
    target = inverse.render_hdr(scene, cfg)
    init = inverse.SceneParams(
        sphere_centers=true.sphere_centers + 0.05,
        sphere_diffuse=true.sphere_diffuse * 0.8,
        light_emission=true.light_emission * 1.2)

    def fit(n):
        result = inverse.inverse_render(scene, target, init, cfg, steps=n,
                                        learning_rate=1e-2, fast=True)
        torch.cuda.synchronize()
        return result

    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fit(steps)
    first_ms = 1e3 * (time.perf_counter() - start) / steps
    launches = read_launches()
    losses = result.losses.cpu()
    check(losses.shape == (steps,) and bool(torch.isfinite(losses).all())
          and losses[-1].item() < losses[0].item(),
          f"{label}: losses {losses.tolist()}")
    for name, value in zip(result.params._fields, result.params):
        check(bool(torch.isfinite(value).all()), f"{label}: {name} not finite")
    check(launches == launches_of(draws_kernel=1, **{trace: steps,
                                                     shade: steps}),
          f"{label}: launches {launches}")
    # The same fit again, warm: the steady step time, and how much of it the
    # card is busy (launches made here are not the main path's count).
    start = time.perf_counter()
    fit(steps)
    warm_ms = 1e3 * (time.perf_counter() - start) / steps
    wall_ms, busy_ms, top = device_busy(lambda: fit(steps))
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    # Device time by the kernels' names (the launch counts' keys differ).
    k2_ms, k3_ms = (profiled_ms(k) / steps for k in (
        "path_grouped_kernel" if grouped else "path_kernel<", shade + "<"))
    check(k2_ms > 0.0 and k3_ms > 0.0, f"{label}: the profiler saw no K2 or "
          f"K3 ({k2_ms} / {k3_ms} ms)")
    log(f"  {label}: loss {losses[0].item():.4e} -> {losses[-1].item():.4e}; "
        f"{first_ms:.2f} ms per step (host clock, hoisting and warm-up "
        f"included), {warm_ms:.2f} warm; under the profiler "
        f"{wall_ms / steps:.2f} ms per step of which the card is busy "
        f"{busy_ms / steps:.3f} ms ({share}); most device time: "
        + ", ".join(f"{name} {ms / steps:.3f} ms" for name, ms in top)
        + f"; launches {launches}")
    return launches, dict(first_call_ms=first_ms, warm_ms=warm_ms,
                          profiled_ms=wall_ms / steps,
                          device_busy_ms=busy_ms / steps,
                          k2_device_ms=k2_ms, k3_device_ms=k3_ms)


def phase_inverse():
    """Path E: the inverse-rendering entry point on the sphere scene."""
    cfg = RenderConfig(pixel_chunk=65536, **INVERSE)
    return inverse_fit("path E", cornell_box_with_spheres(
        resolution=cfg.resolution), cfg, steps=20)


# ---------------------------------------------------------------------------
# Phase host: the Renderer, progressive accumulation and checkpoints, the
# legacy tier, the CLI's new flags, debug checks, profiler traces, native
# ---------------------------------------------------------------------------

# The legacy tier's sizes: the reference's frame at its defaults (30
# samples, 2 bounces, 30 nested samples), under torch.no_grad(), the whole
# frame one pixel chunk (the eager integrator is launch-bound in chunks);
# card against CPU at a small frame (values) and at the test size (the
# gradients of tests/test_torch_legacy.py).
LEGACY_FRAME = dict(width=800, height=600, pixel_chunk=800 * 600)
LEGACY_SMALL = dict(width=48, height=32, legacy_samples=6, legacy_bounces=2,
                    legacy_bounce_samples=6, pixel_chunk=48 * 32)
LEGACY_GRAD = dict(width=16, height=16, legacy_samples=3, legacy_bounces=1,
                   legacy_bounce_samples=3, pixel_chunk=256)
HOST_BATCHES, HOST_SAVE_AFTER = 4, 2
LEGACY_WALL_RATIO = 1.5
# The share of the legacy frame's pixels that must be lit: the room fills
# about 85 % of the frame (the rest is outside its open front).
LEGACY_LIT_SHARE = 0.75


def write_debug_rows(path, hdr):
    image.write_debug_file(path, fetch(hdr))


def host_renderer(tmp):
    """(a) ``Renderer(kernel="decoupled")`` at path C's shape: the one-time
    work in __init__ (one draws kernel launch), one trace launch per draw,
    two draws bit-equal to each other and to ``render_path_decoupled`` called
    as path C calls it; ``draw()`` writes a Cornell box. (b) The MIS
    integrator through ``kernel="cuda"``: one MIS launch per draw."""
    cfg = RenderConfig(**BENCH)
    scene = cornell_box(resolution=cfg.resolution)
    reset_launches()
    start = time.perf_counter()
    r = Renderer(scene, cfg, kernel="decoupled")
    init_s = time.perf_counter() - start
    after_init = read_launches()
    check(after_init == launches_of(draws_kernel=1),
          f"Renderer.__init__ launches {after_init}: expected the draws "
          "kernel once")
    per_draw, frames, draw_s = [], [], []
    for _ in range(2):
        reset_launches()
        start = time.perf_counter()
        frames.append(r.render_hdr())
        draw_s.append(time.perf_counter() - start)
        per_draw.append(read_launches())
    for counts in per_draw:
        check(counts == launches_of(path_kernel=1),
              f"Renderer.render_hdr launches {counts}: expected the trace "
              "kernel once (the draws are made in __init__)")
    ref = decoupled.render_path_decoupled(
        scene, cfg, draws=cuda_path.pregen_draws(cfg),
        occluders=potential_occluders(scene, cfg))
    check(torch.equal(frames[0], frames[1]), "two draws differ")
    check(torch.equal(frames[0], ref),
          "Renderer's frame differs from render_path_decoupled's")
    png, dbg = os.path.join(tmp, "renderer.png"), os.path.join(tmp, "r.txt")
    png_s = r.draw(png, verbose=False)
    write_debug_rows(dbg, r.last_hdr)
    check_frame(png, dbg, cfg)
    log(f"  (a) Renderer(decoupled) {cfg.width}x{cfg.height} x {cfg.spp} spp "
        f"x {cfg.bounces}: __init__ {init_s:.3f} s (launches {after_init}), "
        f"render_hdr {draw_s[0]:.4f} / {draw_s[1]:.4f} s, draw "
        f"{png_s:.4f} s; frames bit-equal to each other and to path C's call")

    mcfg = RenderConfig(integrator="mis", **MIS_SMALL)
    mscene = cornell_box(resolution=mcfg.resolution)
    m = Renderer(mscene, mcfg, kernel="cuda")
    mis_counts = []
    for _ in range(2):
        reset_launches()
        hdr = m.render_hdr()
        mis_counts.append(read_launches())
    check(all(c == launches_of(mis_kernel=1) for c in mis_counts),
          f"Renderer(cuda, mis) launches {mis_counts}: expected one MIS "
          "kernel per draw")
    check(torch.equal(hdr, cuda_mis.render_mis_cuda(mscene, mcfg)),
          "Renderer(cuda, mis) differs from render_mis_cuda")
    m.draw(os.path.join(tmp, "renderer_mis.png"), verbose=False)
    check(image.read_png(os.path.join(tmp, "renderer_mis.png")).shape
          == (mcfg.height, mcfg.width, 3), "MIS PNG shape")
    log(f"  (b) Renderer(cuda, mis) {mcfg.width}x{mcfg.height} x "
        f"{mcfg.camera_rays} x {mcfg.mis_samples}: launches per draw "
        f"{mis_counts[0]}")
    return r, dict(init_s=init_s, render_hdr_s=draw_s, draw_s=png_s,
                   init_launches=after_init, draw_launches=per_draw[0],
                   mis_draw_launches=mis_counts[0])


def host_accumulate(r, tmp):
    """(c) ``draw_accumulate`` through the decoupled route: HOST_BATCHES
    batches of the config's spp, saved and loaded after HOST_SAVE_AFTER;
    bit-equal to the same frames of ``render_path_decoupled`` at seeds 0,
    1, ... summed in the same order. One draws and one trace launch per
    batch (the draws depend on the batch's seed)."""
    cfg, spp = r.config, r.config.spp
    path = os.path.join(tmp, "acc.npz")
    acc, counts = None, []
    start = time.perf_counter()
    for b in range(HOST_BATCHES):
        reset_launches()
        acc, mean = r.draw_accumulate(acc)
        counts.append(read_launches())
        if b + 1 == HOST_SAVE_AFTER:
            checkpoint.save_accumulator(path, acc, cfg)
            acc = checkpoint.load_accumulator(path, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    for c in counts:
        check(c == launches_of(draws_kernel=1, path_kernel=1),
              f"draw_accumulate launches {c}: expected one draws and one "
              "trace launch per batch")
    ref = torch.zeros_like(acc.radiance_sum)
    for seed in range(HOST_BATCHES):
        ref = ref + decoupled.render_path_decoupled(
            r.scene, cfg.replace(seed=seed), occluders=r.occluders) * spp
    check(int(acc.spp_done) == HOST_BATCHES * spp
          and int(acc.seed_cursor) == HOST_BATCHES, "accumulator counts")
    check(torch.equal(acc.radiance_sum, ref),
          "accumulated radiance differs from the summed frames")
    check(torch.equal(mean, ref / torch.tensor(
        float(HOST_BATCHES * spp), device="cuda")), "resolved mean differs")
    log(f"  (c) draw_accumulate(decoupled): {HOST_BATCHES} batches of {spp} "
        f"spp, saved and loaded after {HOST_SAVE_AFTER}, {seconds:.3f} s; "
        "bit-equal to the summed frames; launches per batch "
        f"{counts[0]}")
    return dict(seconds=seconds, batch_launches=counts[0])


def legacy_on(device, kind, kw, grad=False):
    """The legacy tier's frame (and, with ``grad``, the gradients of its
    mean by the sphere-light radiance and the sphere centers) on
    ``device``."""
    cfg = RenderConfig(integrator="legacy", **kw)
    scene = legacy_cornell(kind, resolution=cfg.resolution)
    if not grad:
        with torch.no_grad():
            return render_legacy(scene, cfg, device=device).hdr.cpu()
    emitted = scene.sphere_lights.emitted_radiance.clone().requires_grad_()
    centers = scene.spheres.center.clone().requires_grad_()
    scene = dataclasses.replace(
        scene,
        sphere_lights=dataclasses.replace(scene.sphere_lights,
                                          emitted_radiance=emitted),
        spheres=dataclasses.replace(scene.spheres, center=centers))
    value = render_legacy(scene, cfg, device=device).hdr.mean()
    return torch.autograd.grad(value, [emitted, centers])


def host_legacy():
    """(d) The legacy tier on the card: the reference's frame at its
    defaults (finite, non-negative, lit; timed); the three light kinds on
    card and CPU within the value tolerance; the gradients on card and CPU
    within the gradient tolerance."""
    cfg = RenderConfig(integrator="legacy", **LEGACY_FRAME)
    scene = legacy_cornell("sphere", resolution=cfg.resolution)
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        hdr = render_legacy(scene, cfg, device="cuda").hdr
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - start
    check(read_launches() == launches_of(),
          "the legacy tier launched a kernel of ops/csrc")
    check(bool(torch.isfinite(hdr).all()) and float(hdr.min()) >= 0.0,
          "legacy frame not finite and non-negative")
    lit = float((hdr.sum(-1) > 0).float().mean())
    check(lit > LEGACY_LIT_SHARE,
          f"legacy frame: only {lit:.1%} of the pixels are lit")
    log(f"  (d) legacy {cfg.width}x{cfg.height}, sphere light, "
        f"{cfg.legacy_samples} / {cfg.legacy_bounces} / "
        f"{cfg.legacy_bounce_samples}: {frame_s:.2f} s; {lit:.1%} of the "
        f"pixels lit, mean {float(hdr.mean()):.4f}")
    errs = {}
    for kind in ("sphere", "box", "square"):
        card = legacy_on("cuda", kind, LEGACY_SMALL)
        cpu = legacy_on("cpu", kind, LEGACY_SMALL)
        errs[kind] = float((card - cpu).abs().max())
        check(torch.allclose(card, cpu, atol=HDR_ATOL, rtol=HDR_RTOL),
              f"legacy {kind}: card and CPU differ by {errs[kind]:.3e}")
    log("  (d) legacy 48x32 x 6 / 2 / 6, card against CPU, largest "
        "difference: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    card = legacy_on("cuda", "sphere", LEGACY_GRAD, grad=True)
    cpu = legacy_on("cpu", "sphere", LEGACY_GRAD, grad=True)
    grad_errs = []
    for name, g, c in zip(("emitted radiance", "sphere centers"), card, cpu):
        grad_errs.append(float((g.cpu() - c).abs().max()))
        check(bool(c.abs().sum() > 0) and torch.allclose(
            g.cpu(), c, atol=GRAD_ATOL, rtol=GRAD_RTOL),
            f"legacy gradient of {name}: card and CPU differ by "
            f"{grad_errs[-1]:.3e}")
    log(f"  (d) legacy gradients 16x16 x 3 / 1, card against CPU: "
        f"d emitted {grad_errs[0]:.3e}, d centers {grad_errs[1]:.3e}")
    return dict(frame_s=frame_s, lit_share=lit, card_vs_cpu=errs,
                grad_card_vs_cpu=grad_errs,
                frame=dict(width=cfg.width, height=cfg.height,
                           legacy_samples=cfg.legacy_samples,
                           legacy_bounces=cfg.legacy_bounces,
                           legacy_bounce_samples=cfg.legacy_bounce_samples))


def host_cli(tmp):
    """(e) ``--integrator legacy --scene legacy-box`` at 128 x 96 (the
    defaults of the legacy tier), then one ``--debug-nans`` run of the path
    tracer; both checked as Cornell boxes."""
    out = {}
    cfg = RenderConfig(width=128, height=96, integrator="legacy")
    png, dbg = os.path.join(tmp, "legacy.png"), os.path.join(tmp, "l.txt")
    start = time.perf_counter()
    rc = cli.main([png, "--integrator", "legacy", "--scene", "legacy-box",
                   "--width", "128", "--height", "96", "--debug-output", dbg])
    out["legacy_s"] = time.perf_counter() - start
    check(rc == 0, f"cli legacy returned {rc}")
    # The legacy estimator speckles every wall with bright white samples (in
    # the JAX package too): the walls' colours are held by their median
    # pixel, at 1.5 times the other channels.
    check_frame(png, dbg, cfg, ratio=LEGACY_WALL_RATIO, stat=np.median)
    cfg = RenderConfig(width=128, height=96, spp=16, bounces=3)
    png, dbg = os.path.join(tmp, "nans.png"), os.path.join(tmp, "n.txt")
    start = time.perf_counter()
    try:
        rc = cli.main([png, "--debug-nans", "--width", "128", "--height",
                       "96", "--spp", "16", "--debug-output", dbg])
        check(torch.is_anomaly_enabled(), "--debug-nans left the checks off")
    finally:
        debug.disable()
    out["debug_nans_s"] = time.perf_counter() - start
    check(rc == 0, f"cli --debug-nans returned {rc}")
    check_frame(png, dbg, cfg)
    log(f"  (e) cli legacy-box 128x96: {out['legacy_s']:.2f} s; cli "
        f"--debug-nans, eager path tracer 128x96 x 16 spp: "
        f"{out['debug_nans_s']:.2f} s")
    return out


def host_debug():
    """(f) ``debug_checks`` raises at a NaN-making operation on the card,
    and not outside its block."""
    x = torch.full((4,), -1.0, device="cuda")
    try:
        with debug.debug_checks(nans=True):
            torch.log(x)
        raised = False
    except FloatingPointError as e:
        raised = "log" in str(e)
    check(raised, "debug_checks did not stop at torch.log of -1 on the card")
    check(bool(torch.isnan(torch.log(x)).all())
          and not torch.is_anomaly_enabled(), "debug_checks left state on")
    log("  (f) debug_checks: FloatingPointError at aten.log on the card")


def host_trace(tmp):
    """(g) ``profiler_trace`` around a new decoupled Renderer and its first
    draw (the draws kernel runs in __init__, the trace kernel in the draw):
    the Chrome trace names both kernels."""
    cfg = RenderConfig(**BENCH)
    scene = cornell_box(resolution=cfg.resolution)
    log_dir = os.path.join(tmp, "trace")
    with profiler_trace(log_dir):
        Renderer(scene, cfg, kernel="decoupled").render_hdr()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = " ".join(str(e.get("name", "")) for e in events)
    for kernel in ("path_kernel", "draws_kernel"):
        check(kernel in names, f"the profiler trace names no {kernel}")
    log(f"  (g) profiler_trace: {len(events)} events, path_kernel and "
        "draws_kernel among them")
    return len(events)


def host_native(tmp):
    """(h) Where ``g++`` exists, the native library builds and loads (a
    failure is a failure of the check) and its PNG decodes to the pixels the
    pure-python writer's does."""
    gxx = shutil.which("g++")
    log(f"  (h) g++ {'found: ' + gxx if gxx else 'not found'}")
    if not gxx:
        return dict(gxx=None)
    native.load(strict=True)  # built in phase build
    rgb = np.random.default_rng(7).integers(0, 256, (96, 128, 3), np.uint8)
    a, b = os.path.join(tmp, "native.png"), os.path.join(tmp, "python.png")
    native.write_png(a, rgb)
    image.write_png_python(b, rgb)
    check(np.array_equal(image.read_png(a), rgb)
          and np.array_equal(image.read_png(b), rgb),
          "native and pure-python PNGs decode to different pixels")
    log(f"  (h) native library {native.library_path().name} loaded; its "
        "PNG decodes to the pure-python writer's pixels")
    return dict(gxx=gxx, library=native.library_path().name)


def phase_host(tmp):
    log("== host: Renderer, accumulation and checkpoints, legacy tier, CLI "
        "flags, debug checks, profiler trace, native")
    r, renderer = host_renderer(tmp)
    out = dict(renderer=renderer, accumulate=host_accumulate(r, tmp))
    del r
    out["legacy"] = host_legacy()
    out["cli"] = host_cli(tmp)
    host_debug()
    out["trace_events"] = host_trace(tmp)
    out["native"] = host_native(tmp)
    return out


def shade_rows(launches, resources):
    """The backward kernel at the shapes of paths D and E, as those paths
    launch it (draws read): against its plain version, and its time. Also
    with the draws regenerated, the mode frames above 2 GiB of draw planes
    take; no main path here launches it, so its numbers ride on the row."""
    rows = []
    for label, scene_name, size in (("D", "cornell", BENCH),
                                    ("E", "cornell-spheres", INVERSE)):
        cfg = RenderConfig(**size)
        sh = ShadeInputs(scene_name, cfg)
        ref, nudged = sh.plain(), sh.plain(nudge=True)
        p_ms = time_ms(sh.plain, repeats=2, warmup=0)
        measured = {}
        for regenerate in (False, True):
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
        sph = int(label == "E")
        smem, per_sm = shade_occupancy(sh, False)
        row = dict(
            name=f"shade_bwd_kernel[draws read, {scene_name}]", route="cuda",
            source=SHADE_SOURCE, replaces=SHADE_REPLACES,
            shape=f"{label}: {cfg.width}x{cfg.height} x {cfg.spp} spp x "
                  f"{cfg.bounces} bounces, {sh.table.shape[1]} primitives",
            launches=launches[label]["shade_bwd_kernel"], max_abs_err=err,
            ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=p_ms[1],
            bound_ms=bound, bound_by=by, library_ms=None,
            live_iterations=iters, smem_bytes=smem, blocks_per_sm=per_sm,
            regenerated_blocks_per_sm=shade_occupancy(sh, True)[1],
            **resource_fields(resources[f"shade_bwd_kernel<SPH={sph}, RNG=0>"]),
            regenerated_registers=resources[
                f"shade_bwd_kernel<SPH={sph}, RNG=1>"]["registers"])
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


def mis_rows(launches, resources):
    """The MIS kernel at the shapes of paths F, G and H, as those paths
    launch it, against its plain version on the whole frame: its time and
    its bound from the records of the same frame, its registers, stack,
    shared memory and blocks per SM."""
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
        shares = prefilter_shares(inp)
        bound, by, counts = mis_bound(inp, rec, emit, shares)
        other_bound, other_by, _ = mis_bound(inp, rec, not emit, shares)
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
        other = "records_on" if not emit else "records_off"
        row.update({f"{other}_ms": other_ms[1], f"{other}_ms_min": other_ms[0],
                    f"{other}_ms_max": other_ms[2],
                    f"{other}_bound_ms": other_bound,
                    f"{other}_bound_by": other_by})
        res = resources[f"mis_kernel<EMIT={int(emit)}>"]
        smem, per_sm = static_occupancy(inp, emit)
        row.update(registers=res["registers"], stack_bytes=res["stack_bytes"],
                   spill_store_bytes=res["spill_store_bytes"], smem_bytes=smem,
                   blocks_per_sm=per_sm)
        rows.append(row)
        log(f"  K4 at {label}: {counts}; the other mode (records "
            f"{'off' if emit else 'on'}) {other_ms[1]:.3f} ms (min "
            f"{other_ms[0]:.3f}, max {other_ms[2]:.3f}), bound "
            f"{other_bound:.3f} ms by {other_by}; {res['registers']} "
            f"registers, {res['stack_bytes']} B stack, {smem} B shared, "
            f"{per_sm} blocks per SM")
    return rows, plain


def k1_row(inp: TraceInputs, launches: int, resources):
    """K1 at ``inp``'s shape (path C's): its planes against the plain
    version's, its time by CUDA events over K1_BATCH launches, its bound,
    issue floor, occupancy and ptxas resources; and both sets of planes.
    (Device time is left to ``--split K1`` and ``tools/compare_trees.py``:
    a profiler window this late in a full run misses launches.)"""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    draws_k = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
    draws_p = cuda_path.pregen_draws_plain(inp.offsets, cfg)
    err = compare_draws("K1 at C", draws_k, draws_p)
    p_ms = time_ms(lambda: cuda_path.pregen_draws_plain(inp.offsets, cfg),
                   repeats=2, warmup=0)
    k_ms = time_draws(lambda: cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg))
    bound, by = draws_bound(cfg, n)
    issue = draws_issue_floor(cfg, n, inp.offsets_i32)
    per_sm = cuda_path._library().grt_draws_blocks_per_sm(cfg.bounces)
    check(per_sm > 0, "the draws kernel's occupancy query failed")
    row = dict(
        name="draws_kernel", route="cuda",
        source="gpuraytracer_tpu_torch/ops/csrc/path_kernels.cu",
        replaces="gpuraytracer_tpu/ops/pallas_path.py:275",
        shape="C: 512x512 x 16 spp x 3 bounces",
        launches=launches, max_abs_err=err,
        ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=p_ms[1],
        bound_ms=bound, bound_by=by, library_ms=None, blocks_per_sm=per_sm, **issue,
        **resource_fields(resources[f"draws_kernel<BOUNCES={cfg.bounces}>"]))
    log(f"  draws_kernel at C: {k_ms[1]:.4f} ms (min {k_ms[0]:.4f}, max "
        f"{k_ms[2]:.4f}), bound {bound:.4f} ms by {by}, issue floor "
        f"{issue['issue_floor_ms']:.4f} ms ({issue['sass_per_item']} "
        f"instructions an item at {issue['sm_clock_mhz']} MHz)")
    return row, draws_k, draws_p


def phase_full(launches, plain_small, resources):
    log("== full: kernels at the main paths' shapes")
    rows = []

    # ---- path C: draws kernel, and the trace reading them with the cull
    cfg = RenderConfig(**BENCH)
    n = cfg.num_pixels
    inp = TraceInputs("cornell", cfg, cull=True)
    row, draws_k, draws_p = k1_row(inp, launches["C"]["draws_kernel"], resources)
    rows.append(row)

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
    bound, by, counts = trace_bound(inp, rec_k, k2_prefilter_shares(inp),
                                    emit=True, reads_draws=True)
    smem, per_sm = path_occupancy(inp, True, True)
    rows.append(dict(
        name="path_kernel[emit_records, draws read, occluder cull]",
        route="cuda", source=PATH_SOURCE, replaces=K2_REPLACES,
        shape="C: 512x512 x 16 spp x 3 bounces, 36 triangles",
        launches=launches["C"]["path_kernel"], launches_per_step=1,
        max_abs_err=err, flip_share=flips, ms=k_ms[1], ms_min=k_ms[0],
        ms_max=k_ms[2], plain_ms=p_ms[1], bound_ms=bound, bound_by=by,
        library_ms=None, mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3),
        smem_bytes=smem, blocks_per_sm=per_sm,
        **resource_fields(resources["path_kernel<EMIT=1, READ_DRAWS=1>"]),
        **counts))
    log(f"  K2 at C: {counts}")
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
        del rec_p, hdr_p
        shares = k2_prefilter_shares(inp)
        bound, by, counts = trace_bound(inp, rec_r, shares, emit=False,
                                        reads_draws=False)
        # With records on, dead lanes run on masked: every iteration counts.
        r_bound, r_by, r_counts = trace_bound(inp, rec_r, shares, emit=True,
                                              reads_draws=False)
        del rec_r, hdr_r
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: inp.kernel())
        r_ms = time_ms(lambda: inp.kernel(emit=True), repeats=3)
        smem, per_sm = path_occupancy(inp, False, False)
        log(f"  K2 at {label}: {counts}; records_only mode {r_ms[1]:.1f} ms, "
            f"bound {r_bound:.3f} ms by {r_by} ({r_counts})")
        rows.append(dict(
            name=f"path_kernel[hdr, {scene_name}]", route="cuda",
            source=PATH_SOURCE, replaces=K2_REPLACES,
            shape=f"{label}: 800x600 x 400 spp x 3 bounces, "
                  f"{inp.num_tris} triangles, "
                  f"{inp.packed.num_spheres} spheres",
            launches=launches[label]["path_kernel"], launches_per_frame=1,
            max_abs_err=err, flip_share=flips, ms=k_ms[1], ms_min=k_ms[0],
            ms_max=k_ms[2], plain_ms=1e3 * plain_s, bound_ms=bound,
            bound_by=by, library_ms=None, records_only_ms=r_ms[1],
            records_only_bound_ms=r_bound, records_only_bound_by=r_by,
            mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3), smem_bytes=smem,
            blocks_per_sm=per_sm,
            **resource_fields(resources["path_kernel<EMIT=0, READ_DRAWS=0>"]),
            **counts))

    # ---- path E's trace: records + draws read + the cull inverse_render
    # makes (sphere_slack 0.5), one launch per step
    cfg = RenderConfig(pixel_chunk=65536, **INVERSE)
    inp = TraceInputs("cornell-spheres", cfg, cull=True, sphere_slack=0.5)
    draws_k = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
    hdr_k, rec_k = inp.kernel(draws_k, emit=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    hdr_p, rec_p = inp.plain(draws_k, emit=True, whole_frame=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)
    flips, err = compare_trace("K2 at E emit+draws+cull", hdr_k, rec_k, hdr_p,
                               rec_p, inp.packed)
    k_ms = time_ms(lambda: inp.kernel(draws_k, emit=True))
    bound, by, counts = trace_bound(inp, rec_k, k2_prefilter_shares(inp),
                                    emit=True, reads_draws=True)
    smem, per_sm = path_occupancy(inp, True, True)
    rows.append(dict(
        name="path_kernel[emit_records, draws read, occluder cull, "
             "cornell-spheres]", route="cuda", source=PATH_SOURCE,
        replaces=K2_REPLACES,
        shape=f"E: {cfg.width}x{cfg.height} x {cfg.spp} spp x {cfg.bounces} "
              f"bounces, {inp.num_tris} triangles, "
              f"{inp.packed.num_spheres} spheres",
        launches=launches["E"]["path_kernel"], launches_per_step=1,
        max_abs_err=err, flip_share=flips, ms=k_ms[1], ms_min=k_ms[0],
        ms_max=k_ms[2], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, smem_bytes=smem, blocks_per_sm=per_sm,
        **resource_fields(resources["path_kernel<EMIT=1, READ_DRAWS=1>"]),
        **counts))
    log(f"  K2 at E: {counts}")
    del inp, draws_k, hdr_k, rec_k, hdr_p, rec_p

    rows += shade_rows(launches, resources)
    k4_rows, mis_plain = mis_rows(launches, resources)
    rows += k4_rows
    for row in rows:
        log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}), bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain "
            f"{row['plain_ms']:.1f} ms, launches {row['launches']}")
    row_small = {k: v[1] for k, v in plain_small.items()}
    return rows, row_small, mis_plain


# ---------------------------------------------------------------------------
# The grouped tier: K2g and K3g
# ---------------------------------------------------------------------------

def grouped_trace_bound(inp: TraceInputs, rec, stats, scale, emit,
                        reads_draws):
    """(bound_ms, bound_by, counts) of one grouped trace: the box and
    triangle tests that the plain sweep counted (``stats`` of
    ``render_path_plain``) on a part of the frame, times ``scale`` (every
    lane with records on, where dead lanes run on; live lanes in hdr mode),
    each triangle test at OPS_TRI_PREFILTER and the rest of a whole test
    only for those that pass both prefilters ("passed"), and the spheres,
    shading and camera rays of this frame's records, against the bytes in
    and out. ``whole_tests_bound_ms``: the same with every triangle test
    whole, as if no test were prefiltered."""
    cfg, n = inp.cfg, inp.cfg.num_pixels
    key = (lambda k: k + "_all") if emit else (lambda k: k)
    counts = {f"{loop}_{k}": scale * stats[loop][key(k)]
              for loop in ("closest", "shadow")
              for k in ("rays", "boxes", "triangles", "passed")}
    alive, shaded = live_lanes(rec, inp.packed)
    closest = rec.numel() if emit else int(alive.sum())
    shade = rec.numel() if emit else int(shaded.sum())
    s = inp.packed.num_spheres
    ops = (counts["closest_boxes"] * OPS_BOX_CLOSEST
           + counts["shadow_boxes"] * OPS_BOX_SHADOW
           + (counts["closest_rays"] + counts["shadow_rays"]) * OPS_SWEEP_RAY
           + counts["shadow_rays"] * OPS_SHADOW_RAY
           + closest * s * OPS_SPH_CLOSEST
           + shade * (s * OPS_SPH_SHADOW + OPS_SHADE)
           + cfg.spp * n * OPS_CAMERA)
    if not reads_draws:
        ops += halton_ops(cfg, n)
    whole_ops = (ops + counts["closest_triangles"] * OPS_TRI_CLOSEST
                 + counts["shadow_triangles"] * OPS_TRI_SHADOW)
    ops += ((counts["closest_triangles"] + counts["shadow_triangles"])
            * OPS_TRI_PREFILTER
            + counts["closest_passed"] * (OPS_TRI_CLOSEST - OPS_TRI_PREFILTER)
            + counts["shadow_passed"] * (OPS_TRI_SHADOW - OPS_TRI_PREFILTER))
    grp = inp.packed.grouped
    tables = sum(t.numel() for t in grp[:6]) + inp.packed.atab.numel() \
        + inp.packed.sph.numel() + 18
    nbytes = 4 * n + 12 * n + 4 * tables
    if emit:
        nbytes += 4 * cfg.spp * cfg.bounces * n
    if reads_draws:
        nbytes += 4 * (4 * cfg.bounces + 2) * cfg.spp * n
    bound, by = roofline(nbytes, int(ops))
    counts.update(closest_iterations=closest, shaded_iterations=shade,
                  operations=int(ops),
                  whole_tests_bound_ms=roofline(nbytes, int(whole_ops))[0])
    return bound, by, counts


def phase_grouped():
    """K2g and K3g against their plain versions at the small size, on the
    tessellated scenes and the walls-plus-spheres scene, cull on and off;
    then both forced onto the 36-triangle box and the sphere scene, against
    K2 and K3."""
    cfg = RenderConfig(**SMALL)
    log(f"== grouped: K2g and K3g against their plain versions, {cfg.width} x "
        f"{cfg.height} x {cfg.spp} spp x {cfg.bounces} bounces")
    errs = {}
    for scene_name in GROUPED_SCENES:
        for cull in (True, False):
            tag = f"{scene_name}/{'cull' if cull else 'no cull'}"
            inp = TraceInputs(scene_name, cfg, cull, grouped=True)
            draws = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
            hdr_h, _ = inp.kernel()
            hdr_e, rec_e = inp.kernel(draws, emit=True)
            hdr_r, rec_r = inp.kernel(emit=True)
            torch.cuda.synchronize()
            check(torch.equal(hdr_h, hdr_e) and torch.equal(hdr_h, hdr_r),
                  f"K2g {tag}: the three modes do not give the same image")
            hdr_p, rec_p = inp.plain(draws, emit=True)
            compare_trace(f"K2g {tag} emit+draws", hdr_e, rec_e, hdr_p,
                          rec_p, inp.packed)
            hdr_q, rec_q = inp.plain(emit=True)
            errs[tag] = compare_trace(f"K2g {tag} records_only", hdr_r, rec_r,
                                      hdr_q, rec_q, inp.packed)[1]
            hdr_b, rec_b = inp.brute(draws, emit=True)
            check_same_decisions(f"plain sweep {tag} vs brute force", rec_p,
                                 rec_b, inp.packed)
            check(bool(((hdr_p - hdr_b).abs()
                        <= 5e-8 + 1e-6 * hdr_b.abs()).all()),
                  f"plain sweep {tag}: image differs from the brute force")
            check_same_decisions(f"K2g {tag} vs brute force", rec_e, rec_b,
                                 inp.packed)
            log(f"  K2g {tag}: plain sweep and kernel make the brute force's "
                "decisions")
            if not cull:
                continue
            sh = ShadeInputs(scene_name, cfg, grouped=True)
            k_read, k_again = sh.kernel(), sh.kernel()
            k_regen = sh.kernel(regenerate=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k_read, k_again)),
                  f"K3g {tag}: two launches on the same inputs differ")
            ref, nudged = sh.plain(), sh.plain(nudge=True)
            compare_grads(f"K3g {tag} draws read", k_read, ref, nudged=nudged)
            compare_grads(f"K3g {tag} draws regenerated", k_regen, ref,
                          nudged=nudged)
            compare_grads(f"K3g {tag} regenerated vs read", k_regen, k_read,
                          MODES_ATOL, MODES_RTOL, MODES_RTOL)
            check_glue(f"grouped {tag}", sh)

    # hdr mode on lanes whose paths end while others of their warp go on:
    # an emissive sphere behind the light panel, on the unchanged ray, must
    # not take the place of the panel's emission on a later bounce.
    inp = TraceInputs(None, cfg, cull=False, grouped=True,
                      scene=tess_with_hidden_emitter(cfg.resolution))
    hdr_h, _ = inp.kernel()
    hdr_r, rec_r = inp.kernel(emit=True)
    hdr_p, rec_p = inp.plain(emit=True)
    check(torch.equal(hdr_h, hdr_r), "K2g behind the panel: hdr mode and "
          "records_only mode give different images")
    compare_trace("K2g behind the panel hdr/records_only", hdr_r, rec_r,
                  hdr_p, rec_p, inp.packed)
    # The case occurs: camera rays that end at the panel (bounce 0) and
    # meet the hidden sphere further on, in warps whose other lanes go on.
    prim = (rec_r[:, 0] & (cuda_path.OCC_BIT - 1)).long() - 1
    ends = ((prim >= 0) & (prim < inp.num_tris)
            & (inp.packed.atab[9, prim.clamp_min(0)] > 0.5)).any(dim=0)
    cam = cuda_path.camera_vector(inp.scene.camera, cfg).to(ends.device)
    pix = torch.arange(cfg.num_pixels, device=ends.device)
    sx = ((pix % cfg.width).float() + 0.5) / cfg.width * 2.0 - 1.0
    sy = -(((pix // cfg.width).float() + 0.5) / cfg.height * 2.0 - 1.0)
    d = sx[:, None] * cam[3:6] + sy[:, None] * cam[6:9] - cam[9:12]
    d = d / d.norm(dim=-1, keepdim=True)
    sph = inp.scene.spheres.to(ends.device)
    _, meets = sphere_candidates(sph.center[-1:], sph.radius[-1:],
                                 cam[0:3].expand_as(d), d, RAY_TMIN, RAY_TMAX)
    witness = ends & meets[:, 0]
    mixed = int((witness.view(-1, 32).any(dim=1)
                 & ~ends.view(-1, 32).all(dim=1)).sum())
    check(mixed > 0, "K2g behind the panel: no warp holds the case")
    log(f"  K2g behind the panel: {int(witness.sum())} pixels end at the "
        f"panel with the emissive sphere behind it, in {mixed} warps whose "
        "other lanes go on; hdr mode equals records_only and the plain "
        "version")
    del inp
    # K3g on the same scene: lanes of one warp that end at different bounces,
    # on the panel or on the emissive sphere, each reversing only its own.
    sh = ShadeInputs(None, cfg, grouped=True,
                     scene=tess_with_hidden_emitter(cfg.resolution))
    k_read, k_again = sh.kernel(), sh.kernel()
    k_regen = sh.kernel(regenerate=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k_read, k_again)),
          "K3g behind the panel: two launches on the same inputs differ")
    ref, nudged = sh.plain(), sh.plain(nudge=True)
    compare_grads("K3g behind the panel draws read", k_read, ref, nudged=nudged)
    compare_grads("K3g behind the panel draws regenerated", k_regen, ref,
                  nudged=nudged)
    del sh

    # Forced onto the static tier's scenes: K2g's records are K2's.
    for scene_name in SCENES:
        st = TraceInputs(scene_name, cfg, cull=True)
        gr = TraceInputs(scene_name, cfg, cull=True, grouped=True)
        draws = cuda_path.pregen_draws_kernel(st.offsets_i32, cfg)
        for d, emit in ((None, False), (draws, True), (None, True)):
            h_s, r_s = st.kernel(d, emit)
            h_g, r_g = gr.kernel(d, emit)
            torch.cuda.synchronize()
            same = torch.equal(h_s, h_g) and (not emit
                                              or torch.equal(r_s, r_g))
            check(same, f"K2g forced onto {scene_name} (emit {emit}, draws "
                  f"{d is not None}): not bit-equal to K2")
        log(f"  K2g forced onto {scene_name}: images and records bit-equal to "
            "K2's in the three modes")
        sh = ShadeInputs(scene_name, cfg)
        k3, k3g, k3g_again = sh.kernel(), sh.kernel(grouped=True), \
            sh.kernel(grouped=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k3g, k3g_again)),
              f"K3g forced onto {scene_name}: two launches differ")
        ref, nudged = sh.plain(), sh.plain(nudge=True)
        shifted = tuple(a + (b - c) for a, b, c in zip(k3, nudged, ref))
        compare_grads(f"K3g forced onto {scene_name} vs K3", k3g, k3,
                      nudged=shifted)
    return errs


def phase_grouped_path(label, scene_kw, steps):
    """Paths K and L: the tessellated box at 512 x 512 x 16 spp x 3
    bounces. Forward through ``render_path_cuda_impl`` in hdr mode and with
    records + draws + cull (bench_grouped.py's forward line); then gradients
    of ``render_path_decoupled_fused(scene, draws=..., occluders=...).mean()``
    for every float tensor, ``steps`` chained steps with one K2g and one K3g
    launch each, counted; two more under the profiler."""
    cfg = RenderConfig(**BENCH)
    scene = cornell_box_tessellated(resolution=cfg.resolution, **scene_kw)
    n_tris = scene.triangles.num_triangles
    log(f"== {label}: cornell_box_tessellated({scene_kw}), {n_tris} "
        f"triangles, {cfg.width}x{cfg.height} x {cfg.spp} spp x "
        f"{cfg.bounces} bounces")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    occluders = potential_occluders(scene, cfg)
    occ_s = time.perf_counter() - start
    draws = cuda_path.pregen_draws(cfg)
    compare_draws(f"K1 at {label}", draws,
                  cuda_path.pregen_draws_plain(pixel_rng_offsets(cfg, "cuda"), cfg))
    log(f"  {label}: occluder cull keeps {sum(occluders)} of {n_tris} "
        f"triangles in the shadow table ({occ_s:.2f} s on the host)")
    reset_launches()
    hdr = cuda_path.render_path_cuda_impl(scene, cfg)
    hdr_r, aux = cuda_path.render_path_cuda_impl(
        scene, cfg, emit_records=True, draws=draws, occluders=occluders)
    torch.cuda.synchronize()
    fwd_launches = read_launches()
    check(fwd_launches == launches_of(path_kernel_grouped=2),
          f"path {label} forward: launches {fwd_launches}")
    check(hdr.shape == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(hdr).all()), f"path {label}: image")
    check(torch.equal(hdr, hdr_r), f"path {label}: hdr mode and records + "
          "draws + cull give different images")
    mean = hdr.mean(dim=(0, 1)).tolist()
    check(all(v > 0.0 for v in mean), f"path {label}: a black image {mean}")

    leaves = with_grad(scene)

    def one_step(loss):
        color = leaves.light.color * (1.0 + loss.detach() * 1e-7)
        light = dataclasses.replace(leaves.light, color=color)
        out = cuda_shade.render_path_decoupled_fused(
            dataclasses.replace(leaves, light=light), cfg, draws=draws,
            occluders=occluders)
        return out, scene_grads(leaves, out)

    loss = torch.zeros((), device="cuda")
    step_ms, grads = [], {}
    for step in range(steps):
        before = read_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out, grads = one_step(loss)
        loss = out.mean()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        after = read_launches()
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == launches_of(path_kernel_grouped=1,
                                      shade_bwd_grouped_kernel=1),
              f"path {label} step {step}: launches {per_step}, expected one "
              "K2g and one K3g")
    launches = read_launches()
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"path {label}: d {name} not "
              "finite")
    for name in GRAD_GROUPS:
        check(name in grads and grads[name].abs().max().item() > 0.0,
              f"path {label}: gradient of {name} is missing or all zero")
    # The forward entry's time (launches made here are not the main path's).
    fwd_ms = time_ms(lambda: cuda_path.render_path_cuda_impl(scene, cfg),
                     repeats=3)
    emit_ms = time_ms(lambda: cuda_path.render_path_cuda_impl(
        scene, cfg, emit_records=True, draws=draws, occluders=occluders),
        repeats=3)
    log(f"  {label} forward (CUDA events around the entry, host work "
        f"included): hdr {fwd_ms[1]:.2f} ms, records + draws + cull "
        f"{emit_ms[1]:.2f} ms; mean radiance {[round(v, 4) for v in mean]}")

    def two_more():
        chained = loss
        for _ in range(2):
            chained = one_step(chained)[0].mean()

    wall_ms, busy_ms, top = device_busy(two_more)
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  path {label}: loss {loss.item():.6f}; step times "
        + ", ".join(f"{t:.2f}" for t in step_ms) + " ms (host clock, first "
        f"step includes warm-up); under the profiler {wall_ms / 2:.2f} ms per "
        f"step of which the card is busy {busy_ms / 2:.3f} ms ({share}); most "
        "device time: " + ", ".join(f"{name} {ms / 2:.3f} ms"
                                    for name, ms in top)
        + f"; launches {launches}; peak device memory {peak:.2f} GiB")
    return launches, dict(
        triangles=n_tris, shadow_triangles=sum(occluders),
        occluders_s=occ_s, forward_hdr_ms=fwd_ms[1],
        forward_records_ms=emit_ms[1], steps_ms=step_ms,
        profiled_ms=wall_ms / 2, device_busy_ms=busy_ms / 2,
        peak_gib=peak)


def tier_rows(launches, resources, cases):
    """K2 / K2g and K3 / K3g rows at 512 x 512 x 16 spp x 3 bounces, as a
    path launches them (records, draws read, occluder cull): against their
    plain versions, their times, their bounds. ``cases``: (label, scene,
    grouped, stride, sphere_slack) — the path's label in ``launches``, its
    scene, the tier, every how many pixels the trace's plain version runs
    (it is launch-bound: a Python loop over the groups takes about a second
    per sample-bounce step at 12,802 triangles, whatever the lane count;
    its counts of box and triangle tests, scaled to the frame, give K2g's
    bound) and the cull's sphere slack."""
    rows = []
    cfg = RenderConfig(pixel_chunk=65536, **BENCH)
    n = cfg.num_pixels
    for label, scene, grouped, stride, slack in cases:
        g = "g" if grouped else ""
        inp = TraceInputs(None, cfg, cull=True, grouped=grouped, scene=scene,
                          sphere_slack=slack)
        shape = (f"{label}: 512x512 x 16 spp x 3 bounces, {inp.num_tris} "
                 f"triangles" + (f", {inp.packed.num_spheres} spheres"
                                 if inp.packed.num_spheres > 2 else "")
                 + (f", {inp.packed.grouped.num_shadow} in the shadow table"
                    if grouped else ""))
        draws = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
        hdr_k, rec_k = inp.kernel(draws, emit=True)
        _, rec_r = inp.kernel(emit=True)
        torch.cuda.synchronize()
        check(torch.equal(rec_k, rec_r), f"K2{g} at {label}: draws read and "
              "draws regenerated give different records")
        del rec_r
        pix = torch.arange(0, n, stride, device="cuda")
        sampled = pix.numel()
        stats = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr_p, rec_p = cuda_path.render_path_plain(
            inp.offsets[pix], 0 if stride == 1 else pix, inp.packed,
            inp.shadow_idx, [d[..., pix] for d in draws],
            cfg.replace(pixel_chunk=sampled), True,
            stats if grouped else None)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        flips, err = compare_trace(
            f"K2{g} at {label} ({sampled} pixels)", hdr_k[:, pix],
            rec_k[..., pix], hdr_p, rec_p, inp.packed)
        del hdr_p, rec_p
        k_ms = time_ms(lambda: inp.kernel(draws, emit=True))
        h_ms = time_ms(lambda: inp.kernel(), repeats=3)
        if grouped:
            bound, by, counts = grouped_trace_bound(inp, rec_k, stats,
                                                    n / sampled, True, True)
            h_bound, h_by, h_counts = grouped_trace_bound(
                inp, rec_k, stats, n / sampled, False, False)
            wide = int(inp.packed.grouped.sup.shape[1] > cuda_path.WIDE_SUPERS)
            trace, template = "path_grouped_kernel", f", WIDE={wide}>"
        else:
            shares = k2_prefilter_shares(inp)
            bound, by, counts = trace_bound(inp, rec_k, shares, True, True)
            h_bound, h_by, h_counts = trace_bound(inp, rec_k, shares, False,
                                                  False)
            trace, template = "path_kernel", ">"
        smem, per_sm = path_occupancy(inp, True, True)
        _, h_per_sm = path_occupancy(inp, False, False)
        h_res = resources[f"{trace}<EMIT=0, READ_DRAWS=0{template}"]
        suffix = f", {label}" if inp.packed.num_spheres > 2 else ""
        rows.append(dict(
            name=f"{trace}[emit_records, draws read, occluder cull{suffix}]",
            route="cuda", source=PATH_SOURCE,
            replaces=K2G_REPLACES if grouped else K2_REPLACES, shape=shape,
            launches=launches[label][f"path_kernel{'_grouped' * grouped}"],
            launches_per_step=1, max_abs_err=err, flip_share=flips,
            ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=plain_ms,
            plain_pixels=sampled, bound_ms=bound, bound_by=by,
            library_ms=None, hdr_ms=h_ms[1], hdr_bound_ms=h_bound,
            hdr_bound_by=h_by, hdr_operations=h_counts["operations"],
            hdr_registers=h_res["registers"],
            hdr_stack_bytes=h_res["stack_bytes"], hdr_blocks_per_sm=h_per_sm,
            mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3), smem_bytes=smem,
            blocks_per_sm=per_sm, **({"wide_sweep": bool(wide)} if grouped
                                     else {}),
            **resource_fields(resources[
                f"{trace}<EMIT=1, READ_DRAWS=1{template}"]),
            **counts))
        log(f"  K2{g} at {label}: plain version on {sampled} pixels "
            f"{plain_ms:.0f} ms; {counts}; hdr mode {h_ms[1]:.3f} ms, bound "
            f"{h_bound:.3f} ms by {h_by} ({h_counts}); {smem} B shared, "
            f"{per_sm} blocks per SM ({h_per_sm} in hdr mode)")
        del hdr_k, rec_k, draws, inp
        torch.cuda.empty_cache()

        sh = ShadeInputs(None, cfg, grouped=grouped, scene=scene)
        got, again = sh.kernel(), sh.kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K3{g} at {label}: two launches differ")
        start = time.perf_counter()
        ref = sh.plain()
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - start)
        err = compare_grads(f"K3{g} at {label}", got, ref,
                            nudged=sh.plain(nudge=True))
        k_ms = time_ms(lambda: sh.kernel())
        r_ms = time_ms(lambda: sh.kernel(regenerate=True), repeats=3)
        (bound, by), iters = shade_bound(sh, False)
        (r_bound, r_by), _ = shade_bound(sh, True)
        smem, per_sm = shade_occupancy(sh, False)
        shade = f"shade_bwd{'_grouped' * grouped}_kernel"
        sph = int(sh.table.shape[0] == cuda_shade.NROWS_TAB_SPH)
        res = resources[f"{shade}<SPH={sph}, RNG=0>"]
        rows.append(dict(
            name=f"{shade}[draws read{suffix}]", route="cuda",
            source=SHADE_SOURCE,
            replaces=K3G_REPLACES if grouped else SHADE_REPLACES,
            shape=shape, launches=launches[label][shade],
            max_abs_err=err, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=None,
            regenerated_ms=r_ms[1], regenerated_bound_ms=r_bound,
            regenerated_bound_by=r_by, live_iterations=iters,
            smem_bytes=smem, blocks_per_sm=per_sm,
            regenerated_blocks_per_sm=shade_occupancy(sh, True)[1],
            **resource_fields(res)))
        del sh, ref, got, again
        torch.cuda.empty_cache()
    for row in rows:
        log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}), bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain "
            f"{row['plain_ms']:.1f} ms, launches {row['launches']}, "
            f"{row['smem_bytes']} B shared, {row['blocks_per_sm']} blocks "
            f"per SM, {row['registers']} registers, {row['stack_bytes']} B "
            "stack")
    return rows


def grouped_rows(launches, resources):
    """K2g and K3g at the shapes of paths K and L: the plain sweep on the
    whole frame at K, on every L_PIXEL_STRIDE-th pixel at L."""
    res = (BENCH["width"], BENCH["height"])
    return tier_rows(launches, resources, [
        (label, cornell_box_tessellated(resolution=res, **kw), True, stride,
         0.0)
        for label, kw, stride in (("K", TESS_K, 1),
                                  ("L", TESS_L, L_PIXEL_STRIDE))])


# ---------------------------------------------------------------------------
# Phase spheres: the box with many small spheres, and the tier rule by table
# size
# ---------------------------------------------------------------------------

SPHERES_FRAME = dict(width=800, height=600, spp=16, bounces=3)
SPHERES_STEPS = 4
MIS_SPHERES = dict(width=128, height=96, camera_rays=2, mis_samples=30)
# The traces alone on both tiers across sphere counts: where the grouped
# kernel overtakes the static one (cuda_path / cuda_mis.TRACE_ALONE_BYTES).
TIER_SWEEP = (300, 450, 600, 778, 1000, 1500)
MIS_SWEEP = dict(width=256, height=192, camera_rays=2, mis_samples=30)
# The tier the rule takes for each scene, on the path and the MIS route.
SPHERES_GROUPED = {"box+300": False, "box+1000": True}


# On a scene with small spheres in view K3's float32 cotangents are
# ill-conditioned on the lanes whose camera ray meets a small sphere: there
# every lane's float32 cotangent lies 4-11 % of its size from the float64
# evaluation, in the kernel and the plain version alike, through the sphere
# quadratic's float32 arithmetic (tools/sphere_conditioning.py; PERF.md §6).
# At 128 x 96 K3 is held to compare_grads on the pixels whose paths meet
# none of the small spheres, and its whole frame's distances are printed; at
# 512 x 512 (the rows) compare_grads holds on the whole frame.


def with_cotangent(sh: ShadeInputs, g, fn):
    """``fn()`` with ``sh``'s cotangent replaced by ``g``."""
    kept, sh.g = sh.g, g
    try:
        return fn()
    finally:
        sh.g = kept


def shade_split(sh: ShadeInputs, keep):
    """Kernel, plain version, float64 evaluation and the plain version on
    nudged draws, each by ``grad_groups``, for the cotangent of the pixels
    ``keep`` alone."""
    return tuple(grad_groups(*x) for x in with_cotangent(
        sh, sh.g * keep.float(), lambda: (sh.kernel(), sh.plain(), sh.exact(),
                                          sh.plain(nudge=True))))


def split_distances(k, p, e, m):
    """Per group, over the float64 evaluation's largest magnitude: kernel
    and plain version from it, from each other, and how far the one-ulp
    nudge moves the plain version."""
    out = {}
    for name, r in e.items():
        scale = r.abs().max().item() or 1.0
        out[name] = dict(
            scale=scale,
            kernel_f64=(k[name].double() - r).abs().max().item() / scale,
            plain_f64=(p[name].double() - r).abs().max().item() / scale,
            kernel_plain=(k[name] - p[name]).abs().max().item() / scale,
            nudge=(m[name] - p[name]).abs().max().item() / scale)
    return out


def meets_added(sh: ShadeInputs, first: int, count: int):
    """[n] pixels whose paths meet one of the primitives first .. first +
    count (any sample, any bounce)."""
    prim = (sh.records & (cuda_path.OCC_BIT - 1)).long() - 1
    return ((prim >= first) & (prim < first + count)).any(dim=0).any(dim=0)


def check_shade_small_spheres(tag, sh: ShadeInputs, first: int, count: int):
    """K3 or K3g on a scene whose primitives first .. first + count are small
    spheres in view: compare_grads on the pixels clear of them; the whole
    frame's distances from the float64 evaluation printed. Returns (the
    largest difference on the clear pixels, the whole frame's
    distances)."""
    clear = ~meets_added(sh, first, count)
    k, p, _, m = with_cotangent(sh, sh.g * clear.float(), lambda: (
        sh.kernel(), sh.plain(), None, sh.plain(nudge=True)))
    err = compare_grads(f"{tag}, the {int(clear.sum())} pixels clear of the "
                        "added spheres", k, p, nudged=m)
    dist = split_distances(*shade_split(sh, torch.ones_like(clear)))
    log(f"  {tag}, whole frame, distance over the group's largest magnitude, "
        "kernel-f64 / plain-f64 / kernel-plain (one-ulp nudge): " + ", ".join(
            f"{n} {v['kernel_f64']:.1e} / {v['plain_f64']:.1e} / "
            f"{v['kernel_plain']:.1e} ({v['nudge']:.1e})"
            for n, v in dist.items()))
    return err, dist


def spheres_small(name):
    """The kernels the rule takes for ``name`` against their plain versions:
    K1, K2 or K2g and K3 or K3g at 128 x 96 x 4 spp x 3 bounces, K4 or K4g
    and K5 or K5g at 128 x 96 x 2 x 30, and one ``render_mis_decoupled``
    step with gradients against autograd through the replay of its records;
    on box+1000 the static K2, forced onto it (its block opted in past 48
    KiB), gives K2g's images and records by sha256. Returns the largest
    differences and the static blocks' shared memory and blocks per SM."""
    cfg = RenderConfig(**SMALL)
    scene = box_with_many_spheres(name, cfg.resolution)
    grouped = SPHERES_GROUPED[name]
    g = "g" if grouped else ""
    check(cuda_shade.fused_tier(scene) == grouped,
          f"{name}: the fused path route's tier is not "
          f"{'grouped' if grouped else 'static'}")
    check(cuda_path.grouped_tier(scene, cuda_path.trace_plan(
        scene, alone=True)) == grouped, f"{name}: the path trace alone does "
          "not take the fused route's tier")
    log(f"== spheres {name}: {scene.spheres.num_spheres} spheres, the "
        f"{'grouped' if grouped else 'static'} tier, kernels against their "
        f"plain versions at {cfg.width} x {cfg.height} x {cfg.spp} spp x "
        f"{cfg.bounces} bounces")
    out = {}
    inp = TraceInputs(None, cfg, cull=True, grouped=grouped, scene=scene)
    full = TraceInputs(None, cfg, cull=False, grouped=grouped, scene=scene)
    draws = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
    compare_draws(f"K1 {name}", draws,
                  cuda_path.pregen_draws_plain(inp.offsets, cfg))
    hdr_h, _ = full.kernel()
    hdr_e, rec_e = inp.kernel(draws, emit=True)
    hdr_r, rec_r = full.kernel(emit=True)
    torch.cuda.synchronize()
    check(torch.equal(hdr_h, hdr_e) and torch.equal(hdr_h, hdr_r),
          f"K2{g} {name}: the three modes do not give the same image")
    hdr_p, rec_p = inp.plain(draws, emit=True)
    out[f"K2{g}"] = compare_trace(f"K2{g} {name} emit+draws+cull", hdr_e,
                                  rec_e, hdr_p, rec_p, inp.packed)[1]
    hdr_q, rec_q = full.plain(emit=True)
    compare_trace(f"K2{g} {name} records_only", hdr_r, rec_r, hdr_q, rec_q,
                  inp.packed)
    emissive = int((inp.packed.atab[9] > 0.5).sum())
    smem, per_sm = path_occupancy(inp, True, True)
    out[f"K2{g} smem_bytes"], out[f"K2{g} blocks_per_sm"] = smem, per_sm
    log(f"  K2{g} {name}: {emissive} emissive primitives, {smem} B shared, "
        f"{per_sm} blocks per SM")
    if grouped:
        st = TraceInputs(None, cfg, cull=True, scene=scene)
        for d, emit in ((None, False), (draws, True), (None, True)):
            h_s, r_s = st.kernel(d, emit)
            h_g, r_g = inp.kernel(d, emit)
            same = sha256(h_s) == sha256(h_g) and (
                not emit or sha256(r_s) == sha256(r_g))
            check(same, f"K2 forced onto {name} (emit {emit}, draws "
                  f"{d is not None}): not K2g's bits")
        smem, per_sm = path_occupancy(st, True, True)
        out["K2 forced smem_bytes"], out["K2 forced blocks_per_sm"] = smem, per_sm
        log(f"  K2 forced onto {name} ({smem} B shared, opted in, {per_sm} "
            "blocks per SM): images and records equal to K2g's by sha256 in "
            "the three modes")
        del st
    del inp, full, draws, hdr_h, hdr_e, rec_e, hdr_r, rec_r, hdr_p, rec_p
    del hdr_q, rec_q

    sh = ShadeInputs(None, cfg, grouped=grouped, scene=scene)
    k_read, k_again = sh.kernel(), sh.kernel()
    k_regen = sh.kernel(regenerate=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k_read, k_again)),
          f"K3{g} {name}: two launches on the same inputs differ")
    out[f"K3{g}"], out[f"K3{g} whole frame"] = check_shade_small_spheres(
        f"K3{g} {name} draws read", sh, sh.trace.num_tris,
        MANY_SPHERES[name][0])
    compare_grads(f"K3{g} {name} regenerated vs read", k_regen, k_read,
                  MODES_ATOL, MODES_RTOL, MODES_RTOL)
    smem, per_sm = shade_occupancy(sh, False)
    out[f"K3{g} smem_bytes"], out[f"K3{g} blocks_per_sm"] = smem, per_sm
    log(f"  K3{g} {name}: {smem} B shared, {per_sm} blocks per SM")
    del sh, k_read, k_again, k_regen

    mcfg = RenderConfig(integrator="mis", **MIS_SPHERES)
    occluders = potential_occluders(scene, mcfg)
    check(cuda_mis_bwd.fused_tier(scene, mcfg.mis_samples, occluders)
          == grouped, f"{name}: the fused MIS route's tier is not the path "
          "route's")
    check(not cuda_path.grouped_tier(scene, cuda_mis.mis_plan(
        scene, occluders, mcfg.mis_samples, alone=True)),
          f"{name}: the MIS trace alone is not static")
    tag = (f"{name} {mcfg.width}x{mcfg.height} x {mcfg.camera_rays} x "
           f"{mcfg.mis_samples}")
    mi = MisInputs(None, mcfg, cull=True, grouped=grouped, scene=scene)
    hdr_k, rec_k = mi.kernel(emit=True)
    hdr_p, rec_p = mi.plain(emit=True)
    out[f"K4{g}"] = compare_mis(f"K4{g} {tag}", hdr_k, rec_k, hdr_p, rec_p,
                                mi.packed)[1]
    # The forward route's tier (K4 alone) against the other, hdr mode: the
    # same image, and each one's time.
    other = MisInputs(None, mcfg, cull=True, grouped=not grouped, scene=scene)
    check(sha256(mi.kernel()[0]) == sha256(other.kernel()[0]),
          f"K4 and K4g on {tag}: different images")
    for label, inputs in (("K4g" if grouped else "K4", mi),
                          ("K4" if grouped else "K4g", other)):
        out[f"{label} hdr ms"] = time_ms(lambda: inputs.kernel(), repeats=3)[1]
    log(f"  {tag} hdr mode, the same image on both tiers: K4 "
        f"{out['K4 hdr ms']:.3f} ms, K4g {out['K4g hdr ms']:.3f} ms")
    del mi, other, hdr_k, rec_k, hdr_p, rec_p
    bw = MisBwdInputs(None, mcfg, grouped=grouped, scene=scene)
    got, again = bw.kernel(), bw.kernel()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K5{g} {tag}: two launches on the same inputs differ")
    out[f"K5{g}"] = compare_k5(f"K5{g} {tag}", got, bw.plain(),
                               bw.plain(nudge=True))
    del bw, got, again

    # One step of the MIS entry point with gradients, against autograd
    # through the replay of the same records.
    leaves = with_grad(scene)
    reset_launches()
    got = scene_grads(leaves, cuda_mis_bwd.render_mis_decoupled(
        leaves, mcfg, occluders=occluders))
    torch.cuda.synchronize()
    launched = read_launches()
    expect = launches_of(**{f"mis_kernel{'_grouped' if grouped else ''}": 1,
                            f"mis_bwd{'_grouped' if grouped else ''}_kernel": 1})
    check(launched == expect, f"render_mis_decoupled on {name}: launches "
          f"{launched}")
    ref_scene = with_grad(scene)
    _, rec = cuda_mis.render_mis_cuda_impl(ref_scene.detach(), mcfg,
                                           emit_records=True,
                                           occluders=occluders)
    views = cuda_mis_bwd._pack_diff_inputs_mis(ref_scene, mcfg)
    replay = cuda_mis_bwd.replay_mis(*views, rec,
                                     cuda_mis.sample_table(mcfg).cuda(), mcfg)
    ref = scene_grads(ref_scene, replay.T.reshape(mcfg.height, mcfg.width, 3))
    check(set(got) == set(ref) and len(ref) >= 12,
          f"gradient groups {sorted(got)} against {sorted(ref)}")
    parts, worst = [], 0.0
    for key, r in ref.items():
        scale = r.abs().max().item()
        err = (got[key] - r).abs().max().item()
        check(bool(torch.isfinite(got[key]).all()), f"{key}: not finite")
        check(err <= GRAD_ATOL * max(scale, 1.0) + GRAD_RTOL * scale,
              f"render_mis_decoupled on {name}: d {key} differs from "
              f"autograd through the replay by {err:.3e} (largest magnitude "
              f"{scale:.3e})")
        parts.append(f"{key} {err / max(scale, 1.0):.1e}")
        worst = max(worst, err)
    out["K5 path"] = worst
    log(f"  render_mis_decoupled step on {tag} (K4{g} + K5{g}, one launch "
        "each) vs autograd through the replay, largest difference over "
        "max(largest magnitude, 1): " + ", ".join(parts))
    torch.cuda.empty_cache()
    return out


def spheres_paths(name):
    """The scene's paths at full width: a frame of ``render_path_cuda`` at
    800 x 600 x 16 spp x 3 bounces (timed, beside the same frame forced onto
    the other tier: the same image), then SPHERES_STEPS Adam steps of
    ``inverse_render(fast=True)`` at 512 x 512 x 16 spp x 3 bounces from
    perturbed centers, albedo and emission (one K2 or K2g and one K3 or K3g
    launch per step, counted), then the fit again warm and under the
    profiler."""
    grouped = SPHERES_GROUPED[name]
    trace = f"path_kernel{'_grouped' * grouped}"
    fcfg = RenderConfig(**SPHERES_FRAME)
    scene = box_with_many_spheres(name, fcfg.resolution)
    log(f"== spheres {name}: render_path_cuda at {fcfg.width}x{fcfg.height} "
        f"x {fcfg.spp} spp x {fcfg.bounces} bounces")
    reset_launches()
    hdr = cuda_path.render_path_cuda(scene, fcfg)
    torch.cuda.synchronize()
    launched = read_launches()
    check(launched == launches_of(**{trace: 1}),
          f"{name} frame: launches {launched}")
    mean = hdr.mean(dim=(0, 1)).tolist()
    check(hdr.shape == (fcfg.height, fcfg.width, 3)
          and bool(torch.isfinite(hdr).all()) and min(mean) > 0.0,
          f"{name} frame: mean radiance {mean}")
    other = cuda_path.render_path_cuda_impl(scene, fcfg, grouped=not grouped)
    check(sha256(hdr) == sha256(other), f"{name} frame: K2's and K2g's "
          "images differ")
    frame_ms = time_ms(lambda: cuda_path.render_path_cuda(scene, fcfg),
                       repeats=3)
    other_ms = time_ms(lambda: cuda_path.render_path_cuda_impl(
        scene, fcfg, grouped=not grouped), repeats=3)
    tiers = ("K2g", "K2") if grouped else ("K2", "K2g")
    log(f"  {name} frame: {tiers[0]} (the rule's) {frame_ms[1]:.2f} ms (min "
        f"{frame_ms[0]:.2f}, max {frame_ms[2]:.2f}), forced onto {tiers[1]} "
        f"{other_ms[1]:.2f} ms (min {other_ms[0]:.2f}, max {other_ms[2]:.2f}),"
        " the same image; CUDA events around the entry, packing included; "
        f"mean radiance {[round(v, 4) for v in mean]}")
    del hdr, other

    cfg = RenderConfig(pixel_chunk=65536, **BENCH)
    launches, fit = inverse_fit(f"spheres {name}", box_with_many_spheres(
        name, cfg.resolution), cfg, SPHERES_STEPS, grouped)
    return launches, dict(frame_ms=frame_ms[1], frame_ms_min=frame_ms[0],
                          frame_ms_max=frame_ms[2],
                          frame_other_tier_ms=other_ms[1],
                          frame_other_tier_ms_min=other_ms[0],
                          frame_other_tier_ms_max=other_ms[2], **fit)


def tier_sweep():
    """K2 against K2g (``render_path_cuda_impl``, 800 x 600 x 16 spp x 3
    bounces) and K4 against K4g (``render_mis_cuda_impl``, 256 x 192 x 2 x
    30), hdr mode, on the box with TIER_SWEEP small spheres: the same image
    on both tiers, each one's time, the static block's tables, and the tier
    the trace-alone rule takes."""
    fcfg = RenderConfig(**SPHERES_FRAME)
    mcfg = RenderConfig(integrator="mis", **MIS_SWEEP)
    log("== spheres: the traces alone on both tiers, 800 x 600 x 16 spp x 3 "
        "bounces (K2) and 256 x 192 x 2 x 30 (K4)")
    out = {}
    for n in TIER_SWEEP:
        scene = with_box_spheres(fcfg.resolution, n, MANY_SPHERES_SEED,
                                 MANY_SPHERES_RADII)
        row = {}
        for label, render, cfg, plan in (
                ("K2", cuda_path.render_path_cuda_impl, fcfg,
                 lambda alone: cuda_path.trace_plan(scene, alone=alone)),
                ("K4", cuda_mis.render_mis_cuda_impl, mcfg,
                 lambda alone: cuda_mis.mis_plan(scene, None,
                                                 mcfg.mis_samples, alone))):
            images = [render(scene, cfg, grouped=g) for g in (False, True)]
            check(sha256(images[0]) == sha256(images[1]),
                  f"{label} and {label}g on {n} spheres: different images")
            for g in (False, True):
                row[f"{label}{'g' * g} ms"] = time_ms(
                    lambda: render(scene, cfg, grouped=g), repeats=3)[1]
            smem_bytes, args = plan(False)
            row[f"{label} smem_bytes"] = smem_bytes(*args)
            row[f"{label} rule"] = (f"{label}g" if cuda_path.grouped_tier(
                scene, plan(True)) else label)
        out[n] = row
        log(f"  {n} spheres: " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    return out


def k3_in_view_split():
    """K3 on the in-view probe scene (``spheres_at_static_limit(in_view=
    True)``, 169 primitives, 128 x 96 x 4 spp x 3 bounces): the kernel and
    the plain version each against the float64 evaluation of the same
    records and draws, group by group, on the whole frame and on the lanes
    of the pixels whose paths meet no added sphere, meet one with the
    camera ray, or meet one only at a later bounce; then the light centre's
    cotangent lane by lane (plain version, float32 and float64)."""
    cfg = RenderConfig(**SMALL)
    scene = spheres_at_static_limit(cfg.resolution, in_view=True)
    log(f"== spheres: K3 split on the in-view scene, {PROBE_PRIMS} primitives, "
        f"{cfg.width} x {cfg.height} x {cfg.spp} spp x {cfg.bounces} bounces")
    sh = ShadeInputs(None, cfg, scene=scene)
    first, count = sh.trace.num_tris, PROBE_PRIMS - sh.trace.num_tris - 2
    result = {}
    result["clear_max_abs_err"], result["whole frame"] = \
        check_shade_small_spheres("K3 in view", sh, first, count)
    prim = (sh.records & (cuda_path.OCC_BIT - 1)).long() - 1
    added = (prim >= first) & (prim < first + count)
    camera = added[:, 0].any(dim=0)
    later = added.any(dim=1).any(dim=0) & ~camera
    classes = {"clear": ~(camera | later), "camera ray": camera,
               "later bounce": later}
    for label, keep in classes.items():
        dist = split_distances(*shade_split(sh, keep))
        result[label] = dict(pixels=int(keep.sum()), groups=dist)
        log(f"  K3 in view, {label} ({int(keep.sum())} pixels), distance over "
            "the group's largest magnitude, kernel-f64 / plain-f64 / "
            "kernel-plain (one-ulp nudge): " + ", ".join(
                f"{n} {v['kernel_f64']:.1e} / {v['plain_f64']:.1e} / "
                f"{v['kernel_plain']:.1e} ({v['nudge']:.1e})"
                for n, v in dist.items()))

    # The light centre's cotangent lane by lane: the light vector as a
    # [9, spp, n] leaf of the replay, in float32 and in float64.
    def per_lane(dtype):
        light = sh.light.to(dtype)[:, None, None].expand(
            9, cfg.spp, cfg.num_pixels).clone().requires_grad_(True)
        lum = cuda_shade.replay_packed(sh.table.to(dtype), sh.cam.to(dtype),
                                       light, sh.records,
                                       [d.to(dtype) for d in sh.draws], cfg)
        return torch.autograd.grad((sh.g.to(dtype) * lum).sum(), light)[0][:3]

    lane32, lane64 = per_lane(torch.float32).double(), per_lane(torch.float64)
    err = (lane32 - lane64).abs()
    lanes = {}
    for label, keep in classes.items():
        sel = keep[None, None, :].expand_as(lane64)
        lanes[label] = dict(
            abs_sum=lane64[sel].abs().sum().item(),
            rounding_sum=err[sel].sum().item(),
            largest_rounding=err[sel].max().item() if sel.any() else 0.0)
    total = lane64.sum(dim=(1, 2))
    lanes["sum"] = total.tolist()
    lanes["abs_sum"] = lane64.abs().sum(dim=(1, 2)).tolist()
    lanes["f32_sum_minus_f64"] = (lane32.sum(dim=(1, 2)) - total).tolist()
    result["light_center_lanes"] = lanes
    log("  K3 in view, light centre lane by lane (plain, f32 vs f64): sums "
        f"{[f'{v:.3e}' for v in lanes['sum']]}, sums of |lane| "
        f"{[f'{v:.3e}' for v in lanes['abs_sum']]}, f32 - f64 of the sums "
        f"{[f'{v:.2e}' for v in lanes['f32_sum_minus_f64']]}; per class "
        "(sum of |lane|, sum of |f32 - f64|, largest |f32 - f64|): "
        + ", ".join(f"{c} {v['abs_sum']:.3e} / {v['rounding_sum']:.2e} / "
                    f"{v['largest_rounding']:.2e}"
                    for c, v in lanes.items() if isinstance(v, dict)))
    return result


def phase_spheres(resources):
    """The box with many small spheres: box+300 on the static tier, box+1000
    on the grouped tier by the table-size rule, each kernel against its
    plain version, the paths at full width, the rows; and K3's split on the
    in-view scene."""
    small = {name: spheres_small(name) for name in SPHERES_GROUPED}
    launches, paths = {}, {}
    for name in SPHERES_GROUPED:
        launches[name], paths[name] = spheres_paths(name)
    res = (BENCH["width"], BENCH["height"])
    rows = tier_rows(launches, resources, [
        (name, box_with_many_spheres(name, res), grouped, L_PIXEL_STRIDE, 0.5)
        for name, grouped in SPHERES_GROUPED.items()])
    sweep = tier_sweep()
    split = k3_in_view_split()
    return rows, dict(small=small, paths=paths, tier_sweep=sweep,
                      k3_in_view=split)


# ---------------------------------------------------------------------------
# The MIS grouped tier: K4g and K5g
# ---------------------------------------------------------------------------

def phase_mis_grouped():
    """K4g and K5g against their plain versions at the small MIS size on the
    252-triangle walls, with and without the two analytic spheres, cull on
    and off; both forced onto the box and sphere scenes against K4 and K5;
    and K4g and K5g at 1,282 triangles, whose records hold primitive codes
    above 10 bits."""
    cfg = RenderConfig(integrator="mis", **MIS_SMALL)
    log(f"== mis_grouped: K4g and K5g against their plain versions, "
        f"{cfg.width} x {cfg.height} x {cfg.camera_rays} camera rays x "
        f"{cfg.mis_samples} samples")
    start = time.perf_counter()
    errs = {}
    for scene_name in ("tess-252", "tess-252+spheres"):
        for cull in (True, False):
            tag = f"{scene_name}/{'cull' if cull else 'no cull'}"
            inp = MisInputs(scene_name, cfg, cull, grouped=True)
            hdr_h, none = inp.kernel()
            hdr_e, rec_e = inp.kernel(emit=True)
            hdr_2, rec_2 = inp.kernel(emit=True)
            torch.cuda.synchronize()
            check(none is None, "hdr mode returned records")
            check(torch.equal(hdr_h, hdr_e), f"K4g {tag}: the image with "
                  "records on is not bit-equal to the image with records off")
            check(torch.equal(hdr_e, hdr_2)
                  and torch.equal(rec_e.camera, rec_2.camera)
                  and torch.equal(rec_e.samples, rec_2.samples),
                  f"K4g {tag}: two launches on the same inputs differ")
            hdr_p, rec_p = inp.plain(emit=True)
            errs[f"K4g {tag}"] = compare_mis(f"K4g {tag}", hdr_e, rec_e, hdr_p,
                                             rec_p, inp.packed)[1]
            hdr_b, rec_b = inp.brute(emit=True)
            dead_p = check_same_mis_decisions(
                f"plain sweep {tag} vs brute force", rec_p, rec_b, inp.packed)
            dead_k = check_same_mis_decisions(
                f"K4g {tag} vs brute force", rec_e, rec_b, inp.packed)
            for what, hdr in (("plain sweep", hdr_p), ("K4g", hdr_e)):
                check(bool(((hdr - hdr_b).abs()
                            <= 5e-8 + 1e-6 * hdr_b.abs()).all()),
                      f"{what} {tag}: image differs from the brute force "
                      "beyond atol 5e-8 / rtol 1e-6")
            log(f"  K4g {tag}: plain sweep and kernel make the brute force's "
                f"decisions (probe bits on dead lanes that differ: {dead_p}, "
                f"{dead_k}); max |K4g - brute force| "
                f"{(hdr_e - hdr_b).abs().max().item():.3e}")
            if not cull:
                continue
            bw = MisBwdInputs(scene_name, cfg, grouped=True)
            got, again = bw.kernel(), bw.kernel()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K5g {tag}: two launches on the same inputs differ")
            errs[f"K5g {tag}"] = compare_k5(f"K5g {tag}", got, bw.plain(),
                                            bw.plain(nudge=True))

    # Forced onto the static tier's scenes: K4g's images and records are
    # K4's on every lane; K5g lies within K5's limits of K5.
    for scene_name in SCENES:
        st = MisInputs(scene_name, cfg, cull=True)
        gr = MisInputs(scene_name, cfg, cull=True, grouped=True)
        for emit in (False, True):
            h_s, r_s = st.kernel(emit)
            h_g, r_g = gr.kernel(emit)
            torch.cuda.synchronize()
            same = torch.equal(h_s, h_g) and (
                not emit or (torch.equal(r_s.camera, r_g.camera)
                             and torch.equal(r_s.samples, r_g.samples)))
            check(same, f"K4g forced onto {scene_name} (records {emit}): not "
                  "bit-equal to K4")
        log(f"  K4g forced onto {scene_name}: images and records bit-equal to "
            "K4's on every lane, records on and off")
        bw = MisBwdInputs(scene_name, cfg)
        k5, k5g, k5g_again = (bw.kernel(), bw.kernel(grouped=True),
                              bw.kernel(grouped=True))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k5g, k5g_again)),
              f"K5g forced onto {scene_name}: two launches differ")
        ref, nudged = bw.plain(), bw.plain(nudge=True)
        shifted = tuple(a + (b - c) for a, b, c in zip(k5, nudged, ref))
        errs[f"K5g forced onto {scene_name}"] = compare_k5(
            f"K5g forced onto {scene_name} vs K5", k5g, k5, shifted)

    # 1,282 triangles: primitive codes above 10 bits in the records.
    cfg = RenderConfig(integrator="mis", **MIS_1282)
    scene = cornell_box_tessellated(resolution=cfg.resolution, **TESS_1282)
    inp = MisInputs(None, cfg, cull=True, grouped=True, scene=scene)
    hdr_k, rec_k = inp.kernel(emit=True)
    hdr_p, rec_p = inp.plain(emit=True)
    tag = f"K4g {inp.num_tris} triangles, {cfg.width} x {cfg.height}"
    errs[tag] = compare_mis(tag, hdr_k, rec_k, hdr_p, rec_p, inp.packed)[1]
    check_same_mis_decisions(f"{tag} vs brute force", rec_k,
                             inp.brute(emit=True)[1], inp.packed)
    f = mis_fields(rec_k)
    top = max(int(rec_k.camera.max()), int(f["cos_prim"].max()),
              int(f["vndf_prim"].max()))
    check(1023 < top <= inp.num_tris, f"{tag}: largest primitive code {top}")
    bw = MisBwdInputs(None, cfg, grouped=True, scene=scene)
    errs[f"K5g {inp.num_tris} triangles"] = compare_k5(
        f"K5g {inp.num_tris} triangles", bw.kernel(), bw.plain(),
        bw.plain(nudge=True))
    seconds = time.perf_counter() - start
    log(f"  {tag}: records hold primitive codes up to {top}; phase "
        f"mis_grouped took {seconds:.1f} s")
    return errs, seconds


def phase_mis_grouped_path(label, scene_name, scene, steps):
    """Paths M and N: the tessellated box at 512 x 512 x 6 camera rays x 300
    samples (benchmarks/bench_grouped.py --mis). Forward through
    ``render_mis_cuda_impl`` in hdr mode and with records + occluder cull;
    then gradients of ``render_mis_decoupled(scene, occluders=...).mean()``
    for every float tensor, ``steps`` steps with one K4g and one K5g launch
    each, counted; two more under the profiler."""
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    n_tris = scene.triangles.num_triangles
    log(f"== {label}: {scene_name}, {n_tris} triangles, "
        f"{scene.spheres.num_spheres} spheres, {cfg.width}x{cfg.height} x "
        f"{cfg.camera_rays} x {cfg.mis_samples}")
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    occluders = potential_occluders(scene, cfg)
    occ_s = time.perf_counter() - start
    reset_launches()
    hdr = cuda_mis.render_mis_cuda_impl(scene, cfg)
    hdr_r, _ = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                             occluders=occluders)
    torch.cuda.synchronize()
    fwd_launches = read_launches()
    check(fwd_launches == launches_of(mis_kernel_grouped=2),
          f"path {label}: forward launches {fwd_launches}")
    check(hdr.shape == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(hdr).all()), f"path {label}: image")
    gap = (hdr - hdr_r).abs().max().item()
    check(bool(((hdr - hdr_r).abs() <= 5e-8 + 1e-6 * hdr.abs()).all()),
          f"path {label}: records + cull change the image by {gap:.3e}")
    mean = hdr.mean(dim=(0, 1)).tolist()
    check(all(v > 0.0 for v in mean), f"path {label}: a black image {mean}")
    del hdr_r

    leaves = with_grad(scene)

    def one_step():
        out = cuda_mis_bwd.render_mis_decoupled(leaves, cfg,
                                                occluders=occluders)
        return out, scene_grads(leaves, out)

    step_ms, grads = [], {}
    for step in range(steps):
        before = read_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out, grads = one_step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        after = read_launches()
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == launches_of(mis_kernel_grouped=1,
                                      mis_bwd_grouped_kernel=1),
              f"path {label} step {step}: launches {per_step}, expected one "
              "K4g and one K5g")
    launches = read_launches()
    check(bool(torch.isfinite(out).all()), f"path {label}: image")
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"path {label}: d {name} not "
              "finite")
    wanted = ["light.emitted_radiance", "light.center", "triangles.verts",
              "triangles.roughness", "camera.position"]
    if scene.spheres.num_spheres:
        wanted.append("spheres.center")
    for name in wanted:
        check(name in grads and grads[name].abs().max().item() > 0.0,
              f"path {label}: gradient of {name} is missing or all zero")
    wall_ms, busy_ms, top = device_busy(lambda: [one_step()
                                                 for _ in range(2)])
    share = f"{busy_ms / wall_ms:.1%}" if busy_ms else "not measured"
    peak = torch.cuda.max_memory_allocated() / 2**30
    seconds = time.perf_counter() - started
    log(f"  path {label} {scene_name}: occluder cull keeps {sum(occluders)} "
        f"of {n_tris} triangles ({occ_s:.2f} s on the host); image mean "
        f"{[round(v, 4) for v in mean]}, records + cull vs hdr mode max "
        f"{gap:.3e}; step times " + ", ".join(f"{t:.1f}" for t in step_ms)
        + " ms (host clock, the first with warm-up); under the profiler "
        f"{wall_ms / 2:.1f} ms per step of which the card is busy "
        f"{busy_ms / 2:.1f} ms ({share}); most device time: "
        + ", ".join(f"{name} {ms / 2:.3f} ms" for name, ms in top)
        + f"; launches {launches}; peak device memory {peak:.2f} GiB; "
        f"{seconds:.1f} s")
    return launches, dict(
        triangles=n_tris, spheres=scene.spheres.num_spheres,
        shadow_triangles=sum(occluders), occluders_s=occ_s, steps_ms=step_ms,
        profiled_ms=wall_ms / 2, device_busy_ms=busy_ms / 2, peak_gib=peak,
        seconds=seconds)


def mis_grouped_rows(launches, resources):
    """K4g and K5g at the shapes of paths M and N, as those paths launch
    them (K4g with records and the occluder cull): K4g against the
    brute-force plain version on every ``stride``-th pixel at the full
    shape, and against the plain grouped sweep on the same pixels at fewer
    camera rays and samples (MIS_GROUPED_CHECK); K5g against
    ``mis_bwd_plain`` on the whole frame; their times and bounds."""
    log("== full: K4g and K5g at the shapes of paths M and N")
    started = time.perf_counter()
    rows = []
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    n = cfg.num_pixels
    for label, scene_name, scene in mis_grouped_path_scenes(cfg.resolution):
        key = f"{label} {scene_name}"
        chk = MIS_GROUPED_CHECK[label]
        inp = MisInputs(None, cfg, cull=True, grouped=True, scene=scene)
        sph = int(inp.packed.num_spheres > 0)
        shape = (f"{label}: {cfg.width}x{cfg.height} x {cfg.camera_rays} x "
                 f"{cfg.mis_samples}, {inp.num_tris} triangles "
                 f"({inp.packed.grouped.num_shadow} in the shadow table), "
                 f"{inp.packed.num_spheres} spheres")
        hdr, rec = inp.kernel(emit=True)
        k_ms = time_ms(lambda: inp.kernel(emit=True), repeats=3)
        h_ms = time_ms(lambda: inp.kernel(), repeats=3)
        # The timed launch against the brute-force plain version at the same
        # shape, on a sample of the frame.
        pix = torch.arange(0, n, chk["stride"], device="cuda")
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr_b, rec_b = inp.brute(emit=True, pix=pix)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        plain_shape = (f"brute force on every {chk['stride']}th pixel "
                       f"({pix.numel()}) x {cfg.camera_rays} x "
                       f"{cfg.mis_samples}")
        dead = check_same_mis_decisions(
            f"K4g at {key} vs brute force, {plain_shape}",
            cuda_mis.MisRecords(rec.camera[:, pix], rec.samples[..., pix]),
            rec_b, inp.packed)
        gap = (hdr[:, pix] - hdr_b).abs()
        err = gap.max().item()
        check(bool((gap <= 5e-8 + 1e-6 * hdr_b.abs()).all()),
              f"K4g at {key}: image differs from the brute force beyond "
              f"atol 5e-8 / rtol 1e-6 (max {err:.3e})")
        log(f"  K4g at {key}: the brute force's decisions on {plain_shape} "
            f"(probe bits on dead lanes that differ: {dead}); max |K4g - "
            f"brute force| {err:.3e}; brute force {plain_ms:.0f} ms")
        del hdr, hdr_b, rec_b, gap
        # The plain grouped sweep on the same pixels at fewer camera rays and
        # samples, against K4g on that configuration; its counts estimate
        # the bound's box and triangle tests.
        small = cfg.replace(camera_rays=chk["camera_rays"],
                            mis_samples=chk["mis_samples"])
        sub = MisInputs(None, small, cull=True, grouped=True, scene=scene)
        hdr_k, rec_k = sub.kernel(emit=True)
        stats = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        hdr_p, rec_p = sub.plain(emit=True, pix=pix, stats=stats)
        torch.cuda.synchronize()
        sweep_ms = 1e3 * (time.perf_counter() - start)
        sweep_shape = (f"grouped sweep on every {chk['stride']}th pixel x "
                       f"{small.camera_rays} x {small.mis_samples}")
        flips, sweep_err = compare_mis(
            f"K4g at {key} ({pix.numel()} pixels x {small.camera_rays} x "
            f"{small.mis_samples})", hdr_k[:, pix],
            cuda_mis.MisRecords(rec_k.camera[:, pix], rec_k.samples[..., pix]),
            hdr_p, rec_p, sub.packed)
        del hdr_k, rec_k, hdr_p, rec_p
        check(stats["shadow"].get("rays", 0) > 0,
              f"K4g at {key}: the sampled pixels hold no live sample")
        scale_rays = n / pix.numel() * cfg.camera_rays / small.camera_rays
        scale_samples = scale_rays * ((cfg.mis_samples // 3)
                                      / (small.mis_samples // 3))
        bound, by, counts = mis_grouped_bound(inp, rec, stats, scale_rays,
                                              scale_samples, emit=True)
        h_bound, h_by, _ = mis_grouped_bound(inp, rec, stats, scale_rays,
                                             scale_samples, emit=False)
        wide = int(inp.packed.grouped.sup.shape[1] > cuda_path.WIDE_SUPERS)
        res = resources[f"mis_grouped_kernel<EMIT=1, WIDE={wide}>"]
        smem, per_sm = grouped_occupancy(inp)
        rows.append(dict(
            name=f"mis_kernel[grouped, records, occluder cull, {scene_name}]",
            route="cuda", source=MIS_SOURCE, replaces=K4G_REPLACES,
            shape=shape, launches=launches[key]["mis_kernel_grouped"],
            max_abs_err=err, dead_probe_bits=dead, ms=k_ms[1],
            ms_min=k_ms[0], ms_max=k_ms[2], plain_ms=plain_ms,
            plain_shape=plain_shape, sweep_ms=sweep_ms,
            sweep_shape=sweep_shape, sweep_max_abs_err=sweep_err,
            sweep_flip_share=flips, counts_from=sweep_shape
            + ", scaled to the frame",
            bound_ms=bound, bound_by=by, library_ms=None, hdr_ms=h_ms[1],
            hdr_bound_ms=h_bound, hdr_bound_by=h_by,
            mrays_per_s=nominal_rays(cfg) / k_ms[1] / 1e3,
            registers=res["registers"], stack_bytes=res["stack_bytes"],
            spill_store_bytes=res["spill_store_bytes"],
            spill_load_bytes=res["spill_load_bytes"], smem_bytes=smem,
            blocks_per_sm=per_sm, wide_sweep=bool(wide), **counts))
        log(f"  K4g at {key}: {counts}; hdr mode {h_ms[1]:.1f} ms, bound "
            f"{h_bound:.3f} ms by {h_by}; {sweep_shape} {sweep_ms:.0f} ms")
        del rec, inp, sub
        torch.cuda.empty_cache()

        bw = MisBwdInputs(None, cfg, grouped=True, scene=scene)
        got, again = bw.kernel(), bw.kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5g at {key}: two launches differ")
        start = time.perf_counter()
        ref = bw.plain(whole_frame=True)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - start)
        err = compare_k5(f"K5g at {key}", got, ref,
                         bw.plain(nudge=True, whole_frame=True))
        del ref, got, again
        torch.cuda.empty_cache()
        k_ms = time_ms(bw.kernel, repeats=3)
        bound, by, counts = k5_bound(bw)
        res = resources[f"mis_bwd_grouped_kernel<SPH={sph}>"]
        smem, per_sm = grouped_bwd_occupancy(cfg, sph)
        rows.append(dict(
            name=f"mis_bwd_grouped_kernel[{scene_name}]", route="cuda",
            source=MIS_BWD_SOURCE, replaces=K5G_REPLACES, shape=shape,
            launches=launches[key]["mis_bwd_grouped_kernel"],
            max_abs_err=err, ms=k_ms[1], ms_min=k_ms[0], ms_max=k_ms[2],
            plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=None,
            registers=res["registers"], stack_bytes=res["stack_bytes"],
            spill_store_bytes=res["spill_store_bytes"],
            spill_load_bytes=res["spill_load_bytes"], smem_bytes=smem,
            blocks_per_sm=per_sm, **counts))
        del bw
        torch.cuda.empty_cache()
    for row in rows:
        log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}), bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain "
            f"{row['plain_ms']:.1f} ms, launches {row['launches']}, "
            f"{row['registers']} registers, {row['stack_bytes']} B stack, "
            f"{row['smem_bytes']} B shared memory, {row['blocks_per_sm']} "
            "blocks per SM")
    seconds = time.perf_counter() - started
    log(f"  K4g and K5g rows took {seconds:.1f} s")
    return rows, seconds


def static_occupancy(inp: MisInputs, emit: bool):
    """K4's shared memory per block at ``inp``'s shape, from the library
    (held against the wrapper's plan), and the blocks one SM holds."""
    lib = cuda_mis._library()
    shape = (inp.cfg.mis_samples // 3, inp.packed.num_spheres, inp.num_tris,
             len(inp.shadow_idx))
    smem = lib.grt_mis_static_smem(*shape)
    check(smem == cuda_mis.static_smem_bytes(*shape),
          f"K4's shared memory {smem} B is not the wrapper's plan at {shape}")
    per_sm = lib.grt_mis_static_blocks_per_sm(int(emit), *shape)
    check(per_sm > 0, "K4's occupancy query failed")
    return smem, per_sm


def static_bwd_occupancy(inp: MisBwdInputs):
    """K5's shared memory per block (held against the wrapper's plan) and
    the blocks one SM holds."""
    lib = cuda_mis_bwd._library()
    ndif, prims = inp.table.shape
    sph = int(ndif == cuda_mis_bwd.NDIF_SPH)
    s_per = inp.cfg.mis_samples // 3
    smem = lib.grt_mis_bwd_static_smem(s_per, prims, sph)
    check(smem == cuda_mis_bwd.static_smem_bytes(s_per, prims, ndif),
          f"K5's shared memory {smem} B is not the wrapper's plan")
    per_sm = lib.grt_mis_bwd_static_blocks_per_sm(s_per, prims, sph)
    check(per_sm > 0, "K5's occupancy query failed")
    return smem, per_sm


def grouped_occupancy(inp: MisInputs):
    """K4g's shared memory per block at ``inp``'s shape, from the library
    (held against the wrapper's plan), and the blocks one SM holds."""
    lib = cuda_mis._library()
    grp = inp.packed.grouped
    shape = (inp.cfg.mis_samples // 3, inp.packed.num_spheres,
             grp.sup.shape[1], grp.shadow_sup.shape[1])
    smem = lib.grt_mis_grouped_smem(*shape)
    check(smem == cuda_mis.grouped_smem_bytes(*shape),
          f"K4g's shared memory {smem} B is not the wrapper's plan at {shape}")
    per_sm = lib.grt_mis_grouped_blocks_per_sm(1, *shape)
    check(per_sm > 0, "K4g's occupancy query failed")
    return smem, per_sm


def grouped_bwd_occupancy(cfg: RenderConfig, sph: int):
    """K5g's shared memory per block (held against the wrapper's plan) and
    the blocks one SM holds."""
    lib = cuda_mis_bwd._library()
    s_per = cfg.mis_samples // 3
    smem = lib.grt_mis_bwd_grouped_smem(s_per, sph)
    check(smem == cuda_mis_bwd.grouped_smem_bytes(s_per, 15 if sph else 10),
          f"K5g's shared memory {smem} B is not the wrapper's plan")
    per_sm = lib.grt_mis_bwd_grouped_blocks_per_sm(s_per, sph)
    check(per_sm > 0, "K5g's occupancy query failed")
    return smem, per_sm


# Where the trace and MIS kernels' time goes (``--split``): each is rebuilt
# from a copy of the sources with one part taken out or changed (the results
# of a part taken out are then wrong: timing only) and timed beside the
# unedited build: K2 at the shapes of paths A, B and C, K2g at K's and L's,
# K4 at F's, G's and H's, K5 at I's, K4g and K5g at M's and N's. {what:
# (kernel, library, [(file, old text, new text[, times the old text occurs,
# 1 if not given])])}.
K2_MIN_BLOCKS = 9  # path_kernels.cu's STATIC_MIN_BLOCKS
K2_PROBE_TEXT = ("occ = any_triangle_filtered(sc.shadow, p.n_shadow, hx, hy, hz, "
                 "ldx, ldy, ldz, 0.0f,\n                                    "
                 "ldist - 1e-3f);")
K2_EDITS = {
    "closest filtered": ("path_kernels.cu", "closest_triangle(sc.geo, T,",
                         "grt::closest_triangle_filtered(sc.geo, T,"),
    "probe plain": ("path_kernels.cu", K2_PROBE_TEXT,
                    "occ = occluded(sc.shadow, p.n_shadow, sc.sph, 0, hx, hy, hz, "
                    "ldx, ldy, ldz, ldist - 1e-3f);"),
    "probe exits": ("path_kernels.cu", K2_PROBE_TEXT,
                    "occ = false;\n"
                    "        for (int k = 0; k < p.n_shadow; ++k) {\n"
                    "          const float4* g = reinterpret_cast<const float4*>("
                    "sc.shadow + GEO_ROWS * k);\n"
                    "          float den, tt, u, v;\n"
                    "          grt::triangle_plane(g[0], g[1], g[2], hx, hy, hz, ldx, "
                    "ldy, ldz, &den, &tt, &u, &v);\n"
                    "          if (grt::triangle_inside(den, tt, u, v, 0.0f, "
                    "ldist - 1e-3f)) { occ = true; break; }\n"
                    "        }"),
    "own occupancy": ("path_kernels.cu",
                      "__launch_bounds__(BLOCK_THREADS, STATIC_MIN_BLOCKS)",
                      "__launch_bounds__(BLOCK_THREADS)"),
}


def k2_blocks(n):
    return ("path_kernels.cu", f"constexpr int STATIC_MIN_BLOCKS = {K2_MIN_BLOCKS};",
            f"constexpr int STATIC_MIN_BLOCKS = {n};")


def k2g_prefiltered(indent, ray, bound):
    """A K2g group loop's triangle test with the prefilters before the
    divide (trace.cuh's plane_ahead, plane_within, plane_hit), skipping the
    triangle where either fails: the same decisions (``bound`` >= 1e-3)."""
    o, d = ray
    pad = " " * indent
    return (f"{pad}{{\n"
            f"{pad}  const float4 pn = __ldg(s + 3 * j);\n"
            f"{pad}  den = {d[0]} * pn.x + {d[1]} * pn.y + {d[2]} * pn.z;\n"
            f"{pad}  const float num = pn.w - ({o[0]} * pn.x + {o[1]} * pn.y + "
            f"{o[2]} * pn.z);\n"
            f"{pad}  if (!plane_ahead(den, num) || !plane_within(den, num, {bound})) "
            "continue;\n"
            f"{pad}  plane_hit(__ldg(s + 3 * j + 1), __ldg(s + 3 * j + 2), "
            f"{', '.join(o)}, {', '.join(d)}, den, num, &tt, &u, &v);\n"
            f"{pad}}}")


CLOSEST_RAY = (("ox", "oy", "oz"), ("dx", "dy", "dz"))
SHADOW_RAY = (("hx", "hy", "hz"), ("ldx", "ldy", "ldz"))
K2G_EDITS = {
    # The three group loops of the warp-cooperative sweeps (trace.cuh) with
    # the prefilters, K4's: a closest hit bounded by min(t_best, t_max), the
    # probe by max(t_max, 1e-3).
    "prefilters": [
        ("trace.cuh",
         "        triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * j "
         "+ 2), ox, oy,\n                       oz, dx, dy, dz, &den, &tt, &u, &v);",
         k2g_prefiltered(8, CLOSEST_RAY, "fminf(*t_best, t_max)")),
        ("trace.cuh",
         "          triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * "
         "j + 2), ox,\n                         oy, oz, dx, dy, dz, &den, &tt, &u, &v);",
         k2g_prefiltered(10, CLOSEST_RAY, "fminf(*t_best, t_max)")),
        ("trace.cuh",
         "        triangle_plane(__ldg(s + 3 * j), __ldg(s + 3 * j + 1), __ldg(s + 3 * j "
         "+ 2), hx, hy,\n                       hz, ldx, ldy, ldz, &den, &tt, &u, &v);",
         k2g_prefiltered(8, SHADOW_RAY, "fmaxf(t_max, 1e-3f)"))],
    "own occupancy": ("path_kernels.cu",
                      "__launch_bounds__(GROUPED_THREADS,\n"
                      "                                  WIDE ? GROUPED_MIN_BLOCKS_WIDE "
                      ": GROUPED_MIN_BLOCKS)",
                      "__launch_bounds__(GROUPED_THREADS)"),
    "128 threads": ("path_kernels.cu", "constexpr int GROUPED_THREADS = 384;",
                    "constexpr int GROUPED_THREADS = 128;"),
    "per-lane closest": (
        "path_kernels.cu",
        "      } else if constexpr (WIDE) {\n"
        "        closest_grouped_wide(p.geo, sc.aabb, sc.sup, p.n_super, T, running, ox, "
        "oy, oz,\n"
        "                             dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best, &prim);\n"
        "      } else {\n"
        "        closest_grouped_warp(p.geo, sc.aabb, sc.sup, p.n_super, T, running, ox, "
        "oy, oz,\n"
        "                             dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best, &prim);\n"
        "      }",
        "      } else if (running) {\n"
        "        grt::closest_grouped(p.geo, p.aabb, p.sup, p.n_super, T, ox, oy, "
        "oz, dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_best, &prim);\n"
        "      }"),
    "per-lane probe": (
        "path_kernels.cu",
        "occ = occluded_grouped_warp(p.sgeo, sc.saabb, sc.ssup, p.n_shadow_super,\n"
        "                                    p.n_shadow, running, hx, hy, hz, ldx, ldy, "
        "ldz, 0.0f,\n"
        "                                    ldist - 1e-3f);",
        "occ = running && grt::occluded_grouped(p.sgeo, p.saabb, p.ssup, "
        "p.n_shadow_super, p.n_shadow, hx, hy, hz, ldx, ldy, ldz, 0.0f, "
        "ldist - 1e-3f);"),
}


def k2g_blocks(narrow, wide):
    return [("path_kernels.cu", "constexpr int GROUPED_MIN_BLOCKS = 2;",
             f"constexpr int GROUPED_MIN_BLOCKS = {narrow};"),
            ("path_kernels.cu", "constexpr int GROUPED_MIN_BLOCKS_WIDE = 3;",
             f"constexpr int GROUPED_MIN_BLOCKS_WIDE = {wide};")]


K4_FILTER_OFF = [
    ("mis_kernels.cu",
     "  closest_triangle_filtered(sc.geo, sc.T, ox, oy, oz, dx, dy, dz, RAY_TMIN, "
     "RAY_TMAX,\n                            &t_best, &prim);",
     "  grt::closest_triangle(sc.geo, sc.T, ox, oy, oz, dx, dy, dz, RAY_TMIN, "
     "RAY_TMAX, &t_best,\n                        &prim);"),
    ("mis_kernels.cu",
     "  if (any_triangle_filtered(sc.shadow, sc.n_shadow, ox, oy, oz, dx, dy, dz, "
     "RAY_TMIN,\n                            t_max)) {\n    return false;\n  }",
     "  for (int k = 0; k < sc.n_shadow; ++k) {\n"
     "    const float4* g = reinterpret_cast<const float4*>(sc.shadow + GEO_ROWS * k);\n"
     "    float den, tt, u, v;\n"
     "    grt::triangle_plane(g[0], g[1], g[2], ox, oy, oz, dx, dy, dz, &den, &tt, &u, &v);\n"
     "    if (grt::triangle_inside(den, tt, u, v, RAY_TMIN, t_max)) return false;\n  }")]
# K3 and K3g (shade_kernels.cu): the scatter of a reversed bounce replaced
# by a per-lane add of the row into the thread's own scalars (the arithmetic
# stays live); a constant bounce count; the blocks per SM of either tier and
# K3g's cap on its tables (k3_blocks, k3g_tables).
K3_EDITS = {
    "scatter off": [
        ("shade_kernels.cu",
         "        for (int k = 0; k < NTAB; ++k) stage[k] = rows[k];",
         "        for (int k = 0; k < NTAB; ++k) ds[k] += rows[k];"),
        ("shade_kernels.cu",
         "      warp_scatter_peers<NTAB>(act, pc, stage, STAGE<SPH>, wtab, lane);\n",
         "")],
    # The bounce count a constant (3: paths D, K and L; timing only, E's two
    # bounces then run three) with the bounce loops unrolled, so that the
    # per-bounce entry state can live in registers.
    "three bounces": [
        ("shade_kernels.cu", "  const int B = p.bounces;\n", "  constexpr int B = 3;\n"),
        ("shade_kernels.cu", "      for (int b = 0; b < B; ++b) {\n        const size_t idx",
         "#pragma unroll\n      for (int b = 0; b < B; ++b) {\n        const size_t idx"),
        ("shade_kernels.cu", "    for (int b = B - 1; b >= 0; --b) {",
         "#pragma unroll\n    for (int b = B - 1; b >= 0; --b) {")],
}
K3_MIN_BLOCKS = 5  # shade_kernels.cu's STATIC_MIN_BLOCKS


def k3_blocks(kernel, n):
    """K3 (box scene) or K3g compiled for ``n`` blocks of 128 per SM (1:
    ptxas' own occupancy)."""
    if kernel == "K3":
        return ("shade_kernels.cu", f"constexpr int STATIC_MIN_BLOCKS = {K3_MIN_BLOCKS};",
                f"constexpr int STATIC_MIN_BLOCKS = {n};")
    return ("shade_kernels.cu",
            "__launch_bounds__(BLOCK_THREADS)\nshade_bwd_grouped_kernel(",
            f"__launch_bounds__(BLOCK_THREADS, {n})\nshade_bwd_grouped_kernel(")


def k3g_tables(mib):
    """K3g's grid capped at ``mib`` MiB of per-warp tables (768 in
    shade_kernels.cu): fewer tables to zero and reduce at path L, fewer warps
    on the card."""
    return ("shade_kernels.cu", "constexpr size_t GROUPED_TABLE_BYTES = (size_t)768 << 20;",
            f"constexpr size_t GROUPED_TABLE_BYTES = (size_t){mib} << 20;")


# K6 and K7 (soft_kernels.cu): K6's probes testing every occluder to its
# divide (trace.cuh's occluded, the previous design's), its closest hit
# prefiltered, its occupancy; K7 without its scatter, with the butterflies
# of the previous design over ten or all fourteen columns, at ptxas' own
# occupancy or 5 blocks per SM, in blocks of one warp.
K6_PROBE_TEXT = (
    "  if (any_triangle_filtered(s_shadow, n_shadow, hx, hy, hz, ldx, ldy, ldz, 0.0f, "
    "t_max)) {\n    return true;\n  }\n"
    "  for (int k = 0; k < S; ++k) {\n    float t1, t2;\n"
    "    const bool pos = sphere_roots(s_sph + SPH_ROWS * k, hx, hy, hz, ldx, ldy, ldz, "
    "&t1,\n                                  &t2);\n"
    "    if (pos && (((t1 > 0.0f) && (t1 < t_max)) || ((t2 > 0.0f) && (t2 < t_max)))) {\n"
    "      return true;\n    }\n  }\n  return false;\n")
K6_EDITS = {
    "probes whole": [("soft_kernels.cu", K6_PROBE_TEXT,
                      "  return grt::occluded(s_shadow, n_shadow, s_sph, S, hx, hy, hz, "
                      "ldx, ldy, ldz, t_max);\n")],
    "closest filtered": [(
        "soft_kernels.cu",
        "  closest_triangle(s_geo, T, ox, oy, oz, dx, dy, dz, RAY_TMIN, RAY_TMAX, &t_bg,",
        "  grt::closest_triangle_filtered(s_geo, T, ox, oy, oz, dx, dy, dz, RAY_TMIN, "
        "RAY_TMAX, &t_bg,")],
}


def k6_blocks(n):
    return ("soft_kernels.cu",
            "__global__ void __launch_bounds__(BLOCK_THREADS) silh_kernel(",
            f"__global__ void __launch_bounds__(BLOCK_THREADS, {n}) silh_kernel(")


K7_SCATTER_TEXT = (
    "    unsigned rem = __ballot_sync(FULL, act_bg);\n"
    "    if (rem != 0u) scatter_row<R_N>(rem, act_bg, key_bg, row_bg, my_wtab, lane);\n"
    "    rem = __ballot_sync(FULL, act_s);\n"
    "    if (rem != 0u) scatter_row<R_DF>(rem, act_s, key_s, row_s, my_wtab, lane);\n")
K7_SCATTER_HEAD = "template <int C0>\n__device__ __forceinline__ void scatter_row("
K7_MIN_BLOCKS = 4  # soft_kernels.cu's BWD_MIN_BLOCKS
K7_EDITS = {
    "scatter off": [("soft_kernels.cu", K7_SCATTER_TEXT,
                     "    for (int k = 0; k < NTAB; ++k) ds[k] += (act_bg ? row_bg[k] : 0.0f)"
                     " + (act_s ? row_s[k] : 0.0f);\n")],
    # The previous design's butterflies (a five-shuffle sum per column and
    # distinct primitive), over the ten columns a row can fill.
    "ten-column butterflies": [
        ("soft_kernels.cu", K7_SCATTER_HEAD,
         "template <int C0>\n"
         "__device__ __forceinline__ void scatter_cols(unsigned rem, bool act, int key,\n"
         "                                             const float* row, float* table,\n"
         "                                             int lane) {\n"
         "  while (rem != 0u) {\n"
         "    const int leader = __ffs(rem) - 1;\n"
         "    const int k = __shfl_sync(FULL, key, leader);\n"
         "    const bool mine = act && (key == k);\n"
         "    rem &= ~__ballot_sync(FULL, mine);\n"
         "    for (int c = C0; c < C0 + 10; ++c) {\n"
         "      const float v = warp_sum(mine ? row[c] : 0.0f);\n"
         "      if (lane == leader) table[k * NTAB + c] += v;\n"
         "    }\n"
         "  }\n"
         "}\n\n" + K7_SCATTER_HEAD),
        ("soft_kernels.cu", K7_SCATTER_TEXT, K7_SCATTER_TEXT.replace(
            "scatter_row<", "scatter_cols<"))],
    # The previous design's scatter as it was: butterflies over all fourteen.
    "fourteen-column butterflies": [("soft_kernels.cu", K7_SCATTER_TEXT, (
        "    unsigned rem = __ballot_sync(FULL, act_bg);\n"
        "    if (rem != 0u) grt::warp_scatter_rows<NTAB>(rem, act_bg, key_bg, row_bg, "
        "my_wtab, lane);\n"
        "    rem = __ballot_sync(FULL, act_s);\n"
        "    if (rem != 0u) grt::warp_scatter_rows<NTAB>(rem, act_s, key_s, row_s, "
        "my_wtab, lane);\n"))],
    "own occupancy": [("soft_kernels.cu",
                       "__global__ void __launch_bounds__(BLOCK_THREADS, BWD_MIN_BLOCKS)",
                       "__global__ void __launch_bounds__(BLOCK_THREADS)")],
    "one-warp blocks": [("soft_kernels.cu", "constexpr int BLOCK_THREADS = 128;",
                         "constexpr int BLOCK_THREADS = 32;")],
    # The 21 scalars accumulated in the thread's own row of shared memory
    # (21 floats a thread), not in registers.
    "scalars shared": [
        ("soft_kernels.cu",
         "  float ds[NSCAL];\n  for (int k = 0; k < NSCAL; ++k) ds[k] = 0.0f;\n"
         "  for (int tile",
         "  float* ds = s_wscal + WARPS * NSCAL + threadIdx.x * NSCAL;\n"
         "  for (int k = 0; k < NSCAL; ++k) ds[k] = 0.0f;\n  for (int tile"),
        ("soft_kernels.cu",
         "                          + (size_t)WARPS * ((size_t)num_prims * NTAB + NSCAL));",
         "                          + (size_t)WARPS * ((size_t)num_prims * NTAB + NSCAL)\n"
         "                          + (size_t)BLOCK_THREADS * NSCAL);")],
}


def k7_blocks(n):
    return ("soft_kernels.cu", f"constexpr int BWD_MIN_BLOCKS = {K7_MIN_BLOCKS};",
            f"constexpr int BWD_MIN_BLOCKS = {n};")


K1_ITEM = ("  float x = halton_at<0, SHORT>(ih);\n"
           "  float y = halton_at<1, SHORT>(ih);")
K1_BOUNCE = [f"  {plane}[o] = halton_at<2 + 5 * B + {k}, SHORT>(ih);"
             for k, plane in enumerate(("nee0", "nee1", "cos0", "cos1"))]
K1_PRODUCT = "  const float t = __fmul_rn(f, __uint2float_rn(i - q * B));"
K1_EDITS = {
    "stores alone": [("path_kernels.cu", K1_ITEM, "  float x = 0.25f;\n  float y = 0.75f;"),
                     *[("path_kernels.cu", line, line.split("=")[0] + f"= 0.{k + 1}f;")
                       for k, line in enumerate(K1_BOUNCE)]],
    "streaming stores": [
        *[("path_kernels.cu", line, f"  __stcs({plane} + o, " + line.split("= ")[1][:-1] + ");")
          for plane, line in zip(("nee0", "nee1", "cos0", "cos1"), K1_BOUNCE)],
        ("path_kernels.cu", "  jx[sn] = x;\n  jy[sn] = y;\n  bounce_planes",
         "  __stcs(jx + sn, x);\n  __stcs(jy + sn, y);\n  bounce_planes")],
    # The digit's product by its weight, fl(f d), in two other forms that
    # give the same bits: d converted by an OR into 2^23's significand and a
    # subtract, then multiplied; or that OR and one fused multiply-add by f
    # less f 2^23, which rounds the exact f d once.
    "OR, subtract, multiply": [(
        "halton.cuh", K1_PRODUCT, "  const float t = __fmul_rn(f, __fsub_rn(__uint_as_float("
        "0x4B000000u | (i - q * B)), 8388608.0f));")],
    "OR, fused multiply-add": [(
        "halton.cuh", K1_PRODUCT, "  const float t = __fmaf_rn(f, __uint_as_float(0x4B000000u "
        "| (i - q * B)), -f * 8388608.0f);")],
    "loop inline": [("path_kernels.cu", "__device__ __noinline__ void draws_item_loop(",
                     "__device__ __forceinline__ void draws_item_loop(")],
}


# Step 0 of K1's redesign: edits of the previous K1 (one thread per item, the
# digit loop at a runtime dimension), each taking out one suspect. split()
# takes these in place of SPLIT_EDITS' K1 entries when the package it runs
# holds that source (halton.cuh without the short form): run with the older
# package first on the path, ``PYTHONPATH=OLD python3 -P chip_smoke.py --split
# K1``.
K1_LOOP_STEP = "    r = __fadd_rn(r, __fmul_rn(f, (float)(i - q * B)));"
K1_FIXED_DIGITS = ("halton.cuh", "  while (i > 0u) {",
                   "  constexpr int N = B == 2 ? 21 : B == 3 ? 13 : B == 5 ? 9 : "
                   "B == 7 ? 8 : B <= 13 ? 6 : B <= 31 ? 5 : 4;\n"
                   "#pragma unroll\n  for (int k = 0; k < N; ++k) {")
K1_THREE_BOUNCES = ("path_kernels.cu", "  for (int b = 0; b < bounces; ++b) {",
                    "#pragma unroll\n  for (int b = 0; b < 3; ++b) {")
K1_OR = ("halton.cuh", K1_LOOP_STEP, K1_LOOP_STEP.replace(
    "(float)(i - q * B)", "__fsub_rn(__int_as_float(0x4B000000u | (i - q * B)), 8388608.0f)"))
K1_F_CONSTANT = ("halton.cuh", "    f = __fmul_rn(f, inv_b);", "    f = inv_b;")
SPLIT_EDITS_LOOP_K1 = {
    "K1 (loop form), the stores alone (constant values)": ("K1", "path_kernels", [
        ("path_kernels.cu", "camera_jitter(ih, spp, strat_k, inv_k, &x, &y);",
         "x = 0.25f; y = 0.75f;"),
        *[("path_kernels.cu", f"halton(ih, 2 + 5 * b + {k});", f"0.{k + 1}f;")
          for k in range(4)]]),
    "K1 (loop form), the digit converted by an OR into 2^23 and a subtract": (
        "K1", "path_kernels", [K1_OR]),
    "K1 (loop form), f a constant (the chain of multiplies taken out)": (
        "K1", "path_kernels", [K1_F_CONSTANT]),
    "K1 (loop form), the digit loop at a fixed count": ("K1", "path_kernels", [K1_FIXED_DIGITS]),
    "K1 (loop form), the dimensions compile-time constants (the bounce loop unrolled at 3)": (
        "K1", "path_kernels", [K1_THREE_BOUNCES]),
    "K1 (loop form), fixed digits and compile-time dimensions": (
        "K1", "path_kernels", [K1_FIXED_DIGITS, K1_THREE_BOUNCES]),
    "K1 (loop form), fixed digits, compile-time dimensions, conversion by OR": (
        "K1", "path_kernels", [K1_FIXED_DIGITS, K1_THREE_BOUNCES, K1_OR]),
    "K1 (loop form), fixed digits, compile-time dimensions, f a constant": (
        "K1", "path_kernels", [K1_FIXED_DIGITS, K1_THREE_BOUNCES, K1_F_CONSTANT]),
}


K1_PRODUCT_FORMS = (("an OR, a subtract and a multiply", "OR, subtract, multiply"),
                    ("an OR and a fused multiply-add", "OR, fused multiply-add"))


def k1_threads(n):
    return [("path_kernels.cu", "constexpr int DRAWS_THREADS = 128;",
             f"constexpr int DRAWS_THREADS = {n};")]


def k1_samples(n):
    """K1 with n samples of a pixel a thread, the offset read once."""
    return [
        ("path_kernels.cu", "  const dim3 grid((n + DRAWS_THREADS - 1) / DRAWS_THREADS, spp);",
         f"  const dim3 grid((n + DRAWS_THREADS - 1) / DRAWS_THREADS, (spp + {n - 1}) / {n});"),
        ("path_kernels.cu", "  const int s = blockIdx.y;\n  if (i >= n) return;\n"
         "  const uint32_t ih = (uint32_t)offsets[i] + (uint32_t)s;\n",
         "  if (i >= n) return;\n  const uint32_t offset = (uint32_t)offsets[i];\n"
         f"  for (int s = blockIdx.y * {n}; s < min(spp, ((int)blockIdx.y + 1) * {n}); ++s) {{\n"
         "  const uint32_t ih = offset + (uint32_t)s;\n"),
        ("path_kernels.cu", "    draws_item_loop<BOUNCES>(ih, spp, strat_k, inv_k, sn, o, n, "
         "nee0, nee1, cos0, cos1, jx,\n                             jy);\n  }\n}",
         "    draws_item_loop<BOUNCES>(ih, spp, strat_k, inv_k, sn, o, n, "
         "nee0, nee1, cos0, cos1, jx,\n                             jy);\n  }\n  }\n}")]


# The kernels that regenerate draws (K2 and K2g in hdr and records_only
# modes, K3 and K3g with draws regenerated, K6, K7) on the digit loop, the
# radical inverse before this form: every index takes the loop form.
HALTON_LOOP = [
    ("halton.cuh", "  return i < HALTON_SHORT ? radical_inverse_short<B>(i) : "
     "radical_inverse_loop<B>(i);", "  return radical_inverse_loop<B>(i);"),
    ("halton.cuh", "  if (i < HALTON_SHORT) {\n    bounce_draws_at<true>(i, b, u);",
     "  if (false) {\n    bounce_draws_at<true>(i, b, u);")]


SPLIT_EDITS = {
    "K1, the stores alone (constant values)": ("K1", "path_kernels", K1_EDITS["stores alone"]),
    "K1 with streaming stores (st.global.cs)": ("K1", "path_kernels",
                                                K1_EDITS["streaming stores"]),
    **{f"K1, the digit product by {how}": ("K1", "path_kernels", K1_EDITS[edit])
       for how, edit in K1_PRODUCT_FORMS},
    "K1, the loop form inline": ("K1", "path_kernels", K1_EDITS["loop inline"]),
    **{f"K1 in blocks of {n}": ("K1", "path_kernels", k1_threads(n)) for n in (256, 512)},
    **{f"K1 at {n} samples a thread": ("K1", "path_kernels", k1_samples(n))
       for n in (2, 4, 8, 16)},
    **{f"{k}, the digit product by {how}": (k, lib, K1_EDITS[edit])
       for k, lib in (("K2", "path_kernels"), ("K3", "shade_kernels"),
                      ("K6", "soft_kernels"), ("K7", "soft_kernels"))
       for how, edit in K1_PRODUCT_FORMS},
    **{f"{k} on the loop form of the radical inverse": (k, lib, HALTON_LOOP)
       for k, lib in (("K2", "path_kernels"), ("K2g", "path_kernels"),
                      ("K3", "shade_kernels"), ("K3g", "shade_kernels"),
                      ("K6", "soft_kernels"), ("K7", "soft_kernels"))},
    "K2 without the prefilters (every probe tests every occluder)": (
        "K2", "path_kernels", [K2_EDITS["probe plain"]]),
    "K2, the probe without the prefilters, to its first occluder": (
        "K2", "path_kernels", [K2_EDITS["probe exits"]]),
    "K2, the prefilters in the closest hit as well": (
        "K2", "path_kernels", [K2_EDITS["closest filtered"]]),
    "K2 at ptxas' own occupancy (no minimum of blocks per SM)": (
        "K2", "path_kernels", [K2_EDITS["own occupancy"]]),
    **{f"K2 at a minimum of {n} blocks per SM": ("K2", "path_kernels", [k2_blocks(n)])
       for n in (7, 8, 10)},
    "K2g, the group loops with the prefilters": (
        "K2g", "path_kernels", K2G_EDITS["prefilters"]),
    "K2g on the per-lane sweep, box tables read from global memory": (
        "K2g", "path_kernels", [K2G_EDITS["per-lane closest"],
                                K2G_EDITS["per-lane probe"]]),
    "K2g in blocks of 128 threads at ptxas' own occupancy": (
        "K2g", "path_kernels", [K2G_EDITS["128 threads"], K2G_EDITS["own occupancy"]]),
    "K2g at ptxas' own occupancy (no minimum of blocks per SM)": (
        "K2g", "path_kernels", [K2G_EDITS["own occupancy"]]),
    **{f"K2g at a minimum of {a} / {b} blocks of 384 per SM (narrow / wide sweep)": (
        "K2g", "path_kernels", k2g_blocks(a, b)) for a, b in ((1, 1), (2, 2), (3, 3))},
    "K4, the triangle tests without the prefilters": ("K4", "mis_kernels", K4_FILTER_OFF),
    "K4 at ptxas' own occupancy (no minimum of blocks per SM)": ("K4", "mis_kernels", [(
        "mis_kernels.cu", "__launch_bounds__(BLOCK_THREADS, STATIC_MIN_BLOCKS)",
        "__launch_bounds__(BLOCK_THREADS)")]),
    "K5 without the scatter": ("K5", "mis_bwd_kernels", [(
        "reduce.cuh", "  while (rem != 0u) {\n    const int leader",
        "  while (false) {\n    const int leader")]),
    "K5 without the strategies": ("K5", "mis_bwd_kernels", [
        ("mis_bwd_kernels.cu", "if (surf && (rec & 1)) strategy_light",
         "if (surf && (rec & 1) && GLOBAL_TABLE) strategy_light"),
        ("mis_bwd_kernels.cu",
         "        strategy_cosine<SPH, GLOBAL_TABLE>(",
         "        if (GLOBAL_TABLE) strategy_cosine<SPH, GLOBAL_TABLE>("),
        ("mis_bwd_kernels.cu",
         "        strategy_vndf<SPH, GLOBAL_TABLE>(",
         "        if (GLOBAL_TABLE) strategy_vndf<SPH, GLOBAL_TABLE>(")]),
    "K5 at 2 blocks per SM on the box scene": ("K5", "mis_bwd_kernels", [(
        "mis_bwd_kernels.cu", "__launch_bounds__(BLOCK_THREADS, SPH ? 2 : 3)",
        "__launch_bounds__(BLOCK_THREADS, 2)")]),
    "K5 with the sphere terms on every lane": ("K5", "mis_bwd_kernels", [
        ("mis_bwd_kernels.cu", "if (SPH && (GROUPED || is_sph))",
         "if (SPH)", 4)]),
    "K4g, box tables read from global memory": ("K4g", "mis_kernels", [(
        "mis_kernels.cu",
        "  sc.ggeo = p.geo; sc.aabb = s_aabb; sc.sup = s_sup;\n"
        "  sc.sgeo = p.sgeo; sc.saabb = s_saabb; sc.ssup = s_ssup;",
        "  sc.ggeo = p.geo; sc.aabb = p.aabb; sc.sup = p.sup;\n"
        "  sc.sgeo = p.sgeo; sc.saabb = p.saabb; sc.ssup = p.ssup;")]),
    "K5g without the table writes": ("K5g", "mis_bwd_kernels", [(
        "reduce.cuh", "for (int c = 0; c < NCOL; ++c) dst[c] += sum[c];",
        "for (int c = 0; c < NCOL; ++c) if (sum[c] == 1.25e-33f) dst[c] = sum[c];")]),
    "K5g without the scatter": ("K5g", "mis_bwd_kernels", [(
        "reduce.cuh",
        "  const unsigned peers = __match_any_sync(FULL_MASK, act ? key : -1);",
        "  if (lane >= 0) return;\n"
        "  const unsigned peers = __match_any_sync(FULL_MASK, act ? key : -1);")]),
    "K5g without the strategies": ("K5g", "mis_bwd_kernels", [
        ("mis_bwd_kernels.cu", "if (surf && (rec & 1)) strategy_light",
         "if (surf && (rec & 1) && !GLOBAL_TABLE) strategy_light"),
        ("mis_bwd_kernels.cu",
         "        strategy_cosine<SPH, GLOBAL_TABLE>(",
         "        if (!GLOBAL_TABLE) strategy_cosine<SPH, GLOBAL_TABLE>("),
        ("mis_bwd_kernels.cu",
         "        strategy_vndf<SPH, GLOBAL_TABLE>(",
         "        if (!GLOBAL_TABLE) strategy_vndf<SPH, GLOBAL_TABLE>(")]),
    **{f"{k} without the scatter (each lane adds its row to its own scalars)": (
        k, "shade_kernels", K3_EDITS["scatter off"]) for k in ("K3", "K3g")},
    **{f"{k} with the bounce count a constant (3) and its loops unrolled": (
        k, "shade_kernels", K3_EDITS["three bounces"]) for k in ("K3", "K3g")},
    "K3 at ptxas' own occupancy on the box scene (no minimum of blocks per SM)": (
        "K3", "shade_kernels", [k3_blocks("K3", 1)]),
    "K3 at a minimum of 6 blocks per SM": ("K3", "shade_kernels", [k3_blocks("K3", 6)]),
    "K3g at a minimum of 5 blocks per SM": ("K3g", "shade_kernels", [k3_blocks("K3g", 5)]),
    **{f"K3g with its tables capped at {mib} MiB": ("K3g", "shade_kernels",
                                                   [k3g_tables(mib)]) for mib in (512, 1024)},
    "K6, the probes testing every occluder to its divide": (
        "K6", "soft_kernels", K6_EDITS["probes whole"]),
    "K6, the closest hit prefiltered": ("K6", "soft_kernels", K6_EDITS["closest filtered"]),
    "K6 at a minimum of 12 blocks per SM": ("K6", "soft_kernels", [k6_blocks(12)]),
    "K7 without the scatter (each lane adds its rows to its own scalars)": (
        "K7", "soft_kernels", K7_EDITS["scatter off"]),
    "K7, butterflies over the ten columns": (
        "K7", "soft_kernels", K7_EDITS["ten-column butterflies"]),
    "K7, butterflies over all fourteen columns": (
        "K7", "soft_kernels", K7_EDITS["fourteen-column butterflies"]),
    "K7 at ptxas' own occupancy (no minimum of blocks per SM)": (
        "K7", "soft_kernels", K7_EDITS["own occupancy"]),
    "K7 at a minimum of 5 blocks per SM": ("K7", "soft_kernels", [k7_blocks(5)]),
    "K7 in blocks of one warp": ("K7", "soft_kernels", K7_EDITS["one-warp blocks"]),
    "K7, the 21 scalars in shared memory": ("K7", "soft_kernels",
                                            K7_EDITS["scalars shared"]),
}


def split_builds(edits):
    """The builds of ``edits`` (entries of SPLIT_EDITS), side by side: {what:
    (kernel, library, BuiltLibrary)}."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_split_"))

    def build(item):
        what, (kernel, name, edits) = item
        src = work / re.sub(r"\W+", "_", what)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, old, new, *times in edits:
            text = (src / fname).read_text()
            expected = times[0] if times else 1
            found = text.count(old)
            check(found == expected, f"split {what}: {old!r} found {found} "
                  f"times, not {expected}")
            (src / fname).write_text(text.replace(old, new))
        out = src / f"lib{name}.so"
        start = time.perf_counter()
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                               str(src / f"{name}.cu")], capture_output=True, text=True)
        check(proc.returncode == 0, f"split {what}: nvcc failed\n{proc.stderr}")
        return what, (kernel, name, _build.BuiltLibrary(
            lib=ctypes.CDLL(str(out)), path=out, nvcc=_build.find_nvcc(),
            log=proc.stdout + proc.stderr, seconds=time.perf_counter() - start))

    with ThreadPoolExecutor(len(edits)) as pool:
        return dict(pool.map(build, edits.items()))


# The ptxas names of each kernel's instantiations.
SPLIT_PTXAS = {"K1": "draws_kernel", "K2": "path_kernel<", "K2g": "path_grouped_kernel<",
               "K4": "mis_kernel<", "K4g": "mis_grouped_kernel<",
               "K5": "mis_bwd_kernel<", "K5g": "mis_bwd_grouped_kernel<",
               "K3": "shade_bwd_kernel<", "K3g": "shade_bwd_grouped_kernel<",
               "K6": "silh_kernel", "K7": "soft_bwd_kernel"}
# Timed runs per build in split() where not 3, and launches a run where not 1.
SPLIT_REPEATS = {"K1": K1_REPEATS}
SPLIT_BATCH = {"K1": K1_BATCH}
# The kernels split() also times by the profiler's device time, apart from
# their reduction: the name the profiler gives each.
SPLIT_PROFILED = {"K1": "draws_kernel", "K3g": "shade_bwd_grouped", "K6": "silh_kernel",
                  "K7": "soft_bwd_kernel"}


def warp_keys(key):
    """Per warp of 32 lanes (the last axis of ``key``; -1 where a lane adds
    no row): the distinct keys, the most lanes on one key, and whether any
    lane adds a row."""
    key = key.sort(dim=-1).values
    new = torch.ones_like(key, dtype=torch.bool)
    new[..., 1:] = key[..., 1:] != key[..., :-1]
    distinct = (new & (key >= 0)).sum(dim=-1)
    pos = torch.arange(32, device=key.device).expand_as(key)
    start = torch.where(new, pos, torch.zeros_like(pos)).cummax(dim=-1).values
    largest = torch.where(key >= 0, pos - start + 1,
                          torch.zeros_like(pos)).amax(dim=-1)
    return distinct, largest, key[..., -1] >= 0


def soft_scatter_keys(inp: SoftInputs):
    """K7's two scatters per warp-sample from the records: per 32 consecutive
    (sample, pixel) items of the [spp, N] records (a warp of K7), the
    distinct primitives among the lanes that add a background row (a hit
    not behind a front sphere) and a sphere row (front or potential), and
    the most lanes on one; means over the warps with such a lane, and the
    share of warps that have one."""
    prim, _, _, front, pot, s_idx = cuda_soft._decode(inp.codes)
    keys = {"background": torch.where(~front & (prim >= 0), prim, -1),
            "sphere": torch.where(front | pot, inp.num_tris + s_idx, -1)}
    out = {}
    for name, key in keys.items():
        key = key.flatten()
        key = torch.cat([key, key.new_full(((-key.numel()) % 32,), -1)])
        distinct, largest, live = warp_keys(key.view(-1, 32))
        out[name] = (round(distinct[live].float().mean().item(), 3),
                     round(largest[live].float().mean().item(), 3),
                     round(live.float().mean().item(), 3))
    return out


def scatter_rounds(sh: ShadeInputs):
    """The scatter's rounds in K3 and K3g from the records: per (sample,
    bounce, warp of 32 consecutive pixels) with a live lane, the number of
    distinct primitives the live lanes recorded (a lane is live at a bounce
    where its path is alive and hit something), and the largest number of
    lanes that share one; means over those warp-bounces, by bounce and in
    all."""
    alive, _ = live_lanes(sh.records, sh.trace.packed)
    prim = (sh.records & (cuda_path.OCC_BIT - 1)).long()
    key = torch.where(alive & (prim > 0), prim, torch.full_like(prim, -1))
    distinct, largest, live = warp_keys(key.view(*key.shape[:2], -1, 32))
    out = {}
    for b in range(key.shape[1]):
        m = live[:, b]
        out[f"bounce {b}"] = (round(distinct[:, b][m].float().mean().item(), 3),
                              round(largest[:, b][m].float().mean().item(), 3))
    out["all"] = (round(distinct[live].float().mean().item(), 3),
                  round(largest[live].float().mean().item(), 3),
                  int(live.sum()))
    return out


def split(kernels=None, only=None):
    """The trace, MIS and backward kernels unedited and with each part of
    SPLIT_EDITS taken out or changed, in turns (unedited first and last): K2
    at A and B (hdr) and C (records + draws + cull), K2g at K and L (records
    + draws + cull), K4 at F and G (hdr) and H (records + cull), K5 at I
    (both scenes), K4g and K5g at M and N, K3 at D and E and K3g at K and L
    (draws read, as those paths launch them), K6 and K7 at J, at the
    recovery and at 800 x 600 x 16 (no cull, as J and the recovery launch
    them), K3 and K3g also with draws regenerated, K2g also in hdr mode at
    K, K1 at C. ``kernels``: only these (all by default); a redesign slice
    splits its own kernels alone. ``only``: the edits whose description
    holds this text."""
    kernels = set(kernels or SPLIT_PTXAS)
    log("== split: the kernels with one part taken out or changed: "
        + ", ".join(sorted(kernels)))
    started = time.perf_counter()
    own = {name: _build.load_library(name)
           for name in ("path_kernels", "mis_kernels", "mis_bwd_kernels",
                        "shade_kernels", "soft_kernels")}
    edits = dict(SPLIT_EDITS)
    if "radical_inverse_short" not in (_build.CSRC_DIR / "halton.cuh").read_text():
        edits = {w: e for w, e in edits.items() if e[0] != "K1"} | SPLIT_EDITS_LOOP_K1
    variants = split_builds({what: e for what, e in edits.items()
                             if e[0] in kernels and (only is None or only in what)})
    out = {"ptxas": {}}
    for name, lib in own.items():
        res = {fn: (r["registers"], r["stack_bytes"], r["spill_store_bytes"])
               for fn, r in ptxas_resources(lib.log).items()
               if any(fn.startswith(SPLIT_PTXAS[k]) for k in kernels)}
        if res:
            out["ptxas"][f"{name} unedited"] = res
            log(f"  {name} unedited: registers, stack, spill stores " + ", ".join(
                f"{fn} {r}" for fn, r in res.items()) + f"; built in {lib.seconds:.1f} s")
    for what, (kernel, _, lib) in variants.items():
        res = {name: (r["registers"], r["stack_bytes"], r["spill_store_bytes"])
               for name, r in ptxas_resources(lib.log).items()
               if name.startswith(SPLIT_PTXAS[kernel])}
        out["ptxas"][what] = res
        log(f"  {what}: registers, stack, spill stores " + ", ".join(
            f"{name} {r}" for name, r in res.items()) + f"; built in {lib.seconds:.1f} s")
    if "K1" in kernels:
        # K1's SASS: its instructions (the straight-line part is what a
        # thread executes) and the opcodes of its digit arithmetic.
        for what, lib in ([("K1 unedited", own["path_kernels"])]
                          + [(w, lib) for w, (k, _, lib) in variants.items() if k == "K1"]):
            ops = sass_opcodes(lib.path, "draws_kernel")
            out.setdefault("K1 sass", {})[what] = ops
            log(f"  {what}: SASS {sum(ops.values())} instructions; " + ", ".join(
                f"{op} {c}" for op, c in sorted(ops.items(), key=lambda kv: -kv[1])))

    def turns(key, kernel, name, fn):
        order = ([(f"{kernel} unedited", own[name])]
                 + [(w, lib) for w, (k, n, lib) in variants.items() if k == kernel]
                 + [(f"{kernel} unedited, again", own[name])])
        first = None
        for what, lib in order:
            _build._LOADED[name] = lib
            batch = SPLIT_BATCH.get(kernel, 1)

            def run(launches=batch):
                for _ in range(launches):
                    fn()
            ms = tuple(t / batch for t in time_ms(run, repeats=SPLIT_REPEATS.get(kernel, 3),
                                                 warmup=K1_WARMUP if kernel == "K1" else 1))
            out.setdefault(key, {})[what] = ms
            if kernel == "K1":
                # Which edits keep the bits: the planes against the unedited build's.
                got = fn()
                first = first or got
                same = all(torch.equal(a, b) for a, b in zip(got, first))
                out.setdefault(key + " bit-equal to the unedited build", {})[what] = same
                log(f"  {key}: {what}: planes bit-equal to the unedited build: {same}")
            part = ""
            if kernel in SPLIT_PROFILED:
                # The kernel and its reduction apart, by device time under the
                # profiler.
                device_busy(lambda: run(3 * batch))
                parts = (profiled_ms(SPLIT_PROFILED[kernel]) / (3 * batch),
                         profiled_ms("reduce_") / (3 * batch))
                out.setdefault(key + " kernel / reduction", {})[what] = parts
                part = f"; profiled: kernel {parts[0]:.4f} ms, reduction {parts[1]:.4f} ms"
            log(f"  {key}: {what}: {ms[1]:.3f} ms (min {ms[0]:.3f}, max {ms[2]:.3f})"
                + part)
        _build._LOADED[name] = own[name]

    # Each shape: the kernels it times and a function that makes its inputs
    # and returns (key, {kernel: (library, function to time)}).
    def backward(label, scene_name, size, tess):
        sh = ShadeInputs(scene_name, RenderConfig(**size), grouped=tess is not None,
                         scene=tess and cornell_box_tessellated(
                             resolution=RenderConfig(**BENCH).resolution, **tess))
        key = f"{label} {scene_name or f'tess-{sh.trace.num_tris}'}"
        rounds = scatter_rounds(sh)
        out.setdefault("scatter_rounds", {})[key] = rounds
        log(f"  {key}: distinct primitives per live warp-bounce, and the most "
            f"lanes on one, by bounce: {rounds}")
        name = "K3g" if tess else "K3"
        return key, {name: ("shade_kernels", sh.kernel),
                     f"{name} regenerated": ("shade_kernels",
                                             lambda: sh.kernel(regenerate=True))}

    def trace(label, scene_name, size, cull):
        inp = TraceInputs(scene_name, RenderConfig(**size), cull=cull)
        draws = (cuda_path.pregen_draws_kernel(inp.offsets_i32, inp.cfg)
                 if cull else None)
        return f"{label} {scene_name}", {
            "K2": ("path_kernels", lambda: inp.kernel(draws, emit=cull))}

    def trace_grouped(label, tess):
        cfg = RenderConfig(**BENCH)
        inp = TraceInputs(None, cfg, cull=True, grouped=True, scene=(
            cornell_box_tessellated(resolution=cfg.resolution, **tess)))
        draws = cuda_path.pregen_draws_kernel(inp.offsets_i32, cfg)
        fns = {"K2g": ("path_kernels", lambda: inp.kernel(draws, emit=True))}
        if label == "K":
            fns["K2g hdr"] = ("path_kernels", lambda: inp.kernel())
        return f"{label} tess-{inp.num_tris}", fns

    def mis(label, scene_name, size, emit, cull):
        inp = MisInputs(scene_name, RenderConfig(integrator="mis", **size), cull=cull)
        return f"{label} {scene_name}", {
            "K4": ("mis_kernels", lambda: inp.kernel(emit=emit))}

    def draws(label, size):
        # K and L draw at C's shape (512 x 512 x 16 x 3 from the same
        # offsets): this one shape times K1 for all three.
        cfg = RenderConfig(**size)
        offsets = pixel_rng_offsets(cfg, "cuda").to(torch.int32).contiguous()
        return f"{label} {cfg.width}x{cfg.height} x {cfg.spp} x {cfg.bounces}", {
            "K1": ("path_kernels", lambda: cuda_path.pregen_draws_kernel(offsets, cfg))}

    def mis_bwd(scene_name):
        bw = MisBwdInputs(scene_name, RenderConfig(integrator="mis", **MIS_BENCH))
        return f"I {scene_name}", {"K5": ("mis_bwd_kernels", bw.kernel)}

    def soft(label, size):
        inp = SoftInputs(soft_cfg(size), cull=False)
        key = f"{label} {inp.cfg.width}x{inp.cfg.height} x {inp.cfg.spp}"
        keys = soft_scatter_keys(inp)
        out.setdefault("scatter_keys", {})[key] = keys
        log(f"  {key}: K7's distinct primitives per warp-sample, the most lanes "
            f"on one, the share of warps with a row: {keys}")
        return key, {"K6": ("soft_kernels", inp.silh_kernel),
                     "K7": ("soft_kernels", inp.bwd_kernel)}

    mis_scenes = []  # paths M and N, made at first use

    def mis_grouped(i):
        cfg = RenderConfig(integrator="mis", **MIS_BENCH)
        if not mis_scenes:
            mis_scenes.extend(mis_grouped_path_scenes(cfg.resolution))
        label, scene_name, scene = mis_scenes[i]
        inp = MisInputs(None, cfg, cull=True, grouped=True, scene=scene)
        bw = MisBwdInputs(None, cfg, grouped=True, scene=scene)
        return f"{label} {scene_name}", {
            "K4g": ("mis_kernels", lambda: inp.kernel(emit=True)),
            "K5g": ("mis_bwd_kernels", bw.kernel)}

    shapes = [
        ({"K1"}, lambda: draws("C (and K, L)", BENCH)),
        ({"K3"}, lambda: backward("D", "cornell", BENCH, None)),
        ({"K3"}, lambda: backward("E", "cornell-spheres", INVERSE, None)),
        ({"K3g"}, lambda: backward("K", None, BENCH, TESS_K)),
        ({"K3g"}, lambda: backward("L", None, BENCH, TESS_L)),
        ({"K2"}, lambda: trace("A", "cornell", FRAME, False)),
        ({"K2"}, lambda: trace("B", "cornell-spheres", FRAME, False)),
        ({"K2"}, lambda: trace("C", "cornell", BENCH, True)),
        ({"K2g"}, lambda: trace_grouped("K", TESS_K)),
        ({"K2g"}, lambda: trace_grouped("L", TESS_L)),
        ({"K4"}, lambda: mis("F", "cornell", MIS_FRAME, False, False)),
        ({"K4"}, lambda: mis("G", "cornell-spheres", MIS_FRAME, False, False)),
        ({"K4"}, lambda: mis("H", "cornell", MIS_BENCH, True, True)),
        ({"K5"}, lambda: mis_bwd("cornell")),
        ({"K5"}, lambda: mis_bwd("cornell-spheres")),
        *[({"K4g", "K5g"}, lambda i=i: mis_grouped(i)) for i in range(3)],
        ({"K6", "K7"}, lambda: soft("J", SOFT_J)),
        ({"K6", "K7"}, lambda: soft("recovery", SOFT_RECOVERY)),
        ({"K6", "K7"}, lambda: soft("frame", SOFT_SIZES[-1])),
    ]
    for timed, make in shapes:
        if not timed & kernels:
            continue
        key, fns = make()
        for what, (name, fn) in fns.items():
            kernel, _, mode = what.partition(" ")
            if kernel in kernels:
                turns(f"{key} {mode}".strip(), kernel, name, fn)
        del fns, fn
        torch.cuda.empty_cache()
    log(f"  split took {time.perf_counter() - started:.1f} s")
    return out


def k2_share_drift():
    """How far K2's prefilter pass shares (``k2_prefilter_shares``) move
    between the SHARE_SPP samples per pixel the ``full`` phase counts them
    at and the 400 of paths A and B: {path: {"shares": {spp: shares},
    "change": relative change per share}}."""
    cfg = RenderConfig(**FRAME)
    out = {}
    for label, scene_name in (("A", "cornell"), ("B", "cornell-spheres")):
        inp = TraceInputs(scene_name, cfg, cull=False)
        shares = {}
        for spp in (SHARE_SPP, cfg.spp):
            start = time.perf_counter()
            shares[spp] = k2_prefilter_shares(inp, spp)
            log(f"  K2 shares at {label} {scene_name}, {spp} spp: "
                f"{shares[spp]} ({time.perf_counter() - start:.1f} s)")
        lo, hi = shares[SHARE_SPP], shares[cfg.spp]
        change = {k: hi[k] / lo[k] - 1.0 for k in lo if lo[k]}
        log(f"  K2 shares at {label}: change from {SHARE_SPP} to {cfg.spp} "
            "spp " + ", ".join(f"{k} {v:+.3%}" for k, v in change.items()))
        out[f"{label} {scene_name}"] = dict(
            shares={str(k): v for k, v in shares.items()}, change=change)
    return out


def count_drift():
    """How far the plain grouped sweep's box and triangle tests per (pixel,
    camera ray, sample) move with the number of samples, on the pixels the
    K4g rows sample and with their cull: the scenes of paths M (without the
    spheres) and N at 1 camera ray x 30 and x 300 samples. The K4g rows
    count at 30 samples and scale to 300 (their ``est_`` fields): the change
    printed is that scaling's error."""
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    log(f"== count drift: the plain grouped sweep's tests per sample at "
        f"{cfg.width}x{cfg.height}")
    out = {}
    for label, scene_name, scene in mis_grouped_path_scenes(cfg.resolution):
        if scene.spheres.num_spheres:
            continue  # the same triangles as path M's first scene
        chk = MIS_GROUPED_CHECK[label]
        pix = torch.arange(0, cfg.num_pixels, chk["stride"], device="cuda")
        per = {}
        for samples in (chk["mis_samples"], cfg.mis_samples):
            one = cfg.replace(camera_rays=1, mis_samples=samples)
            inp = MisInputs(None, one, cull=True, grouped=True, scene=scene)
            stats = {}
            start = time.perf_counter()
            inp.plain(pix=pix, stats=stats)
            torch.cuda.synchronize()
            units = pix.numel() * (samples // 3)
            per[samples] = {f"{loop}_{k}": stats[loop].get(k, 0) / units
                            for loop in ("closest", "shadow")
                            for k in ("rays", "boxes", "triangles")}
            log(f"  {label} {scene_name}, {pix.numel()} pixels x 1 x "
                f"{samples}: per (pixel, sample) {per[samples]} "
                f"({time.perf_counter() - start:.1f} s)")
        lo, hi = per[chk["mis_samples"]], per[cfg.mis_samples]
        change = {k: hi[k] / lo[k] - 1.0 for k in lo}
        log(f"  {label} {scene_name}: change from {chk['mis_samples']} to "
            f"{cfg.mis_samples} samples "
            + ", ".join(f"{k} {v:+.2%}" for k, v in change.items()))
        out[f"{label} {scene_name}"] = dict(
            pixels=pix.numel(), samples=[chk["mis_samples"], cfg.mis_samples],
            per_sample={str(k): v for k, v in per.items()}, change=change)
    out["K2 shares"] = k2_share_drift()
    return out


def k2_at_j_row(launches_j, path_j, resources):
    """K2 at path J's shape (hdr, direct, one bounce, sphere scene, no
    cull), as path J launches it: against its plain version, its time by
    CUDA events and under path J's profiler, its bound."""
    cfg = soft_cfg(SOFT_J)
    inp = TraceInputs("cornell-spheres", cfg, cull=False)
    hdr_r, rec_r = inp.kernel(emit=True)
    hdr_h, _ = inp.kernel()
    torch.cuda.synchronize()
    check(torch.equal(hdr_h, hdr_r), "K2 at J: hdr and records_only differ")
    start = time.perf_counter()
    hdr_p, rec_p = inp.plain(emit=True, whole_frame=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)
    flips, err = compare_trace("K2 at J", hdr_r, rec_r, hdr_p, rec_p,
                               inp.packed)
    bound, by, counts = trace_bound(inp, rec_r, k2_prefilter_shares(inp),
                                    emit=False, reads_draws=False)
    k_ms = time_ms(lambda: inp.kernel())
    smem, per_sm = path_occupancy(inp, False, False)
    row = dict(
        name="path_kernel[hdr, direct, cornell-spheres]", route="cuda",
        source=PATH_SOURCE, replaces=K2_REPLACES,
        shape=f"J: {cfg.width}x{cfg.height} x {cfg.spp} spp, direct, "
              f"{inp.num_tris} triangles, {inp.packed.num_spheres} spheres",
        launches=launches_j["path_kernel"], launches_per_step=1,
        max_abs_err=err, flip_share=flips, ms=k_ms[1], ms_min=k_ms[0],
        ms_max=k_ms[2], profiled_ms=path_j["k2_profiled_ms"],
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        smem_bytes=smem, blocks_per_sm=per_sm,
        **resource_fields(resources["path_kernel<EMIT=0, READ_DRAWS=0>"]),
        **counts)
    log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.4f} ms by "
        f"events, {row['profiled_ms']:.4f} ms under the profiler, bound "
        f"{bound:.4f} ms by {by}, plain {plain_ms:.1f} ms")
    return [row]


# ---------------------------------------------------------------------------
# Phase sharded: parallel/ over torch.distributed
# ---------------------------------------------------------------------------

SHARDED_TIMEOUT = 300     # seconds a group of rank processes may take
SHARDED_TRAIN_STEPS = 2   # steps of each make_train_step_fused run in (b)
ORACLE_STEP = dict(width=64, height=64, spp=1, bounces=2)  # (b)'s eager step
NCCL_TURNS = {"D": 5, "I": 3}  # timed turns of each variant in (c)
INVERSE_RES = (INVERSE["width"], INVERSE["height"])
# Path gradients: the JAX package's sharded tolerance
# (tests/test_fast_sharded.py:51); MIS: 1e-5 of the group's largest
# magnitude and rtol 1e-4 (:159-162); the overlapped gradient against the
# plain one: atol 1e-6 / rtol 1e-4 (:92-94).
SHARDED_PATH_TOL = dict(atol=1e-8, rtol=1e-5)
SHARDED_MIS_RTOL = 1e-4
OVERLAP_TOL = dict(atol=1e-6, rtol=1e-4)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def sharded_cases():
    """(label, scene, config, integrator, ranges, launches a range): the
    training steps of paths D, K and I."""
    res = (BENCH["width"], BENCH["height"])
    return [
        ("D", cornell_box(resolution=res), RenderConfig(**BENCH), "path", 4,
         dict(draws_kernel=1, path_kernel=1, shade_bwd_kernel=1)),
        ("K", cornell_box_tessellated(resolution=res, **TESS_K),
         RenderConfig(**BENCH), "path", 2,
         dict(draws_kernel=1, path_kernel_grouped=1,
              shade_bwd_grouped_kernel=1)),
        ("I", cornell_box(resolution=res),
         RenderConfig(integrator="mis", **MIS_BENCH), "mis", 2,
         dict(mis_kernel=1, mis_bwd_kernel=1)),
    ]


def single_entry(kind):
    return (cuda_shade.render_path_decoupled_fused if kind == "path"
            else cuda_mis_bwd.render_mis_fused)


def compare_sharded_grads(what, got, ref, mis):
    """Gradients summed over shards against the single render's, element by
    element at the JAX package's sharded tolerances; the largest difference
    and the largest share of its limit."""
    check(set(got) == set(ref), f"{what}: gradients of {sorted(got)} "
          f"against {sorted(ref)}")
    worst, share = 0.0, 0.0
    for name, r in ref.items():
        g = got[name]
        if mis:
            atol = 1e-5 * max(r.abs().max().item(), 1e-6)
            rtol = SHARDED_MIS_RTOL
        else:
            atol, rtol = SHARDED_PATH_TOL["atol"], SHARDED_PATH_TOL["rtol"]
        diff = (g - r).abs()
        limit = atol + rtol * r.abs()
        largest = diff.max().item() if diff.numel() else 0.0
        worst = max(worst, largest)
        share = max(share, (diff / limit).max().item()
                    if diff.numel() else 0.0)
        check(bool((diff <= limit).all()), f"{what}: d {name} differs by "
              f"{largest:.3e} (atol {atol:.1e}, rtol {rtol:.0e})")
    return worst, share


def sharded_ranges():
    """(a) Pixel ranges in one process, through the local halves: the
    concatenated image against the single render by sha256, the gradients
    summed over the ranges in rank order against the single render's, one
    launch of each kernel per range."""
    out = {}
    for label, scene, cfg, kind, n, expect in sharded_cases():
        occ = potential_occluders(scene, cfg)
        leaves = with_grad(scene)
        reset_launches()
        hdr = single_entry(kind)(leaves, cfg, occluders=occ)
        ref = scene_grads(leaves, hdr)
        check(read_launches() == launches_of(**expect),
              f"sharded {label}: single render launches {read_launches()}")
        shard = (fast.render_path_fused_shard if kind == "path"
                 else fast.render_mis_fused_shard)
        parts = with_grad(scene)
        flats, total = [], {}
        for k in range(n):
            reset_launches()
            flat = shard(parts, cfg, k, n, occluders=occ)
            g = grads_of(parts, flat.sum() / (3 * cfg.num_pixels))
            launched = read_launches()
            check(launched == launches_of(**expect), f"sharded {label} range "
                  f"{k} of {n}: launches {launched}, expected {expect}")
            for name, v in g.items():
                total[name] = v if name not in total else total[name] + v
            flats.append(flat.detach())
        image = torch.cat(flats).reshape(hdr.shape)
        check(sha256(image) == sha256(hdr), f"sharded {label}: {n} ranges "
              "do not make the single render's image")
        worst, share = compare_sharded_grads(f"sharded {label}", total, ref,
                                             kind == "mis")
        log(f"  (a) {label}: {n} ranges, image sha256 equal to the single "
            f"render's, gradients of {len(ref)} tensors within the limit "
            f"(largest difference {worst:.3e}, {share:.2f} of its limit); "
            f"launches per range {expect}")
        out[label] = dict(ranges=n, sha256=sha256(hdr), max_abs_diff=worst,
                          share_of_limit=share, launches_per_range=expect)
    return out


def run_ranks(mode: str, world: int) -> list:
    """Run ``world`` processes of this script as the ranks of a group
    (``--sharded-rank``), each with a log and a JSON result in a temporary
    directory; fail on any non-zero exit or past SHARDED_TIMEOUT (the other
    ranks are killed at once). Returns the ranks' results."""
    out_dir = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{mode}_"))
    port = multihost.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(Path(__file__).resolve()),
         "--sharded-rank", mode, str(r), str(world), str(port), str(out_dir)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=Path(__file__).resolve().parent) for r in range(world)]

    def tail(r):
        return (out_dir / f"rank{r}.log").read_text()[-3000:]

    try:
        deadline = time.monotonic() + SHARDED_TIMEOUT
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            check(not failed, f"sharded {mode}: rank {failed[:1]} exited "
                  f"{[procs[r].returncode for r in failed]}:\n"
                  + (tail(failed[0]) if failed else ""))
            check(time.monotonic() < deadline, f"sharded {mode}: the ranks "
                  f"did not finish within {SHARDED_TIMEOUT} s:\n{tail(0)}")
            time.sleep(0.2)
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"sharded {mode}: rank {r} exited "
                  f"{p.returncode}:\n{tail(r)}")
        return [json.loads((out_dir / f"rank{r}.json").read_text())
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(out_dir, ignore_errors=True)


def params_sha256(params) -> str:
    return sha256(torch.cat([p.detach().reshape(-1) for p in params]))


def grads_sha256(grads: dict) -> str:
    return sha256(torch.cat([grads[k].reshape(-1) for k in sorted(grads)]))


def synced_ms(fn):
    """(result of ``fn``, its milliseconds on the host clock between two
    synchronizations of the card)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, 1e3 * (time.perf_counter() - start)


def gloo_rank_steps() -> dict:
    """(b), on each of two ranks that share the card over gloo: the JAX
    package's multichip dry run (``__graft_entry__.py``) at the shapes of
    (a) and of E: images, losses, parameters after the steps and launches,
    for the parent to compare."""
    m = mesh.make_ray_mesh()
    check(m.shape == {"rays": 2} and m.device == torch.device("cuda", 0),
          f"(b) mesh {m.shape} on {m.device}")
    res = (BENCH["width"], BENCH["height"])
    out = {}
    for label, scene, cfg, expect in (
            ("D", cornell_box(resolution=res), RenderConfig(**BENCH),
             dict(draws_kernel=1, path_kernel=1)),
            ("E", cornell_box_with_spheres(resolution=INVERSE_RES),
             RenderConfig(pixel_chunk=65536, **INVERSE),
             dict(draws_kernel=1, path_kernel=1)),
            ("K", cornell_box_tessellated(resolution=res, **TESS_K),
             RenderConfig(**BENCH),
             dict(draws_kernel=1, path_kernel_grouped=1))):
        scene = scene.to("cuda")
        occ = potential_occluders(scene, cfg)
        reset_launches()
        img = fast.render_path_fused_sharded(scene, cfg, m, occluders=occ)
        check(read_launches() == launches_of(**expect),
              f"(b) {label} image: launches {read_launches()}")
        init_fn, step_fn = train.make_train_step_fused(scene, cfg, m)
        state = init_fn(inverse.extract_params(scene))
        target = torch.zeros(img.shape, device="cuda")
        grouped = "path_kernel_grouped" in expect
        per_step = launches_of(**{
            "draws_kernel": 1,
            "path_kernel_grouped" if grouped else "path_kernel": 1,
            "shade_bwd_grouped_kernel" if grouped else "shade_bwd_kernel": 1})
        losses, step_ms = [], []
        for step in range(SHARDED_TRAIN_STEPS):
            reset_launches()
            (state, loss), ms = synced_ms(lambda: step_fn(state, target))
            check(read_launches() == per_step, f"(b) {label} step {step}: "
                  f"launches {read_launches()}, expected {per_step}")
            check(bool(torch.isfinite(loss)), f"(b) {label}: loss {loss}")
            losses.append(loss.item())
            step_ms.append(ms)
        out[label] = dict(image_sha256=sha256(img), losses=losses,
                          step_ms=step_ms, params_sha256=params_sha256(
                              state.params),
                          launches_per_step={k: v for k, v in per_step.items()
                                             if v})
    # The eager oracle's step: no kernel.
    cfg = RenderConfig(**ORACLE_STEP)
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    init_fn, step_fn = train.make_train_step(scene, cfg, m)
    state = init_fn(inverse.extract_params(scene))
    reset_launches()
    (state, loss), ms = synced_ms(lambda: step_fn(
        state, torch.zeros((cfg.height, cfg.width, 3), device="cuda")))
    check(read_launches() == launches_of() and bool(torch.isfinite(loss)),
          f"(b) oracle step: launches {read_launches()}, loss {loss}")
    out["oracle"] = dict(losses=[loss.item()], step_ms=[ms],
                         params_sha256=params_sha256(state.params))
    # The MIS gradient at I's shape.
    cfg = RenderConfig(integrator="mis", **MIS_BENCH)
    scene = with_grad(cornell_box(resolution=cfg.resolution))
    occ = potential_occluders(scene, cfg)

    def mis_step():
        img = fast.render_mis_fused_sharded(scene, cfg, m, occluders=occ)
        return img, scene_grads(scene, img)

    reset_launches()
    (img, grads), ms = synced_ms(mis_step)
    mis_launches = dict(mis_kernel=1, mis_bwd_kernel=1)
    check(read_launches() == launches_of(**mis_launches),
          f"(b) MIS gradient: launches {read_launches()}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values())
          and sum(g.abs().sum().item() for g in grads.values()) > 0.0,
          "(b) MIS gradients not finite, or all zero")
    out["I"] = dict(image_sha256=sha256(img), grads_sha256=grads_sha256(grads),
                    step_ms=[ms], launches_per_step=mis_launches)
    # The overlapped gradient against the plain fused one, at D's shape.
    cfg = RenderConfig(**BENCH)
    scene = cornell_box(resolution=res).to("cuda")
    target = torch.full((cfg.height, cfg.width, 3), 0.25, device="cuda")
    grad_fn = fast.make_overlapped_grad_fn(scene, cfg, m, n_microtiles=4)
    (loss_o, g_o), over_ms = synced_ms(lambda: grad_fn(scene, target))
    leaves = with_grad(scene)

    def plain():
        loss = torch.mean((fast.render_path_fused_sharded(leaves, cfg, m)
                           - target) ** 2)
        return loss, grads_of(leaves, loss)

    (loss_p, g_p), plain_ms = synced_ms(plain)
    check(abs(loss_o.item() - loss_p.item()) <= 1e-6 * abs(loss_p.item()),
          f"(b) overlapped loss {loss_o.item()} against {loss_p.item()}")
    named_o = dict(zip(
        [f"{part.name}.{f.name}" for part in dataclasses.fields(g_o)
         for f in dataclasses.fields(getattr(g_o, part.name))],
        g_o.tensors()))
    worst = 0.0
    for name, ref in g_p.items():
        diff = (named_o[name] - ref).abs()
        largest = diff.max().item() if diff.numel() else 0.0
        worst = max(worst, largest)
        check(bool((diff <= OVERLAP_TOL["atol"]
                    + OVERLAP_TOL["rtol"] * ref.abs()).all()),
              f"(b) overlapped d {name} differs by {largest:.3e}")
    out["overlapped"] = dict(loss=loss_o.item(), max_abs_diff=worst,
                             step_ms=[over_ms], plain_ms=[plain_ms],
                             grads_sha256=grads_sha256(
                                 {k: named_o[k] for k in g_p}))
    return out


def nccl_rank_steps() -> dict:
    """(c), on a world of one over NCCL: steps at D's and I's shapes,
    unsharded, sharded on a mesh of one (no group: the two autograd
    Functions alone), and sharded on a mesh of one whose axis carries the
    NCCL world group (the Functions and their NCCL collectives), in turns.
    Images and gradients must be equal by bits across the three."""
    import torch.distributed as dist
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"(c) backend {dist.get_backend()}")
    bare = mesh.make_ray_mesh()
    check(bare.group is None, "(c) a mesh of one has a group")
    world = mesh.RayMesh({mesh.RAY_AXIS: mesh.MeshAxis(0, 1, dist.group.WORLD)},
                         dist.group.WORLD, bare.device)
    out = {}
    for label, scene, cfg, kind, _, expect in sharded_cases():
        if label not in NCCL_TURNS:
            continue
        occ = potential_occluders(scene, cfg)
        leaves = with_grad(scene)
        target = torch.full((cfg.height, cfg.width, 3), 0.25, device="cuda")
        sharded = (fast.render_path_fused_sharded if kind == "path"
                   else fast.render_mis_fused_sharded)
        variants = {
            "unsharded": lambda: single_entry(kind)(leaves, cfg,
                                                    occluders=occ),
            "functions": lambda: sharded(leaves, cfg, bare, occluders=occ),
            "nccl": lambda: sharded(leaves, cfg, world, occluders=occ)}

        def step(render):
            img = render()
            return img, grads_of(leaves, torch.mean((img - target) ** 2))

        first = {name: step(fn) for name, fn in variants.items()}
        ref_img, ref_grads = first["unsharded"]
        for name, (img, grads) in first.items():
            # replicate's backward gives the tensors the image does not
            # use a zero gradient where autograd gives none.
            check(sha256(img) == sha256(ref_img)
                  and set(ref_grads) <= set(grads)
                  and all(torch.equal(grads[k], ref_grads[k])
                          for k in ref_grads)
                  and all(not bool(grads[k].any())
                          for k in set(grads) - set(ref_grads)),
                  f"(c) {label} {name}: image or gradients differ from the "
                  "unsharded step's")
        times = {name: [] for name in variants}
        for _ in range(NCCL_TURNS[label]):
            for name, fn in variants.items():
                reset_launches()
                _, ms = synced_ms(lambda: step(fn))
                check(read_launches() == launches_of(**expect),
                      f"(c) {label} {name}: launches {read_launches()}")
                times[name].append(ms)
        med = {name: statistics.median(t) for name, t in times.items()}
        out[label] = dict(step_ms=times, median_ms=med,
                          functions_add_ms=med["functions"] - med["unsharded"],
                          nccl_adds_ms=med["nccl"] - med["functions"],
                          launches_per_step=expect)
    return out


def sharded_rank(mode, rank, world, port, out_dir) -> int:
    """One rank of (b) or (c): join the group, run, write the JSON."""
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    check(multihost.init_distributed(
        f"localhost:{port}", world, rank,
        backend="gloo" if mode == "gloo" else None), "init_distributed")
    _build.load_libraries()  # built by the parent's phase build: loads
    result = gloo_rank_steps() if mode == "gloo" else nccl_rank_steps()
    result["card"] = torch.cuda.get_device_name(torch.cuda.current_device())
    result["backend"] = dist.get_backend()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    multihost.sync_hosts("written")
    dist.destroy_process_group()
    return 0


def phase_sharded():
    """Phase sharded: (a) pixel ranges in one process, (b) two ranks on the
    one card over gloo, (c) a world of one over NCCL."""
    log("== sharded (a): pixel ranges in one process at D's, K's and I's "
        "shapes")
    ranges = sharded_ranges()
    log("== sharded (b): two ranks on the one card over gloo")
    torch.cuda.empty_cache()  # the ranks are processes of their own
    b = run_ranks("gloo", 2)
    for key in ("D", "E", "K", "oracle", "I", "overlapped"):
        check(all(r[key].get("params_sha256") == b[0][key].get(
            "params_sha256") and r[key].get("grads_sha256") == b[0][key].get(
            "grads_sha256") for r in b), f"(b) {key}: the ranks differ")
    single_e = cornell_box_with_spheres(resolution=INVERSE_RES)
    cfg_e = RenderConfig(pixel_chunk=65536, **INVERSE)
    e_sha = sha256(cuda_shade.render_path_decoupled_fused(
        single_e, cfg_e, occluders=potential_occluders(single_e, cfg_e)))
    for key, ref in (("D", ranges["D"]["sha256"]), ("E", e_sha),
                     ("K", ranges["K"]["sha256"]),
                     ("I", ranges["I"]["sha256"])):
        for r, res in enumerate(b):
            check(res[key]["image_sha256"] == ref, f"(b) {key}: rank {r}'s "
                  "gathered image differs from the single-process frame")
    for key in ("D", "E", "K", "oracle", "I", "overlapped"):
        log(f"  (b) {key}: step ms on rank 0 "
            + ", ".join(f"{t:.1f}" for t in b[0][key]["step_ms"])
            + ", rank 1 " + ", ".join(f"{t:.1f}" for t in b[1][key]["step_ms"])
            + (f"; losses {b[0][key]['losses']}" if "losses" in b[0][key]
               else ""))
    log("  (b) images equal to the single-process frames by sha256, the "
        "parameters and gradients equal by bits on both ranks, launches "
        f"per step {b[0]['D']['launches_per_step']} (D)")
    log("== sharded (c): a world of one over NCCL")
    c = run_ranks("nccl", 1)[0]
    for label in NCCL_TURNS:
        med = c[label]["median_ms"]
        log(f"  (c) {label}: median step ms unsharded {med['unsharded']:.2f}, "
            f"sharded without a group {med['functions']:.2f}, with NCCL "
            f"{med['nccl']:.2f}; images and gradients equal by bits")
    return dict(
        ranges=ranges,
        unsharded_step_ms={k: v["median_ms"]["unsharded"]
                           for k, v in c.items() if k in NCCL_TURNS},
        two_ranks_one_card_gloo_step_ms={
            key: [res[key]["step_ms"] for res in b]
            for key in ("D", "E", "K", "oracle", "I", "overlapped")},
        overlapped_max_abs_diff=b[0]["overlapped"]["max_abs_diff"],
        world1_nccl={k: {kk: vv for kk, vv in v.items()
                         if kk != "launches_per_step"}
                     for k, v in c.items() if k in NCCL_TURNS},
        card=c["card"], backends=[b[0]["backend"], c["backend"]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--sharded-rank"] and len(args) == 6:
        return sharded_rank(*args[1:])
    only = None
    if args[:1] == ["--split"] and "--only" in args[:-1]:
        at = args.index("--only")
        only, args = args[at + 1], args[:at] + args[at + 2:]
    if not (args in ([], ["--count-drift"])
            or (args[:1] == ["--split"] and set(args[1:]) <= set(SPLIT_PTXAS))):
        print("usage: python3 chip_smoke.py [--count-drift | --split "
              f"[{' '.join(SPLIT_PTXAS)} ...] [--only TEXT]]", file=sys.stderr)
        return 2
    if args:
        if args[0] == "--split":
            result = {"split_ms": split(args[1:], only)}
        else:
            result = {"count_drift": count_drift()}
        print(json.dumps(result), flush=True)
        print(card_name_and_limit(), flush=True)
        return 0
    started = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    seconds = {}  # wall seconds of each phase

    def timed(name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - start
        log(f"  ({name} took {seconds[name]:.1f} s)")
        return out

    try:
        resources, smi = timed("build", phase_build)
        plain_small = timed("small", phase_small)
        plain_small.update(timed("mis", phase_mis_small))
        launches = timed("main path", phase_main_path, tmp)
        launches["D"], step_ms = timed("D", phase_train)
        launches["E"], inverse_ms = timed("E", phase_inverse)
        host = timed("host", phase_host, tmp)
        mis_launches, mis_frame_ms = timed("MIS paths", phase_mis_path, tmp)
        launches.update(mis_launches)
        mis_bwd_small = timed("mis_bwd", phase_mis_bwd)
        path_i = timed("I", phase_mis_train)
        mis_grad = timed("MIS gradients", phase_mis_grad)
        soft_small = timed("soft", phase_soft)
        launches["J"], path_j = timed("J", phase_soft_train)
        launches["recovery"], recovery = timed("soft recovery",
                                               phase_soft_recovery)
        grouped_small = timed("grouped", phase_grouped)
        launches["K"], path_k = timed("K", phase_grouped_path, "K", TESS_K,
                                      steps=4)
        launches["L"], path_l = timed("L", phase_grouped_path, "L", TESS_L,
                                      steps=2)
        mis_grouped_small, mis_grouped_s = phase_mis_grouped()
        paths_mn = {}
        for label, scene_name, scene in mis_grouped_path_scenes(
                (MIS_BENCH["width"], MIS_BENCH["height"])):
            key = f"{label} {scene_name}"
            launches[key], paths_mn[key] = timed(
                key, phase_mis_grouped_path, label, scene_name, scene,
                steps=4 if label == "M" else 2)
        rows, small_ms, mis_plain = timed("full", phase_full, launches,
                                          plain_small, resources)
        rows += timed("K5 rows", mis_bwd_rows, path_i, resources)
        rows += timed("K6 and K7 rows", soft_rows, launches["J"],
                      launches["recovery"], path_j, recovery, resources)
        rows += timed("K2 at J row", k2_at_j_row, launches["J"], path_j,
                      resources)
        rows += timed("K2g and K3g rows", grouped_rows, launches, resources)
        mis_grouped_row_list, mis_grouped_rows_s = mis_grouped_rows(
            launches, resources)
        rows += mis_grouped_row_list
        sphere_rows, spheres = timed("spheres", phase_spheres, resources)
        rows += sphere_rows
        sharded = timed("sharded", phase_sharded)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"== done in {time.perf_counter() - started:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"kernels": rows, "small_128x96_ms": small_ms,
                      "path_D_step_ms": step_ms,
                      "path_E_step_ms": inverse_ms,
                      "host": host,
                      "path_F_profiled_ms": mis_frame_ms,
                      "mis_plain_ms": mis_plain,
                      "mis_oracle_backward": mis_grad,
                      "path_I": {k: {kk: vv for kk, vv in v.items()
                                     if kk != "launches"}
                                 for k, v in path_i.items()},
                      "mis_bwd_small_max_abs_err": mis_bwd_small,
                      "soft_bwd_max_abs_err": soft_small[0],
                      "soft_path_relative_err": soft_small[1],
                      "path_J": path_j, "soft_recovery": recovery,
                      "grouped_small_max_abs_err": grouped_small,
                      "path_K": path_k, "path_L": path_l,
                      "mis_grouped_small_max_abs_err": mis_grouped_small,
                      "paths_M_N": paths_mn, "spheres": spheres,
                      "mis_grouped_seconds": {
                          "phase": mis_grouped_s,
                          "paths": sum(v["seconds"]
                                       for v in paths_mn.values()),
                          "rows": mis_grouped_rows_s},
                      "phase_seconds": seconds,
                      "ptxas": resources}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
