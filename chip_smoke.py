#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, renders three frames through the
command-line entry point (the main path), times the kernels, and prints

  * a ``kernels`` JSON line (time, bound, plain-version time, launches on the
    main path, largest difference from the plain version, per kernel),
  * the card's name and power limit as ``nvidia-smi`` gives them,
  * as the last line ``{"ok": true, "device": {...}}``.

It needs a card: without one it exits non-zero and prints no result. Every
failed check raises, so a run that ends in the ``ok`` line passed them all.

Phases
  build   nvcc builds ops/csrc/path_kernels.cu; registers and spills printed.
  small   128 x 96, 4 spp, 3 bounces, both scenes, both samplers: draws
          kernel bit-equal to its plain version; trace kernel in its three
          modes against the plain version (records equal except a printed
          share, image within tolerance where the records agree).
  A, B    ``cli.main([png, "--kernel", "cuda"])`` at the reference's frame,
          800 x 600 x 400 spp x 3 bounces, box scene and sphere scene.
  C       ``--kernel decoupled`` at 512 x 512 x 16 spp x 3 bounces: draws
          kernel + record-emitting trace with the occluder cull.
  full    the kernels at the shapes of A, B and C against their plain
          versions, and their times.

Tolerances. Draws: bit-equal (the radical inverse spells out each rounding).
Records: a share of at most 0.5 % of the decisions may differ — the kernel and
the plain version round alike (no fused multiply-add, IEEE divide and square
root), but sin, cos and a few compiler choices differ by an ulp, which flips a
closest hit or a shadow bit on knife-edge rays. A record is a decision where
its path is alive; the records dead lanes still write feed nothing, and their
share is printed, not limited. Image: atol 2e-5 / rtol 1e-4 (f32 sums over a
few bounces) on the pixels all of whose decisions agree.
"""
from __future__ import annotations

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
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import _build, cuda_path, decoupled
from gpuraytracer_tpu_torch.render import pixel_rng_offsets
from gpuraytracer_tpu_torch.sampling import PRIMES
from gpuraytracer_tpu_torch.scene import cornell_box, cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils.metrics import mrays_per_s

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

SCENES = {"cornell": cornell_box, "cornell-spheres": cornell_box_with_spheres}
FRAME = dict(width=800, height=600, spp=400, bounces=3)   # cli.py defaults
BENCH = dict(width=512, height=512, spp=16, bounces=3)    # training-loop size
SMALL = dict(width=128, height=96, spp=4, bounces=3)


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
            name = "draws_kernel"
            m = re.search(r"path_kernelILb(\d)ELb(\d)E", mangled)
            if m:
                name = (f"path_kernel<EMIT={m.group(1)}, "
                        f"READ_DRAWS={m.group(2)}>")
            resources[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            resources[name].update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            resources[name]["registers"] = int(m.group(1))
    return resources


def phase_build():
    log("== build")
    built = _build.load_library("path_kernels")
    version = subprocess.run([built.nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    log("  " + version.splitlines()[-2] + " | " + version.splitlines()[-1])
    log(f"  nvcc {' '.join(_build.NVCC_FLAGS)}")
    log(f"  built {built.path.name} in {built.seconds:.1f} s")
    resources = ptxas_resources(built.log)
    for name, res in resources.items():
        log(f"  ptxas: {name}: {res['registers']} registers, "
            f"{res['stack_bytes']} B stack, {res['spill_store_bytes']} B "
            f"spill stores, {res['spill_load_bytes']} B spill loads")
    check(len(resources) == 4, "ptxas did not report the draws kernel and "
          f"the three trace-kernel instantiations: {resources}\n{built.log}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  card: {smi}")
    return resources, smi


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
            if tag == "cornell/halton":
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
    for key in ("draws", "hdr", "emit"):
        log(f"  128 x 96 x 4 spp, cornell: {key}: plain "
            f"{plain_ms[key][1]:.3f} ms, kernel "
            f"{plain_ms['k_' + key][1]:.3f} ms (median of 5)")
    return plain_ms


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
    just before and read just after."""
    cfg = RenderConfig(**size)
    png = os.path.join(tmp, f"{label}.png")
    dbg = os.path.join(tmp, f"{label}.txt")
    for key in cuda_path.LAUNCHES:
        cuda_path.LAUNCHES[key] = 0
    start = time.perf_counter()
    rc = cli.main([png, "--kernel", kernel, "--scene", scene_name,
                   "--width", str(cfg.width), "--height", str(cfg.height),
                   "--spp", str(cfg.spp), "--bounces", str(cfg.bounces),
                   "--debug-output", dbg])
    seconds = time.perf_counter() - start
    launches = dict(cuda_path.LAUNCHES)
    check(rc == 0, f"path {label}: cli.main returned {rc}")
    check_frame(png, dbg, cfg)
    log(f"  path {label}: {kernel} {scene_name} {cfg.width}x{cfg.height} "
        f"x {cfg.spp} spp x {cfg.bounces}: {seconds:.3f} s with PNG, "
        f"launches {launches}")
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


def phase_full(launches, plain_small):
    log("== full: kernels at the main path's shapes")
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
        log(f"  K2 at {label}: live closest-hit iterations {closest} and "
            f"shaded {shade} of {total}; records_only mode "
            f"{r_ms[1]:.1f} ms")
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
            live_closest_iterations=closest, live_shaded_iterations=shade,
            mrays_per_s=mrays_per_s(cfg, k_ms[1] / 1e3)))
        del rec_r, hdr_r
        torch.cuda.empty_cache()

    for row in rows:
        log(f"  {row['name']} @ {row['shape']}: kernel {row['ms']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}), bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain "
            f"{row['plain_ms']:.1f} ms, launches {row['launches']}")
    row_small = {k: v[1] for k, v in plain_small.items()}
    return rows, row_small


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
        launches = phase_main_path(tmp)
        rows, small_ms = phase_full(launches, plain_small)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"== done in {time.perf_counter() - started:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": rows, "small_128x96x4spp_ms": small_ms,
                      "ptxas": resources}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
