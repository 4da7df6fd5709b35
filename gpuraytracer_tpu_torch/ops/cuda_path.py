"""The variant-B path tracer's two kernels on the card, and their plain
PyTorch versions.

Counterpart of ``gpuraytracer_tpu/ops/pallas_path.py``, both tiers: the
static tier (at most 64 triangles, plus analytic spheres, its tables within
one block's shared memory) tests every triangle; the grouped tier (any
primitive count up to the record encoding's limit; ``grouped_tier`` picks)
sweeps a two-level hierarchy of bounding boxes in triangle order:

  * ``group_aabbs``, ``pad_geo``, ``pack_shadow_tables``  the grouped tier's
    tables (groups of 16 triangles, supers of 8 groups, the occluder-culled
    shadow table), as the JAX package packs them

  * ``pregen_draws``           the Halton draw planes (kernel ``draws_kernel``)
  * ``render_path_cuda_impl``  the full spp x bounces trace (``path_kernel``,
    or ``path_grouped_kernel`` in the grouped tier) in three modes: hdr only;
    ``emit_records`` (int32 decision records, draws read from planes);
    ``records_only`` (records, draws regenerated in the kernel).
  * ``render_path_cuda``       the entry point, hdr only; differentiable: its
    backward re-traces with records and runs the backward kernel
    (``ops/cuda_shade.py``).

The kernels are CUDA C++ (``csrc/path_kernels.cu``), built at first use
(``_build.py``). Beside each stands a plain PyTorch version of the same
function on the same inputs (``pregen_draws_plain``, ``render_path_plain``);
a wrapper takes the plain version only for tensors that lie on the CPU. For
CUDA tensors it launches the kernel or raises; nothing falls back.

Layouts: draw and record planes are ``[spp, bounces, N]`` (jitter
``[spp, N]``) with the pixel axis minor-most; the record code is
``(prim + 1) + OCC_BIT * occluded`` with 0 = miss and sphere ``s`` recorded as
``num_tris + s + 1`` — the JAX package's decoded ``TraceAux``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

from .. import sampling as smp
from ..intersect import (RAY_TMAX, RAY_TMIN, compile_scene,
                         sphere_candidates, triangle_candidates)
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from . import _build

OCC_BIT = 1 << 20  # record code = (prim + 1) + OCC_BIT * shadow_occluded
STATIC_TIER_MAX = 64  # above this many triangles the grouped tier runs
_BIG = 1e30
# The grouped tier: triangles per group, groups per super; the absolute pad
# of every group box (plus 1e-5 of the scene's largest coordinate) and the
# slack on a ray's far limit. The margins are about a thousand times the
# rounding difference between the slab test and the triangle test, so a box
# is never skipped where one of its triangles would have won: decisions
# equal those of the loop over every triangle.
GROUP = 16
SUPER = 8
GROUP_AABB_PAD = 1e-3
T_FAR_SLACK = 1e-3
# Bytes of shared memory one block may use on sm_90: both tiers of the trace
# kernel stage their tables within it (the launcher asks for what exceeds the
# default 48 KiB), and so do the other static kernels. A static kernel whose
# tables pass it sends its route to the grouped tier (``grouped_tier``).
SMEM_LIMIT = 227 * 1024
# A trace that runs alone (no backward after it) takes the static tier only
# while one SM holds at least as many of K2's warps as of K2g's 24 (two
# blocks of 384 threads): six blocks of 128 threads, each with its tables
# and the 1 KiB an SM reserves per block within its 228 KiB. Past that K2g
# is the faster: at 800 x 600 x 16 spp on the box with 300 to 1,500 small
# spheres (PERF.md §6) K2 wins with 22 and 33 KB of tables, K2g from 43 KB.
TRACE_ALONE_BYTES = 228 * 1024 // 6 - 1024
# Above WIDE_SUPERS supers the grouped tiers' closest-hit sweep takes its wide
# form (``csrc/trace.cuh``).
WIDE_SUPERS = 32
# K4's triangle tests and K2's shadow probe take the divide only where two
# exact conditions hold (``plane_ahead``, ``plane_within``); plane_within's
# margin is 1 + 2^-22 (``WITHIN_MARGIN`` in ``csrc/trace.cuh``).
WITHIN_MARGIN = 1.0 + 2.0 ** -22

# Rows of the packed tables (the JAX package's layout).
NROWS = 19   # tri: n xyz, c0, s1 xyz, c1, s2 xyz, c2, diffuse rgb, is_em, emissive rgb
SROWS = 11   # sph: center xyz, radius, diffuse rgb, is_em, emissive rgb
NATTR = 13   # atab: normal xyz, diffuse rgb, emissive rgb, is_em, sphere center xyz

# Kernel launches since the process started (or since a caller reset them):
# each wrapper adds one where it launches its kernel and nowhere else.
# The grouped tier (K2g, ``path_grouped_kernel``) counts apart from the
# static tier.
LAUNCHES = {"draws_kernel": 0, "path_kernel": 0, "path_kernel_grouped": 0}


class TraceAux(NamedTuple):
    """Trace outputs kept for the backward pass. Shapes [spp, bounces, N],
    jitter [spp, N]. The six draw planes are None after a ``records_only``
    trace (the consumer regenerates them)."""

    records: torch.Tensor            # int32: (prim + 1) + OCC_BIT * occluded
    nee_u0: Optional[torch.Tensor]   # f32 light-sample u in [0, 1)
    nee_u1: Optional[torch.Tensor]
    cos_u0: Optional[torch.Tensor]   # f32 cosine-bounce u
    cos_u1: Optional[torch.Tensor]
    jitter_x: Optional[torch.Tensor]  # f32 camera subpixel jitter
    jitter_y: Optional[torch.Tensor]


class GroupedTables(NamedTuple):
    """The grouped tier's geometry: the closest-hit loop's table and boxes,
    and the shadow loop's (the occluder-culled triangles packed dense, or
    the same tables when nothing is culled). Geometry columns are zero past
    the last triangle; their plane test fails the |den| guard."""

    geo: torch.Tensor          # [12, P_gpad] n xyz, c0, s1 xyz, c1, s2 xyz, c2
    aabb: torch.Tensor         # [6, ng_pad] group boxes: lo xyz, hi xyz
    sup: torch.Tensor          # [6, n_super] super boxes
    shadow_geo: torch.Tensor   # [12, S_gpad]
    shadow_aabb: torch.Tensor  # [6, ...]
    shadow_sup: torch.Tensor   # [6, ...]
    num_tris: int              # triangles in geo
    num_shadow: int            # triangles in shadow_geo


class PackedScene(NamedTuple):
    """The trace kernel's scene inputs, all float32 on one device."""

    tri: torch.Tensor    # [NROWS, T]
    cam: torch.Tensor    # [12] position, u * half_width, v * half_height, w
    light: torch.Tensor  # [6] center xyz, color rgb
    sph: torch.Tensor    # [SROWS, max(S, 1)]
    atab: torch.Tensor   # [NATTR, T + S]
    num_spheres: int
    grouped: Optional[GroupedTables] = None  # the grouped tier's tables


def camera_vector(cam, config: RenderConfig) -> torch.Tensor:
    """The camera as the kernels take it, [12] float32: position, then the
    basis prescaled by the half-extents of the image plane (u * half_width,
    v * half_height, w). Differentiable in position, direction and up."""
    f32 = torch.float32
    res_x, res_y = config.resolution
    aspect = float(res_x // res_y) if config.integer_aspect else res_x / res_y
    half_width = torch.tan(cam.horizontal_fov.to(f32) / 2.0)
    half_height = half_width / aspect
    u, v, w = smp.camera_basis(cam.direction.to(f32), cam.up.to(f32))
    return torch.cat([cam.position.to(f32), u * half_width,
                      v * half_height, w])


def group_aabbs(verts: torch.Tensor):
    """[T, 3, 3] float32 vertices -> the two-level box tables: per group of
    GROUP triangles [6, ng_pad] and per super of SUPER groups [6, n_super]
    (rows lo xyz, hi xyz). A trailing partial group is padded with copies of
    its last triangle, which never widens its box; the group table is padded
    to a whole super with point boxes at 1e20 that every ray's slab test
    rejects. Margin GROUP_AABB_PAD + 1e-5 of the largest |coordinate|. The
    JAX package's ``pallas_path.group_aabbs``, operation for operation."""
    f32 = torch.float32
    verts = verts.to(f32)
    dev = verts.device
    n = verts.shape[0]
    ng = max(1, (n + GROUP - 1) // GROUP)
    pad = ng * GROUP - n
    v = (torch.cat([verts, verts[-1:].expand(pad, 3, 3)]) if pad else verts)
    v = v.reshape(ng, GROUP * 3, 3)
    margin = GROUP_AABB_PAD + 1e-5 * verts.abs().max()
    lo = v.amin(dim=1) - margin           # [ng, 3]
    hi = v.amax(dim=1) + margin
    n_super = (ng + SUPER - 1) // SUPER
    gpad = n_super * SUPER - ng
    lo_p = torch.cat([lo, torch.full((gpad, 3), 1e20, dtype=f32,
                                     device=dev)])
    hi_p = torch.cat([hi, torch.full((gpad, 3), -1e20, dtype=f32,
                                     device=dev)])
    slo = lo_p.reshape(n_super, SUPER, 3).amin(dim=1)
    shi = hi_p.reshape(n_super, SUPER, 3).amax(dim=1)
    # Sentinel groups: point boxes at +1e20 (lo == hi).
    hi_p = torch.where(hi_p <= -1e20, torch.full_like(hi_p, 1e20), hi_p)
    gtab = torch.cat([lo_p.T, hi_p.T], dim=0).contiguous()
    stab = torch.cat([slo.T, shi.T], dim=0).contiguous()
    return gtab, stab  # [6, ng_pad], [6, n_super]


def pad_geo(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad geometry columns to a whole number of supers (SUPER * GROUP
    triangles), so that every group the box tables name has its columns."""
    mult = SUPER * GROUP
    p = ((x.shape[1] + mult - 1) // mult) * mult
    return torch.nn.functional.pad(x, (0, p - x.shape[1]))


def pack_shadow_tables(tri, verts, occluders, tri_geo, aabb_main, sup_main):
    """The shadow loop's dense occluder-culled geometry and its two box
    tables (the main tables when no cull is given): the JAX package's
    ``pallas_path.pack_shadow_tables``."""
    if occluders is None:
        return tri_geo, aabb_main, sup_main
    f32 = torch.float32
    dev = tri.device
    keep = [i for i, k in enumerate(occluders) if k]
    if keep:
        kidx = torch.tensor(keep, dtype=torch.int64, device=dev)
        shadow_geo = pad_geo(tri[:12, kidx])
        aabb_shadow, sup_shadow = group_aabbs(verts[kidx])
    else:
        shadow_geo = torch.zeros((12, SUPER * GROUP), dtype=f32, device=dev)
        aabb_shadow = torch.full((6, SUPER), 1e20, dtype=f32, device=dev)
        sup_shadow = torch.full((6, 1), 1e20, dtype=f32, device=dev)
    return shadow_geo, aabb_shadow, sup_shadow


def _pack_grouped(scene: Scene, tri: torch.Tensor,
                  occluders) -> GroupedTables:
    verts = scene.triangles.verts.to(torch.float32)
    geo = pad_geo(tri[:12])
    aabb, sup = group_aabbs(verts)
    shadow_geo, shadow_aabb, shadow_sup = pack_shadow_tables(
        tri, verts, occluders, geo, aabb, sup)
    n_shadow = (tri.shape[1] if occluders is None
                else sum(1 for k in occluders if k))
    return GroupedTables(geo=geo.contiguous(), aabb=aabb, sup=sup,
                         shadow_geo=shadow_geo.contiguous(),
                         shadow_aabb=shadow_aabb, shadow_sup=shadow_sup,
                         num_tris=tri.shape[1], num_shadow=n_shadow)


def _pack_inputs(scene: Scene, config: RenderConfig, grouped: bool = False,
                 occluders=None) -> PackedScene:
    """Marshal a scene for the trace kernel: triangle constants to a
    [NROWS, T] table, the camera to a prescaled basis, the light to six
    scalars, the spheres to a [SROWS, S] table, and the shading attributes
    of every primitive (triangles first, then spheres) to a [NATTR, T + S]
    table read by the winner's index. ``grouped`` adds the grouped tier's
    tables, the shadow table culled by ``occluders``."""
    c = compile_scene(scene.triangles)
    f32 = torch.float32
    tri = torch.stack([
        c.n[:, 0], c.n[:, 1], c.n[:, 2], c.c0,
        c.s1[:, 0], c.s1[:, 1], c.s1[:, 2], c.c1,
        c.s2[:, 0], c.s2[:, 1], c.s2[:, 2], c.c2,
        c.diffuse[:, 0], c.diffuse[:, 1], c.diffuse[:, 2],
        c.is_emissive.to(f32),
        c.emissive[:, 0], c.emissive[:, 1], c.emissive[:, 2],
    ])  # [NROWS, T]
    dev = tri.device

    cam_vec = camera_vector(scene.camera, config)

    light = scene.light
    light_vec = torch.cat([light.center.to(f32).reshape(-1),
                           light.color.to(f32).reshape(-1)])

    sp = scene.spheres
    n_t = scene.triangles.num_triangles
    tri_cols = torch.cat([
        tri[0:3],                                 # normal
        tri[12:15],                               # diffuse
        tri[16:19],                               # emissive
        tri[15:16],                               # is_emissive
        torch.zeros((3, n_t), dtype=f32, device=dev),  # sphere center (n/a)
    ], dim=0)
    if sp.num_spheres:
        sph = torch.stack([
            sp.center[:, 0], sp.center[:, 1], sp.center[:, 2], sp.radius,
            sp.diffuse[:, 0], sp.diffuse[:, 1], sp.diffuse[:, 2],
            (torch.linalg.norm(sp.emissive, dim=-1) > 0.0).to(f32),
            sp.emissive[:, 0], sp.emissive[:, 1], sp.emissive[:, 2],
        ])  # [SROWS, S]
        sph_cols = torch.cat([
            torch.zeros((3, sp.num_spheres), dtype=f32, device=dev),  # normal
            sph[4:7],                             # diffuse
            sph[8:11],                            # emissive
            sph[7:8],                             # is_emissive
            sph[0:3],                             # center
        ], dim=0)
        atab = torch.cat([tri_cols, sph_cols], dim=1)
    else:
        sph = torch.zeros((SROWS, 1), dtype=f32, device=dev)
        atab = tri_cols
    return PackedScene(tri=tri.contiguous(), cam=cam_vec.contiguous(),
                       light=light_vec.contiguous(), sph=sph.contiguous(),
                       atab=atab.contiguous(), num_spheres=sp.num_spheres,
                       grouped=(_pack_grouped(scene, tri, occluders)
                                if grouped else None))


def _stratified_k(config: RenderConfig) -> int:
    """Grid side of the stratified sampler; 0 for the Halton sampler."""
    if config.sampler == "halton":
        return 0
    if config.sampler != "stratified":
        raise ValueError(f"unknown sampler: {config.sampler!r}")
    k = int(round(math.sqrt(config.spp)))
    if k * k != config.spp:
        raise ValueError(
            f"stratified sampler needs a square sample count, got {config.spp}")
    return k


def _check_bounces(config: RenderConfig) -> None:
    if config.spp < 1 or config.bounces < 1:
        raise ValueError("spp and bounces must be at least 1")
    if 2 + 5 * (config.bounces - 1) + 3 >= len(smp.PRIMES):
        raise ValueError(
            f"bounces={config.bounces} needs Halton dimension "
            f"{2 + 5 * (config.bounces - 1) + 3}; only {len(smp.PRIMES)} "
            "prime bases are defined")


def _camera_jitter(ih: torch.Tensor, config: RenderConfig):
    """Camera subpixel jitter (x, y) at Halton indices ``ih``."""
    if config.sampler == "stratified":
        uv = smp.stratified2(ih, 0, config.spp)
        return uv[..., 0], uv[..., 1]
    return smp.halton(ih, 0), smp.halton(ih, 1)


# ---------------------------------------------------------------------------
# The library
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("path_kernels").lib
    if lib.grt_pregen_draws.argtypes is None:
        lib.grt_pregen_draws.argtypes = (
            [_PTR, _INT, _INT, _INT, _INT, _FLT] + [_PTR] * 6 + [_PTR])
        lib.grt_pregen_draws.restype = _INT
        lib.grt_path_trace.argtypes = (
            [_PTR] * 22 + [_INT] * 12 + [_FLT, _FLT, _INT, _INT, _INT, _PTR])
        lib.grt_path_trace.restype = _INT
        lib.grt_draws_blocks_per_sm.argtypes = [_INT]
        lib.grt_draws_blocks_per_sm.restype = _INT
        lib.grt_path_static_smem.argtypes = [_INT] * 3
        lib.grt_path_static_smem.restype = _INT
        lib.grt_path_grouped_smem.argtypes = [_INT] * 3
        lib.grt_path_grouped_smem.restype = _INT
        lib.grt_path_blocks_per_sm.argtypes = [_INT] * 8
        lib.grt_path_blocks_per_sm.restype = _INT
    return lib


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             shape: Sequence[int], device: torch.device) -> int:
    """Validate a kernel argument and return its address."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def _raise_on_launch_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what}: launch failed with CUDA error {code} "
            "(cudaGetLastError after the launch)")


def _draw_shapes(config: RenderConfig, n: int):
    sb = (config.spp, config.bounces, n)
    s = (config.spp, n)
    return [sb, sb, sb, sb, s, s]


# ---------------------------------------------------------------------------
# K1: draw planes
# ---------------------------------------------------------------------------

def pregen_draws_plain(offsets: torch.Tensor, config: RenderConfig):
    """Plain PyTorch version of ``draws_kernel``: the 6-tuple (nee_u0,
    nee_u1, cos_u0, cos_u1, jitter_x, jitter_y) for Halton index offsets
    ``offsets`` [N] (any integer dtype)."""
    rows = [[] for _ in range(6)]
    for n in range(config.spp):
        ih = smp.as_u32(offsets) + n
        jx, jy = _camera_jitter(ih, config)
        rows[4].append(jx)
        rows[5].append(jy)
        for k in range(4):
            rows[k].append(torch.stack([
                smp.halton(ih, 2 + 5 * b + k) for b in range(config.bounces)]))
    return tuple(torch.stack(r) for r in rows)


def pregen_draws_kernel(offsets: torch.Tensor, config: RenderConfig):
    """Launch ``draws_kernel`` for int32 ``offsets`` [N] on the card."""
    if offsets.device.type != "cuda":
        raise ValueError("pregen_draws_kernel needs CUDA tensors")
    dev = offsets.device
    n = offsets.shape[0]
    lib = _library()
    off_ptr = _require(offsets, "offsets", torch.int32, (n,), dev)
    k = _stratified_k(config)
    planes = [torch.empty(shape, dtype=torch.float32, device=dev)
              for shape in _draw_shapes(config, n)]
    with torch.cuda.device(dev):
        code = lib.grt_pregen_draws(
            off_ptr, n, config.spp, config.bounces, k,
            1.0 / k if k else 0.0, *[p.data_ptr() for p in planes],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_launch_error(code, "draws_kernel")
    LAUNCHES["draws_kernel"] += 1
    return tuple(planes)


def pregen_draws(config: RenderConfig, local_offsets=None, device="cuda"):
    """Pregenerate the trace kernel's random draws (camera jitter and the
    per-bounce NEE / cosine pairs): a pure function of (config, pixel
    offsets), hence invariant across the steps of a training or benchmark
    loop. Pass the result as ``draws=`` to the record-emitting trace.
    Returns (nee_u0, nee_u1, cos_u0, cos_u1, jitter_x, jitter_y)."""
    device = resolve_device(device)
    _check_bounces(config)
    _stratified_k(config)
    if local_offsets is None:
        local_offsets = pixel_rng_offsets(config, device)
    offsets = torch.as_tensor(local_offsets).to(device)
    if offsets.device.type == "cuda":
        return pregen_draws_kernel(offsets.to(torch.int32).contiguous(),
                                   config)
    return pregen_draws_plain(offsets, config)


# ---------------------------------------------------------------------------
# K2: the trace
# ---------------------------------------------------------------------------

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-30 taken as 1e30: the slab test's reciprocal
    (``pallas_path._safe_inv``). It keeps (lo - o) * inv free of NaN, and for
    a near-zero direction the test stays conservative."""
    return torch.where(d.abs() < 1e-30, torch.full_like(d, 1e30), 1.0 / d)


def _slab_reach(box, o, inv, t_far):
    """Whether the segment [0, t_far] of each ray [m] meets the box (lo xyz,
    hi xyz): ``pallas_path._slab_interval`` and its test, in that order."""
    t0 = [(box[k] - o[:, k]) * inv[:, k] for k in range(3)]
    t1 = [(box[3 + k] - o[:, k]) * inv[:, k] for k in range(3)]
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]),
                      torch.minimum(t0[1], t1[1])),
        torch.clamp_min(torch.minimum(t0[2], t1[2]), 0.0))
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]),
                      torch.maximum(t0[1], t1[1])),
        torch.maximum(t0[2], t1[2]))
    return tmin <= torch.minimum(tmax, t_far)


def _geo_rows(cols):
    """The plane and dual-basis constants of geometry columns [12+, k]."""
    return (cols[0:3].T, cols[3], cols[4:7].T, cols[7], cols[8:11].T,
            cols[11])


def plane_ahead(den: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """The static tiers' first prefilter (``csrc/trace.cuh:plane_ahead``),
    element-wise on float32 tensors of a triangle test's plane denominator
    and numerator: False only where the test cannot pass for any t_min >= 0
    (|den| below 1e-12, num zero or NaN, or the signs of num and den
    differ)."""
    return (den.abs() >= 1e-12) & torch.where(den > 0, num > 0, num < 0)


def plane_within(den: torch.Tensor, num: torch.Tensor,
                 t_far: torch.Tensor) -> torch.Tensor:
    """The static tiers' second prefilter (``csrc/trace.cuh:plane_within``),
    element-wise on float32 tensors: False only where num / den, rounded, is
    at least t_far (t_far >= 1e-3), so that a test bounded above by t_far
    fails. Neither prefilter is on any path of the port: the kernels skip the
    divide, the barycentrics and the interval test where either is False,
    the plain versions count the tests that pass both (``stats=``), and the
    tests hold both against the exact test."""
    margin = torch.tensor(WITHIN_MARGIN, dtype=torch.float32)
    return num.abs() < (den.abs() * t_far) * margin


def plane_terms(rows, o, d):
    """den and num [n, k] of rays o, d [n, 3] against the plane rows of
    ``_geo_rows``, in trace.cuh's order."""
    nrm, c0 = rows[0], rows[1]
    den = (d[:, 0:1] * nrm[:, 0] + d[:, 1:2] * nrm[:, 1]
           + d[:, 2:3] * nrm[:, 2])
    num = c0 - (o[:, 0:1] * nrm[:, 0] + o[:, 1:2] * nrm[:, 1]
                + o[:, 2:3] * nrm[:, 2])
    return den, num


def prefilter_passes(rows, o, d, t_far):
    """[n, k]: the triangle tests of rays o, d that pass both prefilters,
    each bounded by ``t_far`` (broadcast to [n, k])."""
    den, num = plane_terms(rows, o, d)
    return plane_ahead(den, num) & plane_within(den, num, t_far)


def closest_bounds(t, valid, t_best=None):
    """The bound each test of a closest-hit loop in index order runs
    against: min(RAY_TMAX, the nearest hit before it, ``t_best`` [n] on
    entry), from the loop's distances and hits [n, k]."""
    before = torch.cummin(torch.where(valid, t, torch.full_like(t, _BIG)),
                          dim=-1).values
    prev = torch.cat([torch.full_like(t[:, :1], _BIG), before[:, :-1]],
                     dim=-1)
    if t_best is not None:
        prev = torch.minimum(prev, t_best[:, None])
    return prev.clamp_max(RAY_TMAX)


def _count(stats, key, live, lanes, per_lane=1):
    """Add to ``stats[key]`` the live lanes among ``lanes``, and to
    ``stats[key + "_all"]`` all of them, each times ``per_lane`` (a number,
    or a tensor with one entry per lane): the sweep's work counters; None
    counts nothing."""
    if stats is not None:
        w = torch.as_tensor(per_lane, device=lanes.device).expand(lanes.shape)
        live_sum, all_sum = torch.stack([(w * live[lanes]).sum(),
                                         w.sum()]).tolist()
        stats[key] = stats.get(key, 0) + int(live_sum)
        stats[key + "_all"] = stats.get(key + "_all", 0) + int(all_sum)


def closest_grouped(g: GroupedTables, o, d, live=None, stats=None,
                    passes=False):
    """Closest triangle hit of each ray (o, d [n, 3]) by the grouped tier's
    sweep, the plain version of K2g's: per super, then per group of the
    super, the slab test against t_far = min(t_best (1 + T_FAR_SLACK) +
    T_FAR_SLACK, RAY_TMAX) with the current t_best; the group's triangles are
    tested only on the rays that reach it, in index order, strict < on t.
    Returns (t_best [n], prim [n] int64, -1 where no triangle is hit).
    ``stats``: counts of box and triangle tests on the ``live`` rays, and
    with ``passes`` of the triangle tests that pass both prefilters
    ("passed", which the bound of K2g in ``chip_smoke.py`` reads)."""
    n = o.shape[0]
    dev = o.device
    t_best = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    inv = _safe_inv(d)
    every = torch.arange(n, device=dev)
    _count(stats, "rays", live, every)

    def t_far(lanes):
        return torch.clamp_max(t_best[lanes] * (1.0 + T_FAR_SLACK)
                               + T_FAR_SLACK, RAY_TMAX)

    for sg in range(g.sup.shape[1]):
        _count(stats, "boxes", live, every)
        lanes = every[_slab_reach(g.sup[:, sg], o, inv, t_far(every))]
        for gi in range(sg * SUPER, (sg + 1) * SUPER):
            if not lanes.numel():
                break
            _count(stats, "boxes", live, lanes)
            reach = lanes[_slab_reach(g.aabb[:, gi], o[lanes], inv[lanes],
                                      t_far(lanes))]
            base, top = gi * GROUP, min((gi + 1) * GROUP, g.num_tris)
            if not reach.numel() or top <= base:
                continue
            _count(stats, "triangles", live, reach, top - base)
            rows = _geo_rows(g.geo[:, base:top])
            t, valid = triangle_candidates(*rows, o[reach], d[reach],
                                           RAY_TMIN, RAY_TMAX)
            if stats is not None and passes:
                passed = prefilter_passes(rows, o[reach], d[reach],
                                          closest_bounds(t, valid,
                                                         t_best[reach]))
                _count(stats, "passed", live, reach, passed.sum(dim=-1))
            t_grp, k_grp = torch.where(valid, t, torch.full_like(t, _BIG)
                                       ).min(dim=-1)  # first minimum
            closer = t_grp < t_best[reach]
            won = reach[closer]
            t_best[won] = t_grp[closer]
            prim[won] = base + k_grp[closer]
    return t_best, prim


def occluded_grouped(g: GroupedTables, h, ld, t_max, live=None, stats=None,
                     t_min=0.0, passes=False):
    """Whether each shadow ray (h, ld [n, 3]) hits a triangle of the shadow
    table in (t_min, t_max): the grouped sweep with the segment's far limit
    t_max (1 + T_FAR_SLACK) + T_FAR_SLACK, a ray leaving the sweep at its
    first occluder. The plain version of K2g's shadow probe (t_min 0) and of
    K4g's light probe (t_min RAY_TMIN). ``stats`` and ``passes`` as
    ``closest_grouped``'s, a test passing the prefilters against
    max(t_max, 1e-3)."""
    n = h.shape[0]
    dev = h.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    inv = _safe_inv(ld)
    t_seg = t_max * (1.0 + T_FAR_SLACK) + T_FAR_SLACK
    every = torch.arange(n, device=dev)
    _count(stats, "rays", live, every)
    for sg in range(g.shadow_sup.shape[1]):
        open_ = every[~occ]
        _count(stats, "boxes", live, open_)
        lanes = open_[_slab_reach(g.shadow_sup[:, sg], h[open_], inv[open_],
                                  t_seg[open_])]
        for gi in range(sg * SUPER, (sg + 1) * SUPER):
            lanes = lanes[~occ[lanes]]
            if not lanes.numel():
                break
            _count(stats, "boxes", live, lanes)
            reach = lanes[_slab_reach(g.shadow_aabb[:, gi], h[lanes],
                                      inv[lanes], t_seg[lanes])]
            base, top = gi * GROUP, min((gi + 1) * GROUP, g.num_shadow)
            if not reach.numel() or top <= base:
                continue
            rows = _geo_rows(g.shadow_geo[:, base:top])
            _, blocked = triangle_candidates(*rows, h[reach], ld[reach],
                                             t_min, t_max[reach])
            hit = blocked.any(dim=-1)
            occ[reach] = hit
            # A lane leaves the group at its first occluder.
            tested = torch.where(hit, blocked.float().argmax(dim=-1) + 1,
                                 top - base)
            _count(stats, "triangles", live, reach, tested)
            if stats is not None and passes:
                passed = prefilter_passes(
                    rows, h[reach], ld[reach],
                    t_max[reach].clamp_min(1e-3)[:, None])
                first = (torch.arange(top - base, device=dev)[None, :]
                         < tested[:, None])
                _count(stats, "passed", live, reach,
                       (passed & first).sum(dim=-1))
    return occ


def render_path_plain(offsets: torch.Tensor, rid_base: int,
                      packed: PackedScene,
                      shadow_idx: Optional[torch.Tensor],
                      draws, config: RenderConfig, emit_records: bool,
                      stats: Optional[dict] = None):
    """Plain PyTorch version of ``path_kernel`` on the same inputs: offsets
    [n] (integer), the packed scene, the indices of the triangles kept in
    the shadow loop, optionally the six draw planes. Returns (hdr [3, n]
    float32, records [spp, bounces, n] int32 or None). The arithmetic and
    its order are the kernel's: planar f32 math over [n] tensors and the
    [n, T] candidate tests of ``intersect.py``, or, where ``packed`` holds
    the grouped tables, the grouped sweep (``closest_grouped``,
    ``occluded_grouped``; ``shadow_idx`` is then unused, and may be None:
    the cull is in the shadow table); dead lanes run on masked and records are written for
    every (sample, bounce, pixel). ``rid_base``: the first pixel's id, or
    the ids of all n pixels (an int64 tensor: a sample of pixels from
    anywhere in the frame). ``stats``: a dict that the grouped sweep adds its
    rays, box tests, triangle tests and the triangle tests that pass both
    prefilters ("passed") to, under "closest" and "shadow" (live lanes: a
    path that is alive, a probe from a shaded lane; with the suffix "_all",
    all lanes, as the kernel runs them with records on). Without the grouped
    tables it counts, under the same keys, the static tier's triangle tests
    ("triangles") and those that pass both of its prefilters ("passed"), a
    probe's only where it reaches the light (no triangle or sphere blocks
    it): the loop that stops at its first occluder tests every occluder
    there. The counts change no result."""
    def rid(s):
        return (rid_base + s if isinstance(rid_base, int)
                else rid_base[s:s + config.pixel_chunk])

    outs = [
        _plain_chunk(offsets[s:s + config.pixel_chunk], rid(s), packed,
                     shadow_idx,
                     None if draws is None else
                     [d[..., s:s + config.pixel_chunk] for d in draws],
                     config, emit_records, stats)
        for s in range(0, offsets.shape[0], config.pixel_chunk)
    ]
    hdr = torch.cat([o[0] for o in outs], dim=-1)
    rec = torch.cat([o[1] for o in outs], dim=-1) if emit_records else None
    return hdr, rec


def _plain_chunk(offsets, rid_base, packed, shadow_idx, draws, config,
                 emit_records, stats):
    f32 = torch.float32
    dev = offsets.device
    W, H = config.width, config.height
    n_local = offsets.shape[0]
    tri, atab = packed.tri, packed.atab
    T = tri.shape[1]
    S = packed.num_spheres
    P = T + S

    grp = packed.grouped
    if grp is None:
        geo_all = _geo_rows(tri)
        geo_shadow = _geo_rows(tri[:, shadow_idx.long()])
    if stats is not None:
        stats.setdefault("closest", {})
        stats.setdefault("shadow", {})
    sph_center = packed.sph[0:3].T[:S]
    sph_radius = packed.sph[3][:S]

    rid = (rid_base + torch.arange(n_local, dtype=torch.int64, device=dev)
           if isinstance(rid_base, int) else rid_base.to(dev, torch.int64))
    px = (rid % W).to(f32)
    py = (rid // W).to(f32)
    in_image = rid < W * H
    cam, light = packed.cam, packed.light
    pos, uh, vh, wv = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    lcx, lcy, lcz, lr, lg, lb = (light[k] for k in range(6))
    he = smp._f32(config.area_light_half_extent)
    two_pi = smp._f32(2.0 * math.pi)
    zero = torch.zeros(n_local, dtype=f32, device=dev)
    big = torch.full((n_local,), _BIG, dtype=f32, device=dev)
    # Divisors as tensors: PyTorch divides by a Python scalar through its
    # reciprocal, which rounds twice where the kernel's division rounds once.
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)

    def norm3(x, y, z, floor):
        inv = smp.rsqrt(torch.clamp_min(x * x + y * y + z * z, floor))
        return x * inv, y * inv, z * inv

    def vec(x, y, z):
        return torch.stack([x, y, z], dim=-1)

    every = torch.arange(n_local, device=dev)
    acc = [zero, zero, zero]
    records = []
    for n in range(config.spp):
        ih = smp.as_u32(offsets) + n
        if draws is not None:
            jx, jy = draws[4][n], draws[5][n]
        else:
            jx, jy = _camera_jitter(ih, config)

        s = ((px + jx) / f_w) * 2.0 - 1.0
        t = -(((py + jy) / f_h) * 2.0 - 1.0)
        dx, dy, dz = norm3(*(s * uh[k] + t * vh[k] - wv[k] for k in range(3)),
                           1e-12)
        ox, oy, oz = (zero + pos[k] for k in range(3))
        col = [zero + 1.0] * 3
        a = [zero, zero, zero]
        alive = in_image

        for bounce in range(config.bounces):
            o, d = vec(ox, oy, oz), vec(dx, dy, dz)
            if grp is None:
                t_all, valid = triangle_candidates(*geo_all, o, d, RAY_TMIN,
                                                   RAY_TMAX)
                if stats is not None:
                    passes = prefilter_passes(geo_all, o, d,
                                              closest_bounds(t_all, valid))
                    _count(stats["closest"], "triangles", alive, every, T)
                    _count(stats["closest"], "passed", alive, every,
                           passes.sum(dim=-1))
                if S:
                    t_s, valid_s = sphere_candidates(
                        sph_center, sph_radius, o, d, RAY_TMIN, RAY_TMAX)
                    t_all = torch.cat([t_all, t_s], dim=-1)
                    valid = torch.cat([valid, valid_s], dim=-1)
                t_masked = torch.where(valid, t_all,
                                       torch.full_like(t_all, _BIG))
                t_best, winner = torch.min(t_masked, dim=-1)  # first minimum
            else:
                t_best, winner = closest_grouped(
                    grp, o, d, alive,
                    None if stats is None else stats["closest"], passes=True)
                if S:  # spheres after the triangles, strict <
                    t_s, valid_s = sphere_candidates(
                        sph_center, sph_radius, o, d, RAY_TMIN, RAY_TMAX)
                    for k in range(S):
                        closer = valid_s[:, k] & (t_s[:, k] < t_best)
                        t_best = torch.where(closer, t_s[:, k], t_best)
                        winner = torch.where(closer, T + k, winner)
            hit = t_best < _BIG * 0.5
            prim = torch.where(hit, winner, torch.full_like(winner, -1))

            at = atab[:, torch.clamp(prim, 0, P - 1)]  # [NATTR, n]
            nhx, nhy, nhz = at[0], at[1], at[2]
            is_em = at[9] > 0.5
            if S:
                sphere_won = hit & (prim >= T)
                t_sw = torch.where(sphere_won, t_best, zero)
                nvx = ox + dx * t_sw - at[10]
                nvy = oy + dy * t_sw - at[11]
                nvz = oz + dz * t_sw - at[12]
                nvx, nvy, nvz = norm3(nvx, nvy, nvz, 1e-6)
                nhx = torch.where(sphere_won, nvx, nhx)
                nhy = torch.where(sphere_won, nvy, nhy)
                nhz = torch.where(sphere_won, nvz, nhz)

            active = alive & hit
            hit_light = active & is_em
            a = [torch.where(hit_light, at[6 + k], a[k]) for k in range(3)]
            surf = active & ~is_em

            t_safe = torch.where(surf, t_best, zero)
            hx = ox + dx * t_safe + nhx * 1e-3
            hy = oy + dy * t_safe + nhy * 1e-3
            hz = oz + dz * t_safe + nhz * 1e-3

            if draws is not None:
                u_nee0, u_nee1 = draws[0][n, bounce], draws[1][n, bounce]
                u0, u1 = draws[2][n, bounce], draws[3][n, bounce]
            else:
                u_nee0, u_nee1, u0, u1 = (
                    smp.halton(ih, 2 + 5 * bounce + k) for k in range(4))
            w0 = u_nee0 * 2.0 - 1.0
            w1 = u_nee1 * 2.0 - 1.0
            tlx = lcx + he * w0 - hx
            tly = lcy - hy
            tlz = lcz + he * w1 - hz
            ldist = torch.sqrt(torch.clamp_min(
                tlx * tlx + tly * tly + tlz * tlz, 0.0))
            inv_d = 1.0 / torch.clamp_min(ldist, 1e-3)
            ldx, ldy, ldz = tlx * inv_d, tly * inv_d, tlz * inv_d
            cos_l = torch.clamp(ldy, 0.0, 1.0)  # -ld . (0, -1, 0)
            fall = inv_d * inv_d * cos_l
            cos_s = torch.clamp(nhx * ldx + nhy * ldy + nhz * ldz, 0.0, 1.0)
            gain = fall * cos_s

            col = [torch.where(surf, col[k] * at[3 + k], col[k])
                   for k in range(3)]

            h, ld = vec(hx, hy, hz), vec(ldx, ldy, ldz)
            t_max = ldist - 1e-3
            if grp is None:
                _, blocked = triangle_candidates(*geo_shadow, h, ld, 0.0,
                                                 t_max)
                occ = blocked.any(dim=-1)
            else:
                occ = occluded_grouped(
                    grp, h, ld, t_max, surf,
                    None if stats is None else stats["shadow"], passes=True)
            if S:
                _, blocked_s = sphere_candidates(sph_center, sph_radius, h, ld,
                                                 0.0, t_max)
                occ = occ | blocked_s.any(dim=-1)
            if grp is None and stats is not None:
                reach = every[~occ]
                t_far = t_max[reach].clamp_min(1e-3)[:, None]
                passes = prefilter_passes(geo_shadow, h[reach], ld[reach],
                                          t_far)
                _count(stats["shadow"], "triangles", surf, reach,
                       passes.shape[1])
                _count(stats["shadow"], "passed", surf, reach,
                       passes.sum(dim=-1))
            if emit_records:
                records.append(((prim + 1) + OCC_BIT * occ.to(torch.int64))
                               .to(torch.int32))
            w_c = torch.where(surf & ~occ, gain, zero)
            a = [a[k] + lc * w_c * col[k]
                 for k, lc in enumerate((lr, lg, lb))]

            phi = two_pi * u0
            cth = torch.sqrt(u1)
            sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
            lx, ly, lz = sth * torch.cos(phi), cth, sth * torch.sin(phi)
            ax, ay, az = 0.0072, 1.0, 0.0034
            rx, ry, rz = norm3(nhy * az - nhz * ay, nhz * ax - nhx * az,
                               nhx * ay - nhy * ax, 1e-12)
            fx = ry * nhz - rz * nhy
            fy = rz * nhx - rx * nhz
            fz = rx * nhy - ry * nhx
            sdx = lx * rx + ly * nhx + lz * fx
            sdy = lx * ry + ly * nhy + lz * fy
            sdz = lx * rz + ly * nhz + lz * fz

            ox, oy, oz = (torch.where(surf, new, old) for new, old in
                          ((hx, ox), (hy, oy), (hz, oz)))
            dx, dy, dz = (torch.where(surf, new, old) for new, old in
                          ((sdx, dx), (sdy, dy), (sdz, dz)))
            alive = surf

        acc = [acc[k] + a[k] for k in range(3)]

    inv_spp = smp._f32(1.0 / config.spp)
    hdr = torch.stack([c * inv_spp for c in acc])
    rec = (torch.stack(records).reshape(config.spp, config.bounces, n_local)
           if emit_records else None)
    return hdr, rec


def _boxes8(boxes: torch.Tensor) -> torch.Tensor:
    """A [6, n] box table as the kernel reads it: [n, 8], rows lo xyz, 0,
    hi xyz, 0 (two 16-byte loads per box)."""
    z = torch.zeros_like(boxes[:1])
    return torch.cat([boxes[0:3], z, boxes[3:6], z]).T.contiguous()


def grouped_launch_tables(grp: GroupedTables, dev: torch.device):
    """The grouped tables as the kernels read them, after checking them: the
    two geometry tables triangle-major [P_gpad][12], the four box tables
    [n][8] (``_boxes8``), and the supers of the closest-hit and the shadow
    sweep. The caller holds the tensors until the launch."""
    f32 = torch.float32
    for name, geo, boxes, sup in (
            ("geo", grp.geo, grp.aabb, grp.sup),
            ("shadow_geo", grp.shadow_geo, grp.shadow_aabb, grp.shadow_sup)):
        n_sup = sup.shape[1]
        _require(geo, name, f32, (12, n_sup * SUPER * GROUP), dev)
        _require(boxes, f"{name} boxes", f32, (6, n_sup * SUPER), dev)
        _require(sup, f"{name} supers", f32, (6, n_sup), dev)
    tables = [grp.geo.T.contiguous(), _boxes8(grp.aabb), _boxes8(grp.sup),
              grp.shadow_geo.T.contiguous(), _boxes8(grp.shadow_aabb),
              _boxes8(grp.shadow_sup)]
    return tables, (grp.sup.shape[1], grp.shadow_sup.shape[1])


def static_smem_bytes(num_tris: int, n_shadow: int, num_spheres: int) -> int:
    """Shared memory of one K2 block (``static_smem`` in
    ``csrc/path_kernels.cu``): the triangles, the shadow list, the spheres
    and the attribute rows. Raises ValueError past the most one block may
    use."""
    smem = 4 * (12 * (num_tris + n_shadow) + 4 * num_spheres
                + NATTR * (num_tris + num_spheres))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"scene tables need {smem} B of shared memory; one block may use "
            f"at most {SMEM_LIMIT} B")
    return smem


def grouped_smem_bytes(num_spheres: int, n_super: int,
                       n_shadow_super: int) -> int:
    """Shared memory of one K2g block (``grouped_smem`` in
    ``csrc/path_kernels.cu``): the spheres, the super and group boxes of the
    closest-hit and the shadow sweep (32 B a box). Raises ValueError past
    the most one block may use."""
    smem = 16 * num_spheres + 32 * (1 + SUPER) * (n_super + n_shadow_super)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the grouped trace kernel needs {smem} B of shared memory "
            f"({n_super} + {n_shadow_super} supers of boxes); one block may "
            f"use at most {SMEM_LIMIT} B")
    return smem


def path_trace_kernel(offsets: torch.Tensor, rid_base: int,
                      packed: PackedScene,
                      shadow_idx: Optional[torch.Tensor],
                      draws, config: RenderConfig, emit_records: bool):
    """Launch ``path_kernel`` on the card. Same arguments and results as
    ``render_path_plain``, with ``offsets`` and ``shadow_idx`` int32. Where
    ``packed`` holds the grouped tables the grouped tier runs (K2g,
    ``path_grouped_kernel``) and ``shadow_idx`` is not read (None will
    do)."""
    if offsets.device.type != "cuda":
        raise ValueError("path_trace_kernel needs CUDA tensors")
    dev = offsets.device
    f32, i32 = torch.float32, torch.int32
    n = offsets.shape[0]
    T = packed.tri.shape[1]
    S = packed.num_spheres
    grp = packed.grouped
    n_shadow = shadow_idx.shape[0] if grp is None else grp.num_shadow
    if grp is None:
        static_smem_bytes(T, n_shadow, S)
    else:
        grouped_smem_bytes(S, grp.sup.shape[1], grp.shadow_sup.shape[1])
    if draws is not None and not emit_records:
        raise ValueError("draw planes are read only when records are emitted")

    lib = _library()
    ptrs = [
        _require(offsets, "offsets", i32, (n,), dev),
        _require(packed.cam, "cam", f32, (12,), dev),
        _require(packed.light, "light", f32, (6,), dev),
        _require(packed.tri, "tri", f32, (NROWS, T), dev),
        _require(packed.sph, "sph", f32, (SROWS, max(S, 1)), dev),
    ]
    if grp is None:
        ptrs += [
            _require(packed.atab, "atab", f32, (NATTR, T + S), dev),
            _require(shadow_idx, "shadow_idx", i32, (n_shadow,), dev)]
        tables, supers, taken = [None] * 6, (0, 0), None
    else:
        _require(packed.atab, "atab", f32, (NATTR, T + S), dev)
        atab_t = packed.atab.T.contiguous()  # [T + S][13], held to the launch
        ptrs += [atab_t.data_ptr(), None]
        tables, supers = grouped_launch_tables(grp, dev)
        # The persistent grid's tile counter.
        taken = torch.zeros(1, dtype=i32, device=dev)
    if draws is not None:
        if len(draws) != 6:
            raise ValueError(f"draws: expected 6 planes, got {len(draws)}")
        ptrs += [_require(d, f"draws[{k}]", f32, shape, dev) for k, (d, shape)
                 in enumerate(zip(draws, _draw_shapes(config, n)))]
    else:
        ptrs += [None] * 6
    hdr = torch.empty((3, n), dtype=f32, device=dev)
    rec = (torch.empty((config.spp, config.bounces, n), dtype=i32, device=dev)
           if emit_records else None)
    k = _stratified_k(config)
    with torch.cuda.device(dev):
        code = lib.grt_path_trace(
            *ptrs, hdr.data_ptr(), rec.data_ptr() if emit_records else None,
            *[None if t is None else t.data_ptr() for t in tables],
            None if taken is None else taken.data_ptr(),
            n, rid_base, config.width, config.height, config.spp,
            config.bounces, T, S, n_shadow, k, *supers,
            1.0 / k if k else 0.0, config.area_light_half_extent,
            int(emit_records), int(draws is not None), int(grp is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    name = "path_kernel" if grp is None else "path_kernel_grouped"
    _raise_on_launch_error(code, name)
    LAUNCHES[name] += 1
    return hdr, rec


def reject_grad(scene: Scene) -> None:
    """The trace alone carries no gradient: refuse a scene that asks for one
    instead of returning an image that silently has none. The differentiable
    entry points (``render_path_cuda``, ``render_path_decoupled``) trace a
    detached copy and attach the backward kernel themselves."""
    if any(t.requires_grad for t in scene.tensors()):
        raise NotImplementedError(
            "a scene tensor has requires_grad=True, but the bare trace is not "
            "differentiable: render with render_path_cuda or "
            "render_path_decoupled (they attach the backward kernel), or "
            "pass scene.detach()")


def shadow_count(occluders, num_tris: int) -> int:
    """Triangles in the shadow list: all of them, or those an
    ``intersect.potential_occluders`` tuple keeps."""
    return num_tris if occluders is None else sum(1 for k in occluders if k)


def faster_below(limit: int, plan):
    """``plan`` that also raises ValueError past ``limit`` bytes: the static
    kernel still fits there, but its grouped tier is the faster."""
    def checked(*args):
        smem = plan(*args)
        if smem > limit:
            raise ValueError(f"{smem} B of tables: past {limit} B the grouped "
                             "tier is the faster")
        return smem
    return checked


def trace_plan(scene: Scene, occluders=None, alone: bool = False):
    """K2's shared-memory plan on ``scene``, as ``grouped_tier`` takes it:
    (``static_smem_bytes``, its arguments). ``alone``: for a trace without
    a backward, which also takes K2g past TRACE_ALONE_BYTES."""
    num_tris = scene.triangles.num_triangles
    plan = (faster_below(TRACE_ALONE_BYTES, static_smem_bytes) if alone
            else static_smem_bytes)
    return plan, (num_tris, shadow_count(occluders, num_tris),
                  scene.spheres.num_spheres)


def grouped_tier(scene: Scene, *plans) -> bool:
    """The tier a route takes when the caller does not force one: the
    grouped tier above STATIC_TIER_MAX triangles, as the JAX entry does, and
    wherever a static kernel that the route launches cannot stage its tables
    in one block's shared memory. ``plans``: (plan, arguments) of each such
    kernel, the launchers' own plans (``trace_plan`` and its kin in the
    modules above), which raise ValueError past SMEM_LIMIT, and for a trace
    alone past the size where its grouped kernel is the faster. A route
    that traces and differentiates passes both kernels' plans, so that its
    trace and its backward take one tier."""
    if scene.triangles.num_triangles > STATIC_TIER_MAX:
        return True
    for plan, args in plans:
        try:
            plan(*args)
        except ValueError:
            return True
    return False


def shadow_indices(occluders, num_tris: int, device) -> torch.Tensor:
    """int32 indices of the triangles kept in the shadow loop: all of them,
    or those an ``intersect.potential_occluders`` tuple marks True."""
    if occluders is None:
        keep = list(range(num_tris))
    else:
        if len(occluders) != num_tris:
            raise ValueError(
                f"occluders has {len(occluders)} entries for {num_tris} "
                "triangles")
        keep = [i for i, k in enumerate(occluders) if k]
    return torch.tensor(keep, dtype=torch.int32, device=device)


def render_path_cuda_impl(scene: Scene, config: RenderConfig,
                          emit_records: bool = False,
                          records_only: bool = False,
                          local_offsets=None, rid_base: int = 0,
                          flat_output: bool = False, draws=None,
                          occluders=None, grouped: Optional[bool] = None,
                          device="cuda"):
    """Variant-B trace of ``scene`` on ``device`` through ``path_kernel``
    (through the plain version when ``device`` is the CPU).

    ``grouped``: the tier; None takes ``grouped_tier``'s for a trace alone:
    the grouped tier above STATIC_TIER_MAX triangles, as the JAX entry does,
    or where K2's tables pass TRACE_ALONE_BYTES (a route that also runs the
    backward passes the tier of both kernels). Both tiers make the same
    decisions.

    Modes: hdr only (default) returns hdr [H, W, 3]; ``emit_records``
    returns (hdr, TraceAux) with the draws read from planes — ``draws`` if
    given, else pregenerated here; ``records_only`` (with ``emit_records``)
    regenerates the draws in the kernel and returns a TraceAux without
    planes. ``occluders``: an ``intersect.potential_occluders`` tuple that
    culls the shadow loop. ``local_offsets`` / ``rid_base`` / ``flat_output``
    render the pixel range [rid_base, rid_base + len(local_offsets)) and
    return flat [n, 3] hdr: the hooks a sharded renderer needs."""
    device = resolve_device(device)
    reject_grad(scene)
    _check_bounces(config)
    _stratified_k(config)
    num_tris = scene.triangles.num_triangles
    if grouped is None:
        grouped = grouped_tier(scene, trace_plan(scene, occluders,
                                                 alone=True))
    if num_tris + scene.spheres.num_spheres + 1 >= OCC_BIT:
        raise ValueError("record encoding limit exceeded")
    if records_only and not emit_records:
        raise ValueError("records_only requires emit_records=True")
    reads_draws = emit_records and not records_only
    if draws is not None and not reads_draws:
        # A pregen that this mode cannot consume is a bug at the call site:
        # fail instead of silently re-deriving the draws in the kernel.
        raise ValueError(
            "draws= was passed but this mode regenerates draws in-kernel "
            f"(records_only={records_only}, emit_records={emit_records}); "
            "drop the argument or disable records_only")

    # The grouped tier's cull lives in its shadow table.
    shadow_idx = (None if grouped
                  else shadow_indices(occluders, num_tris, device))
    packed = _pack_inputs(scene.to(device), config, grouped, occluders)
    if local_offsets is None:
        local_offsets = pixel_rng_offsets(config, device)
    offsets = torch.as_tensor(local_offsets).to(device)
    n_local = offsets.shape[0]
    if not flat_output and n_local != config.num_pixels:
        raise ValueError(
            f"{n_local} offsets for {config.num_pixels} pixels: pass "
            "flat_output=True to render a pixel range")

    if reads_draws:
        if draws is None:
            draws = pregen_draws(config, offsets, device)
        else:
            draws = tuple(draws)
            expect = _draw_shapes(config, n_local)
            got = [tuple(d.shape) for d in draws]
            if got != [tuple(e) for e in expect]:
                raise ValueError(
                    "draws= does not match this (config, shard): expected "
                    f"plane shapes {expect}, got {got} — regenerate with "
                    "pregen_draws(config, local_offsets)")
            draws = tuple(d.to(device) for d in draws)

    if device.type == "cuda":
        hdr, rec = path_trace_kernel(
            offsets.to(torch.int32).contiguous(), int(rid_base), packed,
            shadow_idx, draws, config, emit_records)
    else:
        hdr, rec = render_path_plain(offsets, int(rid_base), packed,
                                     shadow_idx, draws, config, emit_records)

    hdr = hdr.T.contiguous()
    if not flat_output:
        hdr = hdr.reshape(config.height, config.width, 3)
    if not emit_records:
        return hdr
    return hdr, TraceAux(rec, *(draws if reads_draws else (None,) * 6))


class _RetraceGrad(torch.autograd.Function):
    """``render_path_cuda`` for a scene that asks for gradients: the forward
    is the hdr-only trace and costs nothing extra; the backward re-traces
    with records and runs the backward kernel through
    ``cuda_shade.render_path_decoupled_fused``. A training loop should call
    that function itself (one trace per step instead of two)."""

    @staticmethod
    def forward(ctx, scene, config, device, *leaves):
        ctx.scene, ctx.config, ctx.device = scene, config, device
        ctx.save_for_backward(*leaves)
        return render_path_cuda_impl(scene.detach(), config, device=device)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from .cuda_shade import render_path_decoupled_fused
        needs = ctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        it = iter(leaves)
        scene = ctx.scene.map(lambda _: next(it))
        with torch.enable_grad():
            out = render_path_decoupled_fused(scene, ctx.config,
                                              device=ctx.device)
            grads = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], g,
                allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if need else None for need in needs)


def render_path_cuda(scene: Scene, config: RenderConfig,
                     device="cuda") -> torch.Tensor:
    """Variant-B path trace through the trace kernel. Returns [H, W, 3]
    linear radiance. Differentiable: where a scene tensor requires
    gradients, the backward pass re-traces with records and runs the
    backward kernel (gradients equal to autograd through the eager oracle;
    visibility is piecewise constant)."""
    device = resolve_device(device)
    leaves = list(scene.tensors())
    if any(t.requires_grad for t in leaves):
        return _RetraceGrad.apply(scene, config, device, *leaves)
    return render_path_cuda_impl(scene, config, device=device)
