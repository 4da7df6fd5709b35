"""The backward of the variant-B path tracer: the shade backward kernel on
the card, its plain PyTorch version, and the autograd glue.

Counterpart of ``gpuraytracer_tpu/ops/pallas_shade.py``, both tiers: the
static tier (at most 64 triangles, plus analytic spheres, its tables within
one block's shared memory) stages the tables there; the grouped tier (any
primitive count up to the record encoding's limit) reads them from global
memory and scatters into per-warp tables of a persistent grid:

  * ``_pack_diff_inputs``            differentiable parameter views of a scene
  * ``replay_packed``                radiance recomputed from trace records, a
    differentiable function of those views (the shading half of the oracle)
  * ``shade_bwd_kernel``             launches ``shade_bwd_kernel``
    (``csrc/shade_kernels.cu``): the cotangents of the views, from records
  * ``shade_bwd_plain``              its plain version: autograd through
    ``replay_packed`` on the same inputs
  * ``render_path_decoupled_fused``  the trace kernel's image with that
    backward attached (one ``torch.autograd.Function``)
  * ``render_path_fused_local``      the same for a pixel range

The render is split at the discrete/continuous boundary. The trace kernel
(``cuda_path``) makes every discrete decision — which primitive a ray hits,
whether a shadow ray is blocked — on a detached scene and writes them down as
records. Autograd treats such decisions as constants anyway, so the gradient
of the image is the gradient of the shading arithmetic replayed along the
recorded paths; the backward kernel does that replay and its reverse in one
pass. Autograd then chains the kernel's cotangents from the packed views
back to the scene's tensors (``compile_scene``, ``camera_basis``, the struct
fields); that chain is not written by hand.

A wrapper takes the plain version only for tensors that lie on the CPU. For
CUDA tensors it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from .. import sampling as smp
from ..intersect import compile_scene
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device, upload
from ..utils.metrics import traced
from . import _build
from .cuda_path import (OCC_BIT, SMEM_LIMIT, _check_bounces,
                        _draw_shapes, _require, _stratified_k,
                        camera_vector, grouped_tier, launch,
                        pregen_draws_plain, render_path_cuda_impl,
                        trace_plan)

# Differentiable table rows: n xyz, c0, diffuse rgb, emissive rgb; for sphere
# scenes also center xyz and radius. The packed table carries in addition the
# selector rows is_emissive (row 10) and is_sphere (row 15), which have no
# gradient.
NTAB = 10
NTAB_SPH = 14
NROWS_TAB = 11
NROWS_TAB_SPH = 16
NSCAL = 21  # camera: pos, hu, hv, wb; light: center, color, normal
_KERNEL_THREADS = 128    # threads per block of both tiers
_KERNEL_WARPS = _KERNEL_THREADS // 32
_GROUPED_TABLE_BYTES = 768 << 20  # K3g's per-warp tables, at most


def _stage(has_spheres: bool) -> int:
    """Floats between two lanes' staging rows of the peer scatter
    (``shade_kernels.cu`` STAGE): the table columns, rounded up to odd."""
    return 15 if has_spheres else 11


def static_smem_bytes(num_prims: int, has_spheres: bool) -> int:
    """Shared memory of one block of K3 (``grt_shade_bwd_smem``, grouped 0):
    its tables (the table [P][rows], the 21 scalars, one [P][ntab] table and
    21 scalars per warp), then the staging rows of the peer scatter. Raises
    past the most one block may use (the kernel opts in past 48 KiB)."""
    nrows = NROWS_TAB_SPH if has_spheres else NROWS_TAB
    ntab = NTAB_SPH if has_spheres else NTAB
    smem = 4 * (nrows * num_prims + NSCAL
                + _KERNEL_WARPS * (num_prims * ntab + NSCAL)
                + _KERNEL_THREADS * _stage(has_spheres))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the parameter tables need {smem} B of shared memory; one block "
            f"may use at most {SMEM_LIMIT} B")
    return smem


def shade_plan(scene: Scene):
    """K3's shared-memory plan on ``scene``, as ``cuda_path.grouped_tier``
    takes it: (``static_smem_bytes``, its arguments)."""
    num_spheres = scene.spheres.num_spheres
    return static_smem_bytes, (scene.triangles.num_triangles + num_spheres,
                               num_spheres > 0)


@traced("plan")
def fused_tier(scene: Scene, occluders=None) -> bool:
    """The fused route's tier, one for its trace and its backward: grouped
    above 64 triangles or where K2's or K3's tables do not fit a block."""
    return grouped_tier(scene, trace_plan(scene, occluders), shade_plan(scene))


def grouped_smem_bytes(has_spheres: bool) -> int:
    """Shared memory of one block of K3g (``grt_shade_bwd_smem``, grouped
    1): the staging rows of the peer scatter."""
    return 4 * _KERNEL_THREADS * _stage(has_spheres)


def full_blocks(n_local: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of K3g's persistent grid without its table cap: all that a
    card of ``sms`` SMs holding ``blocks_per_sm`` blocks each runs at once,
    at most one per ``_KERNEL_WARPS`` tiles of 32 pixels."""
    tiles = (n_local + 31) // 32
    return max(1, min(sms * blocks_per_sm,
                      (tiles + _KERNEL_WARPS - 1) // _KERNEL_WARPS))


def grouped_blocks(n_local: int, num_prims: int, has_spheres: bool,
                   blocks_per_sm: int, sms: int) -> int:
    """Blocks of K3g's persistent grid (``grt_shade_bwd_grouped_blocks``):
    ``full_blocks``, and at most as many as keep one partial table per warp
    within 768 MiB."""
    row = num_prims * (NTAB_SPH if has_spheres else NTAB) + NSCAL
    cap = _GROUPED_TABLE_BYTES // (4 * _KERNEL_WARPS * row)
    return max(1, min(full_blocks(n_local, blocks_per_sm, sms), cap))

# Kernel launches since the process started (or since a caller reset them):
# ``cuda_path.launch`` adds one where the wrapper launches the kernel and
# nowhere else.
# The grouped tier (K3g) counts apart from the static tier.
LAUNCHES = {"shade_bwd_kernel": 0, "shade_bwd_grouped_kernel": 0}
# The partial tables of K3 and K3g since the process started
# (``count_partials``, at the launch): launches; bytes of the tables each
# zeroes, scatters into and reduces; its grid's blocks; and the blocks it
# would run without K3g's table cap (``full_blocks``; K3's grid of one block
# per 128 pixels has no cap).
PARTIALS = {"launches": 0, "bytes": 0, "blocks": 0, "blocks_full": 0}


def count_partials(partials: torch.Tensor, blocks: int,
                   blocks_full: int) -> None:
    """Count one launch of K3 or K3g with its ``partials`` tables."""
    PARTIALS["launches"] += 1
    PARTIALS["bytes"] += partials.numel() * partials.element_size()
    PARTIALS["blocks"] += blocks
    PARTIALS["blocks_full"] += blocks_full


def _auto_records_only(config: RenderConfig, n_pixels=None) -> bool:
    """records_only when the six f32 draw planes would exceed 2 GiB:
    regenerating the draws in the kernels costs a few Halton evaluations per
    (sample, bounce) instead. ``n_pixels`` is the pixel count this device
    renders (the shard-local count of a sharded run)."""
    if n_pixels is None:
        n_pixels = config.num_pixels
    nsb = n_pixels * config.spp * config.bounces
    return nsb * 4 * 4 + n_pixels * config.spp * 2 * 4 > 2 << 30


# ---------------------------------------------------------------------------
# Parameter views
# ---------------------------------------------------------------------------

@traced("pack_diff")
def _pack_diff_inputs(scene: Scene, config: RenderConfig):
    """Differentiable packing of the parameter views the backward kernel
    differentiates: ``table`` [11, T] (or [16, T + S] with spheres),
    ``cam_vec`` [12] and ``light_vec`` [9] (center, color, normal — the
    normal as the scene holds it, not normalized). Gradients chain from
    these back to the scene (vertices through ``compile_scene``, the camera
    through ``camera_basis``, sphere and light fields directly). Column
    order is the record encoding's: triangles first, then spheres."""
    f32 = torch.float32
    c = compile_scene(scene.triangles)
    tri_rows = [
        c.n[:, 0], c.n[:, 1], c.n[:, 2], c.c0,
        c.diffuse[:, 0], c.diffuse[:, 1], c.diffuse[:, 2],
        c.emissive[:, 0], c.emissive[:, 1], c.emissive[:, 2],
        c.is_emissive.to(f32),
    ]
    sp = scene.spheres
    if sp.num_spheres:
        dev = c.n.device
        zt = torch.zeros(scene.triangles.num_triangles, dtype=f32, device=dev)
        zs = torch.zeros(sp.num_spheres, dtype=f32, device=dev)
        sph_rows = [
            zs, zs, zs, zs,                                      # n, c0
            sp.diffuse[:, 0], sp.diffuse[:, 1], sp.diffuse[:, 2],
            sp.emissive[:, 0], sp.emissive[:, 1], sp.emissive[:, 2],
            (torch.linalg.norm(sp.emissive.detach(), dim=-1) > 0.0).to(f32),
        ]
        rows = [torch.cat([t, s]) for t, s in zip(tri_rows, sph_rows)]
        rows += [
            torch.cat([zt, sp.center[:, 0]]),
            torch.cat([zt, sp.center[:, 1]]),
            torch.cat([zt, sp.center[:, 2]]),
            torch.cat([zt, sp.radius]),
            torch.cat([zt, torch.ones_like(zs)]),
        ]
        table = torch.stack(rows)  # [NROWS_TAB_SPH, T + S]
    else:
        table = torch.stack(tri_rows)  # [NROWS_TAB, T]

    light = scene.light
    light_vec = torch.cat([light.center.to(f32).reshape(-1),
                           light.color.to(f32).reshape(-1),
                           light.normal.to(f32).reshape(-1)])
    return table, camera_vector(scene.camera, config), light_vec


# ---------------------------------------------------------------------------
# The replay: radiance from records
# ---------------------------------------------------------------------------

def sample_chunk(config: RenderConfig) -> int:
    """Largest divisor of spp not exceeding ``config.replay_sample_chunk``."""
    c = max(1, min(config.replay_sample_chunk, config.spp))
    while config.spp % c:
        c -= 1
    return c


def replay_packed(table: torch.Tensor, cam_vec: torch.Tensor,
                  light_vec: torch.Tensor, records: torch.Tensor,
                  draws: Sequence[torch.Tensor], config: RenderConfig,
                  rid_base: int = 0) -> torch.Tensor:
    """Radiance summed over the samples given, [3, n], recomputed from trace
    records [C, bounces, n] and the matching draw planes: a differentiable
    function of (table, cam_vec, light_vec). It is the oracle's path
    (``render._path_trace_chunk``) with closest hit and shadow probe replaced
    by the record's decision, the attributes fetched by the recorded index
    and the random numbers read from the planes. The hit distance comes from
    the recorded primitive's plane equation (or sphere quadratic), so it is
    differentiable in the geometry. All math is planar [C, n] float32 in the
    operation order of the trace kernel."""
    f32 = torch.float32
    dev = records.device
    nee0, nee1, cos0, cos1, jx, jy = draws
    n = records.shape[-1]
    P = table.shape[1]
    has_spheres = table.shape[0] == NROWS_TAB_SPH
    W, H = config.width, config.height

    rid = rid_base + torch.arange(n, dtype=torch.int64, device=dev)
    px = (rid % W).to(f32)[None, :]
    py = (rid // W).to(f32)[None, :]
    in_image = (rid < W * H)[None, :]
    pos, hu, hv, wb = cam_vec[0:3], cam_vec[3:6], cam_vec[6:9], cam_vec[9:12]
    lc, lcol, ln = light_vec[0:3], light_vec[3:6], light_vec[6:9]
    he = smp._f32(config.area_light_half_extent)
    two_pi = smp._f32(2.0 * math.pi)

    # Camera ray (sampling.generate_camera_ray, planar).
    s = ((px + jx) / float(W)) * 2.0 - 1.0
    t = -(((py + jy) / float(H)) * 2.0 - 1.0)
    rx, ry, rz = (s * hu[k] + t * hv[k] - wb[k] for k in range(3))
    rn = torch.sqrt(rx * rx + ry * ry + rz * rz)
    dx, dy, dz = rx / rn, ry / rn, rz / rn
    zero = torch.zeros_like(dx)
    ox, oy, oz = zero + pos[0], zero + pos[1], zero + pos[2]

    col = [zero + 1.0, zero + 1.0, zero + 1.0]
    a = [zero, zero, zero]
    alive = in_image.expand_as(dx)

    for b in range(config.bounces):
        code = records[:, b].to(torch.int64)
        occ = code >= OCC_BIT
        prim = code % OCC_BIT - 1
        hit = prim >= 0
        pc = torch.clamp(prim, 0, P - 1)  # a miss reads primitive 0, masked

        at = table[:, pc]  # [rows, C, n]: an indexed load per attribute
        tnx, tny, tnz, c0 = at[0], at[1], at[2], at[3]
        df = (at[4], at[5], at[6])
        em = (at[7], at[8], at[9])
        is_em = at[10] > 0.5

        # Distance along the ray to the recorded triangle's plane.
        den = dx * tnx + dy * tny + dz * tnz
        sden = torch.where(den.abs() < 1e-12, torch.ones_like(den), den)
        tt = (c0 - (ox * tnx + oy * tny + oz * tnz)) / sden

        nhx, nhy, nhz = tnx, tny, tnz
        if has_spheres:
            scx, scy, scz, srad = at[11], at[12], at[13], at[14]
            is_sph = at[15] > 0.5
            # The recorded sphere's quadratic (intersect.sphere_candidates).
            ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
            a_q = dx * dx + dy * dy + dz * dz
            b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
            c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - srad * srad
            disc = b_q * b_q - 4.0 * a_q * c_q
            sq = torch.sqrt(torch.where(disc > 0.0, disc,
                                        torch.ones_like(disc)))
            t1 = (-b_q - sq) / (2.0 * a_q)
            t2 = (-b_q + sq) / (2.0 * a_q)
            t1_ok = (t1 > 1e-3) & (t1 < 1e3)
            tt = torch.where(is_sph, torch.where(t1_ok, t1, t2), tt)
            # Sphere normal from the recomputed hit point.
            sel = hit & is_sph
            t_ns = torch.where(sel, tt, zero)
            thx = ox + dx * t_ns - scx
            thy = oy + dy * t_ns - scy
            thz = oz + dz * t_ns - scz
            inv_n = smp.rsqrt(torch.clamp_min(
                thx * thx + thy * thy + thz * thz, 1e-6))
            nhx = torch.where(sel, thx * inv_n, nhx)
            nhy = torch.where(sel, thy * inv_n, nhy)
            nhz = torch.where(sel, thz * inv_n, nhz)

        active = alive & hit
        hit_light = active & is_em
        a = [torch.where(hit_light, em[k], a[k]) for k in range(3)]
        surf = active & ~is_em

        ts = torch.where(surf, tt, zero)
        hx = ox + dx * ts + nhx * 1e-3
        hy = oy + dy * ts + nhy * 1e-3
        hz = oz + dz * ts + nhz * 1e-3

        # Light sample: right = (he, 0, 0), up = (0, 0, he).
        w0 = nee0[:, b] * 2.0 - 1.0
        w1 = nee1[:, b] * 2.0 - 1.0
        tlx = (lc[0] + he * w0) - hx
        tly = lc[1] - hy
        tlz = (lc[2] + he * w1) - hz
        dist = torch.sqrt(torch.clamp_min(
            tlx * tlx + tly * tly + tlz * tlz, 0.0))
        inv_d = 1.0 / torch.clamp_min(dist, 1e-3)
        ldx, ldy, ldz = tlx * inv_d, tly * inv_d, tlz * inv_d
        cos_l = torch.clamp(-(ldx * ln[0] + ldy * ln[1] + ldz * ln[2]),
                            0.0, 1.0)
        cos_s = torch.clamp(nhx * ldx + nhy * ldy + nhz * ldz, 0.0, 1.0)
        gain = ((inv_d * inv_d) * cos_l) * cos_s

        col = [torch.where(surf, col[k] * df[k], col[k]) for k in range(3)]
        contrib = surf & ~occ
        a = [a[k] + torch.where(contrib, (lcol[k] * gain) * col[k], zero)
             for k in range(3)]

        # Cosine bounce about the fixed-axis basis.
        phi = two_pi * cos0[:, b]
        cth = torch.sqrt(cos1[:, b])
        sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
        sx, sy, sz = sth * torch.cos(phi), cth, sth * torch.sin(phi)
        ax, ay, az = 0.0072, 1.0, 0.0034
        crx = nhy * az - nhz * ay
        cry = nhz * ax - nhx * az
        crz = nhx * ay - nhy * ax
        crn = torch.sqrt(crx * crx + cry * cry + crz * crz)
        crx, cry, crz = crx / crn, cry / crn, crz / crn
        fwx = cry * nhz - crz * nhy
        fwy = crz * nhx - crx * nhz
        fwz = crx * nhy - cry * nhx
        sdx = sx * crx + sy * nhx + sz * fwx
        sdy = sx * cry + sy * nhy + sz * fwy
        sdz = sx * crz + sy * nhz + sz * fwz

        ox, oy, oz = (torch.where(surf, new, old) for new, old in
                      ((hx, ox), (hy, oy), (hz, oz)))
        dx, dy, dz = (torch.where(surf, new, old) for new, old in
                      ((sdx, dx), (sdy, dy), (sdz, dz)))
        alive = surf

    return torch.stack([c.sum(dim=0) for c in a])


# ---------------------------------------------------------------------------
# K3: the backward kernel and its plain version
# ---------------------------------------------------------------------------

def _check_views(g, records, table, cam_vec, light_vec, config, dev):
    """Shapes and types the backward takes; returns (n, P, has_spheres)."""
    f32 = torch.float32
    n = g.shape[-1]
    has_spheres = table.shape[0] == NROWS_TAB_SPH
    P = table.shape[1]
    _require(g, "g", f32, (3, n), dev)
    _require(records, "records", torch.int32,
             (config.spp, config.bounces, n), dev)
    _require(table, "table", f32,
             (NROWS_TAB_SPH if has_spheres else NROWS_TAB, P), dev)
    _require(cam_vec, "cam_vec", f32, (12,), dev)
    _require(light_vec, "light_vec", f32, (9,), dev)
    return n, P, has_spheres


def shade_bwd_plain(g: torch.Tensor, records: torch.Tensor, draws,
                    offsets: Optional[torch.Tensor], table: torch.Tensor,
                    cam_vec: torch.Tensor, light_vec: torch.Tensor,
                    config: RenderConfig, rid_base: int = 0):
    """Plain PyTorch version of ``shade_bwd_kernel`` on the same inputs:
    ``torch.autograd.grad`` of sum(g * replay) through ``replay_packed``.
    ``g`` [3, n] is the image cotangent already divided by spp; the draws
    are the six planes, or None with ``offsets`` [n] to regenerate them.
    Returns (dtab [P, 10 | 14], dscal [21]). Samples go through in chunks of
    about 2^20 lanes, each chunk's graph freed before the next."""
    n, P, has_spheres = _check_views(g, records, table, cam_vec, light_vec,
                                     config, g.device)
    if draws is None:
        draws = pregen_draws_plain(offsets, config)
    views = [v.detach().requires_grad_(True)
             for v in (table, cam_vec, light_vec)]
    total = [torch.zeros_like(v) for v in views]
    chunk = max(1, min(config.spp, (1 << 20) // max(n, 1)))
    with torch.enable_grad():
        for s in range(0, config.spp, chunk):
            lum = replay_packed(*views, records[s:s + chunk],
                                [d[s:s + chunk] for d in draws], config,
                                rid_base)
            grads = torch.autograd.grad((g * lum).sum(), views)
            total = [t + d for t, d in zip(total, grads)]
    d_table, d_cam, d_light = total
    rows = list(range(NTAB)) + (list(range(11, 15)) if has_spheres else [])
    return d_table[rows].T.contiguous(), torch.cat([d_cam, d_light])


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("shade_kernels").lib
    if lib.grt_shade_bwd.argtypes is None:
        lib.grt_shade_bwd.argtypes = (
            [_PTR] * 14 + [_INT] * 9 + [_FLT, _FLT, _INT, _INT, _INT, _PTR])
        lib.grt_shade_bwd.restype = _INT
        lib.grt_shade_bwd_blocks.argtypes = [_INT]
        lib.grt_shade_bwd_blocks.restype = _INT
        lib.grt_shade_bwd_grouped_blocks.argtypes = [_INT] * 4
        lib.grt_shade_bwd_grouped_blocks.restype = _INT
        lib.grt_shade_bwd_smem.argtypes = [_INT] * 3
        lib.grt_shade_bwd_smem.restype = _INT
        lib.grt_shade_bwd_blocks_per_sm.argtypes = [_INT] * 4
        lib.grt_shade_bwd_blocks_per_sm.restype = _INT
    return lib


def shade_bwd_kernel(g: torch.Tensor, records: torch.Tensor, draws,
                     offsets: Optional[torch.Tensor], table: torch.Tensor,
                     cam_vec: torch.Tensor, light_vec: torch.Tensor,
                     config: RenderConfig, rid_base: int = 0,
                     grouped: bool = False):
    """Launch ``shade_bwd_kernel`` on the card (``grouped``: its grouped
    tier, K3g, ``shade_bwd_grouped_kernel``). Same arguments and results
    as ``shade_bwd_plain``, with ``offsets`` int32: it is read (and the draws
    are regenerated in the kernel) when ``draws`` is None."""
    if g.device.type != "cuda":
        raise ValueError("shade_bwd_kernel needs CUDA tensors")
    dev = g.device
    n, P, has_spheres = _check_views(g, records, table, cam_vec, light_vec,
                                     config, dev)
    ntab = NTAB_SPH if has_spheres else NTAB
    _check_bounces(config)
    if not grouped:
        static_smem_bytes(P, has_spheres)
    if draws is not None:
        if len(draws) != 6:
            raise ValueError(f"draws: expected 6 planes, got {len(draws)}")
        ptrs = [_require(d, f"draws[{k}]", torch.float32, shape, dev)
                for k, (d, shape) in enumerate(
                    zip(draws, _draw_shapes(config, n)))]
        ptrs.append(None)
    else:
        if offsets is None:
            raise ValueError("pass the draw planes or the offsets")
        ptrs = [None] * 6 + [_require(offsets, "offsets", torch.int32, (n,),
                                      dev)]

    lib = _library()
    count = P * ntab + NSCAL
    with torch.cuda.device(dev):
        if grouped:
            blocks = lib.grt_shade_bwd_grouped_blocks(
                n, P, int(has_spheres), int(draws is None))
            if blocks <= 0:
                raise RuntimeError("shade_bwd_grouped_kernel: the occupancy "
                                   "query failed")
            rows = blocks * _KERNEL_WARPS  # one table per warp
            table = table.T.contiguous()  # [P, nrows]
            blocks_full = full_blocks(
                n, lib.grt_shade_bwd_blocks_per_sm(
                    P, int(has_spheres), int(draws is None), 1),
                torch.cuda.get_device_properties(dev).multi_processor_count)
        else:
            blocks = rows = blocks_full = lib.grt_shade_bwd_blocks(n)
        partials = torch.empty((rows, count), dtype=torch.float32, device=dev)
        out = torch.empty(count, dtype=torch.float32, device=dev)
        k = _stratified_k(config)
        launch(LAUNCHES, "shade_bwd_grouped_kernel" if grouped
               else "shade_bwd_kernel", lib.grt_shade_bwd,
               g.data_ptr(), records.data_ptr(), *ptrs, table.data_ptr(),
               cam_vec.data_ptr(), light_vec.data_ptr(), partials.data_ptr(),
               out.data_ptr(), n, int(rid_base), config.width, config.height,
               config.spp, config.bounces, P, int(has_spheres), k,
               1.0 / k if k else 0.0, config.area_light_half_extent,
               int(draws is None), int(grouped), blocks,
               torch.cuda.current_stream(dev).cuda_stream)
        count_partials(partials, blocks, blocks_full)
    return out[:P * ntab].view(P, ntab), out[P * ntab:]


# ---------------------------------------------------------------------------
# Autograd glue
# ---------------------------------------------------------------------------

class _AttachGrad(torch.autograd.Function):
    """Forward: the trace kernel's image, unchanged. Backward: one launch of
    the backward kernel (its grouped tier where the trace took it; the plain
    version for CPU tensors), giving the cotangents of (table, cam_vec,
    light_vec); records, draws and offsets are constants."""

    @staticmethod
    def forward(ctx, config, rid_base, grouped, hdr, table, cam_vec,
                light_vec, records, offsets, *draws):
        ctx.config, ctx.rid_base, ctx.grouped = config, rid_base, grouped
        ctx.has_draws = bool(draws)
        ctx.save_for_backward(table, cam_vec, light_vec, records, offsets,
                              *draws)
        return hdr.view_as(hdr)

    @staticmethod
    @torch.autograd.function.once_differentiable
    @traced("attach")
    def backward(ctx, g):
        table, cam_vec, light_vec, records, offsets, *draws = ctx.saved_tensors
        config = ctx.config
        # hdr = (sum over samples) / spp: fold the 1/spp into the cotangent.
        gs = (g * smp._f32(1.0 / config.spp)).reshape(-1, 3).T.contiguous()
        args = (gs, records, tuple(draws) if ctx.has_draws else None, offsets,
                table.detach().contiguous(), cam_vec.detach().contiguous(),
                light_vec.detach().contiguous(), config, ctx.rid_base)
        if gs.device.type == "cuda":
            dtab, dscal = shade_bwd_kernel(*args, grouped=ctx.grouped)
        else:
            dtab, dscal = shade_bwd_plain(*args)
        zrow = torch.zeros((1, table.shape[1]), dtype=dtab.dtype,
                           device=dtab.device)
        cols = dtab.T
        if table.shape[0] == NROWS_TAB_SPH:
            # rows n, c0, diffuse, emissive | is_emissive | center, radius
            # | is_sphere
            d_table = torch.cat([cols[:NTAB], zrow, cols[NTAB:NTAB_SPH],
                                 zrow])
        else:
            d_table = torch.cat([cols, zrow])
        return (None, None, None, None, d_table, dscal[:12], dscal[12:],
                None, None) + (None,) * len(draws)


@traced("render")
def _render_fused(scene: Scene, config: RenderConfig, records_only,
                  local_offsets, rid_base: int, flat_output: bool, draws,
                  occluders, device):
    device = resolve_device(device)
    scene = scene.to(device)
    if local_offsets is not None:
        local_offsets = upload(local_offsets, device)
    if records_only is None:
        records_only = _auto_records_only(
            config, None if local_offsets is None else local_offsets.shape[0])
    # One tier for the trace and its backward; a frame without gradients
    # launches the trace alone and takes its tier.
    needs_grad = any(t.requires_grad for t in scene.tensors())
    grouped = fused_tier(scene, occluders) if needs_grad else None
    # The discrete decisions are constants of the gradient: trace a detached
    # copy, keep the graph for the parameter views only. This call's span
    # holds the trace's.
    hdr, aux = render_path_cuda_impl.__wrapped__(
        scene.detach(), config, emit_records=True, records_only=records_only,
        local_offsets=local_offsets, rid_base=rid_base,
        flat_output=flat_output, draws=draws, occluders=occluders,
        grouped=grouped, device=device)
    if not needs_grad:
        return hdr
    table, cam_vec, light_vec = _pack_diff_inputs(scene, config)
    if records_only:
        offsets = (pixel_rng_offsets(config, device) if local_offsets is None
                   else local_offsets)
        if device.type == "cuda":
            offsets = offsets.to(torch.int32)
        planes = ()
    else:
        offsets = None
        planes = tuple(aux[1:])
    return _AttachGrad.apply(config, int(rid_base), grouped, hdr, table,
                             cam_vec, light_vec, aux.records, offsets,
                             *planes)


def render_path_decoupled_fused(scene: Scene, config: RenderConfig,
                                records_only: Optional[bool] = None,
                                draws=None, occluders=None,
                                device="cuda") -> torch.Tensor:
    """Differentiable variant-B render at the trace kernel's speed: its hdr
    [H, W, 3] with the backward kernel attached. Triangle and sphere scenes.

    ``records_only``: regenerate the draws in both kernels instead of keeping
    six planes between them (default: ``_auto_records_only``). ``draws``:
    optional ``pregen_draws(config)`` planes; they do not change from step
    to step, so a training loop makes them once. ``occluders``: optional
    ``intersect.potential_occluders(scene, config)`` tuple that culls the
    shadow loop; it is tied to the geometry it was computed from."""
    return _render_fused(scene, config, records_only, None, 0, False, draws,
                         occluders, device)


def render_path_fused_local(scene: Scene, config: RenderConfig,
                            local_offsets, rid_base: int,
                            records_only: Optional[bool] = None, draws=None,
                            occluders=None, device="cuda") -> torch.Tensor:
    """The fused render of the pixel range [rid_base, rid_base +
    len(local_offsets)): flat [n, 3] hdr with the backward attached. The
    gradients it gives the scene are this range's share; a sharded renderer
    sums them over the ranges."""
    return _render_fused(scene, config, records_only, local_offsets,
                         rid_base, True, draws, occluders, device)
