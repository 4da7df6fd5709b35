"""The variant-B path tracer's two kernels on the card, and their plain
PyTorch versions.

Counterpart of ``gpuraytracer_tpu/ops/pallas_path.py`` (static tier: at most
64 triangles, plus analytic spheres):

  * ``pregen_draws``           the Halton draw planes (kernel ``draws_kernel``)
  * ``render_path_cuda_impl``  the full spp x bounces trace (``path_kernel``)
    in three modes: hdr only; ``emit_records`` (int32 decision records, draws
    read from planes); ``records_only`` (records, draws regenerated in the
    kernel).
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
STATIC_TIER_MAX = 64  # triangles the static-tier kernel takes
_BIG = 1e30
_SMEM_LIMIT = 48 * 1024  # bytes of shared memory the trace kernel may stage

# Rows of the packed tables (the JAX package's layout).
NROWS = 19   # tri: n xyz, c0, s1 xyz, c1, s2 xyz, c2, diffuse rgb, is_em, emissive rgb
SROWS = 11   # sph: center xyz, radius, diffuse rgb, is_em, emissive rgb
NATTR = 13   # atab: normal xyz, diffuse rgb, emissive rgb, is_em, sphere center xyz

# Kernel launches since the process started (or since a caller reset them):
# each wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"draws_kernel": 0, "path_kernel": 0}


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


class PackedScene(NamedTuple):
    """The trace kernel's scene inputs, all float32 on one device."""

    tri: torch.Tensor    # [NROWS, T]
    cam: torch.Tensor    # [12] position, u * half_width, v * half_height, w
    light: torch.Tensor  # [6] center xyz, color rgb
    sph: torch.Tensor    # [SROWS, max(S, 1)]
    atab: torch.Tensor   # [NATTR, T + S]
    num_spheres: int


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


def _pack_inputs(scene: Scene, config: RenderConfig) -> PackedScene:
    """Marshal a scene for the trace kernel: triangle constants to a
    [NROWS, T] table, the camera to a prescaled basis, the light to six
    scalars, the spheres to a [SROWS, S] table, and the shading attributes
    of every primitive (triangles first, then spheres) to a [NATTR, T + S]
    table read by the winner's index."""
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
                       atab=atab.contiguous(), num_spheres=sp.num_spheres)


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
            [_PTR] * 15 + [_INT] * 10 + [_FLT, _FLT, _INT, _INT, _PTR])
        lib.grt_path_trace.restype = _INT
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

def render_path_plain(offsets: torch.Tensor, rid_base: int,
                      packed: PackedScene, shadow_idx: torch.Tensor,
                      draws, config: RenderConfig, emit_records: bool):
    """Plain PyTorch version of ``path_kernel`` on the same inputs: offsets
    [n] (integer), the packed scene, the indices of the triangles kept in
    the shadow loop, optionally the six draw planes. Returns (hdr [3, n]
    float32, records [spp, bounces, n] int32 or None). The arithmetic and
    its order are the kernel's: planar f32 math over [n] tensors and the
    [n, T] candidate tests of ``intersect.py``; dead lanes run on masked and
    records are written for every (sample, bounce, pixel)."""
    outs = [
        _plain_chunk(offsets[s:s + config.pixel_chunk], rid_base + s, packed,
                     shadow_idx,
                     None if draws is None else
                     [d[..., s:s + config.pixel_chunk] for d in draws],
                     config, emit_records)
        for s in range(0, offsets.shape[0], config.pixel_chunk)
    ]
    hdr = torch.cat([o[0] for o in outs], dim=-1)
    rec = torch.cat([o[1] for o in outs], dim=-1) if emit_records else None
    return hdr, rec


def _plain_chunk(offsets, rid_base, packed, shadow_idx, draws, config,
                 emit_records):
    f32 = torch.float32
    dev = offsets.device
    W, H = config.width, config.height
    n_local = offsets.shape[0]
    tri, atab = packed.tri, packed.atab
    T = tri.shape[1]
    S = packed.num_spheres
    P = T + S

    def geo(rows):
        return (rows[0:3].T, rows[3], rows[4:7].T, rows[7], rows[8:11].T,
                rows[11])

    geo_all = geo(tri)
    geo_shadow = geo(tri[:, shadow_idx.long()])
    sph_center = packed.sph[0:3].T[:S]
    sph_radius = packed.sph[3][:S]

    rid = rid_base + torch.arange(n_local, dtype=torch.int64, device=dev)
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
            t_all, valid = triangle_candidates(*geo_all, o, d, RAY_TMIN,
                                               RAY_TMAX)
            if S:
                t_s, valid_s = sphere_candidates(sph_center, sph_radius, o, d,
                                                 RAY_TMIN, RAY_TMAX)
                t_all = torch.cat([t_all, t_s], dim=-1)
                valid = torch.cat([valid, valid_s], dim=-1)
            t_masked = torch.where(valid, t_all, torch.full_like(t_all, _BIG))
            t_best, winner = torch.min(t_masked, dim=-1)  # first minimum
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
            _, blocked = triangle_candidates(*geo_shadow, h, ld, 0.0, t_max)
            occ = blocked.any(dim=-1)
            if S:
                _, blocked_s = sphere_candidates(sph_center, sph_radius, h, ld,
                                                 0.0, t_max)
                occ = occ | blocked_s.any(dim=-1)
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


def path_trace_kernel(offsets: torch.Tensor, rid_base: int,
                      packed: PackedScene, shadow_idx: torch.Tensor,
                      draws, config: RenderConfig, emit_records: bool):
    """Launch ``path_kernel`` on the card. Same arguments and results as
    ``render_path_plain``, with ``offsets`` and ``shadow_idx`` int32."""
    if offsets.device.type != "cuda":
        raise ValueError("path_trace_kernel needs CUDA tensors")
    dev = offsets.device
    f32, i32 = torch.float32, torch.int32
    n = offsets.shape[0]
    T = packed.tri.shape[1]
    S = packed.num_spheres
    n_shadow = shadow_idx.shape[0]
    if T > STATIC_TIER_MAX:
        raise NotImplementedError(
            f"{T} triangles: the static-tier kernel takes at most "
            f"{STATIC_TIER_MAX} (grouped tier: later slice)")
    smem = 4 * (12 * (T + n_shadow) + 4 * S + NATTR * (T + S))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"scene tables need {smem} B of shared memory; the kernel stages "
            f"at most {_SMEM_LIMIT} B (fewer spheres, or a later tier)")
    if draws is not None and not emit_records:
        raise ValueError("draw planes are read only when records are emitted")

    lib = _library()
    ptrs = [
        _require(offsets, "offsets", i32, (n,), dev),
        _require(packed.cam, "cam", f32, (12,), dev),
        _require(packed.light, "light", f32, (6,), dev),
        _require(packed.tri, "tri", f32, (NROWS, T), dev),
        _require(packed.sph, "sph", f32, (SROWS, max(S, 1)), dev),
        _require(packed.atab, "atab", f32, (NATTR, T + S), dev),
        _require(shadow_idx, "shadow_idx", i32, (n_shadow,), dev),
    ]
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
            n, rid_base, config.width, config.height, config.spp,
            config.bounces, T, S, n_shadow, k, 1.0 / k if k else 0.0,
            config.area_light_half_extent, int(emit_records),
            int(draws is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_launch_error(code, "path_kernel")
    LAUNCHES["path_kernel"] += 1
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
                          occluders=None, device="cuda"):
    """Variant-B trace of ``scene`` on ``device`` through ``path_kernel``
    (through the plain version when ``device`` is the CPU).

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
    if num_tris > STATIC_TIER_MAX:
        raise NotImplementedError(
            f"{num_tris} triangles: the static-tier kernel takes at most "
            f"{STATIC_TIER_MAX} (grouped tier: later slice)")
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

    packed = _pack_inputs(scene.to(device), config)
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

    shadow_idx = shadow_indices(occluders, num_tris, device)
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
