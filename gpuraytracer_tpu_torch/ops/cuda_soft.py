"""The silhouette-gradient path: the record kernel and the backward kernel on
the card, their plain PyTorch versions, and the autograd glue.

Counterpart of ``gpuraytracer_tpu/ops/pallas_soft.py`` (sphere scenes, at
most 64 triangles). ``grad/diff_render.render_direct_soft`` is the
edge-aware direct-lighting oracle: its value is the hard render, its
gradients include the sphere-silhouette term. This module computes the same
at kernel speed:

  * forward: the trace kernel's hdr at ``bounces=1`` (``cuda_path``; the
    soft value equals the hard one) and one silhouette record per (sample,
    pixel) from ``silh_kernel`` (``csrc/soft_kernels.cu``): the discrete
    decisions of the two-layer soft composite packed into one int32
    (``code2`` below);
  * backward: ``soft_bwd_kernel`` replays the composite from those records
    and reverses it by hand (the JAX kernel takes an in-kernel ``jax.vjp``),
    giving the cotangents of the parameter table, camera and light,
    silhouette d(center) and d(radius) included.

Functions:

  * ``silh_records_plain`` / ``silh_records_kernel`` / ``silh_records``:
    the records (plain version, kernel, entry);
  * ``soft_replay``: the composite recomputed from the records, a function
    autograd can differentiate (the reference of the hand-written reverse);
  * ``soft_bwd_plain`` / ``soft_bwd_kernel``: the hand-written reverse in
    PyTorch, in the kernel's order of operations, and the kernel;
  * ``_AttachSoftGrad`` and ``render_direct_soft_fused``: the glue and the
    differentiable entry.

Gradient conventions: the reference of the reverse is ``jax.vjp``, so the
tie rules are JAX autodiff's own: ``maximum(x, c)`` and ``clip`` split the
cotangent 0.5 / 0.5 where ``x`` equals the bound (``torch.clamp`` would
pass all of it). This differs from ``cuda_mis_bwd``, which follows the
hand-written ``pallas_mis_bwd.py``. ``soft_replay`` uses ``torch.maximum`` /
``torch.minimum`` against tensors, whose gradients split ties the same way.

A wrapper takes the plain version only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch

from .. import sampling as smp
from ..intersect import (RAY_TMAX, RAY_TMIN, sphere_candidates,
                         triangle_candidates)
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from . import _build
from .cuda_path import (STATIC_TIER_MAX, PackedScene, _camera_jitter,
                        _pack_inputs, _require, _stratified_k, launch,
                        plane_ahead, plane_within,
                        render_path_cuda_impl, shadow_indices)
from .cuda_shade import NROWS_TAB_SPH, NTAB_SPH, _pack_diff_inputs

# code2 packing (int32; every field exact):
#   bits  0..19  prim_bg + 1 (triangle-only closest winner; 0 = miss)
#   bit   20     occ_bg   (background layer's shadow bit)
#   bit   21     occ_s    (sphere layer's shadow bit)
#   bit   22     sphere_front
#   bit   23     potential (the candidate's closest approach lies in front
#                of the background)
#   bits 24..    s* + 1   (closest-sphere candidate, >= 1 always: the
#                argmin defaults to sphere 0, as in the oracle)
B_OCCB = 1 << 20
B_OCCS = 1 << 21
B_FRONT = 1 << 22
B_POT = 1 << 23
B_SIDX = 1 << 24
MAX_SPHERES = (1 << 7) - 1  # s* + 1 must fit the 7 bits above bit 24

NSCAL_SOFT = 21  # camera: pos, hu, hv, wb; light: center, color, normal
_BIG = 1e30
_SMEM_LIMIT = 48 * 1024  # bytes of shared memory silh_kernel may stage
_KERNEL_THREADS = 128    # threads per block of either kernel
_KERNEL_WARPS = _KERNEL_THREADS // 32
# The most primitives the silhouette path takes: the static tier's triangles
# and the spheres the record's 7 bits can name.
MAX_PRIMS = STATIC_TIER_MAX + MAX_SPHERES

# Kernel launches since the process started (or since a caller reset them):
# ``cuda_path.launch`` adds one where a wrapper launches its kernel and
# nowhere else.
LAUNCHES = {"silh_kernel": 0, "soft_bwd_kernel": 0}


def _check_scene(scene: Scene) -> None:
    assert scene.spheres.num_spheres > 0, "soft renderer requires spheres"
    assert scene.triangles.num_triangles <= STATIC_TIER_MAX, (
        "silhouette kernels take at most "
        f"{STATIC_TIER_MAX} triangles (sphere scenes)")
    if scene.spheres.num_spheres > MAX_SPHERES:
        raise ValueError(f"at most {MAX_SPHERES} spheres fit the record")


# ---------------------------------------------------------------------------
# The kernels' launch plans (mirrors of the C formulas in
# csrc/soft_kernels.cu; chip_smoke.py holds the exported functions against
# them on the card)
# ---------------------------------------------------------------------------

def silh_smem_bytes(num_tris: int, n_shadow: int, num_spheres: int) -> int:
    """Shared memory of one block of K6 (``grt_silh_smem``): the triangle
    table and the occluder list (12 floats a triangle), the spheres (4) and
    the triangles' is_emissive. Raises past the 48 KiB it may stage."""
    smem = 4 * (12 * (num_tris + n_shadow) + 4 * num_spheres + num_tris)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"scene tables need {smem} B of shared memory; the "
                         f"kernel stages at most {_SMEM_LIMIT} B")
    return smem


def silh_blocks(n: int, spp: int) -> int:
    """Blocks of K6 (``grt_silh_blocks``): one thread per (sample, pixel)
    item, ``_KERNEL_THREADS`` a block."""
    return -(-n * spp // _KERNEL_THREADS)


def soft_bwd_smem_bytes(num_prims: int) -> int:
    """Shared memory of one block of K7 (``grt_soft_bwd_smem``): the table
    [P][16], the 21 scalars, one [P][14] table and 21 scalars per warp.
    Above 48 KiB the launch opts in. Raises past ``MAX_PRIMS`` primitives."""
    if not 0 < num_prims <= MAX_PRIMS:
        raise ValueError(f"{num_prims} primitives: the silhouette backward "
                         f"takes 1 to {MAX_PRIMS}")
    return 4 * (NROWS_TAB_SPH * num_prims + NSCAL_SOFT
                + _KERNEL_WARPS * (num_prims * NTAB_SPH + NSCAL_SOFT))


def soft_bwd_blocks(n: int, spp: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of K7's persistent grid (``grt_soft_bwd_blocks``) on a card of
    ``sms`` SMs that hold ``blocks_per_sm`` blocks each: all of them, at
    most one per ``_KERNEL_WARPS`` tiles of 32 (sample, pixel) items. The
    partials are one row per block."""
    tiles = -(-n * spp // 32)
    return max(1, min(sms * blocks_per_sm, -(-tiles // _KERNEL_WARPS)))


# ---------------------------------------------------------------------------
# K6: the silhouette records
# ---------------------------------------------------------------------------

def silh_records_plain(offsets: torch.Tensor, packed: PackedScene,
                       shadow_idx: torch.Tensor, config: RenderConfig,
                       pix: Optional[torch.Tensor] = None,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch version of ``silh_kernel``: the ``code2`` record of
    every (sample, pixel), [spp, n] int32, for the pixels whose Halton
    offsets are ``offsets`` [n]: the whole frame in order, or the pixels
    ``pix`` [n]. The arithmetic and its order are the kernel's; pixels go
    through in chunks of ``config.pixel_chunk``. ``stats``: a dict to which
    the shadow probes add their counts as the kernel runs them (the
    prefiltered loop to the first occluder): probes that reach the light
    (``reached``) and that are blocked (``blocked``), and the triangle tests
    of the probes that reach the light (``triangles``, every occluder) and
    of those the ones that pass both prefilters (``passed``)."""
    rid = (torch.arange(offsets.shape[0], device=offsets.device)
           if pix is None else pix)
    return torch.cat([
        _silh_chunk(offsets[s:s + config.pixel_chunk],
                    rid[s:s + config.pixel_chunk], packed, shadow_idx, config,
                    stats)
        for s in range(0, offsets.shape[0], config.pixel_chunk)], dim=-1)


def _count_probes(stats, geo_shadow, h, ld, t_max, blocked):
    """``silh_records_plain``'s probe counts (``stats``) of one probe per
    lane from ``h`` toward ``ld``."""
    reached = ~blocked
    stats["reached"] = stats.get("reached", 0) + int(reached.sum())
    stats["blocked"] = stats.get("blocked", 0) + int(blocked.sum())
    n, c0 = geo_shadow[0], geo_shadow[1]
    den = (ld[:, None, 0] * n[:, 0] + ld[:, None, 1] * n[:, 1]
           + ld[:, None, 2] * n[:, 2])
    num = c0 - (h[:, None, 0] * n[:, 0] + h[:, None, 1] * n[:, 1]
                + h[:, None, 2] * n[:, 2])
    passes = (plane_ahead(den, num)
              & plane_within(den, num, torch.clamp_min(t_max, 1e-3)[:, None]))
    stats["triangles"] = (stats.get("triangles", 0)
                          + int(reached.sum()) * n.shape[0])
    stats["passed"] = (stats.get("passed", 0)
                       + int((passes & reached[:, None]).sum()))


def _silh_chunk(offsets, rid, packed, shadow_idx, config, stats=None):
    f32 = torch.float32
    dev = offsets.device
    W, H = config.width, config.height
    n = offsets.shape[0]
    tri = packed.tri
    S = packed.num_spheres

    def geo(rows):
        return (rows[0:3].T, rows[3], rows[4:7].T, rows[7], rows[8:11].T,
                rows[11])

    geo_all = geo(tri)
    geo_shadow = geo(tri[:, shadow_idx.long()])
    tri_n = tri[0:3]
    tri_isem = tri[15]
    sph_c = packed.sph[0:3].T[:S]
    sph_r = packed.sph[3][:S]
    cam = packed.cam
    lc = packed.light[0:3]
    he = smp._f32(config.area_light_half_extent)
    rid = rid.to(torch.int64)
    px = (rid % W).to(f32)
    py = (rid // W).to(f32)
    # Divisors as 0-dim tensors: PyTorch divides by a Python scalar through
    # its reciprocal, which rounds twice where the kernel rounds once.
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)
    zero = torch.zeros(n, dtype=f32, device=dev)

    def vec(x, y, z):
        return torch.stack([x, y, z], dim=-1)

    def probe(hx, hy, hz, w0, w1):
        """Shadow bit of the light sample seen from (hx, hy, hz)."""
        tlx = (lc[0] + he * w0) - hx
        tly = lc[1] - hy
        tlz = (lc[2] + he * w1) - hz
        dist = torch.sqrt(torch.clamp_min(tlx * tlx + tly * tly + tlz * tlz,
                                          0.0))
        inv_d = 1.0 / torch.clamp_min(dist, 1e-3)
        h = vec(hx, hy, hz)
        ld = vec(tlx * inv_d, tly * inv_d, tlz * inv_d)
        t_max = dist - 1e-3
        _, blocked = triangle_candidates(*geo_shadow, h, ld, 0.0, t_max)
        _, blocked_s = sphere_candidates(sph_c, sph_r, h, ld, 0.0, t_max)
        blocked = blocked.any(dim=-1) | blocked_s.any(dim=-1)
        if stats is not None:
            _count_probes(stats, geo_shadow, h, ld, t_max, blocked)
        return blocked

    codes = []
    for s in range(config.spp):
        ih = smp.as_u32(offsets) + s
        jx, jy = _camera_jitter(ih, config)
        sx = ((px + jx) / f_w) * 2.0 - 1.0
        sy = -(((py + jy) / f_h) * 2.0 - 1.0)
        rx, ry, rz = (sx * cam[3 + k] + sy * cam[6 + k] - cam[9 + k]
                      for k in range(3))
        rn = torch.sqrt(rx * rx + ry * ry + rz * rz)
        dx, dy, dz = rx / rn, ry / rn, rz / rn
        ox, oy, oz = (zero + cam[k] for k in range(3))
        o, d = vec(ox, oy, oz), vec(dx, dy, dz)

        # Background: the triangle-only closest hit.
        t_all, valid = triangle_candidates(*geo_all, o, d, RAY_TMIN, RAY_TMAX)
        t_bg, winner = torch.min(
            torch.where(valid, t_all, torch.full_like(t_all, _BIG)), dim=-1)
        bg_hit = t_bg < _BIG * 0.5
        prim_bg = torch.where(bg_hit, winner, torch.full_like(winner, -1))

        # Sphere candidate: first minimum of the masked roots; with none
        # valid, sphere 0 and its raw root.
        t_s_all, valid_s = sphere_candidates(sph_c, sph_r, o, d, RAY_TMIN,
                                             RAY_TMAX)
        _, s_idx = torch.min(
            torch.where(valid_s, t_s_all, torch.full_like(t_s_all, _BIG)),
            dim=-1)
        t_s = torch.gather(t_s_all, -1, s_idx[:, None])[:, 0]
        s_valid = torch.gather(valid_s, -1, s_idx[:, None])[:, 0]
        front = s_valid & (t_s < t_bg)

        scx, scy, scz = (sph_c[s_idx, k] for k in range(3))
        t_ca = (scx - ox) * dx + (scy - oy) * dy + (scz - oz) * dz
        potential = (t_ca > RAY_TMIN) & (t_ca < t_bg)

        w0 = smp.halton(ih, 2) * 2.0 - 1.0
        w1 = smp.halton(ih, 3) * 2.0 - 1.0

        # Sphere layer probe: normal at where(front, t_s, 1), floored at
        # 1e-6; shading point o + d * where(front, t_s, 0) + n * 1e-3.
        ts_n = torch.where(front, t_s, zero + 1.0)
        ts_p = torch.where(front, t_s, zero)
        tox = (ox + dx * ts_n) - scx
        toy = (oy + dy * ts_n) - scy
        toz = (oz + dz * ts_n) - scz
        inv_n = 1.0 / torch.sqrt(torch.clamp_min(
            tox * tox + toy * toy + toz * toz, 1e-6))
        occ_s = probe(ox + dx * ts_p + (tox * inv_n) * 1e-3,
                      oy + dy * ts_p + (toy * inv_n) * 1e-3,
                      oz + dz * ts_p + (toz * inv_n) * 1e-3, w0, w1)

        # Background probe: the winner's plane normal (zero on a miss).
        pc = torch.clamp(prim_bg, min=0)
        bnx, bny, bnz = (torch.where(bg_hit, tri_n[k][pc], zero)
                         for k in range(3))
        b_isem = torch.where(bg_hit, tri_isem[pc], zero)
        tri_surf = bg_hit & (b_isem < 0.5)
        tb_p = torch.where(tri_surf, t_bg, zero)
        occ_b = probe(ox + dx * tb_p + bnx * 1e-3, oy + dy * tb_p + bny * 1e-3,
                      oz + dz * tb_p + bnz * 1e-3, w0, w1)

        i64 = torch.int64
        codes.append(((prim_bg + 1) + B_OCCB * occ_b.to(i64)
                      + B_OCCS * occ_s.to(i64) + B_FRONT * front.to(i64)
                      + B_POT * potential.to(i64)
                      + B_SIDX * (s_idx + 1)).to(torch.int32))
    return torch.stack(codes)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("soft_kernels").lib
    if lib.grt_silh_records.argtypes is None:
        lib.grt_silh_records.argtypes = (
            [_PTR] * 7 + [_INT] * 8 + [_FLT, _FLT, _PTR])
        lib.grt_silh_records.restype = _INT
        lib.grt_soft_bwd.argtypes = (
            [_PTR] * 8 + [_INT] * 7 + [_FLT, _FLT, _FLT, _INT, _PTR])
        lib.grt_soft_bwd.restype = _INT
        for name, nargs in (("grt_silh_smem", 3), ("grt_silh_blocks", 2),
                            ("grt_silh_blocks_per_sm", 3),
                            ("grt_soft_bwd_smem", 1),
                            ("grt_soft_bwd_blocks_per_sm", 1),
                            ("grt_soft_bwd_blocks", 3)):
            getattr(lib, name).argtypes = [_INT] * nargs
            getattr(lib, name).restype = _INT
    return lib


def silh_records_kernel(offsets: torch.Tensor, packed: PackedScene,
                        shadow_idx: torch.Tensor,
                        config: RenderConfig) -> torch.Tensor:
    """Launch ``silh_kernel`` on the card. Same arguments and result as
    ``silh_records_plain``, with ``offsets`` and ``shadow_idx`` int32."""
    if offsets.device.type != "cuda":
        raise ValueError("silh_records_kernel needs CUDA tensors")
    dev = offsets.device
    f32, i32 = torch.float32, torch.int32
    n = offsets.shape[0]
    T = packed.tri.shape[1]
    S = packed.num_spheres
    n_shadow = shadow_idx.shape[0]
    if n != config.num_pixels:
        raise ValueError(f"{n} offsets for {config.num_pixels} pixels")
    if not 0 < S <= MAX_SPHERES or T > STATIC_TIER_MAX:
        raise ValueError(f"{T} triangles and {S} spheres: the kernel takes "
                         f"at most {STATIC_TIER_MAX} triangles and 1 to "
                         f"{MAX_SPHERES} spheres")
    silh_smem_bytes(T, n_shadow, S)
    ptrs = [
        _require(offsets, "offsets", i32, (n,), dev),
        _require(packed.cam, "cam", f32, (12,), dev),
        _require(packed.light, "light", f32, (6,), dev),
        _require(packed.tri, "tri", f32, (19, T), dev),
        _require(packed.sph, "sph", f32, (11, S), dev),
        _require(shadow_idx, "shadow_idx", i32, (n_shadow,), dev),
    ]
    lib = _library()
    codes = torch.empty((config.spp, n), dtype=i32, device=dev)
    k = _stratified_k(config)
    with torch.cuda.device(dev):
        launch(LAUNCHES, "silh_kernel", lib.grt_silh_records,
               *ptrs, codes.data_ptr(), n, config.width, config.height,
               config.spp, T, S, n_shadow, k, 1.0 / k if k else 0.0,
               config.area_light_half_extent,
               torch.cuda.current_stream(dev).cuda_stream)
    return codes


def silh_records(scene: Scene, config: RenderConfig, occluders=None,
                 device="cuda") -> torch.Tensor:
    """The silhouette records of ``scene`` (treated as constants: the scene
    is detached), [spp, H * W] int32, through ``silh_kernel`` (the plain
    version on the CPU). ``occluders``: an ``intersect.potential_occluders``
    tuple that culls the triangles of the shadow probes; the records are
    unchanged where it came from that function, whose endpoint set holds
    the camera (the sphere layer probes from about the camera on lanes that
    do not hit a sphere, and that bit counts on ``potential`` lanes)."""
    device = resolve_device(device)
    scene = scene.detach().to(device)
    _check_scene(scene)
    _stratified_k(config)
    packed = _pack_inputs(scene, config)
    shadow_idx = shadow_indices(occluders, scene.triangles.num_triangles,
                                device)
    offsets = pixel_rng_offsets(config, device)
    if device.type == "cuda":
        return silh_records_kernel(offsets.to(torch.int32).contiguous(),
                                   packed, shadow_idx, config)
    return silh_records_plain(offsets, packed, shadow_idx, config)


# ---------------------------------------------------------------------------
# The composite replayed from the records
# ---------------------------------------------------------------------------

def _jmax(x, c: float):
    """max(x, c) with JAX's tie rule for its gradient (0.5 at x == c)."""
    return torch.maximum(x, torch.full_like(x, c))


def _jclip01(x):
    """clip(x, 0, 1) = min(max(x, 0), 1), JAX's tie rules."""
    return torch.minimum(_jmax(x, 0.0), torch.ones_like(x))


def _gmax(x, c: float):
    """d max(x, c) / dx under JAX's rule: 1 above, 0.5 at, 0 below."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0))


def _gclip01(x):
    """d clip(x, 0, 1) / dx under JAX's rules."""
    y = torch.clamp_min(x, 0.0)
    return _gmax(x, 0.0) * torch.where(y < 1.0, 1.0,
                                       torch.where(y == 1.0, 0.5, 0.0))


def _sigmoid(z):
    """1 / (1 + exp(-z)), spelled as the kernel spells it; its gradient is
    torch.sigmoid's, sig (1 - sig), which stays finite where exp(-z)
    overflows (autograd through the quotient would give inf / inf)."""
    sig = 1.0 / (1.0 + torch.exp(-z.detach()))
    if not z.requires_grad:
        return sig
    smooth = torch.sigmoid(z)
    return sig + (smooth - smooth.detach())


def _decode(code: torch.Tensor):
    """(prim_bg, occ_bg, occ_s, sphere_front, potential, s*) of records."""
    code = code.to(torch.int64)
    return (code % B_OCCB - 1, (code & B_OCCB) != 0, (code & B_OCCS) != 0,
            (code & B_FRONT) != 0, (code & B_POT) != 0, code // B_SIDX - 1)


def _shade_fwd(h, nrm, df, occ, lv, w0, w1, he):
    """Next-event estimation at the offset point ``h`` with normal ``nrm``
    and diffuse ``df``: (radiance [3], what its reverse needs)."""
    tl = [(lv[0] + he * w0) - h[0], lv[1] - h[1], (lv[2] + he * w1) - h[2]]
    q = tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]
    dist = torch.sqrt(_jmax(q, 0.0))
    inv_d = 1.0 / _jmax(dist, 1e-3)
    ld = [tl[k] * inv_d for k in range(3)]
    cl_raw = -(ld[0] * lv[6] + ld[1] * lv[7] + ld[2] * lv[8])
    cs_raw = nrm[0] * ld[0] + nrm[1] * ld[1] + nrm[2] * ld[2]
    cos_l = _jclip01(cl_raw)
    cos_s = _jclip01(cs_raw)
    inv_d2 = inv_d * inv_d
    vis = torch.where(occ, 0.0, 1.0)
    base = ((inv_d2 * cos_l) * cos_s) * vis
    out = [(lv[3 + c] * base) * df[c] for c in range(3)]
    return out, SimpleNamespace(tl=tl, q=q, dist=dist, inv_d=inv_d, ld=ld,
                                cl_raw=cl_raw, cs_raw=cs_raw, cos_l=cos_l,
                                cos_s=cos_s, inv_d2=inv_d2, base=base)


def _soft_forward(table, cam, lv, code, ih, px, py, f_w, f_h, config,
                  kappa, num_tris):
    """One sample of the soft composite from its record, planar over the
    pixels: every value the reverse needs, and the two layers' radiance.
    A differentiable function of (table, cam, lv)."""
    P = table.shape[1]
    he = smp._f32(config.area_light_half_extent)
    prim_bg, occ_b, occ_s, front, pot, s_idx = _decode(code)
    bg_hit = prim_bg >= 0
    at_bg = table[:, torch.clamp(prim_bg, 0, P - 1)]
    at_s = table[:, torch.clamp(num_tris + s_idx, 0, P - 1)]

    jx, jy = _camera_jitter(ih, config)
    s = ((px + jx) / f_w) * 2.0 - 1.0
    t = -(((py + jy) / f_h) * 2.0 - 1.0)
    r = [s * cam[3 + k] + t * cam[6 + k] - cam[9 + k] for k in range(3)]
    rn = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    d = [r[k] / rn for k in range(3)]
    zero = torch.zeros_like(px)
    o = [zero + cam[k] for k in range(3)]
    w0 = smp.halton(ih, 2) * 2.0 - 1.0
    w1 = smp.halton(ih, 3) * 2.0 - 1.0

    # ---- sphere layer (candidate s*)
    sc = [at_s[11 + k] for k in range(3)]
    srad = at_s[14]
    sdf = [at_s[4 + c] for c in range(3)]
    oc = [o[k] - sc[k] for k in range(3)]
    a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b_q = 2.0 * (oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2])
    c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - srad * srad
    disc = b_q * b_q - 4.0 * a_q * c_q
    posd = disc > 0.0
    sq = torch.sqrt(torch.where(posd, disc, 1.0))
    t1 = (-b_q - sq) / (2.0 * a_q)
    t2 = (-b_q + sq) / (2.0 * a_q)
    t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
    t_s = torch.where(t1_ok, t1, t2)
    ts_safe = torch.where(front, t_s, 1.0)
    to = [(o[k] + d[k] * ts_safe) - sc[k] for k in range(3)]
    qq = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    mq = _jmax(qq, 1e-6)
    inv_n = 1.0 / torch.sqrt(mq)
    ns = [to[k] * inv_n for k in range(3)]
    ts_p = torch.where(front, ts_safe, 0.0)
    hs = [(o[k] + d[k] * ts_p) + ns[k] * 1e-3 for k in range(3)]
    ls, sh_s = _shade_fwd(hs, ns, sdf, occ_s, lv, w0, w1, he)
    ls = [ls[c] + at_s[7 + c] for c in range(3)]

    # ---- background (triangle) layer
    bn = [at_bg[k] for k in range(3)]
    bdf = [at_bg[4 + c] for c in range(3)]
    b_isem = at_bg[10] > 0.5
    den = d[0] * bn[0] + d[1] * bn[1] + d[2] * bn[2]
    ok = den.abs() >= 1e-12
    sden = torch.where(ok, den, 1.0)
    t_bg = (at_bg[3] - (o[0] * bn[0] + o[1] * bn[1] + o[2] * bn[2])) / sden
    tri_surf = bg_hit & ~b_isem
    em_show = bg_hit & b_isem
    tb_p = torch.where(tri_surf, t_bg, 0.0)
    hb = [(o[k] + d[k] * tb_p) + bn[k] * 1e-3 for k in range(3)]
    lt, sh_b = _shade_fwd(hb, bn, bdf, occ_b, lv, w0, w1, he)
    lt = [torch.where(em_show, at_bg[7 + c],
                      torch.where(tri_surf, lt[c], 0.0)) for c in range(3)]

    # ---- soft coverage of the candidate
    soc = [sc[k] - o[k] for k in range(3)]
    t_ca = soc[0] * d[0] + soc[1] * d[1] + soc[2] * d[2]
    hm = (soc[0] * soc[0] + soc[1] * soc[1] + soc[2] * soc[2]) - t_ca * t_ca
    h = torch.sqrt(_jmax(hm, 1e-12))
    kr = smp._f32(kappa) * srad
    z = (srad - h) / kr
    sig = _sigmoid(z)
    return SimpleNamespace(**locals())


def soft_replay(table: torch.Tensor, cam_vec: torch.Tensor,
                light_vec: torch.Tensor, codes: torch.Tensor,
                offsets: torch.Tensor, config: RenderConfig, kappa: float,
                num_tris: int) -> torch.Tensor:
    """The soft composite summed over the samples, [3, n], recomputed from
    the records [spp, n] with the discrete decisions as constants: a
    differentiable function of (table [16, P], cam_vec [12], light_vec
    [9]). Its value is the hard direct render times spp (up to the last
    bit of alpha = front + alpha_soft - alpha_soft.detach()); autograd
    through it is the reference of ``soft_bwd_plain``."""
    f32 = torch.float32
    dev = codes.device
    W, H = config.width, config.height
    n = codes.shape[1]
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    px, py = (rid % W).to(f32), (rid // W).to(f32)
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)
    total = [torch.zeros(n, dtype=f32, device=dev)] * 3
    for s in range(config.spp):
        v = _soft_forward(table, cam_vec, light_vec, codes[s],
                          smp.as_u32(offsets) + s, px, py, f_w, f_h, config,
                          kappa, num_tris)
        a_soft = torch.where(v.pot, v.sig, 0.0)
        alpha = v.front.to(f32) + a_soft - a_soft.detach()
        total = [total[c] + (alpha * v.ls[c] + (1.0 - alpha) * v.lt[c])
                 for c in range(3)]
    return torch.stack(total)


# ---------------------------------------------------------------------------
# K7: the hand-written reverse and its kernel
# ---------------------------------------------------------------------------

def _shade_rev(sh, nrm, df, lv, d_out, d_lv):
    """Reverse of ``_shade_fwd`` on a lane that is not occluded: returns
    (d h, d nrm, d df) and adds the light's cotangents to ``d_lv``."""
    lb = [lv[3 + c] * sh.base for c in range(3)]
    d_df = [d_out[c] * lb[c] for c in range(3)]
    d_lb = [d_out[c] * df[c] for c in range(3)]
    for c in range(3):
        d_lv[3 + c] = d_lv[3 + c] + d_lb[c] * sh.base
    d_base = (d_lb[0] * lv[3] + d_lb[1] * lv[4]) + d_lb[2] * lv[5]
    ic = sh.inv_d2 * sh.cos_l
    d_ic = d_base * sh.cos_s
    d_cos_s = d_base * ic
    d_invd2 = d_ic * sh.cos_l
    d_cos_l = d_ic * sh.inv_d2
    d_invd = 2.0 * sh.inv_d * d_invd2
    d_cs = _gclip01(sh.cs_raw) * d_cos_s
    d_cl = _gclip01(sh.cl_raw) * d_cos_l
    d_n = [sh.ld[k] * d_cs for k in range(3)]
    d_ld = [nrm[k] * d_cs - lv[6 + k] * d_cl for k in range(3)]
    for k in range(3):
        d_lv[6 + k] = d_lv[6 + k] - sh.ld[k] * d_cl
    d_tl = [sh.inv_d * d_ld[k] for k in range(3)]
    d_invd = d_invd + ((sh.tl[0] * d_ld[0] + sh.tl[1] * d_ld[1])
                       + sh.tl[2] * d_ld[2])
    d_md = -(d_invd * (sh.inv_d * sh.inv_d))
    d_dist = _gmax(sh.dist, 1e-3) * d_md
    d_q = _gmax(sh.q, 0.0) * torch.where(sh.dist > 0.0,
                                         d_dist / (2.0 * sh.dist), 0.0)
    d_h = []
    for k in range(3):
        d_tl[k] = d_tl[k] + (2.0 * sh.tl[k]) * d_q
        d_lv[k] = d_lv[k] + d_tl[k]
        d_h.append(-d_tl[k])
    return d_h, d_n, d_df


def _soft_sample_rev(v, g, d_cam, d_lv):
    """The reverse of one sample, planar over the pixels, in the kernel's
    order of operations. ``g`` [3] planes of the cotangent (divided by
    spp). Adds the camera's and light's per-lane cotangents to ``d_cam``
    [12] and ``d_lv`` [9] (lists of planes); returns the background row
    [14] and the sphere row [14] of every lane, and the lanes that add
    each."""
    w = torch.where
    zero = torch.zeros_like(v.px)
    d_o = [zero] * 3
    d_d = [zero] * 3
    d_sc = [zero] * 3
    d_srad = zero

    # ---- coverage: alpha = front + (alpha_soft - its detached value)
    dal = w(v.pot, ((g[0] * v.ls[0] + g[1] * v.ls[1]) + g[2] * v.ls[2])
            - ((g[0] * v.lt[0] + g[1] * v.lt[1]) + g[2] * v.lt[2]), 0.0)
    d_z = dal * (v.sig * (1.0 - v.sig))
    d_num = d_z / v.kr
    d_kr = -(d_z * v.z) / v.kr
    d_srad = d_srad + (d_num + smp._f32(v.kappa) * d_kr)
    d_hm = _gmax(v.hm, 1e-12) * ((-d_num) * 0.5 / v.h)
    d_tca = (-2.0 * v.t_ca) * d_hm
    for k in range(3):
        d_soc = (2.0 * v.soc[k]) * d_hm + v.d[k] * d_tca
        d_d[k] = d_d[k] + v.soc[k] * d_tca
        d_sc[k] = d_sc[k] + d_soc
        d_o[k] = d_o[k] - d_soc

    # ---- sphere layer: dL/dLs = front
    fs = v.front & ~v.occ_s
    gf = [w(v.front, g[c], 0.0) for c in range(3)]
    d_lv_s = [zero] * 9
    d_hs, d_ns, d_sdf = _shade_rev(v.sh_s, v.ns, v.sdf, v.lv,
                                   [w(fs, gf[c], 0.0) for c in range(3)],
                                   d_lv_s)
    d_hs = [w(fs, x, 0.0) for x in d_hs]
    d_ns = [w(fs, x, 0.0) for x in d_ns]
    d_sdf = [w(fs, x, 0.0) for x in d_sdf]
    for k in range(9):
        d_lv[k] = d_lv[k] + w(fs, d_lv_s[k], 0.0)
    for k in range(3):
        d_o[k] = d_o[k] + d_hs[k]
        d_d[k] = d_d[k] + v.ts_p * d_hs[k]
        d_ns[k] = d_ns[k] + 1e-3 * d_hs[k]
    d_tsp = (v.d[0] * d_hs[0] + v.d[1] * d_hs[1]) + v.d[2] * d_hs[2]
    d_to = [v.inv_n * d_ns[k] for k in range(3)]
    d_invn = (v.to[0] * d_ns[0] + v.to[1] * d_ns[1]) + v.to[2] * d_ns[2]
    d_qq = _gmax(v.qq, 1e-6) * (d_invn * ((-0.5 * v.inv_n) / v.mq))
    for k in range(3):
        d_to[k] = d_to[k] + (2.0 * v.to[k]) * d_qq
        d_sc[k] = d_sc[k] - d_to[k]
        d_o[k] = d_o[k] + d_to[k]
        d_d[k] = d_d[k] + v.ts_safe * d_to[k]
    d_ts = w(v.front, d_tsp + ((v.d[0] * d_to[0] + v.d[1] * d_to[1])
                               + v.d[2] * d_to[2]), 0.0)
    d_t1 = w(v.t1_ok, d_ts, 0.0)
    d_t2 = w(v.t1_ok, 0.0, d_ts)
    inv2a = 1.0 / (2.0 * v.a_q)
    d_b = -(d_t1 + d_t2) * inv2a
    d_sq = (d_t2 - d_t1) * inv2a
    d_a = -(v.t1 * d_t1 + v.t2 * d_t2) / v.a_q
    d_disc = w(v.posd, d_sq / (2.0 * v.sq), 0.0)
    d_b = d_b + (2.0 * v.b_q) * d_disc
    d_a = d_a + (-4.0 * v.c_q) * d_disc
    d_c = (-4.0 * v.a_q) * d_disc
    for k in range(3):
        d_oc = (2.0 * v.oc[k]) * d_c + (2.0 * v.d[k]) * d_b
        d_d[k] = d_d[k] + ((2.0 * v.oc[k]) * d_b + (2.0 * v.d[k]) * d_a)
        d_o[k] = d_o[k] + d_oc
        d_sc[k] = d_sc[k] - d_oc
    d_srad = d_srad + (-2.0 * v.srad) * d_c

    # ---- background layer: dL/dLt = 1 - front
    nf = ~v.front
    bs = nf & v.tri_surf & ~v.occ_b
    d_lv_b = [zero] * 9
    d_hb, d_bn, d_bdf = _shade_rev(v.sh_b, v.bn, v.bdf, v.lv,
                                   [w(bs, g[c], 0.0) for c in range(3)],
                                   d_lv_b)
    d_hb = [w(bs, x, 0.0) for x in d_hb]
    d_bn = [w(bs, x, 0.0) for x in d_bn]
    d_bdf = [w(bs, x, 0.0) for x in d_bdf]
    for k in range(9):
        d_lv[k] = d_lv[k] + w(bs, d_lv_b[k], 0.0)
    for k in range(3):
        d_o[k] = d_o[k] + d_hb[k]
        d_d[k] = d_d[k] + v.tb_p * d_hb[k]
        d_bn[k] = d_bn[k] + 1e-3 * d_hb[k]
    d_tbp = (v.d[0] * d_hb[0] + v.d[1] * d_hb[1]) + v.d[2] * d_hb[2]
    d_num_b = d_tbp / v.sden
    d_den = w(v.ok, -(v.t_bg * d_tbp) / v.sden, 0.0)
    for k in range(3):
        d_o[k] = d_o[k] - v.bn[k] * d_num_b
        d_bn[k] = d_bn[k] - v.o[k] * d_num_b
        d_d[k] = d_d[k] + v.bn[k] * d_den
        d_bn[k] = d_bn[k] + v.d[k] * d_den
    d_bem = [w(nf & v.em_show, g[c], 0.0) for c in range(3)]

    # ---- camera ray: d = r / |r|, o = position
    sdot = (v.d[0] * d_d[0] + v.d[1] * d_d[1]) + v.d[2] * d_d[2]
    for k in range(3):
        d_r = (d_d[k] - v.d[k] * sdot) / v.rn
        d_cam[k] = d_cam[k] + d_o[k]
        d_cam[3 + k] = d_cam[3 + k] + v.s * d_r
        d_cam[6 + k] = d_cam[6 + k] + v.t * d_r
        d_cam[9 + k] = d_cam[9 + k] - d_r

    row_bg = d_bn + [d_num_b] + d_bdf + d_bem + [zero] * 4
    row_s = [zero] * 4 + d_sdf + gf + d_sc + [d_srad]
    return row_bg, nf & v.bg_hit, row_s, v.front | v.pot


def _check_soft(g, codes, offsets, table, cam_vec, light_vec, config, dev,
                offset_dtype=None):
    """Shapes and types the backward takes; returns (n, P)."""
    f32 = torch.float32
    n = g.shape[-1]
    P = table.shape[1]
    _require(g, "g", f32, (3, n), dev)
    _require(codes, "codes", torch.int32, (config.spp, n), dev)
    _require(offsets, "offsets", offset_dtype or offsets.dtype, (n,), dev)
    _require(table, "table", f32, (NROWS_TAB_SPH, P), dev)
    _require(cam_vec, "cam_vec", f32, (12,), dev)
    _require(light_vec, "light_vec", f32, (9,), dev)
    if n != config.num_pixels:
        raise ValueError(f"{n} pixels for a {config.num_pixels}-pixel frame")
    return n, P


def soft_bwd_plain(g: torch.Tensor, codes: torch.Tensor,
                   offsets: torch.Tensor, table: torch.Tensor,
                   cam_vec: torch.Tensor, light_vec: torch.Tensor,
                   config: RenderConfig, kappa: float, num_tris: int):
    """Plain PyTorch version of ``soft_bwd_kernel`` on the same inputs: the
    hand-written reverse of ``soft_replay``, in the kernel's order of
    operations, planar over the pixels. ``g`` [3, n] is the cotangent of the
    image already divided by spp, ``codes`` [spp, n] the silhouette
    records, ``offsets`` [n] the Halton offsets, ``table`` [16, P],
    ``cam_vec`` [12], ``light_vec`` [9]. Returns (dtab [P, 14]: d n, d c0, d
    diffuse, d emissive, d center, d radius; dscal [21]: camera 12, light
    9). The sums over lanes are taken in float64, as the kernel's second
    stage takes them."""
    n, P = _check_soft(g, codes, offsets, table, cam_vec, light_vec, config,
                       g.device)
    f32, f64 = torch.float32, torch.float64
    dev = g.device
    W, H = config.width, config.height
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    px, py = (rid % W).to(f32), (rid // W).to(f32)
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)
    cam, lv = list(cam_vec), list(light_vec)
    dtab = torch.zeros((P, NTAB_SPH), dtype=f64, device=dev)
    dscal = torch.zeros(NSCAL_SOFT, dtype=f64, device=dev)
    zero = torch.zeros(n, dtype=f32, device=dev)
    gl = [g[c] for c in range(3)]
    with torch.no_grad():
        for s in range(config.spp):
            v = _soft_forward(table, cam, lv, codes[s],
                              smp.as_u32(offsets) + s, px, py, f_w, f_h,
                              config, kappa, num_tris)
            d_cam, d_lv = [zero] * 12, [zero] * 9
            row_bg, act_bg, row_s, act_s = _soft_sample_rev(v, gl, d_cam,
                                                            d_lv)
            for row, act, idx in ((row_bg, act_bg, v.prim_bg),
                                  (row_s, act_s, num_tris + v.s_idx)):
                vals = torch.where(act[:, None], torch.stack(row, dim=-1),
                                   0.0)
                dtab.index_add_(0, torch.clamp(idx, 0, P - 1), vals.to(f64))
            dscal += torch.stack(d_cam + d_lv).to(f64).sum(dim=1)
    return dtab.float(), dscal.float()


def soft_bwd_kernel(g: torch.Tensor, codes: torch.Tensor,
                    offsets: torch.Tensor, table: torch.Tensor,
                    cam_vec: torch.Tensor, light_vec: torch.Tensor,
                    config: RenderConfig, kappa: float, num_tris: int):
    """Launch ``soft_bwd_kernel`` on the card. Same arguments and results as
    ``soft_bwd_plain``, with ``offsets`` int32."""
    if g.device.type != "cuda":
        raise ValueError("soft_bwd_kernel needs CUDA tensors")
    dev = g.device
    n, P = _check_soft(g, codes, offsets, table, cam_vec, light_vec, config,
                       dev, torch.int32)
    if not 0 < num_tris < P:
        raise ValueError(f"{num_tris} triangles of {P} primitives: the "
                         "table needs triangles and spheres")
    soft_bwd_smem_bytes(P)
    lib = _library()
    count = P * NTAB_SPH + NSCAL_SOFT
    k = _stratified_k(config)
    with torch.cuda.device(dev):
        blocks = lib.grt_soft_bwd_blocks(n, config.spp, P)
        if blocks <= 0:
            raise RuntimeError("soft_bwd_kernel: the occupancy query failed")
        partials = torch.empty((blocks, count), dtype=torch.float32,
                               device=dev)
        out = torch.empty(count, dtype=torch.float32, device=dev)
        launch(LAUNCHES, "soft_bwd_kernel", lib.grt_soft_bwd,
               g.data_ptr(), codes.data_ptr(), offsets.data_ptr(),
               table.data_ptr(), cam_vec.data_ptr(), light_vec.data_ptr(),
               partials.data_ptr(), out.data_ptr(), n, config.width,
               config.height, config.spp, P, num_tris, k,
               1.0 / k if k else 0.0, config.area_light_half_extent,
               smp._f32(kappa), blocks,
               torch.cuda.current_stream(dev).cuda_stream)
    return out[:P * NTAB_SPH].view(P, NTAB_SPH), out[P * NTAB_SPH:]


# ---------------------------------------------------------------------------
# Autograd glue and the entry point
# ---------------------------------------------------------------------------

class _AttachSoftGrad(torch.autograd.Function):
    """Forward: the trace kernel's image, unchanged. Backward: one launch of
    the soft backward kernel (the plain version for CPU tensors), giving
    the cotangents of (table, cam_vec, light_vec); the records and offsets
    are constants."""

    @staticmethod
    def forward(ctx, config, kappa, num_tris, hdr, table, cam_vec, light_vec,
                codes, offsets):
        ctx.config, ctx.kappa, ctx.num_tris = config, kappa, num_tris
        ctx.save_for_backward(table, cam_vec, light_vec, codes, offsets)
        return hdr.view_as(hdr)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, cam_vec, light_vec, codes, offsets = ctx.saved_tensors
        config = ctx.config
        # hdr = (sum over samples) / spp: fold the 1/spp into the cotangent.
        gs = (g * smp._f32(1.0 / config.spp)).reshape(-1, 3).T.contiguous()
        args = (gs, codes, offsets, table.detach().contiguous(),
                cam_vec.detach().contiguous(), light_vec.detach().contiguous(),
                config, ctx.kappa, ctx.num_tris)
        if gs.device.type == "cuda":
            dtab, dscal = soft_bwd_kernel(*args)
        else:
            dtab, dscal = soft_bwd_plain(*args)
        cols = dtab.T
        zrow = torch.zeros((1, table.shape[1]), dtype=dtab.dtype,
                           device=dtab.device)
        # rows n, c0, diffuse, emissive | is_emissive | center, radius |
        # is_sphere; the two selectors have no cotangent.
        d_table = torch.cat([cols[:10], zrow, cols[10:14], zrow])
        return (None, None, None, None, d_table, dscal[:12], dscal[12:],
                None, None)


def render_direct_soft_fused(scene: Scene, config: RenderConfig,
                             kappa: float = 0.05, occluders=None,
                             device="cuda") -> torch.Tensor:
    """Edge-aware direct-lighting render at kernel speed, [H, W, 3]: the
    value is the trace kernel's hdr at ``bounces=1`` (the hard direct
    render); the gradients are those of
    ``grad.diff_render.render_direct_soft`` (interior and sphere-silhouette
    terms), through the silhouette records and the backward kernel. Sphere
    scenes with at most 64 triangles. ``occluders``: an optional
    ``intersect.potential_occluders`` tuple that culls the shadow probes of
    both forward kernels; values and gradients are unchanged (see
    ``silh_records``)."""
    device = resolve_device(device)
    scene = scene.to(device)
    _check_scene(scene)
    cfg1 = config.replace(bounces=1) if config.bounces != 1 else config
    hdr = render_path_cuda_impl(scene.detach(), cfg1, occluders=occluders,
                                device=device)
    codes = silh_records(scene, cfg1, occluders=occluders, device=device)
    if not any(t.requires_grad for t in scene.tensors()):
        return hdr
    table, cam_vec, light_vec = _pack_diff_inputs(scene, cfg1)
    offsets = pixel_rng_offsets(cfg1, device)
    if device.type == "cuda":
        offsets = offsets.to(torch.int32)
    return _AttachSoftGrad.apply(cfg1, float(kappa),
                                 scene.triangles.num_triangles, hdr, table,
                                 cam_vec, light_vec, codes,
                                 offsets.contiguous())

