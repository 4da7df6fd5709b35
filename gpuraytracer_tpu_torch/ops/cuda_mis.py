"""The variant-A MIS integrator's kernel on the card, and its plain PyTorch
version.

Counterpart of ``gpuraytracer_tpu/ops/pallas_mis.py``, both tiers: the
static tier (at most 64 triangles, plus analytic spheres, its tables within
one block's shared memory) tests every triangle; the grouped tier (any
primitive count below the record encoding's limit;
``cuda_path.grouped_tier`` picks) sweeps the two-level box hierarchy of the
path tracer's grouped tier (``cuda_path.group_aabbs``, ``csrc/trace.cuh``),
the light probes over the occluder-culled shadow table:

  * ``render_mis_cuda_impl``  the full camera-ray x sample loop
    (``mis_kernel``): hdr only, or with ``emit_records`` the two int32
    decision streams beside it; optional occluder cull of the light probes;
    ``local_n`` / ``rid_base`` / ``flat_output`` render a pixel range;
    ``grouped`` forces a tier.
  * ``render_mis_cuda``       the entry point, hdr only; differentiable: its
    backward is autograd through the eager oracle (``render.render_mis``),
    as the JAX package's ``render_mis_pallas`` is. The fast differentiable
    path is ``cuda_mis_bwd.render_mis_decoupled``: this kernel with records
    on, and the record-replay backward kernel.

The kernel is CUDA C++ (``csrc/mis_kernels.cu``), built at first use
(``_build.py``). Beside it stands ``render_mis_plain``, plain PyTorch on the
same inputs in the kernel's operation order; the wrapper takes it only for
tensors that lie on the CPU. For CUDA tensors it launches the kernel or
raises; nothing falls back.

Layouts: the camera record is ``[camera_rays, N]`` (prim + 1, 0 = miss), the
sample record ``[camera_rays, s_per, N]`` (bit layout below), pixel axis
minor-most; sphere ``s`` is primitive ``num_tris + s``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .. import sampling as smp
from ..intersect import (RAY_TMAX, RAY_TMIN, compile_scene,
                         sphere_candidates, triangle_candidates)
from ..render import _mis_chunk, _mis_sample_tables, pixel_coords
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from . import _build
from .cuda_path import (SMEM_LIMIT, SUPER, GroupedTables, _pack_grouped,
                        _raise_on_launch_error, _require, camera_vector,
                        closest_bounds, closest_grouped, grouped_launch_tables,
                        grouped_tier, occluded_grouped, prefilter_passes,
                        faster_below, shadow_count,
                        shadow_indices)

# Rows of the packed tables (the JAX package's layout).
NROWS = 21   # tri: n xyz, c0, s1 xyz, c1, s2 xyz, c2, diffuse rgb, is_em, emissive rgb, metallic, roughness
NLIGHT = 17  # center, emitted radiance, width, depth, normal, tangent, bitangent
SROWS = 4    # sph: center xyz, radius
NATTR = 12   # atab: normal xyz, diffuse rgb, metallic, roughness, is_em, sphere center xyz
# The sample table as the kernel reads it: ten draws (u0, u1 of light, cosine,
# cosine-secondary, vndf, vndf-secondary), then the derived direction scalars
# of the two lobes — cosine w0 = cos(phi) sin(theta), w1 = sin(phi) sin(theta),
# cos(theta); VNDF k0, k1, cos(theta).
NTAB_EXT = 16
(TAB_LU0, TAB_LU1, TAB_CU0, TAB_CU1, TAB_CSU0, TAB_CSU1, TAB_VU0, TAB_VU1,
 TAB_VSU0, TAB_VSU1, TAB_W0C, TAB_W1C, TAB_CTH, TAB_K0V, TAB_K1V,
 TAB_VCT) = range(NTAB_EXT)

# Per-sample record bit layout (int32): reach1 | reach2 << 1 | reach3 << 2
# | (cos_prim + 1) << REC_SHIFT_C | (vndf_prim + 1) << REC_SHIFT_V, 14-bit
# primitive codes (0 = miss).
REC_SHIFT_C = 3
REC_SHIFT_V = 17
REC_CODE_MASK = (1 << 14) - 1
REC_MAX_PRIMS = REC_CODE_MASK - 1

_BIG = 1e30
# A MIS trace that runs alone takes the static tier only while one SM holds
# at least as many of K4's warps as of K4g's 12 (one block of 384 threads):
# three blocks of 128 threads (as ``cuda_path.TRACE_ALONE_BYTES``). At 256 x
# 192 x 2 x 30 on the box with 300 to 1,500 small spheres (PERF.md §6) K4
# wins up to 66 KB of tables, K4g at 98 KB.
TRACE_ALONE_BYTES = 228 * 1024 // 3 - 1024
# Both tiers stage their tables within ``cuda_path.SMEM_LIMIT``, one block's
# most on sm_90 (the launcher asks for what exceeds the default 48 KiB). The
# [16, s_per] sample table is the part that grows: about 3,500 samples per
# strategy at 36 triangles.
# The grouped tier (K4g) runs one persistent block of 384 threads per SM. A
# block stages the sample table, the spheres and the box tables of both
# sweeps (32 B a box: a super and its SUPER groups). Above WIDE_SUPERS
# (``cuda_path``) supers its closest-hit sweep takes its wide form
# (trace.cuh).
# Sample steps (pixels x camera rays x samples per strategy) whose autograd
# graph the oracle backward of ``render_mis_cuda`` holds at a time: about
# 4 KB each at 36 triangles (``chip_smoke.py`` prints it), so some 9 GB.
BACKWARD_LANE_STEPS = 1 << 21

# Kernel launches since the process started (or since a caller reset them):
# the wrapper adds one where it launches the kernel and nowhere else. The
# grouped tier (K4g) counts apart from the static tier.
LAUNCHES = {"mis_kernel": 0, "mis_kernel_grouped": 0}


class MisRecords(NamedTuple):
    """The integrator's discrete decisions, int32, pixel axis last."""

    camera: torch.Tensor   # [camera_rays, N]: prim + 1 of the primary hit
    samples: torch.Tensor  # [camera_rays, s_per, N]: packed, see REC_SHIFT_*


class PackedMisScene(NamedTuple):
    """The kernel's scene inputs, all float32 on one device."""

    tri: torch.Tensor    # [NROWS, T]
    cam: torch.Tensor    # [12] position, u * half_width, v * half_height, w
    light: torch.Tensor  # [NLIGHT]
    sph: torch.Tensor    # [SROWS, max(S, 1)]
    atab: torch.Tensor   # [NATTR, T + S]
    tabs: torch.Tensor   # [NTAB_EXT, s_per]
    num_spheres: int
    grouped: Optional[GroupedTables] = None  # the grouped tier's tables


def sample_table(config: RenderConfig) -> torch.Tensor:
    """The kernel's pixel-independent sample table, [NTAB_EXT, s_per] float32
    on the CPU: rows 0-9 are the shared draws
    (``sampling.mis_sample_table_rows``), rows 10-15 the sines, cosines and
    square roots of the two lobe directions, which depend on the draws
    alone. Made on the host whatever the render device, so that the kernel
    and its plain version read the same bits."""
    rows = smp.mis_sample_table_rows(config.mis_samples, config.sampler)
    two_pi = smp._f32(2.0 * math.pi)
    phi = two_pi * rows[TAB_CU0]
    cth = torch.sqrt(rows[TAB_CU1])
    sth = torch.sqrt(torch.clamp_min(1.0 - rows[TAB_CU1], 0.0))
    vphi = two_pi * rows[TAB_VU0]
    # len(Ve) == 1 after the normalize (reference quirk): cosThetaMax is the
    # constant 1/sqrt(2).
    ctm = smp._f32(1.0 / math.sqrt(2.0))
    vct = ctm + (1.0 - ctm) * rows[TAB_VU1]
    vst = torch.sqrt(torch.clamp_min(1.0 - vct * vct, 0.0))
    derived = torch.stack([torch.cos(phi) * sth, torch.sin(phi) * sth, cth,
                           torch.cos(vphi) * vst, torch.sin(vphi) * vst, vct])
    return torch.cat([rows, derived], dim=0)


def _pack_inputs(scene: Scene, config: RenderConfig, grouped: bool = False,
                 occluders=None) -> PackedMisScene:
    """Marshal a scene for the kernel: triangle constants to a [NROWS, T]
    table, the camera to a prescaled basis, the light to 17 scalars with its
    frame built here (the branching basis the oracle uses), sphere geometry
    to a [SROWS, S] table, the shading attributes of every primitive
    (triangles first, then spheres) to a [NATTR, T + S] table read by the
    winner's index, and the sample table. ``grouped`` adds the grouped
    tier's tables from the first 12 rows of the triangle table, the light
    probes' table culled by ``occluders`` (the JAX package's
    ``pallas_mis._pack_inputs(grouped=True)``)."""
    c = compile_scene(scene.triangles)
    f32 = torch.float32
    tri = torch.stack([
        c.n[:, 0], c.n[:, 1], c.n[:, 2], c.c0,
        c.s1[:, 0], c.s1[:, 1], c.s1[:, 2], c.c1,
        c.s2[:, 0], c.s2[:, 1], c.s2[:, 2], c.c2,
        c.diffuse[:, 0], c.diffuse[:, 1], c.diffuse[:, 2],
        c.is_emissive.to(f32),
        c.emissive[:, 0], c.emissive[:, 1], c.emissive[:, 2],
        c.metallic, c.roughness,
    ])  # [NROWS, T]
    dev = tri.device

    light = scene.light
    lnorm = light.normal.to(f32)
    lt, lb = smp.build_orthonormal_basis(lnorm)
    light_vec = torch.cat([
        light.center.to(f32).reshape(-1),
        light.emitted_radiance.to(f32).reshape(-1),
        light.width.to(f32).reshape(1), light.depth.to(f32).reshape(1),
        lnorm.reshape(-1), lt.reshape(-1), lb.reshape(-1)])

    sp = scene.spheres
    n_t = scene.triangles.num_triangles
    tri_cols = torch.cat([
        tri[0:3],                                      # normal
        tri[12:15],                                    # diffuse
        tri[19:20], tri[20:21],                        # metallic, roughness
        tri[15:16],                                    # is_emissive
        torch.zeros((3, n_t), dtype=f32, device=dev),  # sphere center (n/a)
    ], dim=0)
    if sp.num_spheres:
        sph = torch.stack([sp.center[:, 0], sp.center[:, 1], sp.center[:, 2],
                           sp.radius])
        sph_cols = torch.cat([
            torch.zeros((3, sp.num_spheres), dtype=f32, device=dev),  # normal
            sp.diffuse.T,
            sp.metallic.reshape(1, -1), sp.roughness.reshape(1, -1),
            (torch.linalg.norm(sp.emissive, dim=-1) > 0.0).to(f32)
            .reshape(1, -1),
            sp.center.T,
        ], dim=0)
        atab = torch.cat([tri_cols, sph_cols], dim=1)
    else:
        sph = torch.zeros((SROWS, 1), dtype=f32, device=dev)
        atab = tri_cols
    return PackedMisScene(
        tri=tri.contiguous(),
        cam=camera_vector(scene.camera, config).contiguous(),
        light=light_vec.contiguous(), sph=sph.contiguous(),
        atab=atab.contiguous(),
        tabs=sample_table(config).to(dev).contiguous(),
        num_spheres=sp.num_spheres,
        grouped=_pack_grouped(scene, tri, occluders) if grouped else None)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def render_mis_plain(n_local: int, rid_base, packed: PackedMisScene,
                     shadow_idx: Optional[torch.Tensor],
                     config: RenderConfig, emit_records: bool,
                     stats: Optional[dict] = None):
    """Plain PyTorch version of ``mis_kernel`` on the same inputs: the pixel
    range [rid_base, rid_base + n_local), the packed scene, the indices of
    the triangles kept in the light probes. Returns (hdr [3, n] float32,
    MisRecords or None). The arithmetic and its order are the kernel's
    (planar f32 math over [n] tensors, the [n, T] candidate tests of
    ``intersect.py`` or, where ``packed`` holds the grouped tables, the
    grouped sweep (``cuda_path.closest_grouped``, ``occluded_grouped``;
    ``shadow_idx`` is then unused, and may be None: the cull is in the
    shadow table), the
    derived rows of the sample table, the constant cosThetaMax, the probe
    over the culled subset), not the oracle's; every lane runs every step
    masked, and records are written for every (camera ray, sample, pixel).
    Pixels go through in chunks of ``config.pixel_chunk``. ``rid_base``: the
    first pixel's id, or the ids of all n_local pixels (an int64 tensor: a
    sample of pixels from anywhere in the frame). ``stats``: a dict that the
    grouped sweep adds its rays, box tests and triangle tests to, under
    "camera" (primary rays), "closest" (the lobe rays) and "shadow" (the
    light probes): live lanes, and with the suffix "_all" all lanes. Without
    the grouped tables it counts, under the same keys, the triangle tests of
    live lanes ("triangles") and those of them that pass both of the static
    kernel's prefilters (``plane_ahead``, ``plane_within``: "passed"), a
    probe's only where it reaches the light. The counts change no result."""
    def rid(s):
        return (rid_base + s if isinstance(rid_base, int)
                else rid_base[s:s + config.pixel_chunk])

    outs = [
        _plain_chunk(min(config.pixel_chunk, n_local - s), rid(s), packed,
                     shadow_idx, config, emit_records, stats)
        for s in range(0, n_local, config.pixel_chunk)
    ]
    hdr = torch.cat([o[0] for o in outs], dim=-1)
    if not emit_records:
        return hdr, None
    return hdr, MisRecords(torch.cat([o[1] for o in outs], dim=-1),
                           torch.cat([o[2] for o in outs], dim=-1))


def _plain_chunk(n_local, rid_base, packed, shadow_idx, config, emit_records,
                 stats):
    f32 = torch.float32
    dev = packed.tri.device
    W, H = config.width, config.height
    tri, atab, tabs = packed.tri, packed.atab, packed.tabs
    T = tri.shape[1]
    S = packed.num_spheres
    s_per = config.mis_samples // 3
    inv_pi = smp._f32(1.0 / math.pi)
    pi = smp._f32(math.pi)

    def geo(rows):
        return (rows[0:3].T, rows[3], rows[4:7].T, rows[7], rows[8:11].T,
                rows[11])

    grp = packed.grouped
    if grp is None:
        geo_all = geo(tri)
        geo_shadow = geo(tri[:, shadow_idx.long()])
    if stats is not None:
        for key in ("camera", "closest", "shadow"):
            stats.setdefault(key, {})
    sph_center = packed.sph[0:3].T[:S]
    sph_radius = packed.sph[3][:S]

    rid = (rid_base + torch.arange(n_local, dtype=torch.int64, device=dev)
           if isinstance(rid_base, int) else rid_base.to(dev, torch.int64))
    xi, yi = rid % W, rid // W
    px, py = xi.to(f32), yi.to(f32)
    cam = packed.cam
    pos, uh, vh, wv = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    lt = packed.light
    lcx, lcy, lcz, ler, leg, leb, lw, ld = (lt[k] for k in range(8))
    lnx, lny, lnz, ltx, lty, ltz, lbx, lby, lbz = (lt[k] for k in range(8, 17))
    zero = torch.zeros(n_local, dtype=f32, device=dev)
    # Divisors as tensors: PyTorch divides by a Python scalar through its
    # reciprocal, which rounds twice where the kernel's division rounds once.
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)

    def vec(x, y, z):
        return torch.stack([x, y, z], dim=-1)

    def dot3(ax, ay, az, bx, by, bz):
        return ax * bx + ay * by + az * bz

    def norm3(x, y, z, floor=1e-12):
        inv = smp.rsqrt(torch.clamp_min(x * x + y * y + z * z, floor))
        return x * inv, y * inv, z * inv

    def clamp01(x):
        return torch.clamp(x, 0.0, 1.0)

    def d_ggx(n_dot_h, a):
        f = (n_dot_h * a * a - n_dot_h) * n_dot_h + 1.0
        return (a * a) / (pi * f * f + 1e-12)

    def smith_g1(n_dot_v, roughness):
        a = roughness * roughness
        a2 = a * a
        nv2 = torch.clamp_min(n_dot_v * n_dot_v, 1e-12)
        return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))

    def brdf(vx, vy, vz, nx, ny, nz, df, met, rgh, lx, ly, lz):
        hx, hy, hz = norm3(vx + lx, vy + ly, vz + lz)
        n_dot_v = dot3(nx, ny, nz, vx, vy, vz).abs() + 1e-5
        n_dot_l = clamp01(dot3(nx, ny, nz, lx, ly, lz))
        n_dot_h = clamp01(dot3(nx, ny, nz, hx, hy, hz))
        l_dot_h = clamp01(dot3(lx, ly, lz, hx, hy, hz))
        one_m_met = 1.0 - met
        d = d_ggx(n_dot_h, rgh)
        # (1 - l.h)^5 by multiplies, as the kernel spells it.
        q = 1.0 - l_dot_h
        q2 = q * q
        p5 = q2 * q2 * q
        a = rgh * rgh
        ggx_l = n_dot_v * torch.sqrt(torch.clamp_min(
            (-n_dot_l * a + n_dot_l) * n_dot_l + a, 1e-12))
        ggx_v = n_dot_l * torch.sqrt(torch.clamp_min(
            (-n_dot_v * a + n_dot_v) * n_dot_v + a, 1e-12))
        vis = 0.5 / (ggx_v + ggx_l + 1e-7)
        spec = (d * vis) / (4.0 * n_dot_v * n_dot_l + 1e-7)
        out = []
        for c in df:
            f0 = 0.04 * one_m_met + c * met
            fs = f0 + (1.0 - f0) * p5
            out.append((1.0 - fs) * one_m_met * (c * inv_pi + spec * fs)
                       * n_dot_l)
        return out

    def cosine_pdf(nx, ny, nz, dx, dy, dz):
        return torch.clamp_min(dot3(nx, ny, nz, dx, dy, dz), 0.0) * inv_pi

    def vndf_pdf(vx, vy, vz, nx, ny, nz, lx, ly, lz, rgh):
        hx, hy, hz = norm3(vx + lx, vy + ly, vz + lz)
        n_dot_h = dot3(nx, ny, nz, hx, hy, hz).abs()
        v_dot_h = dot3(vx, vy, vz, hx, hy, hz).abs()
        n_dot_v = dot3(nx, ny, nz, vx, vy, vz).abs()
        return (d_ggx(n_dot_h, rgh) * smith_g1(n_dot_v, rgh) * v_dot_h) / (
            4.0 * n_dot_v + 1e-7)

    def power_heuristic_3(p1, p2, p3, n):
        a = n * p1
        return a / (a + n * p2 + n * p3 + 1e-6)

    def square_light_pdf(p_x, p_y, p_z, dx, dy, dz):
        tox, toy, toz = lcx - p_x, lcy - p_y, lcz - p_z
        dist2 = tox * tox + toy * toy + toz * toz
        cos_t = torch.clamp_min(-(dx * lnx + dy * lny + dz * lnz), 0.0)
        return dist2 / (lw * ld * cos_t + 1e-6)

    def sweep_stats(key):
        return None if stats is None else stats[key]

    def count_prefilter(key, rows, ox, oy, oz, dx, dy, dz, t_far, lanes):
        """Adds to stats[key] the triangle tests of the lanes ``lanes`` (all
        where None) and those that pass both prefilters, each test bounded
        by ``t_far`` [n, T]."""
        nrm = rows[0]
        passed = prefilter_passes(rows, vec(ox, oy, oz), vec(dx, dy, dz),
                                  t_far)
        if lanes is not None:
            passed = passed & lanes[:, None]
        n_lanes = len(ox) if lanes is None else int(lanes.sum())
        st = stats[key]
        st["triangles"] = st.get("triangles", 0) + n_lanes * nrm.shape[0]
        st["passed"] = st.get("passed", 0) + int(passed.sum())

    def closest_full(ox, oy, oz, dx, dy, dz, live, key):
        o, d = vec(ox, oy, oz), vec(dx, dy, dz)
        if grp is None:
            t_all, valid = triangle_candidates(*geo_all, o, d, RAY_TMIN,
                                               RAY_TMAX)
            if stats is not None:
                # A test's bound: RAY_TMAX, or the nearest hit before it.
                count_prefilter(key, geo_all, ox, oy, oz, dx, dy, dz,
                                closest_bounds(t_all, valid), live)
            if S:
                t_s, valid_s = sphere_candidates(sph_center, sph_radius, o, d,
                                                 RAY_TMIN, RAY_TMAX)
                t_all = torch.cat([t_all, t_s], dim=-1)
                valid = torch.cat([valid, valid_s], dim=-1)
            t_masked = torch.where(valid, t_all, torch.full_like(t_all, _BIG))
            t_best, winner = torch.min(t_masked, dim=-1)  # first minimum
        else:
            t_best, winner = closest_grouped(grp, o, d, live,
                                             sweep_stats(key))
            if S:  # spheres after the triangles, strict <
                t_s, valid_s = sphere_candidates(sph_center, sph_radius, o, d,
                                                 RAY_TMIN, RAY_TMAX)
                for k in range(S):
                    closer = valid_s[:, k] & (t_s[:, k] < t_best)
                    t_best = torch.where(closer, t_s[:, k], t_best)
                    winner = torch.where(closer, T + k, winner)
        hit = t_best < _BIG * 0.5
        prim = torch.where(hit, winner, torch.full_like(winner, -1))
        # A miss reads row 0; every use is gated by ``hit``.
        at = atab[:, torch.where(hit, winner, torch.zeros_like(winner))]
        nx, ny, nz = at[0], at[1], at[2]
        if S:
            sphere_won = hit & (prim >= T)
            t_s = torch.where(sphere_won, t_best, zero)
            nvx, nvy, nvz = norm3(ox + dx * t_s - at[9], oy + dy * t_s - at[10],
                                  oz + dz * t_s - at[11], 1e-6)
            nx = torch.where(sphere_won, nvx, nx)
            ny = torch.where(sphere_won, nvy, ny)
            nz = torch.where(sphere_won, nvz, nz)
        return (hit, t_best, prim, nx, ny, nz, (at[3], at[4], at[5]), at[6],
                at[7], at[8] > 0.5)

    def light_reachable(ox, oy, oz, dx, dy, dz, t_max, live):
        o, d = vec(ox, oy, oz), vec(dx, dy, dz)
        if grp is None:
            _, blocked = triangle_candidates(*geo_shadow, o, d, RAY_TMIN,
                                             t_max)
            occ = blocked.any(dim=-1)
        else:
            occ = occluded_grouped(grp, o, d, t_max, live,
                                   sweep_stats("shadow"), t_min=RAY_TMIN)
        if S:
            _, blocked_s = sphere_candidates(sph_center, sph_radius, o, d,
                                             RAY_TMIN, t_max)
            occ = occ | blocked_s.any(dim=-1)
        if grp is None and stats is not None:
            t_far = torch.clamp_min(t_max, RAY_TMIN)[:, None].expand(
                -1, geo_shadow[1].shape[0])
            count_prefilter("shadow", geo_shadow, ox, oy, oz, dx, dy, dz,
                            t_far, live & ~occ)
        return ~occ

    def direct_light(p_x, p_y, p_z, nx, ny, nz, inx, iny, inz, df, met, rgh,
                     u0, u1, active, use_heuristic):
        ox, oy, oz = p_x + nx * 1e-4, p_y + ny * 1e-4, p_z + nz * 1e-4
        a = (u0 - 0.5) * lw
        b = (u1 - 0.5) * ld
        sx = lcx + ltx * a + lbx * b
        sy = lcy + lty * a + lby * b
        sz = lcz + ltz * a + lbz * b
        tox, toy, toz = sx - ox, sy - oy, sz - oz
        dist = torch.sqrt(torch.clamp_min(
            tox * tox + toy * toy + toz * toz, 1e-30))
        # Plain division: the first Halton sample is the light's corner.
        ldx, ldy, ldz = tox / dist, toy / dist, toz / dist
        reach = light_reachable(ox, oy, oz, ldx, ldy, ldz,
                                dist * (1.0 - 1e-4), active)
        pdf_l = square_light_pdf(p_x, p_y, p_z, ldx, ldy, ldz)
        vx, vy, vz = -inx, -iny, -inz
        f = brdf(vx, vy, vz, nx, ny, nz, df, met, rgh, ldx, ldy, ldz)
        inv_pdf = 1.0 / pdf_l
        out = [f[k] * le * inv_pdf for k, le in enumerate((ler, leg, leb))]
        if use_heuristic:
            pdf_c = cosine_pdf(nx, ny, nz, ldx, ldy, ldz)
            pdf_v = vndf_pdf(vx, vy, vz, nx, ny, nz, ldx, ldy, ldz, rgh)
            w = power_heuristic_3(pdf_l, pdf_c, pdf_v, float(s_per))
            out = [c * w for c in out]
        hit_light = active & reach
        return [torch.where(hit_light, c, zero) for c in out], reach

    def bounce_strategy(p_x, p_y, p_z, nx, ny, nz, inx, iny, inz, df, met,
                        rgh, active, sdx, sdy, sdz, pdf_self, w, su0, su1):
        ox, oy, oz = p_x + nx * 1e-4, p_y + ny * 1e-4, p_z + nz * 1e-4
        (hit, t2, prim2, n2x, n2y, n2z, d2, m2, r2,
         isem2) = closest_full(ox, oy, oz, sdx, sdy, sdz, active, "closest")
        f = brdf(-inx, -iny, -inz, nx, ny, nz, df, met, rgh, sdx, sdy, sdz)
        pdf_ok = pdf_self > 0.0
        inv_pdf = torch.where(
            pdf_ok, 1.0 / torch.where(pdf_ok, pdf_self,
                                      torch.ones_like(pdf_self)), zero)
        hit_light = active & hit & isem2
        hit_geo = active & hit & ~isem2
        t_safe = torch.where(hit_geo, t2, zero)
        sec, sec_reach = direct_light(
            ox + sdx * t_safe, oy + sdy * t_safe, oz + sdz * t_safe,
            n2x, n2y, n2z, sdx, sdy, sdz, d2, m2, r2, su0, su1, hit_geo,
            False)
        out = []
        for k, le in enumerate((ler, leg, leb)):
            light_term = w * f[k] * le * inv_pdf
            geo_term = f[k] * inv_pdf * sec[k]
            out.append(torch.where(hit_light, light_term, zero)
                       + torch.where(hit_geo, geo_term, zero))
        return out, prim2, sec_reach

    acc = [zero, zero, zero]
    cam_rec, samp_rec = [], []
    inv_s = smp._f32(1.0 / s_per)
    for cr in range(config.camera_rays):
        jit = smp.hash_random_2d(xi, yi, cr)
        s = ((px + jit[..., 0]) / f_w) * 2.0 - 1.0
        t = -(((py + jit[..., 1]) / f_h) * 2.0 - 1.0)
        dx, dy, dz = norm3(*(s * uh[k] + t * vh[k] - wv[k] for k in range(3)))
        ox, oy, oz = (zero + pos[k] for k in range(3))

        (hit, t_hit, prim_cam, nhx, nhy, nhz, df, met, rgh,
         isem) = closest_full(ox, oy, oz, dx, dy, dz, None, "camera")
        if emit_records:
            cam_rec.append(torch.where(hit, prim_cam + 1,
                                       torch.zeros_like(prim_cam))
                           .to(torch.int32))
        cam_hit_light = hit & isem
        acc = [acc[k] + torch.where(cam_hit_light, zero + le, zero)
               for k, le in enumerate((ler, leg, leb))]
        surf = hit & ~isem
        t_safe = torch.where(surf, t_hit, zero)
        p_x, p_y, p_z = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
        vx, vy, vz = -dx, -dy, -dz

        # Branching basis about the normal.
        use_y = nhx.abs() > 0.9
        ax = torch.where(use_y, zero, zero + 1.0)
        ay = torch.where(use_y, zero + 1.0, zero)
        an = ax * nhx + ay * nhy
        tx, ty, tz = norm3(ax - an * nhx, ay - an * nhy, -an * nhz)
        bx = nhy * tz - nhz * ty
        by = nhz * tx - nhx * tz
        bz = nhx * ty - nhy * tx

        # The sample-invariant part of the VNDF chain.
        alpha = rgh * rgh
        vtx = dot3(vx, vy, vz, tx, ty, tz)
        vtb = dot3(vx, vy, vz, bx, by, bz)
        vtn = dot3(vx, vy, vz, nhx, nhy, nhz)
        vex, vey, vez = norm3(alpha * vtx, alpha * vtb, vtn)
        t1x, t1y, t1z = norm3(vez, zero, -vex)
        t2x = vey * t1z - vez * t1y
        t2y = vez * t1x - vex * t1z
        t2z = vex * t1y - vey * t1x

        surface = (p_x, p_y, p_z, nhx, nhy, nhz, dx, dy, dz, df, met, rgh)
        m = [zero, zero, zero]
        for n in range(s_per):
            tab = tabs[:, n]
            s1, reach1 = direct_light(*surface, tab[TAB_LU0], tab[TAB_LU1],
                                      surf, True)

            w0, w1, cth = tab[TAB_W0C], tab[TAB_W1C], tab[TAB_CTH]
            cdx, cdy, cdz = norm3(tx * w0 + bx * w1 + nhx * cth,
                                  ty * w0 + by * w1 + nhy * cth,
                                  tz * w0 + bz * w1 + nhz * cth)
            pdf_c = cosine_pdf(nhx, nhy, nhz, cdx, cdy, cdz)
            pdf_l = square_light_pdf(p_x, p_y, p_z, cdx, cdy, cdz)
            pdf_v = vndf_pdf(vx, vy, vz, nhx, nhy, nhz, cdx, cdy, cdz, rgh)
            w_c = power_heuristic_3(pdf_c, pdf_l, pdf_v, float(s_per))
            s2, prim_c, reach2 = bounce_strategy(
                *surface, surf, cdx, cdy, cdz, pdf_c, w_c, tab[TAB_CSU0],
                tab[TAB_CSU1])

            k0, k1, vct = tab[TAB_K0V], tab[TAB_K1V], tab[TAB_VCT]
            hx, hy, hz = norm3(t1x * k0 + t2x * k1 + vex * vct,
                               t1y * k0 + t2y * k1 + vey * vct,
                               t1z * k0 + t2z * k1 + vez * vct)
            nlx, nly, nlz = norm3(alpha * hx, alpha * hy,
                                  torch.clamp_min(hz, 0.0))
            whx, why, whz = norm3(tx * nlx + bx * nly + nhx * nlz,
                                  ty * nlx + by * nly + nhy * nlz,
                                  tz * nlx + bz * nly + nhz * nlz)
            ddh = dot3(dx, dy, dz, whx, why, whz)
            vdx = dx - 2.0 * ddh * whx
            vdy = dy - 2.0 * ddh * why
            vdz = dz - 2.0 * ddh * whz
            pdf_v2 = vndf_pdf(vx, vy, vz, nhx, nhy, nhz, vdx, vdy, vdz, rgh)
            pdf_l2 = square_light_pdf(p_x, p_y, p_z, vdx, vdy, vdz)
            pdf_c2 = cosine_pdf(nhx, nhy, nhz, vdx, vdy, vdz)
            w_v = power_heuristic_3(pdf_v2, pdf_l2, pdf_c2, float(s_per))
            s3, prim_v, reach3 = bounce_strategy(
                *surface, surf, vdx, vdy, vdz, pdf_v2, w_v, tab[TAB_VSU0],
                tab[TAB_VSU1])

            if emit_records:
                samp_rec.append((
                    reach1.to(torch.int64) + 2 * reach2.to(torch.int64)
                    + 4 * reach3.to(torch.int64)
                    + (prim_c + 1) * (1 << REC_SHIFT_C)
                    + (prim_v + 1) * (1 << REC_SHIFT_V)).to(torch.int32))
            m = [m[k] + s1[k] + s2[k] + s3[k] for k in range(3)]

        acc = [acc[k] + torch.where(surf, m[k] * inv_s, zero)
               for k in range(3)]

    hdr = torch.stack(acc)
    if not emit_records:
        return hdr, None, None
    return (hdr, torch.stack(cam_rec),
            torch.stack(samp_rec).reshape(config.camera_rays, s_per, n_local))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = _build.load_library("mis_kernels").lib
    if lib.grt_mis_trace.argtypes is None:
        lib.grt_mis_trace.argtypes = [_PTR] * 17 + [_INT] * 13 + [_PTR]
        lib.grt_mis_trace.restype = _INT
        lib.grt_mis_grouped_smem.argtypes = [_INT] * 4
        lib.grt_mis_grouped_smem.restype = _INT
        lib.grt_mis_grouped_blocks_per_sm.argtypes = [_INT] * 5
        lib.grt_mis_grouped_blocks_per_sm.restype = _INT
        lib.grt_mis_static_smem.argtypes = [_INT] * 4
        lib.grt_mis_static_smem.restype = _INT
        lib.grt_mis_static_blocks_per_sm.argtypes = [_INT] * 5
        lib.grt_mis_static_blocks_per_sm.restype = _INT
    return lib


def static_smem_bytes(s_per: int, num_spheres: int, num_tris: int,
                      n_shadow: int) -> int:
    """Shared memory of one K4 block (``static_smem`` in
    ``csrc/mis_kernels.cu``): the triangles, the shadow list, the attribute
    rows, the [s_per][16] sample table and the spheres. Raises ValueError
    past the most one block may use."""
    smem = 4 * (NTAB_EXT * s_per + SROWS * num_spheres
                + 12 * (num_tris + n_shadow) + NATTR * (num_tris + num_spheres))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"scene and sample tables need {smem} B of shared memory; "
            f"the kernel stages at most {SMEM_LIMIT} B (fewer samples "
            "per strategy or spheres)")
    return smem


def mis_plan(scene: Scene, occluders, mis_samples: int,
             alone: bool = False):
    """K4's shared-memory plan on ``scene`` at ``mis_samples``, as
    ``cuda_path.grouped_tier`` takes it: (``static_smem_bytes``, its
    arguments). ``alone``: for a trace without a backward, which also takes
    K4g past TRACE_ALONE_BYTES."""
    num_tris = scene.triangles.num_triangles
    plan = (faster_below(TRACE_ALONE_BYTES, static_smem_bytes) if alone
            else static_smem_bytes)
    return plan, (mis_samples // 3, scene.spheres.num_spheres, num_tris,
                  shadow_count(occluders, num_tris))


def grouped_smem_bytes(s_per: int, num_spheres: int, n_super: int,
                       n_shadow_super: int) -> int:
    """Shared memory of one K4g block (``grouped_smem`` in
    ``csrc/mis_kernels.cu``): the [s_per][16] sample table, the spheres, the
    super and group boxes of the closest-hit and the shadow sweep. Raises
    ValueError past the most one block may use."""
    smem = (4 * (NTAB_EXT * s_per + SROWS * num_spheres)
            + 32 * (1 + SUPER) * (n_super + n_shadow_super))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the grouped MIS kernel needs {smem} B of shared memory ("
            f"{s_per} samples per strategy, {n_super} + {n_shadow_super} "
            f"supers of boxes); one block may use at most {SMEM_LIMIT} B "
            "(fewer samples per strategy)")
    return smem


def mis_trace_kernel(n_local: int, rid_base: int, packed: PackedMisScene,
                     shadow_idx: Optional[torch.Tensor],
                     config: RenderConfig, emit_records: bool):
    """Launch ``mis_kernel`` on the card. Same arguments and results as
    ``render_mis_plain`` (``rid_base`` an int), with ``shadow_idx`` int32.
    Where ``packed`` holds the grouped tables the grouped tier runs (K4g)
    and ``shadow_idx`` is not read (None will do)."""
    dev = packed.tri.device
    if dev.type != "cuda":
        raise ValueError("mis_trace_kernel needs CUDA tensors")
    f32, i32 = torch.float32, torch.int32
    T = packed.tri.shape[1]
    S = packed.num_spheres
    s_per = config.mis_samples // 3
    grp = packed.grouped
    n_shadow = shadow_idx.shape[0] if grp is None else grp.num_shadow
    # The static tier stages the scene tables; the grouped tier the sample
    # table, the spheres and the box tables.
    if grp is None:
        static_smem_bytes(s_per, S, T, n_shadow)
    else:
        grouped_smem_bytes(s_per, S, grp.sup.shape[1], grp.shadow_sup.shape[1])
    if n_local < 1 or rid_base < 0 or rid_base + n_local > config.num_pixels:
        raise ValueError(
            f"pixel range [{rid_base}, {rid_base + n_local}) is not inside "
            f"the frame's {config.num_pixels} pixels")

    lib = _library()
    atab = _require(packed.atab, "atab", f32, (NATTR, T + S), dev)
    if grp is None:
        idx = _require(shadow_idx, "shadow_idx", i32, (n_shadow,), dev)
        tables, supers, taken = [None] * 6, (0, 0), None
    else:
        atab_t = packed.atab.T.contiguous()  # [T + S][12], held to the launch
        atab, idx = atab_t.data_ptr(), None
        tables, supers = grouped_launch_tables(grp, dev)
        # The persistent grid's tile counter.
        taken = torch.zeros(1, dtype=i32, device=dev)
    ptrs = [
        _require(packed.cam, "cam", f32, (12,), dev),
        _require(packed.light, "light", f32, (NLIGHT,), dev),
        _require(packed.tri, "tri", f32, (NROWS, T), dev),
        _require(packed.sph, "sph", f32, (SROWS, max(S, 1)), dev),
        atab, _require(packed.tabs, "tabs", f32, (NTAB_EXT, s_per), dev), idx,
    ]
    hdr = torch.empty((3, n_local), dtype=f32, device=dev)
    rec = None
    if emit_records:
        rec = MisRecords(
            torch.empty((config.camera_rays, n_local), dtype=i32, device=dev),
            torch.empty((config.camera_rays, s_per, n_local), dtype=i32,
                        device=dev))
    with torch.cuda.device(dev):
        code = lib.grt_mis_trace(
            *ptrs, hdr.data_ptr(),
            rec.camera.data_ptr() if emit_records else None,
            rec.samples.data_ptr() if emit_records else None,
            *[None if t is None else t.data_ptr() for t in tables],
            None if taken is None else taken.data_ptr(), n_local, rid_base,
            config.width, config.height,
            config.camera_rays, s_per, T, S, n_shadow, int(emit_records),
            *supers, int(grp is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    name = "mis_kernel" if grp is None else "mis_kernel_grouped"
    _raise_on_launch_error(code, name)
    LAUNCHES[name] += 1
    return hdr, rec


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def render_mis_cuda_impl(scene: Scene, config: RenderConfig,
                         emit_records: bool = False, occluders=None,
                         local_n: Optional[int] = None, rid_base: int = 0,
                         flat_output: bool = False,
                         grouped: Optional[bool] = None, device="cuda"):
    """Variant-A MIS render of ``scene`` on ``device`` through ``mis_kernel``
    (through the plain version when ``device`` is the CPU). Returns raw
    accumulated hdr [H, W, 3] (apply ``render.tonemap_mis`` for the image),
    and with ``emit_records`` (hdr, MisRecords). ``grouped``: the tier; None
    takes ``cuda_path.grouped_tier``'s for a trace alone: the grouped tier
    above STATIC_TIER_MAX triangles, as the JAX entry does, or where K4's
    tables pass TRACE_ALONE_BYTES (a route that also runs the backward
    passes the tier of both kernels). Both tiers make the same decisions. ``occluders``: an
    ``intersect.potential_occluders`` tuple that culls the light probes.
    ``local_n`` / ``rid_base`` / ``flat_output`` render the pixels
    [rid_base, rid_base + local_n) and return flat [local_n, 3] hdr: the
    hooks a sharded renderer needs. Not differentiable: a scene that asks
    for gradients raises."""
    device = resolve_device(device)
    if any(t.requires_grad for t in scene.tensors()):
        raise NotImplementedError(
            "a scene tensor has requires_grad=True, but the bare MIS trace is "
            "not differentiable: render with render_mis_decoupled (the "
            "backward kernel) or render_mis_cuda (autograd through the eager "
            "oracle), or pass scene.detach()")
    if config.camera_rays < 1 or config.mis_samples < 3:
        raise ValueError("camera_rays must be at least 1 and mis_samples at "
                         "least 3")
    num_tris = scene.triangles.num_triangles
    if grouped is None:
        grouped = grouped_tier(scene, mis_plan(
            scene, occluders, config.mis_samples, alone=True))
    if num_tris + scene.spheres.num_spheres >= REC_MAX_PRIMS:
        raise ValueError("record encoding limit exceeded")
    n_local = config.num_pixels if local_n is None else int(local_n)
    if not flat_output and n_local != config.num_pixels:
        raise ValueError(
            f"{n_local} pixels of {config.num_pixels}: pass flat_output=True "
            "to render a pixel range")

    # The grouped tier's cull lives in its shadow table.
    shadow_idx = (None if grouped
                  else shadow_indices(occluders, num_tris, device))
    packed = _pack_inputs(scene.to(device), config, grouped, occluders)
    trace = mis_trace_kernel if device.type == "cuda" else render_mis_plain
    hdr, rec = trace(n_local, int(rid_base), packed, shadow_idx, config,
                     emit_records)
    hdr = hdr.T.contiguous()
    if not flat_output:
        hdr = hdr.reshape(config.height, config.width, 3)
    return (hdr, rec) if emit_records else hdr


class _OracleGrad(torch.autograd.Function):
    """``render_mis_cuda`` for a scene that asks for gradients: the forward
    is the kernel's image, the backward autograd through the eager oracle on
    the same scene (visibility piecewise constant), one range of pixels at a
    time so that the graph held stays within ``BACKWARD_LANE_STEPS``."""

    @staticmethod
    def forward(ctx, scene, config, device, *leaves):
        ctx.scene, ctx.config, ctx.device = scene, config, device
        ctx.save_for_backward(*leaves)
        return render_mis_cuda_impl(scene.detach(), config, device=device)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        config = ctx.config
        needs = ctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        it = iter(leaves)
        scene = ctx.scene.map(lambda _: next(it)).to(ctx.device)
        wanted = [t for t in leaves if t.requires_grad]
        steps = config.camera_rays * (config.mis_samples // 3)
        chunk = max(1, min(config.pixel_chunk, config.num_pixels,
                           BACKWARD_LANE_STEPS // steps))
        tables = _mis_sample_tables(config, ctx.device)
        px, py = pixel_coords(config, ctx.device)
        g = g.reshape(config.num_pixels, 3)
        sums = [None] * len(wanted)
        for s in range(0, config.num_pixels, chunk):
            with torch.enable_grad():
                out = _mis_chunk(compile_scene(scene.triangles), scene,
                                 config, tables, px[s:s + chunk],
                                 py[s:s + chunk])
                part = torch.autograd.grad(out, wanted, g[s:s + chunk],
                                           allow_unused=True)
            sums = [p if a is None else a if p is None else a + p
                    for a, p in zip(sums, part)]
        grads = iter(sums)
        return (None, None, None) + tuple(
            next(grads) if need else None for need in needs)


def render_mis_cuda(scene: Scene, config: RenderConfig,
                    device="cuda") -> torch.Tensor:
    """Variant-A MIS render through the kernel. Returns [H, W, 3] raw
    accumulated hdr (pre-tonemap). Differentiable: where a scene tensor
    requires gradients, the backward pass is autograd through the eager
    oracle (slow; ``cuda_mis_bwd.render_mis_decoupled`` has the backward
    kernel)."""
    device = resolve_device(device)
    leaves = list(scene.tensors())
    if any(t.requires_grad for t in leaves):
        return _OracleGrad.apply(scene, config, device, *leaves)
    return render_mis_cuda_impl(scene, config, device=device)

