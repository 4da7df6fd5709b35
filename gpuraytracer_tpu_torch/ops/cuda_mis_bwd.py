"""The backward of the variant-A MIS integrator: the MIS backward kernel on
the card, its plain PyTorch version, and the autograd glue.

Counterpart of ``gpuraytracer_tpu/ops/pallas_mis_bwd.py``, both tiers (the
static tier at most 64 triangles plus analytic spheres, its tables within one
block's shared memory; the grouped tier any primitive count below the record
encoding's limit):

  * the forward/reverse pairs ``_fwd_*`` / ``_rev_*`` of the per-sample
    arithmetic (norm3, GGX D, Smith G1, BRDF, VNDF pdf, cosine pdf, light
    pdf, power heuristic, the camera-material BRDF + VNDF pair, light
    sample, direct light, bounce) and ``_sample_fwd_rev``, one MIS sample's
    forward recompute and hand-written reverse;
  * ``_fwd_hoist`` / ``_rev_hoist``: the sample-invariant stage (camera ray,
    camera hit from the recorded winner's plane or sphere, basis, VNDF view
    frame, offset origin, camera-material invariants), its reverse derived
    by hand (the JAX kernel takes ``jax.vjp`` of it);
  * ``mis_bwd_plain``: the kernel's sweep in PyTorch over planes;
  * ``replay_mis``: the image recomputed from the records by the forwards
    alone, for autograd to differentiate (the reference the sweep is held
    to);
  * ``mis_bwd_kernel``: launches ``mis_bwd_kernel`` or, for the grouped
    tier, ``mis_bwd_grouped_kernel`` (``csrc/mis_bwd_kernels.cu``);
  * ``_pack_diff_inputs_mis`` and ``_AttachGradMis``: the differentiable
    parameter views and the one ``torch.autograd.Function``;
  * ``render_mis_fused``, ``render_mis_fused_local``,
    ``render_mis_decoupled``: the MIS trace kernel's image with that backward
    attached.

The forward is ``mis_kernel`` with records on; visibility is piecewise
constant, so the gradient of the image is the gradient of the shading
arithmetic replayed along the recorded decisions. Autograd chains the
kernel's cotangents from the packed views back to the scene.

Gradient conventions are the JAX package's (``pallas_mis_bwd.py:48-51``):
``clip`` gates with ``(x >= lo) & (x <= hi)``, ``|x|`` gives ``sign(x)``,
``maximum(x, c)`` passes where ``x >= c``. The hand-written reverse follows
them, not torch's tie rules. A wrapper takes the plain version only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import sampling as smp
from ..intersect import RAY_TMAX, RAY_TMIN, compile_scene
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from . import _build
from .cuda_mis import (NTAB_EXT, REC_CODE_MASK, REC_SHIFT_C, REC_SHIFT_V,
                       TAB_CSU0, TAB_CSU1, TAB_CTH, TAB_K0V, TAB_K1V, TAB_LU0,
                       TAB_LU1, TAB_VCT, TAB_VSU0, TAB_VSU1, TAB_W0C, TAB_W1C,
                       MisRecords, mis_plan, render_mis_cuda_impl,
                       sample_table)
from .cuda_path import (SMEM_LIMIT, _raise_on_launch_error, _require,
                        camera_vector, grouped_tier)

# Differentiable table rows: n xyz, c0, diffuse rgb, metallic, roughness,
# is_emissive (a selector: no gradient); sphere scenes add center xyz,
# radius, is_sphere (selector).
NDIF = 10
NDIF_SPH = 15
NCAM = 12
NLIGHT = 17
NSCAL = NCAM + NLIGHT

# The 44 hoisted sample-invariant planes (``cs``).
CS_D = 0       # camera ray direction
CS_P = 3       # camera-hit point
CS_NH = 6      # shading normal
CS_DF = 9      # diffuse rgb
CS_MET = 12
CS_RGH = 13
CS_T = 14      # basis tangent
CS_B = 17      # basis bitangent
CS_VE = 20     # stretched, normalized view vector
CS_T1 = 23     # its frame
CS_T2 = 26
CS_ALPHA = 29  # roughness^2
CS_OFF = 30    # offset origin p + nh * 1e-4
CS_V = 33      # view vector -d
CS_CNDV = 36   # |nh.v| + 1e-5
CS_CSQV = 37   # sqrt(ndv^2 (1 - a) + a)
CS_F0 = 38     # Fresnel F0 rgb
CS_OMM = 41    # 1 - metallic
CS_G1 = 42     # Smith G1(|nh.v|, roughness)
CS_VNDV = 43   # |nh.v|
NCS = 44

# Light vector: center, emitted radiance, width, depth, normal, tangent,
# bitangent.
L_C, L_E, L_W, L_D, L_N, L_T, L_B = 0, 3, 6, 7, 8, 11, 14

PI_F = smp._f32(math.pi)
INV_PI_F = smp._f32(1.0 / math.pi)
_KERNEL_WARPS = 4         # warps per block of mis_bwd_kernel
# The grouped tier (K5g) keeps each thread's per-item state in shared memory:
# cs and d_cs (NCS each), d_light (NLIGHT) and the two lobe winners' rows.
GROUPED_THREADS = 32 * _KERNEL_WARPS


def grouped_state_floats(ndif: int) -> int:
    """Floats of one K5g thread's state (``State`` in
    ``csrc/mis_bwd_kernels.cu``)."""
    return 2 * NCS + NLIGHT + 2 * ndif


def mis_bwd_plan(scene: Scene, mis_samples: int):
    """K5's shared-memory plan on ``scene`` at ``mis_samples``, as
    ``cuda_path.grouped_tier`` takes it: (``static_smem_bytes``, its
    arguments)."""
    num_spheres = scene.spheres.num_spheres
    return static_smem_bytes, (mis_samples // 3,
                               scene.triangles.num_triangles + num_spheres,
                               NDIF_SPH if num_spheres else NDIF)


def fused_tier(scene: Scene, mis_samples: int, occluders=None) -> bool:
    """The fused MIS route's tier, one for its trace and its backward:
    grouped above 64 triangles or where K4's or K5's tables do not fit a
    block."""
    return grouped_tier(scene, mis_plan(scene, occluders, mis_samples),
                        mis_bwd_plan(scene, mis_samples))


def grouped_smem_bytes(s_per: int, ndif: int) -> int:
    """Shared memory of one K5g block (``grouped_smem`` in
    ``csrc/mis_bwd_kernels.cu``): the [s_per][16] sample table, the camera
    and light scalars and the threads' state. Raises ValueError past the
    most one block may use."""
    smem = 4 * (NTAB_EXT * s_per + NSCAL
                + GROUPED_THREADS * grouped_state_floats(ndif))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the grouped MIS backward kernel needs {smem} B of shared memory "
            f"({s_per} samples per strategy); one block may use at most "
            f"{SMEM_LIMIT} B (fewer samples per strategy)")
    return smem


def static_smem_bytes(s_per: int, num_prims: int, ndif: int) -> int:
    """Shared memory of one K5 block (``static_smem`` in
    ``csrc/mis_bwd_kernels.cu``): the [P][ndif] parameter table, the
    [s_per][16] sample table, the camera and light scalars, and one
    [P][ndif] table and 29 scalars per warp. Raises ValueError past the most
    one block may use."""
    smem = 4 * (ndif * num_prims + NTAB_EXT * s_per + NSCAL
                + _KERNEL_WARPS * (num_prims * ndif + NSCAL))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the parameter and sample tables need {smem} B of shared "
            f"memory; the backward kernel stages at most {SMEM_LIMIT} B "
            "(fewer samples per strategy or primitives)")
    return smem


# Kernel launches since the process started (or since a caller reset them):
# the wrapper adds one where it launches the kernel and nowhere else.
LAUNCHES = {"mis_bwd_kernel": 0, "mis_bwd_grouped_kernel": 0}


def _w(cond, x):
    """``x`` where ``cond``, else an exact zero."""
    return torch.where(cond, x, 0.0)


def _zero(like):
    return torch.zeros_like(like)


# ---------------------------------------------------------------------------
# Forward/reverse pairs. Each ``_fwd_*`` returns (outputs, res); its
# ``_rev_*`` takes res and the output cotangents and returns the input
# cotangents in the forward's argument order.
# ---------------------------------------------------------------------------

def _fwd_norm3(x, y, z, eps):
    """x / sqrt(max(|x|^2, eps))."""
    q = x * x + y * y + z * z
    inv = 1.0 / torch.sqrt(torch.clamp_min(q, eps))
    return (x * inv, y * inv, z * inv), (x, y, z, inv, q >= eps)


def _rev_norm3(res, dx_, dy_, dz_):
    x, y, z, inv, ok = res
    d_inv = x * dx_ + y * dy_ + z * dz_
    d_q = _w(ok, (-0.5) * inv * inv * inv * d_inv)
    return (inv * dx_ + 2.0 * x * d_q,
            inv * dy_ + 2.0 * y * d_q,
            inv * dz_ + 2.0 * z * d_q)


def _fwd_dggx(ndh, rgh):
    """GGX D(n.h) taking roughness, not alpha (a quirk of the reference)."""
    f = (ndh * rgh * rgh - ndh) * ndh + 1.0
    den = PI_F * f * f + 1e-12
    out = (rgh * rgh) / den
    inv_den = 1.0 / den
    return out, (ndh, rgh, f, inv_den, out)


def _rev_dggx(res, d_out):
    ndh, rgh, f, inv_den, out = res
    d_rgh = 2.0 * rgh * inv_den * d_out
    d_den = -(out * inv_den) * d_out
    d_f = 2.0 * PI_F * f * d_den
    d_ndh = 2.0 * ndh * (rgh * rgh - 1.0) * d_f
    d_rgh = d_rgh + 2.0 * rgh * ndh * ndh * d_f
    return d_ndh, d_rgh


def _fwd_smith_g1(ndv, rgh):
    a = rgh * rgh
    a2 = a * a
    nv2r = ndv * ndv
    nv2 = torch.clamp_min(nv2r, 1e-12)
    s = torch.sqrt(1.0 + a2 * (1.0 - nv2) / nv2)
    g1 = 2.0 / (1.0 + s)
    inv_nv2 = 1.0 / nv2
    return g1, (ndv, rgh, a, a2, nv2r, inv_nv2, s, g1)


def _rev_smith_g1(res, d_g1):
    ndv, rgh, a, a2, nv2r, inv_nv2, s, g1 = res
    d_s = -(g1 / (1.0 + s)) * d_g1
    d_in = d_s / (2.0 * s)
    d_a2 = (inv_nv2 - 1.0) * d_in
    d_nv2 = -(a2 * inv_nv2 * inv_nv2) * d_in
    d_ndv = _w(nv2r >= 1e-12, 2.0 * ndv * d_nv2)
    d_rgh = 4.0 * rgh * a * d_a2
    return d_ndv, d_rgh


def _fwd_brdf(v3, n3, df3, met, rgh, l3):
    """calculateBRDFContribution; ``v`` is the view direction. (1 - l.h)^5
    by multiplies, as the trace kernel spells it."""
    vx, vy, vz = v3
    nx, ny, nz = n3
    lx, ly, lz = l3
    h3, res_h = _fwd_norm3(vx + lx, vy + ly, vz + lz, 1e-12)
    hx, hy, hz = h3
    ndv_raw = nx * vx + ny * vy + nz * vz
    ndv = ndv_raw.abs() + 1e-5
    ndl_raw = nx * lx + ny * ly + nz * lz
    ndl = torch.clamp(ndl_raw, 0.0, 1.0)
    ndh_raw = nx * hx + ny * hy + nz * hz
    ndh = torch.clamp(ndh_raw, 0.0, 1.0)
    ldh_raw = lx * hx + ly * hy + lz * hz
    ldh = torch.clamp(ldh_raw, 0.0, 1.0)
    omm = 1.0 - met
    f0 = tuple(0.04 * omm + df3[c] * met for c in range(3))
    dggx, res_d = _fwd_dggx(ndh, rgh)
    q = 1.0 - ldh
    x2 = q * q
    p5 = x2 * x2 * q
    x4 = x2 * x2
    fres = tuple(f0[c] + (1.0 - f0[c]) * p5 for c in range(3))
    a = rgh * rgh
    argl = (-ndl * a + ndl) * ndl + a
    sql = torch.sqrt(torch.clamp_min(argl, 1e-12))
    inv_sql = 1.0 / sql
    argv = (-ndv * a + ndv) * ndv + a
    sqv = torch.sqrt(torch.clamp_min(argv, 1e-12))
    inv_sqv = 1.0 / sqv
    sumg = ndl * sqv + ndv * sql + 1e-7
    vis = 0.5 / sumg
    inv_sumg = vis + vis
    den_s = 4.0 * ndv * ndl + 1e-7
    spec = dggx * vis / den_s
    inv_dens = 1.0 / den_s
    out = tuple((1.0 - fres[c]) * omm * (df3[c] * INV_PI_F + spec * fres[c])
                * ndl for c in range(3))
    res = (v3, n3, df3, met, rgh, l3, h3, res_h, ndv_raw, ndv, ndl_raw, ndl,
           ndh_raw, ldh_raw, x4, omm, f0, res_d, dggx, p5, fres, a, argl,
           inv_sql, sql, argv, inv_sqv, sqv, vis, inv_sumg, inv_dens, spec)
    return out, res


def _rev_brdf(res, d_out):
    (v3, n3, df3, met, rgh, l3, h3, res_h, ndv_raw, ndv, ndl_raw, ndl,
     ndh_raw, ldh_raw, x4, omm, f0, res_d, dggx, p5, fres, a, argl,
     inv_sql, sql, argv, inv_sqv, sqv, vis, inv_sumg, inv_dens, spec) = res
    zero = _zero(d_out[0])
    d_ndl = zero
    d_ndv = zero
    d_spec = zero
    d_omm = zero
    d_met = zero
    d_p5 = zero
    d_df = [zero, zero, zero]
    for c in range(3):
        g = d_out[c]
        kd = (1.0 - fres[c]) * omm
        inner = df3[c] * INV_PI_F + spec * fres[c]
        d_kd = inner * ndl * g
        d_inner = kd * ndl * g
        d_ndl = d_ndl + kd * inner * g
        d_fc = spec * d_inner - omm * d_kd
        d_omm = d_omm + (1.0 - fres[c]) * d_kd
        d_df[c] = d_df[c] + INV_PI_F * d_inner
        d_spec = d_spec + fres[c] * d_inner
        d_f0 = (1.0 - p5) * d_fc
        d_p5 = d_p5 + (1.0 - f0[c]) * d_fc
        d_omm = d_omm + 0.04 * d_f0
        d_df[c] = d_df[c] + met * d_f0
        d_met = d_met + df3[c] * d_f0
    d_met = d_met - d_omm
    d_ldh = -5.0 * x4 * d_p5
    d_dggx = vis * inv_dens * d_spec
    d_vis = dggx * inv_dens * d_spec
    d_dens = -(spec * inv_dens) * d_spec
    d_ndv = d_ndv + 4.0 * ndl * d_dens
    d_ndl = d_ndl + 4.0 * ndv * d_dens
    d_sumg = -(vis * inv_sumg) * d_vis
    d_ndl = d_ndl + sqv * d_sumg
    d_sqv = ndl * d_sumg
    d_ndv = d_ndv + sql * d_sumg
    d_sql = ndv * d_sumg
    d_argv = _w(argv >= 1e-12, 0.5 * inv_sqv * d_sqv)
    d_argl = _w(argl >= 1e-12, 0.5 * inv_sql * d_sql)
    d_ndv = d_ndv + 2.0 * ndv * (1.0 - a) * d_argv
    d_a = (1.0 - ndv * ndv) * d_argv
    d_ndl = d_ndl + 2.0 * ndl * (1.0 - a) * d_argl
    d_a = d_a + (1.0 - ndl * ndl) * d_argl
    d_ndh, d_rgh = _rev_dggx(res_d, d_dggx)
    d_rgh = d_rgh + 2.0 * rgh * d_a
    d_ldh_raw = _w((ldh_raw >= 0.0) & (ldh_raw <= 1.0), d_ldh)
    d_ndh_raw = _w((ndh_raw >= 0.0) & (ndh_raw <= 1.0), d_ndh)
    d_ndl_raw = _w((ndl_raw >= 0.0) & (ndl_raw <= 1.0), d_ndl)
    d_ndv_raw = torch.sign(ndv_raw) * d_ndv
    d_n = tuple(l3[c] * d_ndl_raw + h3[c] * d_ndh_raw + v3[c] * d_ndv_raw
                for c in range(3))
    d_l = [n3[c] * d_ndl_raw + h3[c] * d_ldh_raw for c in range(3)]
    d_h = [n3[c] * d_ndh_raw + l3[c] * d_ldh_raw for c in range(3)]
    d_v = [n3[c] * d_ndv_raw for c in range(3)]
    dh = _rev_norm3(res_h, *d_h)
    for c in range(3):
        d_v[c] = d_v[c] + dh[c]
        d_l[c] = d_l[c] + dh[c]
    return tuple(d_v), d_n, tuple(d_df), d_met, d_rgh, tuple(d_l)


def _fwd_vndf(v3, n3, l3, rgh):
    """VNDF pdf D G1 |v.h| / (4 |n.v| + 1e-7)."""
    h3, res_h = _fwd_norm3(v3[0] + l3[0], v3[1] + l3[1], v3[2] + l3[2],
                           1e-12)
    ndh_raw = n3[0] * h3[0] + n3[1] * h3[1] + n3[2] * h3[2]
    vdh_raw = v3[0] * h3[0] + v3[1] * h3[1] + v3[2] * h3[2]
    vdh = vdh_raw.abs()
    ndv_raw = n3[0] * v3[0] + n3[1] * v3[1] + n3[2] * v3[2]
    dggx, res_d = _fwd_dggx(ndh_raw.abs(), rgh)
    g1, res_g = _fwd_smith_g1(ndv_raw.abs(), rgh)
    den = 4.0 * ndv_raw.abs() + 1e-7
    pdf = dggx * g1 * vdh / den
    inv_den = 1.0 / den
    res = (v3, n3, h3, res_h, ndh_raw, vdh_raw, ndv_raw, dggx, res_d, g1,
           res_g, vdh, inv_den, pdf)
    return pdf, res


def _rev_vndf(res, d_pdf):
    (v3, n3, h3, res_h, ndh_raw, vdh_raw, ndv_raw, dggx, res_d, g1, res_g,
     vdh, inv_den, pdf) = res
    d_dggx = g1 * vdh * inv_den * d_pdf
    d_g1 = dggx * vdh * inv_den * d_pdf
    d_vdh = dggx * g1 * inv_den * d_pdf
    d_den = -(pdf * inv_den) * d_pdf
    d_ndv = 4.0 * d_den
    d_ndh, d_rgh = _rev_dggx(res_d, d_dggx)
    d_ndv_g, d_rgh_g = _rev_smith_g1(res_g, d_g1)
    d_ndv = d_ndv + d_ndv_g
    d_rgh = d_rgh + d_rgh_g
    d_ndh_raw = torch.sign(ndh_raw) * d_ndh
    d_vdh_raw = torch.sign(vdh_raw) * d_vdh
    d_ndv_raw = torch.sign(ndv_raw) * d_ndv
    d_n = tuple(h3[c] * d_ndh_raw + v3[c] * d_ndv_raw for c in range(3))
    d_v = [h3[c] * d_vdh_raw + n3[c] * d_ndv_raw for c in range(3)]
    d_h = [n3[c] * d_ndh_raw + v3[c] * d_vdh_raw for c in range(3)]
    dh = _rev_norm3(res_h, *d_h)
    for c in range(3):
        d_v[c] = d_v[c] + dh[c]
    return tuple(d_v), d_n, tuple(dh), d_rgh


def _fwd_cospdf(n3, d3):
    """Cosine-hemisphere pdf max(0, n.d) / pi."""
    raw = n3[0] * d3[0] + n3[1] * d3[1] + n3[2] * d3[2]
    return torch.clamp_min(raw, 0.0) * INV_PI_F, raw


def _rev_cospdf(n3, d3, raw, d_pdf):
    d_raw = _w(raw >= 0.0, d_pdf * INV_PI_F)
    return (tuple(d3[c] * d_raw for c in range(3)),
            tuple(n3[c] * d_raw for c in range(3)))


def _fwd_lightpdf(lightp, q3, dir3):
    """Square-light pdf to the light *center* (a quirk of the reference)."""
    to = tuple(lightp[L_C + c] - q3[c] for c in range(3))
    dist2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    ct_raw = -(dir3[0] * lightp[L_N] + dir3[1] * lightp[L_N + 1]
               + dir3[2] * lightp[L_N + 2])
    cos_t = torch.clamp_min(ct_raw, 0.0)
    den = lightp[L_W] * lightp[L_D] * cos_t + 1e-6
    pdf = dist2 / den
    inv_den = 1.0 / den
    return pdf, (dir3, to, ct_raw, cos_t, inv_den, pdf, lightp)


def _rev_lightpdf(res, d_pdf, d_lightp):
    """Adds the light's cotangents to ``d_lightp`` (a list); returns
    (d_q, d_dir)."""
    dir3, to, ct_raw, cos_t, inv_den, pdf, lightp = res
    lw, ldep = lightp[L_W], lightp[L_D]
    d_dist2 = d_pdf * inv_den
    d_den = -(pdf * inv_den) * d_pdf
    d_lightp[L_W] = d_lightp[L_W] + ldep * cos_t * d_den
    d_lightp[L_D] = d_lightp[L_D] + lw * cos_t * d_den
    d_ct = _w(ct_raw >= 0.0, lw * ldep * d_den)
    d_dir = tuple(-lightp[L_N + c] * d_ct for c in range(3))
    d_q = []
    for c in range(3):
        d_lightp[L_N + c] = d_lightp[L_N + c] - dir3[c] * d_ct
        d_to = 2.0 * to[c] * d_dist2
        d_lightp[L_C + c] = d_lightp[L_C + c] + d_to
        d_q.append(-d_to)
    return tuple(d_q), d_dir


def _fwd_ph3(p1, p2, p3, n):
    """beta = 1 power heuristic with per-strategy count n."""
    aa = n * p1
    den = aa + n * p2 + n * p3 + 1e-6
    w = aa / den
    inv_den = 1.0 / den
    return w, (inv_den, w, n)


def _rev_ph3(res, d_w):
    inv_den, w, n = res
    t = d_w * inv_den
    return n * (1.0 - w) * t, -n * w * t, -n * w * t


def _fwd_bv(cs, l3):
    """The camera-material BRDF and VNDF pdf toward ``l3``, with every
    direction-independent term read from the hoisted planes and the half
    vector shared between the two."""
    v3 = cs[CS_V:CS_V + 3]
    n3 = cs[CS_NH:CS_NH + 3]
    df3 = cs[CS_DF:CS_DF + 3]
    rgh, a = cs[CS_RGH], cs[CS_ALPHA]
    ndv, sqv = cs[CS_CNDV], cs[CS_CSQV]
    f0 = cs[CS_F0:CS_F0 + 3]
    omm, g1, vndv = cs[CS_OMM], cs[CS_G1], cs[CS_VNDV]
    h3, res_h = _fwd_norm3(v3[0] + l3[0], v3[1] + l3[1], v3[2] + l3[2],
                           1e-12)
    ndl_raw = n3[0] * l3[0] + n3[1] * l3[1] + n3[2] * l3[2]
    ndl = torch.clamp(ndl_raw, 0.0, 1.0)
    ndh_raw = n3[0] * h3[0] + n3[1] * h3[1] + n3[2] * h3[2]
    ldh_raw = l3[0] * h3[0] + l3[1] * h3[1] + l3[2] * h3[2]
    ldh = torch.clamp(ldh_raw, 0.0, 1.0)
    dggx_b, res_db = _fwd_dggx(torch.clamp(ndh_raw, 0.0, 1.0), rgh)
    q = 1.0 - ldh
    x2 = q * q
    p5 = x2 * x2 * q
    x4 = x2 * x2
    fres = tuple(f0[c] + (1.0 - f0[c]) * p5 for c in range(3))
    argl = (-ndl * a + ndl) * ndl + a
    sql = torch.sqrt(torch.clamp_min(argl, 1e-12))
    inv_sql = 1.0 / sql
    sumg = ndl * sqv + ndv * sql + 1e-7
    vis = 0.5 / sumg
    inv_sumg = vis + vis
    den_s = 4.0 * ndv * ndl + 1e-7
    spec = dggx_b * vis / den_s
    inv_dens = 1.0 / den_s
    out = tuple((1.0 - fres[c]) * omm * (df3[c] * INV_PI_F + spec * fres[c])
                * ndl for c in range(3))
    vdh_raw = v3[0] * h3[0] + v3[1] * h3[1] + v3[2] * h3[2]
    vdh = vdh_raw.abs()
    dggx_v, res_dv = _fwd_dggx(ndh_raw.abs(), rgh)
    denv = 4.0 * vndv + 1e-7
    pdf = dggx_v * g1 * vdh / denv
    inv_denv = 1.0 / denv
    res = (v3, n3, df3, l3, a, ndv, sqv, f0, omm, g1, inv_denv, h3, res_h,
           ndl_raw, ndl, ndh_raw, ldh_raw, x4, p5, fres, dggx_b, res_db,
           argl, inv_sql, sql, inv_sumg, vis, inv_dens, spec, vdh_raw, vdh,
           dggx_v, res_dv, pdf)
    return out, pdf, res


def _rev_bv(res, d_out, d_pdf):
    """Reverse of ``_fwd_bv``: a dict with ``d_l`` and one entry per hoisted
    plane read (the caller adds them to ``d_cs``)."""
    (v3, n3, df3, l3, a, ndv, sqv, f0, omm, g1, inv_denv, h3, res_h,
     ndl_raw, ndl, ndh_raw, ldh_raw, x4, p5, fres, dggx_b, res_db,
     argl, inv_sql, sql, inv_sumg, vis, inv_dens, spec, vdh_raw, vdh,
     dggx_v, res_dv, pdf) = res
    zero = _zero(d_out[0])
    d_ndl = zero
    d_spec = zero
    d_omm = zero
    d_p5 = zero
    d_df = [zero, zero, zero]
    d_f0 = [zero, zero, zero]
    for c in range(3):
        g = d_out[c]
        kd = (1.0 - fres[c]) * omm
        inner = df3[c] * INV_PI_F + spec * fres[c]
        gi = ndl * g
        d_kd = inner * gi
        d_inner = kd * gi
        d_ndl = d_ndl + (kd * inner) * g
        d_fc = spec * d_inner - omm * d_kd
        d_omm = d_omm + (1.0 - fres[c]) * d_kd
        d_df[c] = INV_PI_F * d_inner
        d_spec = d_spec + fres[c] * d_inner
        d_f0[c] = (1.0 - p5) * d_fc
        d_p5 = d_p5 + (1.0 - f0[c]) * d_fc
    d_ldh = -5.0 * x4 * d_p5
    d_dggx_b = vis * inv_dens * d_spec
    d_vis = dggx_b * inv_dens * d_spec
    d_dens = -(spec * inv_dens) * d_spec
    d_ndv = 4.0 * ndl * d_dens
    d_ndl = d_ndl + 4.0 * ndv * d_dens
    d_sumg = -(vis * inv_sumg) * d_vis
    d_ndl = d_ndl + sqv * d_sumg
    d_sqv = ndl * d_sumg
    d_ndv = d_ndv + sql * d_sumg
    d_sql = ndv * d_sumg
    d_argl = _w(argl >= 1e-12, 0.5 * inv_sql * d_sql)
    d_ndl = d_ndl + 2.0 * ndl * (1.0 - a) * d_argl
    d_a = (1.0 - ndl * ndl) * d_argl
    d_ndh_b, d_rgh = _rev_dggx(res_db, d_dggx_b)
    d_dggx_v = g1 * vdh * inv_denv * d_pdf
    d_g1 = dggx_v * vdh * inv_denv * d_pdf
    d_vdh = dggx_v * g1 * inv_denv * d_pdf
    d_vndv = 4.0 * (-(pdf * inv_denv) * d_pdf)
    d_ndh_v, d_rgh_v = _rev_dggx(res_dv, d_dggx_v)
    d_rgh = d_rgh + d_rgh_v
    d_ndh_raw = (_w((ndh_raw >= 0.0) & (ndh_raw <= 1.0), d_ndh_b)
                 + torch.sign(ndh_raw) * d_ndh_v)
    d_ndl_raw = _w((ndl_raw >= 0.0) & (ndl_raw <= 1.0), d_ndl)
    d_ldh_raw = _w((ldh_raw >= 0.0) & (ldh_raw <= 1.0), d_ldh)
    d_vdh_raw = torch.sign(vdh_raw) * d_vdh
    d_n = tuple(l3[c] * d_ndl_raw + h3[c] * d_ndh_raw for c in range(3))
    d_l = [n3[c] * d_ndl_raw + h3[c] * d_ldh_raw for c in range(3)]
    d_h = [n3[c] * d_ndh_raw + l3[c] * d_ldh_raw + v3[c] * d_vdh_raw
           for c in range(3)]
    d_v = [h3[c] * d_vdh_raw for c in range(3)]
    dh = _rev_norm3(res_h, *d_h)
    for c in range(3):
        d_v[c] = d_v[c] + dh[c]
        d_l[c] = d_l[c] + dh[c]
    return dict(d_l=d_l, d_v=d_v, d_n=d_n, d_df=d_df, d_rgh=d_rgh, d_a=d_a,
                d_ndv=d_ndv, d_sqv=d_sqv, d_f0=d_f0, d_omm=d_omm, d_g1=d_g1,
                d_vndv=d_vndv)


def _fwd_lsample(lightp, o3, u0, u1):
    """A point of the light rectangle and the unit direction to it from
    ``o3``."""
    su0 = u0 - 0.5
    su1 = u1 - 0.5
    sw = su0 * lightp[L_W]
    sdep = su1 * lightp[L_D]
    to = tuple(lightp[L_C + c] + lightp[L_T + c] * sw
               + lightp[L_B + c] * sdep - o3[c] for c in range(3))
    q2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    dist = torch.sqrt(torch.clamp_min(q2, 1e-30))
    inv_dist = 1.0 / dist
    ld = tuple(to[c] / dist for c in range(3))
    return ld, (to, q2, inv_dist, su0, su1, lightp)


def _rev_to_light(to, q2, inv_dist, su0, su1, lightp, d_ld, d_lightp):
    """Reverse of ``ld = to / |to|`` with ``to = s - o`` and s the light
    sample at (su0, su1): adds the light's cotangents, returns d_o."""
    d_to = [inv_dist * d_ld[c] for c in range(3)]
    d_invd = to[0] * d_ld[0] + to[1] * d_ld[1] + to[2] * d_ld[2]
    d_q2 = _w(q2 >= 1e-30, -0.5 * inv_dist * inv_dist * inv_dist * d_invd)
    lw, ldep = lightp[L_W], lightp[L_D]
    d_o = []
    for c in range(3):
        d_s = d_to[c] + 2.0 * to[c] * d_q2
        d_lightp[L_C + c] = d_lightp[L_C + c] + d_s
        d_lightp[L_T + c] = d_lightp[L_T + c] + su0 * lw * d_s
        d_lightp[L_W] = d_lightp[L_W] + su0 * lightp[L_T + c] * d_s
        d_lightp[L_B + c] = d_lightp[L_B + c] + su1 * ldep * d_s
        d_lightp[L_D] = d_lightp[L_D] + su1 * lightp[L_B + c] * d_s
        d_o.append(-d_s)
    return tuple(d_o)


def _rev_lsample(res, d_ld, d_lightp):
    """Adds the light's cotangents to ``d_lightp``; returns d_o."""
    return _rev_to_light(*res, d_ld, d_lightp)


def _fwd_direct_light(lightp, q3, n3, inc3, df3, met, rgh, u0, u1, gate,
                      s_per_f, heuristic):
    """calculateDirectLightSamplingContribution with the probe's decision
    given as ``gate`` (active and reached)."""
    o3 = tuple(q3[c] + n3[c] * 1e-4 for c in range(3))
    su0 = u0 - 0.5
    su1 = u1 - 0.5
    sw = su0 * lightp[L_W]
    sdep = su1 * lightp[L_D]
    to = tuple(lightp[L_C + c] + lightp[L_T + c] * sw
               + lightp[L_B + c] * sdep - o3[c] for c in range(3))
    q2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    dist = torch.sqrt(torch.clamp_min(q2, 1e-30))
    inv_dist = 1.0 / dist
    ld = tuple(to[c] / dist for c in range(3))
    pdf_l, res_pl = _fwd_lightpdf(lightp, q3, ld)
    v3 = tuple(-inc3[c] for c in range(3))
    b3, res_b = _fwd_brdf(v3, n3, df3, met, rgh, ld)
    inv_pdf = 1.0 / pdf_l
    le = lightp[L_E:L_E + 3]
    cpre = tuple(b3[c] * le[c] * inv_pdf for c in range(3))
    if heuristic:
        pdf_c, raw_pc = _fwd_cospdf(n3, ld)
        pdf_v, res_pv = _fwd_vndf(v3, n3, ld, rgh)
        w, res_w = _fwd_ph3(pdf_l, pdf_c, pdf_v, s_per_f)
        out = tuple(_w(gate, cpre[c] * w) for c in range(3))
        res_h = (raw_pc, res_pv, res_w, w)
    else:
        out = tuple(_w(gate, cpre[c]) for c in range(3))
        res_h = None
    res = (n3, ld, (to, q2, inv_dist, su0, su1, lightp), res_pl, b3, res_b,
           inv_pdf, le, cpre, gate, res_h)
    return out, res


def _rev_direct_light(res, d_out, d_lightp):
    """Adds the light's cotangents to ``d_lightp``; returns (d_q, d_n,
    d_inc, d_df, d_met, d_rgh)."""
    (n3, ld, res_to, res_pl, b3, res_b, inv_pdf, le, cpre, gate,
     res_h) = res
    zero = _zero(d_out[0])
    d_inv_pdf = zero
    d_ld = [zero, zero, zero]
    d_n = [zero, zero, zero]
    d_rgh = zero
    d_pdf_l = zero
    if res_h is not None:
        raw_pc, res_pv, res_w, w = res_h
        d_w = zero
        d_cpre = []
        for c in range(3):
            g = _w(gate, d_out[c])
            d_w = d_w + cpre[c] * g
            d_cpre.append(w * g)
        d_pl_w, d_pc, d_pv = _rev_ph3(res_w, d_w)
        d_pdf_l = d_pdf_l + d_pl_w
        dn_c, dd_c = _rev_cospdf(n3, ld, raw_pc, d_pc)
        d_v_pv, dn_v, dd_v, d_rgh_pv = _rev_vndf(res_pv, d_pv)
        d_rgh = d_rgh + d_rgh_pv
        d_v = list(d_v_pv)
        for c in range(3):
            d_n[c] = d_n[c] + dn_c[c] + dn_v[c]
            d_ld[c] = d_ld[c] + dd_c[c] + dd_v[c]
    else:
        d_cpre = [_w(gate, d_out[c]) for c in range(3)]
        d_v = [zero, zero, zero]
    d_b = []
    for c in range(3):
        d_b.append(le[c] * inv_pdf * d_cpre[c])
        d_lightp[L_E + c] = d_lightp[L_E + c] + b3[c] * inv_pdf * d_cpre[c]
        d_inv_pdf = d_inv_pdf + b3[c] * le[c] * d_cpre[c]
    d_pdf_l = d_pdf_l + (-(inv_pdf * inv_pdf) * d_inv_pdf)
    d_v_b, d_n_b, d_df, d_met, d_rgh_b, d_l_b = _rev_brdf(res_b, tuple(d_b))
    d_rgh = d_rgh + d_rgh_b
    for c in range(3):
        d_v[c] = d_v[c] + d_v_b[c]
        d_n[c] = d_n[c] + d_n_b[c]
        d_ld[c] = d_ld[c] + d_l_b[c]
    d_q_pl, d_ld_pl = _rev_lightpdf(res_pl, d_pdf_l, d_lightp)
    for c in range(3):
        d_ld[c] = d_ld[c] + d_ld_pl[c]
    d_o = _rev_to_light(*res_to, d_ld, d_lightp)
    d_q = tuple(d_q_pl[c] + d_o[c] for c in range(3))
    for c in range(3):
        d_n[c] = d_n[c] + 1e-4 * d_o[c]
    d_inc = tuple(-d_v[c] for c in range(3))
    return d_q, tuple(d_n), d_inc, tuple(d_df), d_met, d_rgh


def _fwd_bounce(cs, lightp, at2, hit2, sec_reach, sd3, pdf_self, w, su0,
                su1, surf, s_per_f, num_spheres, b2):
    """The cosine / VNDF bounce body with the recorded winner's attributes
    ``at2`` and secondary probe bit ``sec_reach``; the camera-material BRDF
    toward ``sd3`` comes in as ``b2``."""
    off = cs[CS_OFF:CS_OFF + 3]
    n2t = at2[0:3]
    c02 = at2[3]
    den2 = sd3[0] * n2t[0] + sd3[1] * n2t[1] + sd3[2] * n2t[2]
    ok2 = den2.abs() >= 1e-12
    sden2 = torch.where(ok2, den2, 1.0)
    inv_sden2 = 1.0 / sden2
    num2 = c02 - (off[0] * n2t[0] + off[1] * n2t[1] + off[2] * n2t[2])
    t2p = num2 / sden2
    t2 = t2p
    sph = None
    if num_spheres:
        is_sph = at2[14] > 0.5
        oc = tuple(off[c] - at2[10 + c] for c in range(3))
        rad = at2[13]
        a_q = sd3[0] * sd3[0] + sd3[1] * sd3[1] + sd3[2] * sd3[2]
        b_q = 2.0 * (oc[0] * sd3[0] + oc[1] * sd3[1] + oc[2] * sd3[2])
        c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - rad * rad
        disc = b_q * b_q - 4.0 * a_q * c_q
        posd = disc > 0.0
        sq = torch.sqrt(torch.where(posd, disc, 1.0))
        t1 = (-b_q - sq) / (2.0 * a_q)
        t2q = (-b_q + sq) / (2.0 * a_q)
        t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
        t2 = torch.where(is_sph, torch.where(t1_ok, t1, t2q), t2p)
        sph = (is_sph, oc, rad, a_q, b_q, c_q, posd, sq, t1, t2q, t1_ok)
    pdf_ok = pdf_self > 0.0
    inv_pdf = _w(pdf_ok, 1.0 / torch.where(pdf_ok, pdf_self, 1.0))
    isem2 = at2[9] > 0.5
    hit_light = surf & hit2 & isem2
    hit_geo = surf & hit2 & ~isem2
    le = lightp[L_E:L_E + 3]
    t2s = _w(hit_geo, t2)
    bp = tuple(off[c] + sd3[c] * t2s for c in range(3))
    n2 = n2t
    sphn = None
    if num_spheres:
        sel = hit_geo & sph[0]
        nv = tuple(bp[c] - at2[10 + c] for c in range(3))
        qn = nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]
        inv_n = 1.0 / torch.sqrt(torch.clamp_min(qn, 1e-6))
        n2 = tuple(torch.where(sel, nv[c] * inv_n, n2t[c]) for c in range(3))
        sphn = (sel, nv, qn, inv_n)
    dl3, res_dl = _fwd_direct_light(lightp, bp, n2, sd3, at2[4:7], at2[7],
                                    at2[8], su0, su1, hit_geo & sec_reach,
                                    s_per_f, False)
    out = tuple(_w(hit_light, w * b2[c] * le[c] * inv_pdf)
                + _w(hit_geo, b2[c] * inv_pdf * dl3[c]) for c in range(3))
    res = (off, sd3, n2t, ok2, inv_sden2, t2p, sph, b2, pdf_ok, inv_pdf,
           hit_light, hit_geo, le, t2s, sphn, dl3, res_dl, w)
    return out, res


def _rev_bounce(res, d_out, d_lightp, d_at2, num_spheres):
    """Adds the light's and the winner's cotangents to ``d_lightp`` and
    ``d_at2`` (lists); returns a dict of d_off, d_b2, d_sd, d_pdf_self,
    d_w."""
    (off, sd3, n2t, ok2, inv_sden2, t2p, sph, b2, pdf_ok, inv_pdf,
     hit_light, hit_geo, le, t2s, sphn, dl3, res_dl, w) = res
    zero = _zero(d_out[0])
    d_b2 = [zero, zero, zero]
    d_inv_pdf = zero
    d_w = zero
    d_dl = [zero, zero, zero]
    for c in range(3):
        d_lt = _w(hit_light, d_out[c])
        d_g = _w(hit_geo, d_out[c])
        d_b2[c] = d_b2[c] + inv_pdf * dl3[c] * d_g
        d_inv_pdf = d_inv_pdf + b2[c] * dl3[c] * d_g
        d_dl[c] = b2[c] * inv_pdf * d_g
        d_w = d_w + b2[c] * le[c] * inv_pdf * d_lt
        d_b2[c] = d_b2[c] + w * le[c] * inv_pdf * d_lt
        d_lightp[L_E + c] = d_lightp[L_E + c] + w * b2[c] * inv_pdf * d_lt
        d_inv_pdf = d_inv_pdf + w * b2[c] * le[c] * d_lt
    d_pdf_self = _w(pdf_ok, -(inv_pdf * inv_pdf) * d_inv_pdf)
    d_bp_t, d_n2, d_sd_dl, d_df2, d_met2, d_rgh2 = _rev_direct_light(
        res_dl, tuple(d_dl), d_lightp)
    d_bp = list(d_bp_t)
    d_sd = list(d_sd_dl)
    for c in range(3):
        d_at2[4 + c] = d_at2[4 + c] + d_df2[c]
    d_at2[7] = d_at2[7] + d_met2
    d_at2[8] = d_at2[8] + d_rgh2
    if num_spheres:
        sel, nv, qn, inv_n = sphn
        d_n2t = [_w(~sel, d_n2[c]) for c in range(3)]
        d_n2s = [_w(sel, d_n2[c]) for c in range(3)]
        d_nv = [d_n2s[c] * inv_n for c in range(3)]
        d_inv_n = nv[0] * d_n2s[0] + nv[1] * d_n2s[1] + nv[2] * d_n2s[2]
        d_qn = _w(qn >= 1e-6, -0.5 * inv_n * inv_n * inv_n * d_inv_n)
        for c in range(3):
            d_nv[c] = d_nv[c] + 2.0 * nv[c] * d_qn
            d_bp[c] = d_bp[c] + d_nv[c]
            d_at2[10 + c] = d_at2[10 + c] - d_nv[c]
    else:
        d_n2t = list(d_n2)
    d_off = list(d_bp)
    d_t2s = sd3[0] * d_bp[0] + sd3[1] * d_bp[1] + sd3[2] * d_bp[2]
    for c in range(3):
        d_sd[c] = d_sd[c] + t2s * d_bp[c]
    d_t2 = _w(hit_geo, d_t2s)
    if num_spheres:
        is_sph, oc, rad, a_q, b_q, c_q, posd, sq, t1, t2q, t1_ok = sph
        d_tsph = _w(is_sph, d_t2)
        d_t2p = _w(~is_sph, d_t2)
        d_t1 = _w(t1_ok, d_tsph)
        d_t2q = _w(~t1_ok, d_tsph)
        inv2a = 1.0 / (2.0 * a_q)
        d_b_q = -(d_t1 + d_t2q) * inv2a
        d_sq = (d_t2q - d_t1) * inv2a
        d_a_q = -(t1 * d_t1 + t2q * d_t2q) / a_q
        d_disc = _w(posd, d_sq / (2.0 * sq))
        d_b_q = d_b_q + 2.0 * b_q * d_disc
        d_a_q = d_a_q + (-4.0 * c_q * d_disc)
        d_c_q = -4.0 * a_q * d_disc
        d_at2[13] = d_at2[13] + (-2.0 * rad * d_c_q)
        for c in range(3):
            d_oc = 2.0 * oc[c] * d_c_q + 2.0 * sd3[c] * d_b_q
            d_sd[c] = d_sd[c] + 2.0 * oc[c] * d_b_q + 2.0 * sd3[c] * d_a_q
            d_off[c] = d_off[c] + d_oc
            d_at2[10 + c] = d_at2[10 + c] - d_oc
    else:
        d_t2p = d_t2
    d_num = d_t2p * inv_sden2
    d_sden = -(t2p * inv_sden2) * d_t2p
    d_den2 = _w(ok2, d_sden)
    d_at2[3] = d_at2[3] + d_num
    for c in range(3):
        d_off[c] = d_off[c] - n2t[c] * d_num
        d_n2t[c] = d_n2t[c] + sd3[c] * d_den2 - off[c] * d_num
        d_sd[c] = d_sd[c] + n2t[c] * d_den2
        d_at2[c] = d_at2[c] + d_n2t[c]
    return dict(d_off=d_off, d_b2=tuple(d_b2), d_sd=d_sd,
                d_pdf_self=d_pdf_self, d_w=d_w)


def _add(acc, base, values):
    for c, v in enumerate(values):
        acc[base + c] = acc[base + c] + v


def _apply_bv(d_cs, bv):
    """Route a ``_rev_bv`` result into the hoisted-plane cotangents."""
    _add(d_cs, CS_V, bv["d_v"])
    _add(d_cs, CS_NH, bv["d_n"])
    _add(d_cs, CS_DF, bv["d_df"])
    _add(d_cs, CS_F0, bv["d_f0"])
    for key, slot in (("d_rgh", CS_RGH), ("d_a", CS_ALPHA),
                      ("d_ndv", CS_CNDV), ("d_sqv", CS_CSQV),
                      ("d_omm", CS_OMM), ("d_g1", CS_G1),
                      ("d_vndv", CS_VNDV)):
        d_cs[slot] = d_cs[slot] + bv[key]


def _sample_fwd_rev(cs, lightp, tabsc, reach1, reach2, reach3, hit_c, at_c,
                    hit_v, at_v, surf, gs, s_per_f, d_cs, d_lightp, d_at_c,
                    d_at_v, num_spheres):
    """Forward recompute and hand-written reverse of one MIS sample, all
    three strategies. ``gs`` is the rgb cotangent already gated by ``surf``
    and divided by s_per; ``tabsc`` the sample's 16 table values. Adds into
    the ``d_*`` lists."""
    d3 = cs[CS_D:CS_D + 3]
    p3 = cs[CS_P:CS_P + 3]
    nh3 = cs[CS_NH:CS_NH + 3]
    t3 = cs[CS_T:CS_T + 3]
    b3 = cs[CS_B:CS_B + 3]
    ve3 = cs[CS_VE:CS_VE + 3]
    t1v3 = cs[CS_T1:CS_T1 + 3]
    t2v3 = cs[CS_T2:CS_T2 + 3]
    alpha = cs[CS_ALPHA]
    off3 = cs[CS_OFF:CS_OFF + 3]
    le = lightp[L_E:L_E + 3]

    # ---- strategy 1: the light rectangle, heuristic-weighted
    ld1, res_ls1 = _fwd_lsample(lightp, off3, tabsc[TAB_LU0], tabsc[TAB_LU1])
    pdf_l1, res_pl1 = _fwd_lightpdf(lightp, p3, ld1)
    b1, pdf_v1, res_bv1 = _fwd_bv(cs, ld1)
    pdf_c1, raw_pc1 = _fwd_cospdf(nh3, ld1)
    w1, res_w1 = _fwd_ph3(pdf_l1, pdf_c1, pdf_v1, s_per_f)
    inv_pdf1 = 1.0 / pdf_l1
    gate1 = surf & reach1
    zero = _zero(gs[0])
    d_w = zero
    d_invp = zero
    d_b1 = []
    for c in range(3):
        g = _w(gate1, gs[c])
        cpre = b1[c] * le[c] * inv_pdf1
        d_w = d_w + cpre * g
        d_cpre = w1 * g
        d_b1.append(le[c] * inv_pdf1 * d_cpre)
        d_lightp[L_E + c] = d_lightp[L_E + c] + b1[c] * inv_pdf1 * d_cpre
        d_invp = d_invp + b1[c] * le[c] * d_cpre
    d_pdf_l1 = -(inv_pdf1 * inv_pdf1) * d_invp
    d_pl, d_pc, d_pv = _rev_ph3(res_w1, d_w)
    d_pdf_l1 = d_pdf_l1 + d_pl
    d_n_pc, d_d_pc = _rev_cospdf(nh3, ld1, raw_pc1, d_pc)
    bv = _rev_bv(res_bv1, tuple(d_b1), d_pv)
    _apply_bv(d_cs, bv)
    d_q_pl, d_dir_pl = _rev_lightpdf(res_pl1, d_pdf_l1, d_lightp)
    d_ld = [bv["d_l"][c] + d_d_pc[c] + d_dir_pl[c] for c in range(3)]
    d_off1 = _rev_lsample(res_ls1, d_ld, d_lightp)
    _add(d_cs, CS_P, d_q_pl)
    _add(d_cs, CS_NH, d_n_pc)
    _add(d_cs, CS_OFF, d_off1)

    # ---- strategy 2: the cosine lobe
    w0, w1c, cth = tabsc[TAB_W0C], tabsc[TAB_W1C], tabsc[TAB_CTH]
    raw = tuple(t3[c] * w0 + b3[c] * w1c + nh3[c] * cth for c in range(3))
    cd3, res_cd = _fwd_norm3(*raw, 1e-12)
    pdf_c, raw_pc = _fwd_cospdf(nh3, cd3)
    pdf_l, res_pl = _fwd_lightpdf(lightp, p3, cd3)
    b2, pdf_v, res_bv = _fwd_bv(cs, cd3)
    w_c, res_w = _fwd_ph3(pdf_c, pdf_l, pdf_v, s_per_f)
    _, res_bo = _fwd_bounce(cs, lightp, at_c, hit_c, reach2, cd3, pdf_c, w_c,
                            tabsc[TAB_CSU0], tabsc[TAB_CSU1], surf, s_per_f,
                            num_spheres, b2)
    bo = _rev_bounce(res_bo, gs, d_lightp, d_at_c, num_spheres)
    d_cd = list(bo["d_sd"])
    d_p1, d_p2, d_p3v = _rev_ph3(res_w, bo["d_w"])
    d_pdf_c = bo["d_pdf_self"] + d_p1
    bv = _rev_bv(res_bv, bo["d_b2"], d_p3v)
    _apply_bv(d_cs, bv)
    d_q_pl, d_dir_pl = _rev_lightpdf(res_pl, d_p2, d_lightp)
    d_n_pc, d_d_pc = _rev_cospdf(nh3, cd3, raw_pc, d_pdf_c)
    for c in range(3):
        d_cd[c] = d_cd[c] + bv["d_l"][c] + d_dir_pl[c] + d_d_pc[c]
    d_raw = _rev_norm3(res_cd, *d_cd)
    _add(d_cs, CS_OFF, bo["d_off"])
    _add(d_cs, CS_NH, [d_n_pc[c] + cth * d_raw[c] for c in range(3)])
    _add(d_cs, CS_P, d_q_pl)
    _add(d_cs, CS_T, [w0 * d_raw[c] for c in range(3)])
    _add(d_cs, CS_B, [w1c * d_raw[c] for c in range(3)])

    # ---- strategy 3: the GGX visible-normal lobe
    k0, k1, vct = tabsc[TAB_K0V], tabsc[TAB_K1V], tabsc[TAB_VCT]
    hraw = tuple(t1v3[c] * k0 + t2v3[c] * k1 + ve3[c] * vct for c in range(3))
    h3, res_h = _fwd_norm3(*hraw, 1e-12)
    mz = torch.clamp_min(h3[2], 0.0)
    nl3, res_nl = _fwd_norm3(alpha * h3[0], alpha * h3[1], mz, 1e-12)
    whraw = tuple(t3[c] * nl3[0] + b3[c] * nl3[1] + nh3[c] * nl3[2]
                  for c in range(3))
    wh3, res_wh = _fwd_norm3(*whraw, 1e-12)
    ddh = d3[0] * wh3[0] + d3[1] * wh3[1] + d3[2] * wh3[2]
    vd3 = tuple(d3[c] - 2.0 * ddh * wh3[c] for c in range(3))
    b2v, pdf_v2, res_bv3 = _fwd_bv(cs, vd3)
    pdf_l2, res_pl3 = _fwd_lightpdf(lightp, p3, vd3)
    pdf_c2, raw_pc3 = _fwd_cospdf(nh3, vd3)
    w_v, res_w3 = _fwd_ph3(pdf_v2, pdf_l2, pdf_c2, s_per_f)
    _, res_bo3 = _fwd_bounce(cs, lightp, at_v, hit_v, reach3, vd3, pdf_v2,
                             w_v, tabsc[TAB_VSU0], tabsc[TAB_VSU1], surf,
                             s_per_f, num_spheres, b2v)
    bo = _rev_bounce(res_bo3, gs, d_lightp, d_at_v, num_spheres)
    d_vd = list(bo["d_sd"])
    d_p1, d_p2, d_p3v = _rev_ph3(res_w3, bo["d_w"])
    d_pdf_v2 = bo["d_pdf_self"] + d_p1
    d_n_pc, d_d_pc = _rev_cospdf(nh3, vd3, raw_pc3, d_p3v)
    d_q_pl, d_dir_pl = _rev_lightpdf(res_pl3, d_p2, d_lightp)
    bv = _rev_bv(res_bv3, bo["d_b2"], d_pdf_v2)
    _apply_bv(d_cs, bv)
    for c in range(3):
        d_vd[c] = d_vd[c] + d_d_pc[c] + d_dir_pl[c] + bv["d_l"][c]
    # vd = d - 2 ddh wh, ddh = d.wh
    d_ddh = -2.0 * (wh3[0] * d_vd[0] + wh3[1] * d_vd[1] + wh3[2] * d_vd[2])
    d_wh = [-2.0 * ddh * d_vd[c] + d3[c] * d_ddh for c in range(3)]
    d_d_loc = [d_vd[c] + wh3[c] * d_ddh for c in range(3)]
    d_whraw = _rev_norm3(res_wh, *d_wh)
    d_nl = [t3[0] * d_whraw[0] + t3[1] * d_whraw[1] + t3[2] * d_whraw[2],
            b3[0] * d_whraw[0] + b3[1] * d_whraw[1] + b3[2] * d_whraw[2],
            nh3[0] * d_whraw[0] + nh3[1] * d_whraw[1] + nh3[2] * d_whraw[2]]
    d_nraw = _rev_norm3(res_nl, *d_nl)
    d_cs[CS_ALPHA] = d_cs[CS_ALPHA] + (h3[0] * d_nraw[0] + h3[1] * d_nraw[1])
    d_h = (alpha * d_nraw[0], alpha * d_nraw[1],
           _w(h3[2] >= 0.0, d_nraw[2]))
    d_hraw = _rev_norm3(res_h, *d_h)
    _add(d_cs, CS_T1, [k0 * d_hraw[c] for c in range(3)])
    _add(d_cs, CS_T2, [k1 * d_hraw[c] for c in range(3)])
    _add(d_cs, CS_VE, [vct * d_hraw[c] for c in range(3)])
    _add(d_cs, CS_T, [nl3[0] * d_whraw[c] for c in range(3)])
    _add(d_cs, CS_B, [nl3[1] * d_whraw[c] for c in range(3)])
    _add(d_cs, CS_OFF, bo["d_off"])
    _add(d_cs, CS_D, d_d_loc)
    _add(d_cs, CS_NH, [d_n_pc[c] + nl3[2] * d_whraw[c] for c in range(3)])
    _add(d_cs, CS_P, d_q_pl)


def _sample_fwd(cs, lightp, tabsc, reach1, reach2, reach3, hit_c, at_c,
                hit_v, at_v, surf, s_per_f, num_spheres):
    """The rgb value of one MIS sample, three strategies, from the forwards
    alone: the function ``_sample_fwd_rev`` reverses."""
    d3 = cs[CS_D:CS_D + 3]
    p3 = cs[CS_P:CS_P + 3]
    nh3 = cs[CS_NH:CS_NH + 3]
    t3, b3 = cs[CS_T:CS_T + 3], cs[CS_B:CS_B + 3]
    le = lightp[L_E:L_E + 3]
    ld1, _ = _fwd_lsample(lightp, cs[CS_OFF:CS_OFF + 3], tabsc[TAB_LU0],
                          tabsc[TAB_LU1])
    pdf_l1, _ = _fwd_lightpdf(lightp, p3, ld1)
    b1, pdf_v1, _ = _fwd_bv(cs, ld1)
    pdf_c1, _ = _fwd_cospdf(nh3, ld1)
    w1, _ = _fwd_ph3(pdf_l1, pdf_c1, pdf_v1, s_per_f)
    inv_pdf1 = 1.0 / pdf_l1
    s1 = [_w(surf & reach1, b1[c] * le[c] * inv_pdf1 * w1) for c in range(3)]
    w0, w1c, cth = tabsc[TAB_W0C], tabsc[TAB_W1C], tabsc[TAB_CTH]
    cd3, _ = _fwd_norm3(*(t3[c] * w0 + b3[c] * w1c + nh3[c] * cth
                          for c in range(3)), 1e-12)
    pdf_c, _ = _fwd_cospdf(nh3, cd3)
    pdf_l, _ = _fwd_lightpdf(lightp, p3, cd3)
    b2, pdf_v, _ = _fwd_bv(cs, cd3)
    w_c, _ = _fwd_ph3(pdf_c, pdf_l, pdf_v, s_per_f)
    s2, _ = _fwd_bounce(cs, lightp, at_c, hit_c, reach2, cd3, pdf_c, w_c,
                        tabsc[TAB_CSU0], tabsc[TAB_CSU1], surf, s_per_f,
                        num_spheres, b2)
    t1v3, t2v3 = cs[CS_T1:CS_T1 + 3], cs[CS_T2:CS_T2 + 3]
    ve3, alpha = cs[CS_VE:CS_VE + 3], cs[CS_ALPHA]
    k0, k1, vct = tabsc[TAB_K0V], tabsc[TAB_K1V], tabsc[TAB_VCT]
    h3, _ = _fwd_norm3(*(t1v3[c] * k0 + t2v3[c] * k1 + ve3[c] * vct
                         for c in range(3)), 1e-12)
    nl3, _ = _fwd_norm3(alpha * h3[0], alpha * h3[1],
                        torch.clamp_min(h3[2], 0.0), 1e-12)
    wh3, _ = _fwd_norm3(*(t3[c] * nl3[0] + b3[c] * nl3[1] + nh3[c] * nl3[2]
                          for c in range(3)), 1e-12)
    ddh = d3[0] * wh3[0] + d3[1] * wh3[1] + d3[2] * wh3[2]
    vd3 = tuple(d3[c] - 2.0 * ddh * wh3[c] for c in range(3))
    b2v, pdf_v2, _ = _fwd_bv(cs, vd3)
    pdf_l2, _ = _fwd_lightpdf(lightp, p3, vd3)
    pdf_c2, _ = _fwd_cospdf(nh3, vd3)
    w_v, _ = _fwd_ph3(pdf_v2, pdf_l2, pdf_c2, s_per_f)
    s3, _ = _fwd_bounce(cs, lightp, at_v, hit_v, reach3, vd3, pdf_v2, w_v,
                        tabsc[TAB_VSU0], tabsc[TAB_VSU1], surf, s_per_f,
                        num_spheres, b2v)
    return tuple(s1[c] + s2[c] + s3[c] for c in range(3))


# ---------------------------------------------------------------------------
# The sample-invariant stage, forward and its reverse derived by hand
# ---------------------------------------------------------------------------

def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _fwd_hoist(at, cam, px, py, jx, jy, surf, f_w, f_h, num_spheres):
    """Everything of a camera ray that does not depend on the sample: the
    ray from the 12 camera scalars and the hash jitter, its hit from the
    recorded winner's plane (or sphere) — the closest-hit loop's expression,
    so the same t — the point normal of a sphere, the branching basis, the
    VNDF view frame, the offset origin and the camera-material BRDF/VNDF
    invariants. ``at`` is the winner's table column, ``f_w`` / ``f_h`` the
    frame size as 0-dim tensors (a true division). Returns (cs, res)."""
    pos, uh, vh, wv = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    s = ((px + jx) / f_w) * 2.0 - 1.0
    t = -(((py + jy) / f_h) * 2.0 - 1.0)
    d3, res_d = _fwd_norm3(*(s * uh[c] + t * vh[c] - wv[c]
                             for c in range(3)), 1e-12)
    nt = at[0:3]
    c0 = at[3]
    den = d3[0] * nt[0] + d3[1] * nt[1] + d3[2] * nt[2]
    ok = den.abs() >= 1e-12
    sden = torch.where(ok, den, 1.0)
    inv_sden = 1.0 / sden
    tt_p = (c0 - (pos[0] * nt[0] + pos[1] * nt[1] + pos[2] * nt[2])) / sden
    tt = tt_p
    sph = None
    if num_spheres:
        is_sph = at[14] > 0.5
        oc = tuple(pos[c] - at[10 + c] for c in range(3))
        rad = at[13]
        a_q = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
        b_q = 2.0 * (oc[0] * d3[0] + oc[1] * d3[1] + oc[2] * d3[2])
        c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - rad * rad
        disc = b_q * b_q - 4.0 * a_q * c_q
        posd = disc > 0.0
        sq = torch.sqrt(torch.where(posd, disc, 1.0))
        t1 = (-b_q - sq) / (2.0 * a_q)
        t2 = (-b_q + sq) / (2.0 * a_q)
        t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
        tt = torch.where(is_sph, torch.where(t1_ok, t1, t2), tt_p)
        sph = (is_sph, oc, rad, a_q, b_q, c_q, posd, sq, t1, t2, t1_ok)
    t_safe = _w(surf, tt)
    p3 = tuple(pos[c] + d3[c] * t_safe for c in range(3))
    nh3 = tuple(nt)
    sphn = None
    if num_spheres:
        sel = surf & sph[0]
        nv = tuple(p3[c] - at[10 + c] for c in range(3))
        qn = nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]
        inv_n = 1.0 / torch.sqrt(torch.clamp_min(qn, 1e-6))
        nh3 = tuple(torch.where(sel, nv[c] * inv_n, nt[c]) for c in range(3))
        sphn = (sel, nv, qn, inv_n)
    df3 = at[4:7]
    met, rgh = at[7], at[8]
    # Branching basis about the normal.
    use_y = nh3[0].abs() > 0.9
    ax = torch.where(use_y, 0.0, 1.0)
    ay = torch.where(use_y, 1.0, 0.0)
    an = ax * nh3[0] + ay * nh3[1]
    tg3, res_tg = _fwd_norm3(ax - an * nh3[0], ay - an * nh3[1],
                             -an * nh3[2], 1e-12)
    bt3 = _cross(nh3, tg3)
    v3 = tuple(-d3[c] for c in range(3))
    alpha = rgh * rgh
    vtx = v3[0] * tg3[0] + v3[1] * tg3[1] + v3[2] * tg3[2]
    vtb = v3[0] * bt3[0] + v3[1] * bt3[1] + v3[2] * bt3[2]
    vtn = v3[0] * nh3[0] + v3[1] * nh3[1] + v3[2] * nh3[2]
    ve3, res_ve = _fwd_norm3(alpha * vtx, alpha * vtb, vtn, 1e-12)
    t1v3, res_t1 = _fwd_norm3(ve3[2], ve3[2] * 0.0, -ve3[0], 1e-12)
    t2v3 = _cross(ve3, t1v3)
    cndv_raw = nh3[0] * v3[0] + nh3[1] * v3[1] + nh3[2] * v3[2]
    cndv = cndv_raw.abs() + 1e-5
    comm = 1.0 - met
    f03 = tuple(0.04 * comm + df3[c] * met for c in range(3))
    argv = (-cndv * alpha + cndv) * cndv + alpha
    csqv = torch.sqrt(torch.clamp_min(argv, 1e-12))
    vndv = cndv_raw.abs()
    g1v, res_g = _fwd_smith_g1(vndv, rgh)
    off3 = tuple(p3[c] + nh3[c] * 1e-4 for c in range(3))
    cs = (d3 + p3 + nh3 + tuple(df3) + (met, rgh) + tg3 + bt3 + ve3 + t1v3
          + t2v3 + (alpha,) + off3 + v3 + (cndv, csqv) + f03
          + (comm, g1v, vndv))
    res = (s, t, pos, res_d, d3, nt, ok, inv_sden, tt_p, sph, surf, t_safe,
           sphn, nh3, df3, met, rgh, ax, ay, an, res_tg, tg3, bt3, v3, alpha,
           vtx, vtb, res_ve, ve3, res_t1, t1v3, cndv_raw, cndv, argv, csqv,
           res_g, num_spheres)
    return cs, res


def _rev_hoist(res, d_cs):
    """Reverse of ``_fwd_hoist``: the 44 accumulated hoisted-plane
    cotangents to (d_at, the winner's table column, and d_cam12)."""
    (s, t, pos, res_d, d3, nt, ok, inv_sden, tt_p, sph, surf, t_safe,
     sphn, nh3, df3, met, rgh, ax, ay, an, res_tg, tg3, bt3, v3, alpha,
     vtx, vtb, res_ve, ve3, res_t1, t1v3, cndv_raw, cndv, argv, csqv,
     res_g, num_spheres) = res

    def part(base):
        return list(d_cs[base:base + 3])

    d_p = [d_cs[CS_P + c] + d_cs[CS_OFF + c] for c in range(3)]
    d_nh = [d_cs[CS_NH + c] + 1e-4 * d_cs[CS_OFF + c] for c in range(3)]
    d_vndv_g, d_rgh_g = _rev_smith_g1(res_g, d_cs[CS_G1])
    d_vndv = d_cs[CS_VNDV] + d_vndv_g
    d_rgh = d_cs[CS_RGH] + d_rgh_g
    d_argv = _w(argv >= 1e-12, 0.5 * (1.0 / csqv) * d_cs[CS_CSQV])
    d_cndv = d_cs[CS_CNDV] + 2.0 * cndv * (1.0 - alpha) * d_argv
    d_alpha = d_cs[CS_ALPHA] + (1.0 - cndv * cndv) * d_argv
    d_comm = d_cs[CS_OMM]
    d_met = d_cs[CS_MET]
    d_df = part(CS_DF)
    for c in range(3):
        d_f0 = d_cs[CS_F0 + c]
        d_comm = d_comm + 0.04 * d_f0
        d_df[c] = d_df[c] + met * d_f0
        d_met = d_met + df3[c] * d_f0
    d_met = d_met - d_comm
    d_craw = torch.sign(cndv_raw) * (d_cndv + d_vndv)
    d_v = [d_cs[CS_V + c] + nh3[c] * d_craw for c in range(3)]
    for c in range(3):
        d_nh[c] = d_nh[c] + v3[c] * d_craw
    # t2v = ve x t1v
    d_t2 = part(CS_T2)
    d_ve = [a + b for a, b in zip(part(CS_VE), _cross(t1v3, d_t2))]
    d_t1 = [a + b for a, b in zip(part(CS_T1), _cross(d_t2, ve3))]
    # t1v = norm3(ve.z, 0, -ve.x)
    d_r1 = _rev_norm3(res_t1, *d_t1)
    d_ve[2] = d_ve[2] + d_r1[0]
    d_ve[0] = d_ve[0] - d_r1[2]
    # ve = norm3(alpha vtx, alpha vtb, vtn)
    d_rv = _rev_norm3(res_ve, *d_ve)
    d_alpha = d_alpha + (vtx * d_rv[0] + vtb * d_rv[1])
    d_vtx = alpha * d_rv[0]
    d_vtb = alpha * d_rv[1]
    d_vtn = d_rv[2]
    d_tg = part(CS_T)
    d_bt = part(CS_B)
    for c in range(3):
        d_v[c] = d_v[c] + tg3[c] * d_vtx + bt3[c] * d_vtb + nh3[c] * d_vtn
        d_tg[c] = d_tg[c] + v3[c] * d_vtx
        d_bt[c] = d_bt[c] + v3[c] * d_vtb
        d_nh[c] = d_nh[c] + v3[c] * d_vtn
    d_rgh = d_rgh + 2.0 * rgh * d_alpha
    d_d = [d_cs[CS_D + c] - d_v[c] for c in range(3)]
    # bt = nh x tg
    d_nh = [a + b for a, b in zip(d_nh, _cross(tg3, d_bt))]
    d_tg = [a + b for a, b in zip(d_tg, _cross(d_bt, nh3))]
    # tg = norm3(a - an nh), an = a.nh
    d_tr = _rev_norm3(res_tg, *d_tg)
    d_an = -(nh3[0] * d_tr[0] + nh3[1] * d_tr[1] + nh3[2] * d_tr[2])
    for c in range(3):
        d_nh[c] = d_nh[c] - an * d_tr[c]
    d_nh[0] = d_nh[0] + ax * d_an
    d_nh[1] = d_nh[1] + ay * d_an
    zero = _zero(d_d[0])
    d_center = [zero, zero, zero]
    if num_spheres:
        sel, nv, qn, inv_n = sphn
        d_nt = [_w(~sel, d_nh[c]) for c in range(3)]
        d_ns = [_w(sel, d_nh[c]) for c in range(3)]
        d_inv_n = nv[0] * d_ns[0] + nv[1] * d_ns[1] + nv[2] * d_ns[2]
        d_qn = _w(qn >= 1e-6, -0.5 * inv_n * inv_n * inv_n * d_inv_n)
        for c in range(3):
            d_nv = d_ns[c] * inv_n + 2.0 * nv[c] * d_qn
            d_p[c] = d_p[c] + d_nv
            d_center[c] = d_center[c] - d_nv
    else:
        d_nt = d_nh
    # p = pos + d t_safe
    d_o = list(d_p)
    d_tsafe = d3[0] * d_p[0] + d3[1] * d_p[1] + d3[2] * d_p[2]
    for c in range(3):
        d_d[c] = d_d[c] + t_safe * d_p[c]
    d_tt = _w(surf, d_tsafe)
    d_rad = zero
    if num_spheres:
        is_sph, oc, rad, a_q, b_q, c_q, posd, sq, t1, t2, t1_ok = sph
        d_tsph = _w(is_sph, d_tt)
        d_ttp = _w(~is_sph, d_tt)
        d_t1 = _w(t1_ok, d_tsph)
        d_t2 = _w(~t1_ok, d_tsph)
        inv2a = 1.0 / (2.0 * a_q)
        d_b_q = -(d_t1 + d_t2) * inv2a
        d_sq = (d_t2 - d_t1) * inv2a
        d_a_q = -(t1 * d_t1 + t2 * d_t2) / a_q
        d_disc = _w(posd, d_sq / (2.0 * sq))
        d_b_q = d_b_q + 2.0 * b_q * d_disc
        d_a_q = d_a_q + (-4.0 * c_q * d_disc)
        d_c_q = -4.0 * a_q * d_disc
        d_rad = -2.0 * rad * d_c_q
        for c in range(3):
            d_oc = 2.0 * oc[c] * d_c_q + 2.0 * d3[c] * d_b_q
            d_d[c] = d_d[c] + 2.0 * oc[c] * d_b_q + 2.0 * d3[c] * d_a_q
            d_o[c] = d_o[c] + d_oc
            d_center[c] = d_center[c] - d_oc
    else:
        d_ttp = d_tt
    # tt_p = (c0 - pos.nt) / sden, den = d.nt
    d_num = d_ttp * inv_sden
    d_den = _w(ok, -(tt_p * inv_sden) * d_ttp)
    d_nt = list(d_nt)
    for c in range(3):
        d_o[c] = d_o[c] - nt[c] * d_num
        d_nt[c] = d_nt[c] + d3[c] * d_den - pos[c] * d_num
        d_d[c] = d_d[c] + nt[c] * d_den
    d_r = _rev_norm3(res_d, *d_d)
    d_cam = (d_o + [s * d_r[c] for c in range(3)]
             + [t * d_r[c] for c in range(3)] + [-d_r[c] for c in range(3)])
    d_at = d_nt + [d_num] + d_df + [d_met, d_rgh, zero]
    if num_spheres:
        d_at += d_center + [d_rad, zero]
    return d_at, d_cam


# ---------------------------------------------------------------------------
# K5: the backward kernel and its plain version
# ---------------------------------------------------------------------------

def _check_views(g, records, table, cam_vec, light_vec, stab, config, dev):
    """Shapes and types the backward takes; returns (n, P, num_spheres)."""
    f32, i32 = torch.float32, torch.int32
    n = g.shape[-1]
    s_per = config.mis_samples // 3
    ndif = table.shape[0]
    if ndif not in (NDIF, NDIF_SPH):
        raise ValueError(f"table: {ndif} rows, expected {NDIF} or {NDIF_SPH}")
    P = table.shape[1]
    _require(g, "g", f32, (3, n), dev)
    _require(records.camera, "records.camera", i32, (config.camera_rays, n),
             dev)
    _require(records.samples, "records.samples", i32,
             (config.camera_rays, s_per, n), dev)
    _require(table, "table", f32, (ndif, P), dev)
    _require(cam_vec, "cam_vec", f32, (NCAM,), dev)
    _require(light_vec, "light_vec", f32, (NLIGHT,), dev)
    _require(stab, "stab", f32, (NTAB_EXT, s_per), dev)
    return n, P, int(ndif == NDIF_SPH)


def mis_bwd_plain(g: torch.Tensor, records: MisRecords, table: torch.Tensor,
                  cam_vec: torch.Tensor, light_vec: torch.Tensor,
                  stab: torch.Tensor, config: RenderConfig, rid_base: int = 0):
    """Plain PyTorch version of ``mis_bwd_kernel`` on the same inputs: the
    kernel's sweep, in its order of operations, over [camera_rays, n] planes
    for the pixels [rid_base, rid_base + n). ``g`` [3, n] is the cotangent
    of the hdr (not divided by s_per), ``records`` the trace's, ``table``
    [10 | 15, P], ``cam_vec`` [12], ``light_vec`` [17], ``stab`` the
    [16, s_per] sample table. Returns (dtab [P, 10 | 15], dscal [29]: camera
    12, light 17); the selector columns of dtab are zero. Pixels go through
    in chunks of ``config.pixel_chunk``. The sums over lanes are taken in
    float64, as the kernel's second stage takes them: a frame sums millions
    of terms per primitive."""
    n, P, num_spheres = _check_views(g, records, table, cam_vec, light_vec,
                                     stab, config, g.device)
    ndif = table.shape[0]
    dtab = torch.zeros((P, ndif), dtype=torch.float64, device=g.device)
    dscal = torch.zeros(NSCAL, dtype=torch.float64, device=g.device)
    for s0 in range(0, n, config.pixel_chunk):
        s1 = min(n, s0 + config.pixel_chunk)
        sub = MisRecords(records.camera[:, s0:s1], records.samples[..., s0:s1])
        dscal = dscal + _plain_chunk(g[:, s0:s1], sub, table, cam_vec,
                                     light_vec, stab, config, rid_base + s0,
                                     num_spheres, dtab)
    return dtab.float(), dscal.float()


def _scatter(dtab, code, live, rows):
    """Add the rows [ndif] of the lanes in ``live`` to dtab at the recorded
    primitive (code = prim + 1); other lanes add nothing."""
    vals = torch.where(live[..., None], torch.stack(rows, dim=-1), 0.0)
    prim = torch.clamp(code.long() - 1, min=0)
    dtab.index_add_(0, prim.reshape(-1),
                    vals.reshape(-1, dtab.shape[1]).to(dtab.dtype))


def _fetch(table, code):
    """(hit, the recorded primitive's column as a list of planes). A miss
    reads column 0; every use of it is gated by ``hit``."""
    prim = code.long() - 1
    return prim >= 0, list(table[:, torch.clamp(prim, min=0)])


def _plain_chunk(g, records, table, cam_vec, light_vec, stab, config,
                 rid_base, num_spheres, dtab):
    f32 = torch.float32
    dev = g.device
    cr_n, s_per, n = records.samples.shape
    W, H = config.width, config.height
    rid = rid_base + torch.arange(n, dtype=torch.int64, device=dev)
    xi, yi = rid % W, rid // W
    jit = torch.stack([smp.hash_random_2d(xi, yi, cr) for cr in range(cr_n)])
    f_w = torch.tensor(float(W), dtype=f32, device=dev)
    f_h = torch.tensor(float(H), dtype=f32, device=dev)
    cam_hit, at_cam = _fetch(table, records.camera)
    isem = at_cam[9] > 0.5
    cam_hit_light = cam_hit & isem
    surf = cam_hit & ~isem
    cam = list(cam_vec)
    lightp = list(light_vec)
    cs, res_h = _fwd_hoist(at_cam, cam, xi.to(f32), yi.to(f32), jit[..., 0],
                           jit[..., 1], surf, f_w, f_h, num_spheres)
    inv_s = smp._f32(1.0 / s_per)
    gs = [_w(surf, g[c] * inv_s) for c in range(3)]
    zero = torch.zeros((cr_n, n), dtype=f32, device=dev)
    d_cs = [zero] * NCS
    d_lightp = [zero] * NLIGHT
    # A camera ray on the light adds the emitted radiance.
    for c in range(3):
        d_lightp[L_E + c] = _w(cam_hit_light, g[c].expand(cr_n, n))
    ndif = table.shape[0]
    for k in range(s_per):
        tabsc = list(stab[:, k])
        srec = records.samples[:, k]
        reach = [((srec >> b) & 1) == 1 for b in range(3)]
        code_c = (srec >> REC_SHIFT_C) & REC_CODE_MASK
        code_v = (srec >> REC_SHIFT_V) & REC_CODE_MASK
        hit_c, at_c = _fetch(table, code_c)
        hit_v, at_v = _fetch(table, code_v)
        d_at_c = [zero] * ndif
        d_at_v = [zero] * ndif
        _sample_fwd_rev(cs, lightp, tabsc, *reach, hit_c, at_c, hit_v, at_v,
                        surf, gs, float(s_per), d_cs, d_lightp, d_at_c,
                        d_at_v, num_spheres)
        _scatter(dtab, code_c, surf & hit_c, d_at_c)
        _scatter(dtab, code_v, surf & hit_v, d_at_v)
    d_at_cam, d_cam = _rev_hoist(res_h, d_cs)
    _scatter(dtab, records.camera, surf, d_at_cam)
    f64 = torch.float64
    return torch.stack([_w(surf, x).sum(dtype=f64) for x in d_cam]
                       + [x.sum(dtype=f64) for x in d_lightp])


def replay_mis(table: torch.Tensor, cam_vec: torch.Tensor,
               light_vec: torch.Tensor, records: MisRecords,
               stab: torch.Tensor, config: RenderConfig, rid_base: int = 0):
    """The raw accumulated hdr [3, n] recomputed from the MIS records (the
    trace's image up to the order of the last sums) as a function of the
    parameter views: the function whose reverse ``mis_bwd_plain`` and the
    kernel write out by hand, built from the forwards alone, for autograd to
    differentiate. Slow: it holds the graph of the whole sweep."""
    f32 = torch.float32
    dev = table.device
    cr_n, s_per, n = records.samples.shape
    W, H = config.width, config.height
    num_spheres = int(table.shape[0] == NDIF_SPH)
    rid = rid_base + torch.arange(n, dtype=torch.int64, device=dev)
    xi, yi = rid % W, rid // W
    jit = torch.stack([smp.hash_random_2d(xi, yi, cr) for cr in range(cr_n)])
    cam_hit, at_cam = _fetch(table, records.camera)
    isem = at_cam[9] > 0.5
    surf = cam_hit & ~isem
    lightp = list(light_vec)
    cs, _ = _fwd_hoist(at_cam, list(cam_vec), xi.to(f32), yi.to(f32),
                       jit[..., 0], jit[..., 1], surf,
                       torch.tensor(float(W), dtype=f32, device=dev),
                       torch.tensor(float(H), dtype=f32, device=dev),
                       num_spheres)
    m = [torch.zeros((cr_n, n), dtype=f32, device=dev)] * 3
    for k in range(s_per):
        srec = records.samples[:, k]
        reach = [((srec >> b) & 1) == 1 for b in range(3)]
        hit_c, at_c = _fetch(table, (srec >> REC_SHIFT_C) & REC_CODE_MASK)
        hit_v, at_v = _fetch(table, (srec >> REC_SHIFT_V) & REC_CODE_MASK)
        s = _sample_fwd(cs, lightp, list(stab[:, k]), *reach, hit_c, at_c,
                        hit_v, at_v, surf, float(s_per), num_spheres)
        m = [m[c] + s[c] for c in range(3)]
    inv_s = smp._f32(1.0 / s_per)
    per_ray = [_w(cam_hit & isem, lightp[L_E + c].expand(cr_n, n))
               + _w(surf, m[c] * inv_s) for c in range(3)]
    return torch.stack([x.sum(dim=0) for x in per_ray])


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library("mis_bwd_kernels").lib
    if lib.grt_mis_bwd.argtypes is None:
        lib.grt_mis_bwd.argtypes = [_PTR] * 9 + [_INT] * 10 + [_PTR]
        lib.grt_mis_bwd.restype = _INT
        lib.grt_mis_bwd_blocks.argtypes = [_INT, _INT]
        lib.grt_mis_bwd_blocks.restype = _INT
        lib.grt_mis_bwd_grouped_blocks.argtypes = [_INT] * 5
        lib.grt_mis_bwd_grouped_blocks.restype = _INT
        lib.grt_mis_bwd_grouped_smem.argtypes = [_INT] * 2
        lib.grt_mis_bwd_grouped_smem.restype = _INT
        lib.grt_mis_bwd_grouped_blocks_per_sm.argtypes = [_INT] * 2
        lib.grt_mis_bwd_grouped_blocks_per_sm.restype = _INT
        lib.grt_mis_bwd_static_smem.argtypes = [_INT] * 3
        lib.grt_mis_bwd_static_smem.restype = _INT
        lib.grt_mis_bwd_static_blocks_per_sm.argtypes = [_INT] * 3
        lib.grt_mis_bwd_static_blocks_per_sm.restype = _INT
    return lib


def mis_bwd_kernel(g: torch.Tensor, records: MisRecords, table: torch.Tensor,
                   cam_vec: torch.Tensor, light_vec: torch.Tensor,
                   stab: torch.Tensor, config: RenderConfig,
                   rid_base: int = 0, grouped: bool = False):
    """Launch ``mis_bwd_kernel`` on the card (``grouped``: its grouped tier,
    K5g, ``mis_bwd_grouped_kernel``). Same arguments and results as
    ``mis_bwd_plain``."""
    if g.device.type != "cuda":
        raise ValueError("mis_bwd_kernel needs CUDA tensors")
    dev = g.device
    n, P, num_spheres = _check_views(g, records, table, cam_vec, light_vec,
                                     stab, config, dev)
    ndif = table.shape[0]
    s_per = config.mis_samples // 3
    if grouped:
        grouped_smem_bytes(s_per, ndif)
    else:
        static_smem_bytes(s_per, P, ndif)
    if n < 1 or rid_base < 0 or rid_base + n > config.num_pixels:
        raise ValueError(
            f"pixel range [{rid_base}, {rid_base + n}) is not inside the "
            f"frame's {config.num_pixels} pixels")
    lib = _library()
    count = P * ndif + NSCAL
    with torch.cuda.device(dev):
        if grouped:
            blocks = lib.grt_mis_bwd_grouped_blocks(
                n, config.camera_rays, s_per, P, num_spheres)
            if blocks <= 0:
                raise RuntimeError("mis_bwd_grouped_kernel: the occupancy "
                                   "query failed")
            rows = blocks * _KERNEL_WARPS  # one table per warp
            table = table.T.contiguous()  # [P, ndif]
        else:
            blocks = rows = lib.grt_mis_bwd_blocks(n, config.camera_rays)
        partials = torch.empty((rows, count), dtype=torch.float32, device=dev)
        out = torch.empty(count, dtype=torch.float32, device=dev)
        code = lib.grt_mis_bwd(
            g.data_ptr(), records.camera.data_ptr(),
            records.samples.data_ptr(), table.data_ptr(), cam_vec.data_ptr(),
            light_vec.data_ptr(), stab.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n, int(rid_base), config.width, config.height,
            config.camera_rays, s_per, P, num_spheres, int(grouped), blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    name = "mis_bwd_grouped_kernel" if grouped else "mis_bwd_kernel"
    _raise_on_launch_error(code, name)
    LAUNCHES[name] += 1
    return out[:P * ndif].view(P, ndif), out[P * ndif:]


# ---------------------------------------------------------------------------
# Parameter views and the autograd glue
# ---------------------------------------------------------------------------

def _pack_diff_inputs_mis(scene: Scene, config: RenderConfig):
    """Differentiable packing of the views the backward differentiates:
    ``table`` [10, T] (or [15, T + S] with spheres), ``cam_vec`` [12] and
    ``light_vec`` [17] (the light's frame built here from its normal, as the
    forward's packing does). Gradients chain from them back to the scene.
    Column order is the record encoding's: triangles, then spheres."""
    f32 = torch.float32
    c = compile_scene(scene.triangles)
    rows = [c.n[:, 0], c.n[:, 1], c.n[:, 2], c.c0,
            c.diffuse[:, 0], c.diffuse[:, 1], c.diffuse[:, 2],
            c.metallic, c.roughness, c.is_emissive.to(f32)]
    sp = scene.spheres
    if sp.num_spheres:
        dev = c.n.device
        zt = torch.zeros(scene.triangles.num_triangles, dtype=f32, device=dev)
        zs = torch.zeros(sp.num_spheres, dtype=f32, device=dev)
        sph_rows = [zs, zs, zs, zs,
                    sp.diffuse[:, 0], sp.diffuse[:, 1], sp.diffuse[:, 2],
                    sp.metallic.reshape(-1), sp.roughness.reshape(-1),
                    (torch.linalg.norm(sp.emissive.detach(), dim=-1) > 0.0)
                    .to(f32)]
        rows = [torch.cat([a, b]) for a, b in zip(rows, sph_rows)]
        rows += [torch.cat([zt, sp.center[:, k]]) for k in range(3)]
        rows += [torch.cat([zt, sp.radius.reshape(-1)]),
                 torch.cat([zt, torch.ones_like(zs)])]
    light = scene.light
    lnorm = light.normal.to(f32)
    lt, lb = smp.build_orthonormal_basis(lnorm)
    light_vec = torch.cat([
        light.center.to(f32).reshape(-1),
        light.emitted_radiance.to(f32).reshape(-1),
        light.width.to(f32).reshape(1), light.depth.to(f32).reshape(1),
        lnorm.reshape(-1), lt.reshape(-1), lb.reshape(-1)])
    return (torch.stack(rows), camera_vector(scene.camera, config),
            light_vec)


class _AttachGradMis(torch.autograd.Function):
    """Forward: the MIS trace kernel's image, unchanged. Backward: one launch
    of the backward kernel (its grouped tier where the trace took it; the
    plain version for CPU tensors), giving the cotangents of (table, cam_vec,
    light_vec); the records and the sample table are constants. The
    cotangent goes in as it comes: the kernel divides by s_per itself, and
    hdr sums the camera rays."""

    @staticmethod
    def forward(ctx, config, rid_base, grouped, hdr, table, cam_vec,
                light_vec, cam_rec, samp_rec, stab):
        ctx.config, ctx.rid_base, ctx.grouped = config, rid_base, grouped
        ctx.save_for_backward(table, cam_vec, light_vec, cam_rec, samp_rec,
                              stab)
        return hdr.view_as(hdr)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, cam_vec, light_vec, cam_rec, samp_rec, stab = ctx.saved_tensors
        gs = g.reshape(-1, 3).T.contiguous()
        args = (gs, MisRecords(cam_rec, samp_rec), table.detach().contiguous(),
                cam_vec.detach().contiguous(), light_vec.detach().contiguous(),
                stab, ctx.config, ctx.rid_base)
        if gs.device.type == "cuda":
            dtab, dscal = mis_bwd_kernel(*args, grouped=ctx.grouped)
        else:
            dtab, dscal = mis_bwd_plain(*args)
        d_table = dtab.T.contiguous()
        d_table[9] = 0.0                     # is_emissive: a selector
        if table.shape[0] == NDIF_SPH:
            d_table[14] = 0.0                # is_sphere: a selector
        return (None, None, None, None, d_table, dscal[:NCAM], dscal[NCAM:],
                None, None, None)


def _render_fused(scene: Scene, config: RenderConfig, local_n, rid_base,
                  flat_output, occluders, device):
    device = resolve_device(device)
    scene = scene.to(device)
    # One tier for the trace and its backward; a frame without gradients
    # launches the trace alone and takes its tier.
    needs_grad = any(t.requires_grad for t in scene.tensors())
    grouped = (fused_tier(scene, config.mis_samples, occluders) if needs_grad
               else None)
    # The discrete decisions are constants of the gradient: trace a detached
    # copy, keep the graph for the parameter views only.
    hdr, rec = render_mis_cuda_impl(
        scene.detach(), config, emit_records=True, occluders=occluders,
        local_n=local_n, rid_base=rid_base, flat_output=flat_output,
        grouped=grouped, device=device)
    if not needs_grad:
        return hdr
    table, cam_vec, light_vec = _pack_diff_inputs_mis(scene, config)
    stab = sample_table(config).to(device).contiguous()
    return _AttachGradMis.apply(config, int(rid_base), grouped, hdr, table,
                                cam_vec, light_vec, rec.camera, rec.samples,
                                stab)


def render_mis_fused(scene: Scene, config: RenderConfig, occluders=None,
                     device="cuda") -> torch.Tensor:
    """Differentiable variant-A render at the trace kernel's speed: the MIS
    kernel's raw accumulated hdr [H, W, 3] with the record-replay backward
    kernel attached. Triangle and sphere scenes, any triangle count below
    the record encoding's limit (above 64 triangles, or where K4's or K5's
    static tables do not fit a block, both kernels take their grouped tier).
    ``occluders``: an
    ``intersect.potential_occluders(scene, config)`` tuple that culls the
    light probes; it is tied to the geometry it was computed from."""
    return _render_fused(scene, config, None, 0, False, occluders, device)


def render_mis_fused_local(scene: Scene, config: RenderConfig, local_n: int,
                           rid_base: int, occluders=None,
                           device="cuda") -> torch.Tensor:
    """The fused render of the pixel range [rid_base, rid_base + local_n):
    flat [local_n, 3] hdr with the backward attached. The gradients it gives
    the scene are this range's share; a sharded renderer sums them over the
    ranges."""
    return _render_fused(scene, config, local_n, rid_base, True, occluders,
                         device)


def render_mis_decoupled(scene: Scene, config: RenderConfig, occluders=None,
                         device="cuda") -> torch.Tensor:
    """Variant-A render through the record-emitting trace with the occluder
    cull, hdr [H, W, 3]; differentiable through the backward kernel. Its
    value is the forward-only trace's."""
    return render_mis_fused(scene, config, occluders=occluders, device=device)
