"""PyTorch port vs the JAX package: the module that holds the MIS backward
kernel (``ops/cuda_mis_bwd.py``), through its plain version on the CPU.

Three tiers, none of which runs the JAX package's interpret-mode kernel:

  * every forward/reverse pair, ``_sample_fwd_rev`` and the hoisted stage
    against ``torch.autograd`` of their own forward, on random
    well-conditioned planes: largest difference under 3e-3 of the largest
    magnitude, the bound of the JAX package's
    ``test_handwritten_reverse_helpers``;
  * the same pairs and ``_sample_fwd_rev`` against the JAX package's own
    ``_fwd_*`` / ``_rev_*`` / ``_sample_fwd_rev`` (pure ``jnp``) on the same
    numpy inputs: atol 1e-6, rtol 1e-5 (the two sides differ by an ulp of
    ``rsqrt`` against ``1 / sqrt`` and ``pow`` against four multiplies);
  * the whole sweep (``mis_bwd_plain``) against torch.autograd of
    ``replay_mis`` on the same records, the replay against the trace's
    image, the packing against ``_pack_diff_inputs_mis``, pixel ranges, and
    the entry points' contract. The gradients against ``jax.grad`` of the JAX
    oracle are in ``test_torch_mis_grad.py`` (its fixtures hold them).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.ops.pallas_mis_bwd as J
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import _build, cuda_mis, cuda_mis_bwd as M
from gpuraytracer_tpu_torch.scene import (cornell_box, cornell_box_glossy,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

SHP = (4, 8)
CFG = dict(width=16, height=8, integrator="mis", camera_rays=2,
           mis_samples=6, pixel_chunk=128)
HELPER_TOL = 3e-3
JAX_ATOL, JAX_RTOL = 1e-6, 1e-5


# ---------------------------------------------------------------------------
# Random planes, as numpy, handed to either package
# ---------------------------------------------------------------------------

class Planes:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def p(self, lo=0.0, hi=1.0):
        return self.rng.uniform(lo, hi, SHP).astype(np.float32)

    def v3(self):
        v = self.rng.normal(size=(3,) + SHP)
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        return tuple(v[i].astype(np.float32) for i in range(3))

    def b(self, p=0.5):
        return self.rng.random(SHP) > p

    def lightp(self):
        lc = [self.p(-0.5, 0.5), self.p(1.5, 2.0), self.p(-0.5, 0.5)]
        le = [self.p(5, 10) for _ in range(3)]
        return tuple(lc + le + [self.p(0.3, 0.8), self.p(0.3, 0.8)]
                     + list(self.v3()) + list(self.v3()) + list(self.v3()))

    def cs(self):
        """44 hoisted planes, consistent where the reverse relies on it."""
        d3, p3, nh3 = self.v3(), (self.p(-1, 1), self.p(0, 1),
                                  self.p(-1, 1)), self.v3()
        df3 = (self.p(), self.p(), self.p())
        met, rgh = self.p(0, 1), self.p(0.05, 1)
        alpha = rgh * rgh
        off3 = tuple(p3[c] + nh3[c] * np.float32(1e-4) for c in range(3))
        v3 = tuple(-d3[c] for c in range(3))
        raw = sum(nh3[c] * v3[c] for c in range(3))
        cndv = np.abs(raw) + np.float32(1e-5)
        comm = 1 - met
        f0 = tuple(np.float32(0.04) * comm + df3[c] * met for c in range(3))
        csqv = np.sqrt(np.maximum((-cndv * alpha + cndv) * cndv + alpha,
                                  1e-12))
        vndv = np.abs(raw)
        nv2 = np.maximum(vndv * vndv, 1e-12)
        g1 = 2 / (1 + np.sqrt(1 + alpha * alpha * (1 - nv2) / nv2))
        out = (d3 + p3 + nh3 + df3 + (met, rgh) + self.v3() + self.v3()
               + self.v3() + self.v3() + self.v3() + (alpha,) + off3 + v3
               + (cndv, csqv) + f0 + (comm, g1, vndv))
        return tuple(np.asarray(x, np.float32) for x in out)

    def at2(self, ns):
        at = list(self.v3()) + [self.p(-1, 1), self.p(), self.p(), self.p(),
                                self.p(0, 1), self.p(0.05, 1),
                                (self.rng.random(SHP) > 0.7).astype(np.float32)]
        if ns:
            at += [self.p(-1, 1), self.p(0, 1), self.p(-1, 1),
                   self.p(0.2, 0.6),
                   (self.rng.random(SHP) > 0.5).astype(np.float32)]
        return tuple(at)

    def tabsc(self):
        t = [np.float32(self.rng.uniform(0.05, 0.95)) for _ in range(10)]
        ph = 2.0 * math.pi * float(t[2])
        u1 = float(t[3])
        sth = math.sqrt(max(1.0 - u1, 0.0))
        vph = 2.0 * math.pi * float(t[6])
        ctm = 1.0 / math.sqrt(2.0)
        vct = ctm + (1.0 - ctm) * float(t[7])
        vst = math.sqrt(max(0.0, 1.0 - vct * vct))
        return t + [np.float32(x) for x in (
            math.cos(ph) * sth, math.sin(ph) * sth, math.sqrt(u1),
            math.cos(vph) * vst, math.sin(vph) * vst, vct)]


def to_torch(x, grad=False):
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(v, grad) for v in x)
    if isinstance(x, np.ndarray) and x.dtype == np.bool_:
        return torch.from_numpy(x)
    t = torch.tensor(np.asarray(x, np.float32))
    return t.requires_grad_(True) if grad else t


def to_jax(x):
    if isinstance(x, (tuple, list)):
        return type(x)(to_jax(v) for v in x)
    return jnp.asarray(x)


def leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in leaves(v)]
    return [x]


def route_bv(bv):
    """A ``_rev_bv`` dict as 44 hoisted-plane cotangents plus d_l."""
    got = [0.0] * M.NCS
    for key, slot in (("d_v", M.CS_V), ("d_n", M.CS_NH), ("d_df", M.CS_DF),
                      ("d_f0", M.CS_F0)):
        for c in range(3):
            got[slot + c] = bv[key][c]
    for key, slot in (("d_rgh", M.CS_RGH), ("d_a", M.CS_ALPHA),
                      ("d_ndv", M.CS_CNDV), ("d_sqv", M.CS_CSQV),
                      ("d_omm", M.CS_OMM), ("d_g1", M.CS_G1),
                      ("d_vndv", M.CS_VNDV)):
        got[slot] = bv[key]
    return got + list(bv["d_l"])


# ---------------------------------------------------------------------------
# The pairs. Each case makes (diff, fixed, cot) from a seed: differentiable
# inputs, the other inputs, output cotangents; ``run(mod, diff, fixed, cot)``
# returns (outputs, input cotangents in the order of leaves(diff)) with
# ``mod`` either package's module.
# ---------------------------------------------------------------------------

def _zeros_like_list(like, n):
    return [like * 0.0 for _ in range(n)]


def run_norm3(mod, diff, fixed, cot):
    out, res = mod._fwd_norm3(*diff, 1e-12)
    return list(out), list(mod._rev_norm3(res, *cot))


def run_dggx(mod, diff, fixed, cot):
    out, res = mod._fwd_dggx(*diff)
    return [out], list(mod._rev_dggx(res, cot[0]))


def run_smith_g1(mod, diff, fixed, cot):
    out, res = mod._fwd_smith_g1(*diff)
    return [out], list(mod._rev_smith_g1(res, cot[0]))


def run_brdf(mod, diff, fixed, cot):
    out, res = mod._fwd_brdf(*diff)
    return list(out), leaves(mod._rev_brdf(res, tuple(cot)))


def run_vndf(mod, diff, fixed, cot):
    out, res = mod._fwd_vndf(*diff)
    return [out], leaves(mod._rev_vndf(res, cot[0]))


def run_cospdf(mod, diff, fixed, cot):
    n3, d3 = diff
    out, raw = mod._fwd_cospdf(n3, d3)
    return [out], leaves(mod._rev_cospdf(n3, d3, raw, cot[0]))


def run_lightpdf(mod, diff, fixed, cot):
    lightp, q3, dir3 = diff
    out, res = mod._fwd_lightpdf(lightp, q3, dir3)
    d_lp = _zeros_like_list(q3[0], 17)
    d_q, d_dir = mod._rev_lightpdf(res, cot[0], d_lp)
    return [out], leaves(d_lp) + leaves(d_q) + leaves(d_dir)


def run_ph3(mod, diff, fixed, cot):
    out, res = mod._fwd_ph3(*diff, fixed[0])
    return [out], list(mod._rev_ph3(res, cot[0]))


def run_bv(mod, diff, fixed, cot):
    cs, l3 = diff
    out, pdf, res = mod._fwd_bv(cs, l3)
    bv = mod._rev_bv(res, tuple(cot[:3]), cot[3])
    return list(out) + [pdf], route_bv(bv)


def run_lsample(mod, diff, fixed, cot):
    lightp, o3 = diff
    out, res = mod._fwd_lsample(lightp, o3, *fixed)
    d_lp = _zeros_like_list(o3[0], 17)
    d_o = mod._rev_lsample(res, list(cot), d_lp)
    return list(out), leaves(d_lp) + leaves(d_o)


def run_direct_light(heuristic):
    def run(mod, diff, fixed, cot):
        lightp, q3, n3, inc3, df3, met, rgh = diff
        u0, u1, gate = fixed
        out, res = mod._fwd_direct_light(lightp, q3, n3, inc3, df3, met, rgh,
                                         u0, u1, gate, 2.0, heuristic)
        d_lp = _zeros_like_list(met, 17)
        grads = mod._rev_direct_light(res, tuple(cot), d_lp)
        return list(out), leaves(d_lp) + leaves(grads)
    return run


def run_bounce(ns):
    def run(mod, diff, fixed, cot):
        lightp, at2, off3, sd3, pdf_self, w, b2 = diff
        cs0, hit2, reach, surf, su0, su1 = fixed
        cs = list(cs0)
        cs[M.CS_OFF:M.CS_OFF + 3] = off3
        out, res = mod._fwd_bounce(cs, lightp, at2, hit2, reach, sd3,
                                   pdf_self, w, su0, su1, surf, 2.0, ns, b2)
        d_lp = _zeros_like_list(w, 17)
        d_at = _zeros_like_list(w, len(at2))
        bo = mod._rev_bounce(res, tuple(cot), d_lp, d_at, ns)
        return list(out), (leaves(d_lp) + leaves(d_at) + leaves(bo["d_off"])
                           + leaves(bo["d_sd"]) + [bo["d_pdf_self"], bo["d_w"]]
                           + leaves(bo["d_b2"]))
    return run


def make_case(name, seed=7):
    g = Planes(seed)
    if name == "norm3":
        return g.v3(), (), [g.p(-1, 1) for _ in range(3)]
    if name == "dggx":
        return (g.p(0.05, 0.95), g.p(0.05, 1)), (), [g.p(-1, 1)]
    if name == "smith_g1":
        return (g.p(0.05, 0.95), g.p(0.05, 1)), (), [g.p(-1, 1)]
    if name == "brdf":
        return ((g.v3(), g.v3(), (g.p(), g.p(), g.p()), g.p(), g.p(0.05, 1),
                 g.v3()), (), [g.p(-1, 1) for _ in range(3)])
    if name == "vndf":
        return (g.v3(), g.v3(), g.v3(), g.p(0.05, 1)), (), [g.p(-1, 1)]
    if name == "cospdf":
        return (g.v3(), g.v3()), (), [g.p(-1, 1)]
    if name == "lightpdf":
        return ((g.lightp(), (g.p(-1, 1), g.p(0, 1), g.p(-1, 1)),
                 tuple(-x for x in g.v3())), (), [g.p(-1, 1)])
    if name == "ph3":
        return ((g.p(0.1, 2), g.p(0.1, 2), g.p(0.1, 2)), (np.float32(2.0),),
                [g.p(-1, 1)])
    if name == "bv":
        return (g.cs(), g.v3()), (), [g.p(-1, 1) for _ in range(4)]
    if name == "lsample":
        return ((g.lightp(), (g.p(-1, 1), g.p(0, 1), g.p(-1, 1))),
                (np.float32(0.41), np.float32(0.13)),
                [g.p(-1, 1) for _ in range(3)])
    if name.startswith("direct_light"):
        return ((g.lightp(), (g.p(-1, 1), g.p(0, 1), g.p(-1, 1)), g.v3(),
                 g.v3(), (g.p(), g.p(), g.p()), g.p(), g.p(0.05, 1)),
                (np.float32(0.41), np.float32(0.13), g.b(0.3)),
                [g.p(-1, 1) for _ in range(3)])
    if name.startswith("bounce"):
        ns = int(name[-1])
        cs = g.cs()
        return ((g.lightp(), g.at2(ns), cs[M.CS_OFF:M.CS_OFF + 3], g.v3(),
                 g.p(0.1, 2), g.p(0, 1), (g.p(), g.p(), g.p())),
                (cs, g.b(0.3), g.b(0.4), g.b(0.3), np.float32(0.41),
                 np.float32(0.13)),
                [g.p(-1, 1) for _ in range(3)])
    raise KeyError(name)


RUNS = {
    "norm3": run_norm3, "dggx": run_dggx, "smith_g1": run_smith_g1,
    "brdf": run_brdf, "vndf": run_vndf, "cospdf": run_cospdf,
    "lightpdf": run_lightpdf, "ph3": run_ph3, "bv": run_bv,
    "lsample": run_lsample,
    "direct_light_heuristic": run_direct_light(True),
    "direct_light_plain": run_direct_light(False),
    "bounce_tri0": run_bounce(0), "bounce_sph1": run_bounce(1),
}


def close(name, got, want, tol=HELPER_TOL):
    got = np.stack([np.broadcast_to(np.asarray(g, np.float64), SHP)
                    for g in got])
    want = np.stack([np.broadcast_to(np.asarray(w, np.float64), SHP)
                     for w in want])
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert np.isfinite(got).all(), name
    assert err < tol, f"{name}: {err:.3e} of the largest magnitude"


def autograd_of(run, diff, fixed, cot):
    """(the hand-written input cotangents, torch.autograd's)."""
    diff_t = to_torch(diff, grad=True)
    outs, got = run(M, diff_t, to_torch(fixed), to_torch(cot))
    flat = leaves(diff_t)
    want = torch.autograd.grad(outs, flat, to_torch(cot), allow_unused=True)
    want = [torch.zeros(SHP) if w is None else w for w in want]
    got = [torch.zeros(SHP) if isinstance(x, float) else x.detach()
           for x in got]
    return got, want


@pytest.mark.parametrize("name", sorted(RUNS))
def test_reverse_pair_matches_autograd(name):
    diff, fixed, cot = make_case(name)
    got, want = autograd_of(RUNS[name], diff, fixed, cot)
    assert len(got) == len(want)
    close(name, got, want)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pair_matches_jax_package(name):
    diff, fixed, cot = make_case(name, seed=11)
    outs_t, grads_t = RUNS[name](M, to_torch(diff), to_torch(fixed),
                                 to_torch(cot))
    outs_j, grads_j = RUNS[name](J, to_jax(diff), to_jax(fixed), to_jax(cot))
    for what, a, b in (("outputs", outs_t, outs_j),
                       ("cotangents", grads_t, grads_j)):
        assert len(a) == len(b)
        for k, (x, y) in enumerate(zip(a, b)):
            x = np.broadcast_to(np.asarray(x, np.float32), SHP)
            y = np.broadcast_to(np.asarray(y, np.float32), SHP)
            np.testing.assert_allclose(x, y, atol=JAX_ATOL, rtol=JAX_RTOL,
                                       err_msg=f"{name} {what}[{k}]")


# ---------------------------------------------------------------------------
# One whole sample, both scene types
# ---------------------------------------------------------------------------

def sample_case(ns, seed):
    g = Planes(seed)
    diff = (g.cs(), g.lightp(), g.at2(ns), g.at2(ns))
    fixed = (g.b(0.4), g.b(0.4), g.b(0.4), g.b(0.3), g.b(0.3), g.b(0.3),
             g.tabsc())
    gs = tuple(g.p(-1, 1) for _ in range(3))
    return diff, fixed, gs


def sample_sweep(mod, diff, fixed, gs, ns):
    cs, lightp, at_c, at_v = diff
    reach1, reach2, reach3, hit_c, hit_v, surf, tabsc = fixed
    ndif = len(at_c)
    like = gs[0] * 0.0
    d_cs = [like] * M.NCS
    d_lp = [like] * 17
    d_atc = [like] * ndif
    d_atv = [like] * ndif
    mod._sample_fwd_rev(list(cs), list(lightp), list(tabsc), reach1, reach2,
                        reach3, hit_c, list(at_c), hit_v, list(at_v), surf,
                        gs, 2.0, d_cs, d_lp, d_atc, d_atv, ns)
    return d_cs + d_lp + d_atc + d_atv


def sample_primal(cs, lp, at_c, at_v, fixed, gs, ns):
    """sum(gs * one sample's three strategies), from the forwards alone."""
    reach1, reach2, reach3, hit_c, hit_v, surf, tabsc = fixed
    out = M._sample_fwd(cs, lp, tabsc, reach1, reach2, reach3, hit_c, at_c,
                        hit_v, at_v, surf, 2.0, ns)
    return sum((gs[c] * out[c]).sum() for c in range(3))


@pytest.mark.parametrize("ns", [0, 1])
def test_sample_sweep_matches_autograd(ns):
    diff, fixed, gs = sample_case(ns, seed=7)
    fixed_t, gs_t = to_torch(fixed), to_torch(gs)
    got = sample_sweep(M, to_torch(diff), fixed_t, gs_t, ns)
    diff_t = to_torch(diff, grad=True)
    flat = leaves(diff_t)
    want = torch.autograd.grad(sample_primal(*diff_t, fixed_t, gs_t, ns),
                               flat, allow_unused=True)
    want = [torch.zeros(SHP) if w is None else w for w in want]
    assert len(got) == len(want)
    sizes = (M.NCS, 17, len(diff[2]), len(diff[3]))
    start = 0
    for what, size in zip(("cs", "light", "at_c", "at_v"), sizes):
        close(f"sample{ns}.{what}", got[start:start + size],
              want[start:start + size])
        start += size


@pytest.mark.parametrize("ns", [0, 1])
def test_sample_sweep_matches_jax_package(ns):
    diff, fixed, gs = sample_case(ns, seed=13)
    got = sample_sweep(M, to_torch(diff), to_torch(fixed), to_torch(gs), ns)
    ref = sample_sweep(J, to_jax(diff), to_jax(fixed), to_jax(gs), ns)
    for k, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(
            np.broadcast_to(a.numpy(), SHP), np.broadcast_to(np.asarray(b),
                                                             SHP),
            atol=JAX_ATOL, rtol=JAX_RTOL, err_msg=f"sample{ns} [{k}]")


# ---------------------------------------------------------------------------
# The hoisted stage
# ---------------------------------------------------------------------------

def hoist_case(ns, seed):
    """A camera looking down -z, a triangle plane two units along each ray
    and (with spheres) a sphere of radius 0.5 three units along it."""
    g = Planes(seed)
    cam = np.array([0.1, 1.0, 3.5, 0.3, 0.01, 0.0, 0.0, 0.3, 0.02, 0.05,
                    -0.03, 1.0], np.float32)
    px = g.rng.integers(0, 16, SHP).astype(np.float32)
    py = g.rng.integers(0, 8, SHP).astype(np.float32)
    jx, jy = g.p(), g.p()
    s = ((px + jx) / 16) * 2 - 1
    t = -(((py + jy) / 8) * 2 - 1)
    r = np.stack([s * cam[3 + c] + t * cam[6 + c] - cam[9 + c]
                  for c in range(3)])
    d = r / np.linalg.norm(r, axis=0)
    n = -d + 0.3 * np.stack(g.v3())
    n /= np.linalg.norm(n, axis=0)
    hit = cam[:3, None, None] + 2.0 * d
    c0 = (n * hit).sum(axis=0)
    at = list(n) + [c0, g.p(), g.p(), g.p(), g.p(0, 1), g.p(0.05, 1),
                    np.zeros(SHP)]
    if ns:
        center = cam[:3, None, None] + 3.0 * d + 0.2 * np.stack(g.v3())
        at += list(center) + [np.full(SHP, 0.5), g.b(0.5).astype(float)]
    at = tuple(np.asarray(x, np.float32) for x in at)
    fixed = (px, py, jx, jy, g.b(0.2))
    d_cs = tuple(g.p(-1, 1) for _ in range(M.NCS))
    return at, tuple(cam), fixed, d_cs


def _hoist(at, cam, fixed, ns):
    px, py, jx, jy, surf = fixed
    return M._fwd_hoist(list(at), list(cam), px, py, jx, jy, surf,
                        torch.tensor(16.0), torch.tensor(8.0), ns)


@pytest.mark.parametrize("ns", [0, 1])
def test_hoist_reverse_matches_autograd(ns):
    at, cam, fixed, d_cs = hoist_case(ns, seed=5)
    fixed_t, d_cs_t = to_torch(fixed), to_torch(d_cs)
    at_t, cam_t = to_torch(at, grad=True), to_torch(cam, grad=True)
    cs, res = _hoist(at_t, cam_t, fixed_t, ns)
    assert len(cs) == M.NCS
    d_at, d_cam = M._rev_hoist(res, list(d_cs_t))
    want = torch.autograd.grad(cs, list(at_t) + list(cam_t), list(d_cs_t),
                               allow_unused=True)
    want = [torch.zeros(SHP) if w is None else w for w in want]
    assert len(d_at) == len(at) and len(d_cam) == M.NCAM
    close(f"hoist{ns}.at", [x.detach() for x in d_at], want[:len(at)])
    # The camera scalars broadcast over the planes: their cotangent is the
    # sum of the per-lane cotangents.
    got_cam = [x.detach().sum() for x in d_cam]
    want_cam = want[len(at):]
    scale = max(float(torch.stack(want_cam).abs().max()), 1e-6)
    err = float((torch.stack(got_cam) - torch.stack(want_cam)).abs().max())
    assert err / scale < HELPER_TOL, err / scale


@pytest.mark.parametrize("ns", [0, 1])
def test_hoist_replays_the_trace_kernels_surface(ns):
    """The hoisted point, normal and frame are the plain trace's expressions
    (``cuda_mis._plain_chunk``): equal bits on the rays of a frame."""
    scene = (cornell_box_with_spheres if ns else cornell_box)(
        resolution=(16, 8))
    cfg = RenderConfig(**CFG)
    _, rec = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                           device="cpu")
    table, cam, _ = M._pack_diff_inputs_mis(scene, cfg)
    hit, at = M._fetch(table, rec.camera)
    surf = hit & (at[9] < 0.5)
    rid = torch.arange(cfg.num_pixels)
    xi, yi = rid % 16, rid // 16
    jit = torch.stack([M.smp.hash_random_2d(xi, yi, cr) for cr in range(2)])
    cs, _ = M._fwd_hoist(at, list(cam), xi.float(), yi.float(), jit[..., 0],
                         jit[..., 1], surf, torch.tensor(16.0),
                         torch.tensor(8.0), ns)
    # The hit point lies on the recorded primitive: on its plane, or on the
    # sphere's surface.
    p = torch.stack(cs[M.CS_P:M.CS_P + 3])
    n = torch.stack(cs[M.CS_NH:M.CS_NH + 3])
    assert torch.allclose(n.norm(dim=0)[surf], torch.ones(()), atol=1e-6)
    if ns:
        is_sph = surf & (at[14] > 0.5)
        assert bool(is_sph.any())
        dist = (p - torch.stack(at[10:13])).norm(dim=0)
        assert torch.allclose(dist[is_sph], at[13][is_sph], atol=1e-5)
    plane = surf & (at[14] < 0.5) if ns else surf
    off = (n * p).sum(dim=0) - at[3]
    assert float(off[plane].abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# Packing, plain version, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctor", ["cornell_box", "cornell_box_with_spheres"])
def test_pack_diff_inputs_matches_jax(ctor):
    """Bit-equal to ``_pack_diff_inputs_mis``, but for rows n and c0 of the
    rotated boxes, an ulp apart (``compile_scene`` rounds in another
    order)."""
    jax_scene = getattr(jscene, ctor)(resolution=(16, 8))
    jcfg = jtypes.RenderConfig(**CFG)
    tab, cam, light = (np.asarray(x) for x in
                       J._pack_diff_inputs_mis(jax_scene, jcfg))
    scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))
    got = M._pack_diff_inputs_mis(scene, RenderConfig(**CFG))
    assert got[0].shape == tab.shape
    np.testing.assert_allclose(got[0][:4].numpy(), tab[:4], atol=2.5e-7,
                               rtol=0)
    np.testing.assert_array_equal(got[0][4:].numpy(), tab[4:])
    np.testing.assert_allclose(got[1].numpy(), cam.reshape(-1), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), light.reshape(-1))


def with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def grads(scene):
    return [None if t.grad is None else t.grad.clone()
            for t in scene.tensors()]


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres])
def test_pixel_ranges_sum_to_the_frame(ctor):
    """Two ranges of ``render_mis_fused_local`` (one not a multiple of the
    width) give the frame's image and, summed, its gradients: atol 1e-6 of
    the largest magnitude, rtol 1e-5."""
    cfg = RenderConfig(**CFG)
    base = ctor(resolution=(16, 8))
    weight = torch.from_numpy(np.random.default_rng(3).random(
        (cfg.num_pixels, 3)).astype(np.float32))
    whole = with_grad(base)
    hdr = M.render_mis_fused(whole, cfg, device="cpu")
    (hdr.reshape(-1, 3) * weight).sum().backward()
    parts = with_grad(base)
    cut = 3 * cfg.width + 5
    flat = []
    for rid_base, n in ((0, cut), (cut, cfg.num_pixels - cut)):
        out = M.render_mis_fused_local(parts, cfg, n, rid_base, device="cpu")
        assert out.shape == (n, 3)
        (out * weight[rid_base:rid_base + n]).sum().backward()
        flat.append(out.detach())
    assert torch.equal(torch.cat(flat), hdr.detach().reshape(-1, 3))
    n_checked = 0
    for a, b in zip(grads(parts), grads(whole)):
        assert (a is None) == (b is None)
        if a is not None:
            scale = max(float(b.abs().max()), 1.0)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * scale,
                                       rtol=1e-5)
            n_checked += 1
    assert n_checked >= 12


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres])
def test_decoupled_takes_gradients_and_keeps_its_value(ctor):
    """A scene that asks for gradients renders (no raise), bit-equal to the
    forward-only call and to the record-emitting trace; every gradient is
    finite and the selectors have none."""
    cfg = RenderConfig(**CFG)
    base = ctor(resolution=(16, 8))
    scene = with_grad(base)
    out = M.render_mis_decoupled(scene, cfg, device="cpu")
    assert out.requires_grad
    ref = M.render_mis_decoupled(base, cfg, device="cpu")
    assert not ref.requires_grad
    assert torch.equal(out.detach(), ref)
    trace, _ = cuda_mis.render_mis_cuda_impl(base, cfg, emit_records=True,
                                             device="cpu")
    assert torch.equal(ref, trace)
    out.mean().backward()
    got = [g for g in grads(scene) if g is not None]
    assert len(got) >= 12 and all(torch.isfinite(g).all() for g in got)
    assert float(scene.light.emitted_radiance.grad.abs().max()) > 0.0
    assert M.LAUNCHES == {"mis_bwd_kernel": 0, "mis_bwd_grouped_kernel": 0}


def _frame(ctor, **kw):
    cfg = RenderConfig(**dict(CFG, **kw))
    scene = ctor(resolution=cfg.resolution)
    hdr, rec = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                             device="cpu")
    views = [v.detach() for v in M._pack_diff_inputs_mis(scene, cfg)]
    return cfg, hdr, rec, views, cuda_mis.sample_table(cfg)


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres,
                                  cornell_box_glossy])
def test_replay_recomputes_the_trace_image(ctor):
    """``replay_mis`` on the trace's records gives the trace's image: atol
    2e-5 / rtol 1e-4 (the path-value tolerance; the same arithmetic, the
    last sums in another order)."""
    cfg, hdr, rec, views, stab = _frame(ctor)
    out = M.replay_mis(*views, rec, stab, cfg)
    np.testing.assert_allclose(out.T.reshape(hdr.shape).numpy(), hdr.numpy(),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres,
                                  cornell_box_glossy])
def test_plain_version_is_autograd_of_the_replay(ctor):
    """The whole hand-written sweep (hoisted stage, three strategies, the
    scatter of the winners' rows, the scalar sums) against torch.autograd of
    the replay on the same records and cotangent: atol 1e-6 max(scale, 1),
    rtol 1e-4 of a group's largest magnitude (the path-gradient tolerance)."""
    cfg, _, rec, views, stab = _frame(ctor, width=24, height=16,
                                      mis_samples=9)
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=(3, cfg.num_pixels)).astype(np.float32))
    dtab, dscal = M.mis_bwd_plain(g, rec, *views, stab, cfg)
    leaves_ = [v.clone().requires_grad_(True) for v in views]
    d_table, d_cam, d_light = torch.autograd.grad(
        (g * M.replay_mis(*leaves_, rec, stab, cfg)).sum(), leaves_)
    d_table[9] = 0.0
    if d_table.shape[0] == M.NDIF_SPH:
        d_table[14] = 0.0
    for got, want in ((dtab, d_table.T), (dscal[:12], d_cam),
                      (dscal[12:], d_light)):
        scale = float(want.abs().max())
        assert scale > 0.0
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-6 * max(scale, 1.0) + 1e-4 * scale,
                                   rtol=0)


def test_plain_version_in_pixel_chunks():
    """``mis_bwd_plain`` over pixel chunks equals it over the whole range up
    to the order of the sums (atol 1e-6 of the largest magnitude, rtol
    1e-5); the selector columns stay zero."""
    cfg = RenderConfig(**CFG)
    scene = cornell_box_with_spheres(resolution=(16, 8))
    _, rec = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                           device="cpu")
    table, cam, light = M._pack_diff_inputs_mis(scene, cfg)
    stab = cuda_mis.sample_table(cfg)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, cfg.num_pixels)).astype(np.float32))
    whole = M.mis_bwd_plain(g, rec, table, cam, light, stab, cfg)
    parts = M.mis_bwd_plain(g, rec, table, cam, light, stab,
                            cfg.replace(pixel_chunk=37))
    assert whole[0].shape == (table.shape[1], M.NDIF_SPH)
    assert whole[1].shape == (M.NSCAL,)
    assert not whole[0][:, 9].any() and not whole[0][:, 14].any()
    for a, b in zip(parts, whole):
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * scale,
                                   rtol=1e-5)


def test_wrappers_reject_what_the_kernel_does_not_take():
    cfg = RenderConfig(**CFG)
    scene = cornell_box(resolution=(16, 8))
    _, rec = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                           device="cpu")
    table, cam, light = M._pack_diff_inputs_mis(scene, cfg)
    stab = cuda_mis.sample_table(cfg)
    g = torch.zeros((3, cfg.num_pixels))
    for grouped in (False, True):
        with pytest.raises(ValueError, match="CUDA tensors"):
            M.mis_bwd_kernel(g, rec, table, cam, light, stab, cfg,
                             grouped=grouped)
    with pytest.raises(ValueError, match="stab"):
        M.mis_bwd_plain(g, rec, table, cam, light, stab[:, :1], cfg)
    with pytest.raises(ValueError, match="rows"):
        M.mis_bwd_plain(g, rec, table[:9], cam, light, stab, cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            M.render_mis_decoupled(scene, cfg)
    assert M.LAUNCHES == {"mis_bwd_kernel": 0, "mis_bwd_grouped_kernel": 0}


def test_kernel_source_is_registered_for_the_build():
    assert "mis_bwd_kernels" in _build.SOURCES
    text = (_build.CSRC_DIR / "mis_bwd_kernels.cu").read_text()
    assert "grt_mis_bwd" in text and "mis_bwd_kernel<" in text
    assert "mis_bwd_grouped_kernel<" in text
    assert '#include "reduce.cuh"' in text
    shade = (_build.CSRC_DIR / "shade_kernels.cu").read_text()
    assert '#include "reduce.cuh"' in shade
    assert "atomicAdd" not in text + shade
