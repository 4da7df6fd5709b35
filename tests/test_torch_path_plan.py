"""The variant-B trace pair's host-side plans on the CPU (K2, K2g).

K2's shadow probe takes a triangle test's divide, barycentrics and interval
test only where the two exact prefilters of ``ops/csrc/trace.cuh`` hold
(``any_triangle_filtered`` at t_min = 0 with the bound max(t_max, 1e-3),
mirrored by ``cuda_path.plane_ahead`` and ``cuda_path.plane_within``), and
stops at its first occluder. The same prefilters serve the closest-hit loop
``closest_triangle_filtered``; K2's closest hit and K2g's group loops keep
the exact tests, which were faster (``chip_smoke.py --split`` times both
with the prefilters), but the bounds of both kernels charge a test that
fails them the prefilter's operations alone. A prefilter may reject only tests that fail: so wherever the exact
test passes (float32 IEEE division on the CPU, the order of ``trace.cuh``),
both must hold. They are held to that at t_min = 0 on seeded float32 pairs
and bounds and on adversarial ones (signed zeros, subnormals, NaN,
infinities, bounds at or below 0 and below 1e-3, quotients one ulp either
side of 0 and of the bound); on the box scenes' triangle rows with seeded
rays, where plain mirrors of the prefiltered probe and closest-hit loops give
the exact loops' shadow bits, winners and distances bit for bit; and on the
tessellated box (1,002 triangles) through the grouped sweep, where a
mirror of the group loops with the prefilters gives
``cuda_path.closest_grouped``'s and ``occluded_grouped``'s results and
divides exactly the tests that their "passed" count (K2g's bound) counts.
The plain version's counts of the tests
that pass (``render_path_plain(stats=)``, read by ``chip_smoke.py``'s bounds
of K2 and K2g, which charge a failing test the prefilter's operations alone)
change no result.

``cuda_path.static_smem_bytes`` and ``grouped_smem_bytes`` mirror the C
sides' ``static_smem`` and ``grouped_smem`` (``ops/csrc/path_kernels.cu``,
exported as ``grt_path_static_smem`` and ``grt_path_grouped_smem``;
``chip_smoke.py`` holds each against its mirror on the card). They are held
against the C formulas with the numbers written out, at the shapes of paths
A-E, J, K and L and past the most one block may use. No kernel runs.
"""
import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.intersect import (RAY_TMAX, RAY_TMIN,
                                              compile_scene,
                                              potential_occluders,
                                              triangle_candidates)
from gpuraytracer_tpu_torch.ops import cuda_path
from gpuraytracer_tpu_torch.ops.cuda_path import GROUP, SUPER
from gpuraytracer_tpu_torch.render import pixel_rng_offsets
from gpuraytracer_tpu_torch.scene import (cornell_box,
                                          cornell_box_tessellated,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

F32 = np.float32
LIMIT = 227 * 1024  # one block's most on sm_90
TINY = float(np.finfo(F32).smallest_subnormal)


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def one_ulp(x, up):
    return float(np.nextafter(F32(x), F32(np.inf if up else -np.inf)))


def probe_filter(den, num, t_max):
    """The any-hit loops' prefilter: both conditions, the bound
    max(t_max, 1e-3) (``any_triangle_filtered``)."""
    t_far = torch.clamp_min(t_max, float(F32(1e-3)))
    return (cuda_path.plane_ahead(den, num)
            & cuda_path.plane_within(den, num, t_far))


def probe_passes(den, num, t_max):
    """The (num, den) part of the exact probe test at t_min = 0: |den| >=
    1e-12 and 0 < num / den < t_max in float32 (the barycentrics only reject
    more)."""
    tt = num / den
    return (den.abs() >= 1e-12) & (tt > 0.0) & (tt < t_max)


def seeded_probe_tests(n=200_000):
    rng = np.random.default_rng(10)
    mag = 10.0 ** rng.uniform(-45, 38, size=(2, n))
    sign = rng.choice([-1.0, 1.0], size=(2, n))
    num, den = (mag * sign).astype(F32)
    num[rng.random(n) < 0.02] = 0.0
    near = rng.random(n) < 0.05
    den[near] = (F32(1e-12) * rng.uniform(0.5, 2.0, near.sum())
                 * rng.choice([-1.0, 1.0], near.sum())).astype(F32)
    # Bounds from -1 to 1e3, a share of them at or below 0 and below 1e-3.
    t_max = (10.0 ** rng.uniform(-6, 3, n)).astype(F32)
    t_max[rng.random(n) < 0.1] *= -1.0
    t_max[rng.random(n) < 0.02] = 0.0
    # A third of the quotients near the bound, so that both sides are hit.
    close = rng.random(n) < 0.33
    with np.errstate(over="ignore"):
        num[close] = (t_max[close] * rng.uniform(0.99, 1.01, close.sum())
                      * den[close]).astype(F32)
    return (torch.from_numpy(num), torch.from_numpy(den),
            torch.from_numpy(t_max))


def adversarial_probe_tests():
    """Signed zeros, subnormals, NaN and infinities against each other;
    bounds at +-0, below 0, at 1e-45, below and at 1e-3 and above it; and
    quotients one ulp either side of 0 and of each bound."""
    nan, inf = float("nan"), float("inf")
    special = [0.0, -0.0, TINY, -TINY, 1e-40, -1e-40, 1e-38, nan, inf, -inf,
               1.0, -1.0, 1e30, -1e30, 1e-12, -1e-12, one_ulp(1e-12, False),
               -one_ulp(1e-12, True)]
    bounds = [0.0, -0.0, -1e-3, -1.0, TINY, 1e-6, one_ulp(1e-3, False),
              float(F32(1e-3)), one_ulp(1e-3, True), 0.37, 999.0, inf, nan]
    nums, dens, t_maxes = [], [], []
    for t in bounds:
        for a in special:
            for b in special:
                nums.append(a)
                dens.append(b)
                t_maxes.append(t)
        for den in (1.0, -1.0, 3.0, -0.7, 1e-12, -1e-12, 1e20, -1e30, 1e38):
            for q in (0.0, TINY, -TINY, t, one_ulp(t, False),
                      one_ulp(t, True)):
                with np.errstate(over="ignore", invalid="ignore"):
                    num = F32(q) * F32(den)
                    near = (num, np.nextafter(num, F32(np.inf)),
                            np.nextafter(num, F32(-np.inf)))
                for v in near:
                    nums.append(float(v))
                    dens.append(den)
                    t_maxes.append(t)
    return f32(nums), f32(dens), f32(t_maxes)


@pytest.mark.parametrize("source", ["seeded", "adversarial"])
def test_probe_prefilter_rejects_only_failing_tests(source):
    num, den, t_max = (seeded_probe_tests() if source == "seeded"
                       else adversarial_probe_tests())
    passes = probe_passes(den, num, t_max)
    kept = probe_filter(den, num, t_max)
    assert passes.any() and (~kept).any()
    missed = passes & ~kept
    assert not missed.any(), list(zip(num[missed][:5].tolist(),
                                      den[missed][:5].tolist(),
                                      t_max[missed][:5].tolist()))


def test_probe_bounds_at_or_below_zero_pass_nothing():
    # t_max <= 0 (a light sample nearer than 1e-3): the exact test fails
    # everywhere; the prefilter, bounded at 1e-3, may keep some, which the
    # interval test then rejects.
    num, den, _ = seeded_probe_tests(50_000)
    for t in (0.0, -0.0, -1e-3, -TINY):
        t_max = torch.full_like(num, t)
        assert not probe_passes(den, num, t_max).any()
    # A quotient just below 1e-3 passes the prefilter at any t_max below it.
    den = f32([1.0])
    num = f32([one_ulp(1e-3, False)])
    assert probe_filter(den, num, f32([-1.0])).item()


def test_probe_prefilter_at_zero_quotients():
    # num / den rounds to +0 (tt > 0 fails), to the smallest subnormal, or
    # its sign differs: only the positive quotient may pass.
    den = f32([1.0, 1.0, 1e30, -1.0, 1.0])
    num = f32([0.0, TINY, TINY, TINY, -0.0])
    t_max = f32([1.0] * 5)
    assert probe_passes(den, num, t_max).tolist() == [False, True, False,
                                                     False, False]
    assert probe_filter(den, num, t_max).tolist() == [False, True, True,
                                                     False, False]


# ---------------------------------------------------------------------------
# The loops on the box scenes
# ---------------------------------------------------------------------------

def seeded_rays(tris, n, seed):
    """Half the origins inside the box, half on its triangles one 1e-3 step
    off along the normal (as the hit points of a probe start), on either
    side; seeded unit directions."""
    scene = compile_scene(tris)
    rng = np.random.default_rng(seed)
    inside = rng.uniform(-2.4, 2.4, (n // 2, 3))
    k = rng.integers(0, tris.verts.shape[0], n - n // 2)
    a, b = rng.uniform(0.0, 0.5, (2, n - n // 2))
    v = tris.verts.numpy().astype(np.float64)
    on = (v[k, 0] + a[:, None] * (v[k, 1] - v[k, 0])
          + b[:, None] * (v[k, 2] - v[k, 0])
          + 1e-3 * rng.choice([-1.0, 1.0], (n - n // 2, 1))
          * scene.n.numpy()[k])
    origin = torch.from_numpy(np.concatenate([inside, on]).astype(F32))
    direction = torch.from_numpy(rng.normal(size=(n, 3)).astype(F32))
    direction = direction / direction.norm(dim=-1, keepdim=True)
    return scene, origin, direction


def loop_terms(scene, o, d):
    """Per (ray, triangle): den, num and the barycentric dot products, in
    trace.cuh's order."""
    rows = (scene.n, scene.c0, scene.s1, scene.c1, scene.s2, scene.c2)
    den, num = cuda_path.plane_terms(rows, o, d)

    def dots(s, c):
        return ((o[:, 0:1] * s[:, 0] + o[:, 1:2] * s[:, 1]
                 + o[:, 2:3] * s[:, 2]),
                (d[:, 0:1] * s[:, 0] + d[:, 1:2] * s[:, 1]
                 + d[:, 2:3] * s[:, 2]), c)

    return den, num, dots(scene.s1, scene.c1), dots(scene.s2, scene.c2)


def inside(den, num, s1, s2, k, t_min, t_max):
    """trace.cuh's plane_hit and triangle_inside for triangle k: (tt, hit)."""
    tt = num[:, k] / den[:, k]
    u = s1[0][:, k] + tt * s1[1][:, k] - s1[2][k]
    v = s2[0][:, k] + tt * s2[1][:, k] - s2[2][k]
    hit = ((den[:, k].abs() >= 1e-12) & (tt > t_min) & (tt < t_max)
           & (u >= 0) & (v >= 0) & (u + v <= 1))
    return tt, hit


def closest_loop(terms, filtered):
    """closest_triangle (or, ``filtered``, closest_triangle_filtered) over
    every triangle in index order, vectorized over rays: (t_best, prim,
    tests that reach the divide)."""
    den, num, s1, s2 = terms
    n, T = num.shape
    t_best = torch.full((n,), 1e30, dtype=torch.float32)
    prim = torch.full((n,), -1, dtype=torch.int64)
    t_min, t_max = float(F32(RAY_TMIN)), float(F32(RAY_TMAX))
    divided = 0
    for k in range(T):
        go = torch.ones(n, dtype=torch.bool)
        if filtered:
            go = (cuda_path.plane_ahead(den[:, k], num[:, k])
                  & cuda_path.plane_within(den[:, k], num[:, k],
                                           torch.clamp_max(t_best, t_max)))
        divided += int(go.sum())
        tt, hit = inside(den, num, s1, s2, k, t_min, t_max)
        won = go & hit & (tt < t_best)
        t_best = torch.where(won, tt, t_best)
        prim = torch.where(won, k, prim)
    return t_best, prim, divided


def probe_loop(terms, t_max, filtered):
    """occluded's triangle loop (or, ``filtered``, any_triangle_filtered's,
    which stops at the first occluder) at t_min = 0: (occluded, tests that
    reach the divide)."""
    den, num, s1, s2 = terms
    n, T = num.shape
    occ = torch.zeros(n, dtype=torch.bool)
    divided = 0
    for k in range(T):
        go = ~occ if filtered else torch.ones(n, dtype=torch.bool)
        if filtered:
            go &= probe_filter(den[:, k], num[:, k], t_max)
        divided += int(go.sum())
        _, hit = inside(den, num, s1, s2, k, 0.0, t_max)
        occ |= go & hit
    return occ, divided


@pytest.mark.parametrize("scene_fn", [cornell_box, cornell_box_with_spheres])
def test_prefiltered_closest_hit_is_the_exact_loop(scene_fn):
    tris = scene_fn(resolution=(8, 8)).triangles
    scene, o, d = seeded_rays(tris, 4096, 21)
    terms = loop_terms(scene, o, d)
    t_exact, p_exact, all_tests = closest_loop(terms, False)
    t_filt, p_filt, divided = closest_loop(terms, True)
    assert (p_exact >= 0).any()
    assert torch.equal(p_exact, p_filt) and torch.equal(t_exact, t_filt)
    # And the plain version's candidate test gives the same winners.
    t_c, valid = triangle_candidates(scene.n, scene.c0, scene.s1, scene.c1,
                                     scene.s2, scene.c2, o, d, RAY_TMIN,
                                     RAY_TMAX)
    t_min, k_min = torch.where(valid, t_c, torch.full_like(t_c, 1e30)).min(-1)
    assert torch.equal(torch.where(t_min < 5e29, k_min, -1), p_exact)
    assert divided < 0.5 * all_tests


@pytest.mark.parametrize("scene_fn", [cornell_box, cornell_box_with_spheres])
def test_prefiltered_probe_is_the_exact_loop(scene_fn):
    """Probes from the seeded points toward seeded targets: t_max is the
    distance less 1e-3, so some targets within 1e-3 give t_max <= 0; the
    shadow bits of the early-exit prefiltered loop are the exact loop's."""
    tris = scene_fn(resolution=(8, 8)).triangles
    scene, o, _ = seeded_rays(tris, 4096, 22)
    rng = np.random.default_rng(23)
    target = rng.uniform(-2.5, 2.5, (o.shape[0], 3)).astype(F32)
    near = rng.random(o.shape[0]) < 0.1
    target[near] = (o.numpy()[near]
                    + rng.normal(size=(near.sum(), 3)) * 4e-4).astype(F32)
    tl = torch.from_numpy(target) - o
    ldist = tl.norm(dim=-1)
    d = tl / torch.clamp_min(ldist, 1e-3)[:, None]
    t_max = ldist - 1e-3
    assert (t_max <= 0).any() and (t_max > 1).any()
    terms = loop_terms(scene, o, d)
    occ_exact, all_tests = probe_loop(terms, t_max, False)
    occ_filt, divided = probe_loop(terms, t_max, True)
    assert occ_exact.any() and (~occ_exact).any()
    assert torch.equal(occ_exact, occ_filt)
    _, blocked = triangle_candidates(scene.n, scene.c0, scene.s1, scene.c1,
                                     scene.s2, scene.c2, o, d, 0.0, t_max)
    assert torch.equal(blocked.any(dim=-1), occ_exact)
    assert divided < 0.5 * all_tests


# ---------------------------------------------------------------------------
# The prefiltered group loops through the grouped sweep
# ---------------------------------------------------------------------------

def group_terms(geo, base, top, o, d):
    rows = cuda_path._geo_rows(geo[:, base:top])
    den, num = cuda_path.plane_terms(rows, o, d)

    def dots(s, c):
        return ((o[:, 0:1] * s[:, 0] + o[:, 1:2] * s[:, 1]
                 + o[:, 2:3] * s[:, 2]),
                (d[:, 0:1] * s[:, 0] + d[:, 1:2] * s[:, 1]
                 + d[:, 2:3] * s[:, 2]), c)

    return den, num, dots(rows[2], rows[3]), dots(rows[4], rows[5])


def closest_grouped_filtered(g, o, d):
    """closest_grouped with the prefilters in its group loop (the loop
    ``chip_smoke.py --split`` builds into K2g): the same box tests, each
    group's triangles one by one with the prefilters. Returns (t_best, prim, tests that reach the
    divide)."""
    n = o.shape[0]
    t_best = torch.full((n,), 1e30, dtype=torch.float32)
    prim = torch.full((n,), -1, dtype=torch.int64)
    inv = cuda_path._safe_inv(d)
    every = torch.arange(n)
    t_min, t_max = float(F32(RAY_TMIN)), float(F32(RAY_TMAX))
    divided = 0

    def far(lanes):
        return torch.clamp_max(t_best[lanes] * (1.0 + cuda_path.T_FAR_SLACK)
                               + cuda_path.T_FAR_SLACK, RAY_TMAX)

    for sg in range(g.sup.shape[1]):
        lanes = every[cuda_path._slab_reach(g.sup[:, sg], o, inv, far(every))]
        for gi in range(sg * SUPER, (sg + 1) * SUPER):
            reach = lanes[cuda_path._slab_reach(g.aabb[:, gi], o[lanes],
                                                inv[lanes], far(lanes))]
            base, top = gi * GROUP, min((gi + 1) * GROUP, g.num_tris)
            if not reach.numel() or top <= base:
                continue
            den, num, s1, s2 = group_terms(g.geo, base, top, o[reach],
                                           d[reach])
            tb, pr = t_best[reach], prim[reach]
            for j in range(top - base):
                go = (cuda_path.plane_ahead(den[:, j], num[:, j])
                      & cuda_path.plane_within(den[:, j], num[:, j],
                                               torch.clamp_max(tb, t_max)))
                divided += int(go.sum())
                tt, hit = inside(den, num, s1, s2, j, t_min, t_max)
                won = go & hit & (tt < tb)
                tb = torch.where(won, tt, tb)
                pr = torch.where(won, base + j, pr)
            t_best[reach], prim[reach] = tb, pr
    return t_best, prim, divided


def occluded_grouped_filtered(g, h, ld, t_max):
    """occluded_grouped with the prefilters in its group loop at t_min = 0:
    (occluded, tests that reach the divide)."""
    n = h.shape[0]
    occ = torch.zeros(n, dtype=torch.bool)
    inv = cuda_path._safe_inv(ld)
    t_seg = t_max * (1.0 + cuda_path.T_FAR_SLACK) + cuda_path.T_FAR_SLACK
    every = torch.arange(n)
    divided = 0
    for sg in range(g.shadow_sup.shape[1]):
        open_ = every[~occ]
        lanes = open_[cuda_path._slab_reach(g.shadow_sup[:, sg], h[open_],
                                            inv[open_], t_seg[open_])]
        for gi in range(sg * SUPER, (sg + 1) * SUPER):
            lanes = lanes[~occ[lanes]]
            reach = lanes[cuda_path._slab_reach(g.shadow_aabb[:, gi],
                                                h[lanes], inv[lanes],
                                                t_seg[lanes])]
            base, top = gi * GROUP, min((gi + 1) * GROUP, g.num_shadow)
            if not reach.numel() or top <= base:
                continue
            den, num, s1, s2 = group_terms(g.shadow_geo, base, top, h[reach],
                                           ld[reach])
            hit_any = torch.zeros(reach.numel(), dtype=torch.bool)
            for j in range(top - base):
                go = ~hit_any & probe_filter(den[:, j], num[:, j],
                                             t_max[reach])
                divided += int(go.sum())
                _, hit = inside(den, num, s1, s2, j, 0.0, t_max[reach])
                hit_any |= go & hit
            occ[reach] = hit_any
    return occ, divided


@pytest.fixture(scope="module")
def tessellated():
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=1)
    scene = cornell_box_tessellated(resolution=cfg.resolution,
                                    wall_subdiv=6, sphere_subdiv=2)
    assert scene.triangles.num_triangles == 1002
    occluders = potential_occluders(scene, cfg)
    packed = cuda_path._pack_inputs(scene, cfg, True, occluders)
    return scene, packed.grouped


def test_grouped_prefiltered_closest_hit(tessellated):
    scene, g = tessellated
    _, o, d = seeded_rays(scene.triangles, 1024, 31)
    stats = {}
    t_exact, p_exact = cuda_path.closest_grouped(g, o, d, stats=stats,
                                                passes=True)
    t_filt, p_filt, divided = closest_grouped_filtered(g, o, d)
    assert (p_exact >= 0).sum() > 0.5 * o.shape[0]
    assert torch.equal(p_exact, p_filt) and torch.equal(t_exact, t_filt)
    # The plain sweep's count of passes is the mirror's count of divides.
    assert stats["passed"] == divided < 0.7 * stats["triangles"]


def test_grouped_prefiltered_probe(tessellated):
    scene, g = tessellated
    _, h, _ = seeded_rays(scene.triangles, 1024, 32)
    rng = np.random.default_rng(33)
    # Light samples on the ceiling panel's plane, and a few within 1e-3.
    target = np.stack([rng.uniform(-0.6, 0.6, h.shape[0]),
                       np.full(h.shape[0], 2.49),
                       rng.uniform(-0.6, 0.6, h.shape[0])], -1).astype(F32)
    near = rng.random(h.shape[0]) < 0.05
    target[near] = (h.numpy()[near]
                    + rng.normal(size=(near.sum(), 3)) * 4e-4).astype(F32)
    tl = torch.from_numpy(target) - h
    ldist = tl.norm(dim=-1)
    ld = tl / torch.clamp_min(ldist, 1e-3)[:, None]
    t_max = ldist - 1e-3
    stats = {}
    occ_exact = cuda_path.occluded_grouped(g, h, ld, t_max, stats=stats,
                                           passes=True)
    occ_filt, divided = occluded_grouped_filtered(g, h, ld, t_max)
    assert occ_exact.any() and (~occ_exact).any()
    assert torch.equal(occ_exact, occ_filt)
    assert stats["passed"] == divided < stats["triangles"]


# ---------------------------------------------------------------------------
# The plain version's counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_fn, cull", [(cornell_box, False),
                                            (cornell_box, True),
                                            (cornell_box_with_spheres, True)])
def test_plain_counts_the_static_tier_passes(scene_fn, cull):
    cfg = RenderConfig(width=16, height=12, spp=2, bounces=3,
                       pixel_chunk=192)
    scene = scene_fn(resolution=cfg.resolution)
    occluders = potential_occluders(scene, cfg) if cull else None
    T = scene.triangles.num_triangles
    packed = cuda_path._pack_inputs(scene, cfg, False, occluders)
    idx = cuda_path.shadow_indices(occluders, T, "cpu")
    offsets = pixel_rng_offsets(cfg, "cpu")
    stats = {}
    hdr, rec = cuda_path.render_path_plain(offsets, 0, packed, idx, None,
                                           cfg, True, stats)
    hdr_0, rec_0 = cuda_path.render_path_plain(offsets, 0, packed, idx, None,
                                               cfg, True)
    assert torch.equal(hdr, hdr_0) and torch.equal(rec, rec_0)
    c, s = stats["closest"], stats["shadow"]
    # Every lane of every (sample, bounce) runs a closest hit with records
    # on; the live ones are those whose path is alive.
    assert c["triangles_all"] == cfg.num_pixels * cfg.spp * cfg.bounces * T
    assert 0 < c["triangles"] < c["triangles_all"]
    for st in (c, s):
        for key in ("", "_all"):
            assert 0 <= st["passed" + key] <= st["triangles" + key]
        assert st["passed"] <= st["passed_all"]
    assert c["passed"] < 0.5 * c["triangles"]
    # Probes count only where they reach the light: every occluder there.
    occ = (rec & cuda_path.OCC_BIT) != 0
    assert s["triangles_all"] == int((~occ).sum()) * len(idx)


def test_plain_counts_the_grouped_passes():
    cfg = RenderConfig(width=8, height=6, spp=1, bounces=3, pixel_chunk=48)
    scene = cornell_box_tessellated(resolution=cfg.resolution,
                                    wall_subdiv=3, sphere_subdiv=1)
    packed = cuda_path._pack_inputs(scene, cfg, True,
                                    potential_occluders(scene, cfg))
    offsets = pixel_rng_offsets(cfg, "cpu")
    stats = {}
    hdr, rec = cuda_path.render_path_plain(offsets, 0, packed, None, None,
                                           cfg, True, stats)
    hdr_0, rec_0 = cuda_path.render_path_plain(offsets, 0, packed, None,
                                               None, cfg, True)
    assert torch.equal(hdr, hdr_0) and torch.equal(rec, rec_0)
    for loop in ("closest", "shadow"):
        st = stats[loop]
        assert 0 < st["passed"] < st["triangles"]
        assert st["passed"] <= st["passed_all"] < st["triangles_all"]


# ---------------------------------------------------------------------------
# Shared-memory plans
# ---------------------------------------------------------------------------

def supers(n):
    return -(-n // (SUPER * GROUP))


# Paths K and L: triangles and shadow-table triangles after the cull.
GROUPED_PATHS = {"K": (1002, 642), "L": (12802, 10242)}


def test_supers_of_the_grouped_paths():
    assert [supers(n) for p in ("K", "L") for n in GROUPED_PATHS[p]] == [
        8, 6, 101, 81]


@pytest.mark.parametrize("path, wide", [("K", False), ("L", True)])
def test_k2g_takes_the_wide_sweep_above_32_supers(path, wide):
    assert (supers(GROUPED_PATHS[path][0]) > cuda_path.WIDE_SUPERS) is wide


# (spheres, n_super, n_shadow_super) -> bytes: 16 S + 16 x 18 (n_super +
# n_shadow_super): a super and its eight groups, two float4 a box.
@pytest.mark.parametrize("shape, expected", [
    ((0, 8, 6), 16 * 18 * 14),
    ((0, 101, 81), 16 * 18 * 182),
    ((2, 8, 6), 32 + 16 * 18 * 14),
    ((0, 1, 1), 16 * 18 * 2),
])
def test_k2g_plan_is_the_c_formula(shape, expected):
    assert cuda_path.grouped_smem_bytes(*shape) == expected
    assert expected == {(0, 8, 6): 4032, (0, 101, 81): 52416,
                        (2, 8, 6): 4064, (0, 1, 1): 576}[shape]


def test_k2g_plan_at_l_opts_in_beyond_48_kib():
    assert 48 * 1024 < cuda_path.grouped_smem_bytes(0, 101, 81) <= LIMIT


@pytest.mark.parametrize("shape", [(0, 404, 404), (0, 800, 10)])
def test_k2g_plan_raises_past_the_limit(shape):
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_path.grouped_smem_bytes(*shape)


# (triangles, shadow list, spheres) -> bytes: 4 (12 (T + n_shadow) + 4 S +
# 13 (T + S)): paths A (no cull), B, C / D (24 of 36 kept), J, E.
@pytest.mark.parametrize("shape, expected", [
    ((36, 36, 0), 4 * (12 * 72 + 13 * 36)),
    ((12, 12, 2), 4 * (12 * 24 + 8 + 13 * 14)),
    ((36, 24, 0), 4 * (12 * 60 + 13 * 36)),
])
def test_k2_plan_is_the_c_formula(shape, expected):
    assert cuda_path.static_smem_bytes(*shape) == expected
    assert expected == {(36, 36, 0): 5328, (12, 12, 2): 1912,
                        (36, 24, 0): 4752}[shape]


def test_k2_plan_raises_past_48_kib():
    # One block's most, opted in past 48 KiB: on the sphere scene's 12
    # triangles (no cull) up to 3,392 spheres, 4 (25 12 + 12 12 + 17 S).
    assert cuda_path.static_smem_bytes(12, 12, 3392) == 232432 <= LIMIT
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_path.static_smem_bytes(12, 12, 3393)
