"""The MIS static pair's host-side plans on the CPU (K4, K5).

``cuda_path.plane_ahead`` and ``cuda_path.plane_within`` mirror K4's two exact
prefilters (``ops/csrc/trace.cuh``): the kernel skips a triangle test's
divide, barycentrics and interval test where either is False. They may
reject only tests that fail: so wherever the exact test passes (float32 IEEE
division on the CPU, the order of ``trace.cuh``), both must hold. They are
held to that on seeded float32 pairs and bounds, on adversarial ones (signed
zeros, subnormals, NaN, infinities, quotients one ulp either side of
RAY_TMIN and of the bound, |den| one ulp either side of 1e-12, products that
overflow) and on the box scenes' triangle rows with seeded rays, where the
prefiltered closest-hit and probe loops give the exact loops' winners and
distances bit for bit. The plain version's count of the tests that pass
both (``render_mis_plain(stats=)``, read by ``chip_smoke.py``'s bound of the
static tier) changes no result.

``cuda_mis.static_smem_bytes`` and ``cuda_mis_bwd.static_smem_bytes`` are
the wrappers' mirrors of the C sides' ``static_smem`` (exported as
``grt_mis_static_smem`` and ``grt_mis_bwd_static_smem``; ``chip_smoke.py``
holds each against its mirror on the card). They are held against the C
formulas with the numbers written out, at the shapes of paths F-I and past
the most one block may use. No kernel runs.
"""
import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.intersect import (RAY_TMAX, RAY_TMIN,
                                              compile_scene,
                                              triangle_candidates)
from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_mis_bwd, cuda_path
from gpuraytracer_tpu_torch.scene import cornell_box, cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig

LIMIT = 227 * 1024  # one block's most on sm_90
T_MINS = (0.0, float(np.float32(RAY_TMIN)), 1e-45)


def exact_passes(num, den, t_min):
    """The (num, den) part of trace.cuh's test: |den| >= 1e-12 and
    num / den > t_min, in float32 (t_max and the barycentrics only reject
    more)."""
    tt = num / den
    return (den.abs() >= 1e-12) & (tt > t_min)


def one_ulp(x, up):
    x = torch.tensor(x, dtype=torch.float32)
    return torch.nextafter(x, torch.tensor(np.inf if up else -np.inf,
                                           dtype=torch.float32)).item()


def adversarial_pairs():
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    special = [0.0, -0.0, tiny, -tiny, 1e-40, -1e-40, 1e-38, -1e-38,
               float("nan"), float("inf"), -float("inf"), 1.0, -1.0, 1e30,
               -1e30, 1e-12, -1e-12, one_ulp(1e-12, True),
               one_ulp(1e-12, False), -one_ulp(1e-12, True),
               -one_ulp(1e-12, False)]
    nums = [a for a in special for _ in special]
    dens = [b for _ in special for b in special]
    # Quotients at RAY_TMIN and one ulp either side, over dens of both
    # signs and several magnitudes.
    t0 = float(np.float32(RAY_TMIN))
    for q in (one_ulp(t0, False), t0, one_ulp(t0, True)):
        for den in (1.0, -1.0, 3.0, -0.7, 1e-12, -1e-12,
                    one_ulp(1e-12, True), -one_ulp(1e-12, False), 1e20):
            num = np.float32(q) * np.float32(den)
            for n in (num, np.nextafter(num, np.float32(np.inf)),
                      np.nextafter(num, np.float32(-np.inf))):
                nums.append(float(n))
                dens.append(den)
    return (torch.tensor(nums, dtype=torch.float32),
            torch.tensor(dens, dtype=torch.float32))


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def seeded_pairs(n=100_000):
    rng = np.random.default_rng(9)
    mag = 10.0 ** rng.uniform(-45, 38, size=(2, n))
    sign = rng.choice([-1.0, 1.0], size=(2, n))
    pairs = (mag * sign).astype(np.float32)
    # A share of exact zeros and of values near 1e-12.
    pairs[0, rng.random(n) < 0.02] = 0.0
    near = rng.random(n) < 0.05
    pairs[1, near] = (np.float32(1e-12) * rng.uniform(0.5, 2.0, near.sum())
                      * rng.choice([-1.0, 1.0], near.sum())).astype(np.float32)
    return torch.from_numpy(pairs[0]), torch.from_numpy(pairs[1])


@pytest.mark.parametrize("source", ["seeded", "adversarial"])
@pytest.mark.parametrize("t_min", T_MINS)
def test_prefilter_rejects_only_failing_tests(source, t_min):
    num, den = seeded_pairs() if source == "seeded" else adversarial_pairs()
    passes = exact_passes(num, den, t_min)
    ahead = cuda_path.plane_ahead(den, num)
    assert passes.any() and (~ahead).any()
    missed = passes & ~ahead
    assert not missed.any(), list(zip(num[missed][:5].tolist(),
                                      den[missed][:5].tolist()))


def test_prefilter_on_the_special_values():
    nan, inf = float("nan"), float("inf")
    den = torch.tensor([1.0, -1.0, 1.0, -1.0, 0.0, -0.0, nan, 1.0, 1e-13,
                        inf, 1.0, -1.0], dtype=torch.float32)
    num = torch.tensor([1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0, nan, 1.0, 1.0,
                        0.0, -0.0], dtype=torch.float32)
    expect = [True, True, False, False, False, False, False, False, False,
              True, False, False]
    assert cuda_path.plane_ahead(den, num).tolist() == expect


def seeded_bounds(n=100_000):
    rng = np.random.default_rng(11)
    return torch.from_numpy((10.0 ** rng.uniform(-3, 3, n)).astype(np.float32))


def bound_pairs():
    """Quotients at a bound and one ulp either side, bounds at RAY_TMIN,
    RAY_TMAX and between, over dens of both signs from 1e-12 to 1e38."""
    nums, dens, bounds = [], [], []
    for t_far in (float(np.float32(RAY_TMIN)), one_ulp(RAY_TMIN, True), 0.37,
                  2.5, 999.0, float(np.float32(RAY_TMAX))):
        for den in (1.0, -1.0, 3.0, -0.7, 1e-12, -1e-12,
                    one_ulp(1e-12, True), 1e20, -1e30, 1e38):
            for q in (one_ulp(t_far, False), t_far, one_ulp(t_far, True)):
                with np.errstate(over="ignore"):  # 1e3 x 1e38: num = inf
                    num = np.float32(q) * np.float32(den)
                for n in (num, np.nextafter(num, np.float32(np.inf)),
                          np.nextafter(num, np.float32(-np.inf))):
                    nums.append(float(n))
                    dens.append(den)
                    bounds.append(t_far)
    return f32(nums), f32(dens), f32(bounds)


@pytest.mark.parametrize("source", ["seeded", "adversarial"])
def test_bound_prefilter_rejects_only_failing_tests(source):
    if source == "seeded":
        num, den = seeded_pairs()
        t_far = seeded_bounds()
    else:
        num, den, t_far = bound_pairs()
    passes = (den.abs() >= 1e-12) & (num / den > 0) & (num / den < t_far)
    within = cuda_path.plane_within(den, num, t_far)
    assert passes.any() and (~within).any()
    missed = passes & ~within
    assert not missed.any(), list(zip(num[missed][:5].tolist(),
                                      den[missed][:5].tolist(),
                                      t_far[missed][:5].tolist()))


def test_bound_prefilter_margin():
    # 1 + 2^-22 is a float, and a product that overflows keeps the test.
    assert float(np.float32(cuda_path.WITHIN_MARGIN)) == cuda_path.WITHIN_MARGIN
    assert cuda_path.plane_within(f32([1e38]), f32([1e30]), f32([1e3])).item()
    # The margin keeps a quotient at the bound (the exact test rejects it);
    # a few ulp above, the prefilter rejects it.
    t_far = f32([0.37])
    assert cuda_path.plane_within(f32([1.0]), t_far, t_far).item()
    above = t_far * f32([1.0 + 2.0 ** -20])
    assert not cuda_path.plane_within(f32([1.0]), above, t_far).item()


def closest_exact(num, den, s1, s2, t_min, t_max):
    """The exact closest-hit loop in index order (strict <), vectorized over
    rays, from the per-triangle num, den and barycentric terms."""
    n_rays, T = num.shape
    t_best = torch.full((n_rays,), 1e30, dtype=torch.float32)
    prim = torch.full((n_rays,), -1, dtype=torch.int64)
    for k in range(T):
        tt = num[:, k] / den[:, k]
        u = s1[0][:, k] + tt * s1[1][:, k] - s1[2][k]
        v = s2[0][:, k] + tt * s2[1][:, k] - s2[2][k]
        hit = ((den[:, k].abs() >= 1e-12) & (tt > t_min) & (tt < t_max)
               & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt < t_best))
        t_best = torch.where(hit, tt, t_best)
        prim = torch.where(hit, k, prim)
    return t_best, prim


def closest_filtered(num, den, s1, s2, t_min, t_max):
    """The same loop with both prefilters before the divide, t_far following
    the nearest hit, as closest_triangle_filtered runs it."""
    n_rays, T = num.shape
    t_best = torch.full((n_rays,), 1e30, dtype=torch.float32)
    prim = torch.full((n_rays,), -1, dtype=torch.int64)
    t_far = torch.full((n_rays,), t_max, dtype=torch.float32)
    tested = 0
    for k in range(T):
        go = (cuda_path.plane_ahead(den[:, k], num[:, k])
              & cuda_path.plane_within(den[:, k], num[:, k], t_far))
        tested += int(go.sum())
        tt = num[:, k] / den[:, k]
        u = s1[0][:, k] + tt * s1[1][:, k] - s1[2][k]
        v = s2[0][:, k] + tt * s2[1][:, k] - s2[2][k]
        hit = go & ((den[:, k].abs() >= 1e-12) & (tt > t_min) & (tt < t_max)
                    & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt < t_best))
        t_best = torch.where(hit, tt, t_best)
        t_far = torch.where(hit, tt, t_far)
        prim = torch.where(hit, k, prim)
    return t_best, prim, tested


@pytest.mark.parametrize("scene_fn", [cornell_box, cornell_box_with_spheres])
def test_prefilter_on_the_box_scenes(scene_fn):
    """Rays from seeded points inside the box and from its triangles,
    offset along their normals as the light probes and lobe rays start, in
    seeded directions, against every triangle row: the predicate holds
    wherever the exact test passes, and rejects a large share of the
    tests."""
    tris = scene_fn(resolution=(8, 8)).triangles
    scene = compile_scene(tris)
    rng = np.random.default_rng(17)
    n = 4096
    # Half the origins inside the box, half on its triangles one 1e-4 step
    # off along the normal, on either side.
    inside = rng.uniform(-2.4, 2.4, (n // 2, 3))
    k = rng.integers(0, tris.verts.shape[0], n // 2)
    a, b = rng.uniform(0.0, 0.5, (2, n // 2))
    v = tris.verts.numpy().astype(np.float64)
    on = (v[k, 0] + a[:, None] * (v[k, 1] - v[k, 0])
          + b[:, None] * (v[k, 2] - v[k, 0])
          + 1e-4 * rng.choice([-1.0, 1.0], (n // 2, 1))
          * scene.n.numpy()[k])
    origin = torch.from_numpy(np.concatenate([inside, on]).astype(np.float32))
    direction = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    direction = direction / direction.norm(dim=-1, keepdim=True)
    o = origin[:, None, :]
    d = direction[:, None, :]
    # trace.cuh's order: d.x n.x + d.y n.y + d.z n.z.
    den = (d[..., 0] * scene.n[:, 0] + d[..., 1] * scene.n[:, 1]
           + d[..., 2] * scene.n[:, 2])
    num = scene.c0 - (o[..., 0] * scene.n[:, 0] + o[..., 1] * scene.n[:, 1]
                      + o[..., 2] * scene.n[:, 2])
    _, valid = triangle_candidates(scene.n, scene.c0, scene.s1, scene.c1,
                                   scene.s2, scene.c2, origin, direction,
                                   RAY_TMIN, RAY_TMAX)
    ahead = cuda_path.plane_ahead(den, num)
    assert valid.any()
    assert not (valid & ~ahead).any()
    assert (exact_passes(num, den, RAY_TMIN) <= ahead).all()
    share = 1.0 - ahead.float().mean().item()
    assert share > 0.25, f"the prefilter rejects only {share:.1%} here"

    # The closest-hit loop with both prefilters: the exact loop's winners and
    # distances, bit for bit, with fewer tests.
    def dots(s, c):
        return ((o[..., 0] * s[:, 0] + o[..., 1] * s[:, 1] + o[..., 2] * s[:, 2]),
                (d[..., 0] * s[:, 0] + d[..., 1] * s[:, 1] + d[..., 2] * s[:, 2]),
                c)

    s1, s2 = dots(scene.s1, scene.c1), dots(scene.s2, scene.c2)
    t_min, t_max = float(np.float32(RAY_TMIN)), float(np.float32(RAY_TMAX))
    t_exact, p_exact = closest_exact(num, den, s1, s2, t_min, t_max)
    t_filt, p_filt, tested = closest_filtered(num, den, s1, s2, t_min, t_max)
    assert (p_exact >= 0).any()
    assert torch.equal(p_exact, p_filt) and torch.equal(t_exact, t_filt)
    assert tested < 0.5 * num.numel()


@pytest.mark.parametrize("scene_fn", [cornell_box, cornell_box_with_spheres])
def test_plain_counts_the_prefiltered_tests(scene_fn):
    """The plain version's count of the tests that pass both prefilters
    (``stats``, which chip_smoke.py's bound of the static tier reads) leaves
    its image and records as they are, counts every live lane's tests, and
    finds that fewer than half of the closest-hit tests pass."""
    cfg = RenderConfig(integrator="mis", width=16, height=12, camera_rays=1,
                       mis_samples=6, pixel_chunk=192)
    scene = scene_fn(resolution=cfg.resolution)
    packed = cuda_mis._pack_inputs(scene, cfg, False, None)
    T = scene.triangles.num_triangles
    idx = cuda_path.shadow_indices(None, T, "cpu")
    stats = {}
    hdr, rec = cuda_mis.render_mis_plain(cfg.num_pixels, 0, packed, idx, cfg,
                                         True, stats)
    hdr_0, rec_0 = cuda_mis.render_mis_plain(cfg.num_pixels, 0, packed, idx,
                                             cfg, True)
    assert torch.equal(hdr, hdr_0) and torch.equal(rec.samples, rec_0.samples)
    assert stats["camera"]["triangles"] == cfg.num_pixels * T
    for key in ("camera", "closest", "shadow"):
        st = stats[key]
        assert 0 <= st["passed"] <= st["triangles"] and st["triangles"] % T == 0
    assert stats["closest"]["triangles"] > 0
    assert stats["closest"]["passed"] < 0.5 * stats["closest"]["triangles"]


# Paths F-I at 300 samples (100 per strategy): triangles, shadow-list
# triangles, spheres. F and G trace without the cull (every triangle in the
# list), H and I with it (24 of the box's 36 triangles kept).
PATHS = {"F": (36, 36, 0), "G": (12, 12, 2), "H": (36, 24, 0),
         "I-spheres": (12, 12, 2)}
S_PER = 100


@pytest.mark.parametrize("path", sorted(PATHS))
def test_k4_plan_accepts_the_paths(path):
    tris, shadow, spheres = PATHS[path]
    smem = cuda_mis.static_smem_bytes(S_PER, spheres, tris, shadow)
    assert 0 < smem <= LIMIT


# (s_per, spheres, triangles, shadow) -> bytes: 4 (16 s_per + 4 S
# + 12 (T + n_shadow) + 12 (T + S)).
@pytest.mark.parametrize("shape, expected", [
    ((100, 0, 36, 36), 4 * (1600 + 12 * 72 + 12 * 36)),
    ((100, 2, 12, 12), 4 * (1600 + 8 + 12 * 24 + 12 * 14)),
    ((100, 0, 36, 24), 4 * (1600 + 12 * 60 + 12 * 36)),
])
def test_k4_plan_is_the_c_formula(shape, expected):
    assert cuda_mis.static_smem_bytes(*shape) == expected
    assert expected == {(100, 0, 36, 36): 11584, (100, 2, 12, 12): 8256,
                        (100, 0, 36, 24): 11008}[shape]


@pytest.mark.parametrize("shape", [(3700, 0, 36, 36), (100, 0, 2000, 2000)])
def test_k4_plan_raises_past_the_limit(shape):
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_mis.static_smem_bytes(*shape)


# K5 at path I: primitives (36 triangles, or 12 + 2 spheres) and the table's
# rows (10, or 15 with spheres).
K5_PATHS = {"I": (36, 10), "I-spheres": (14, 15)}


@pytest.mark.parametrize("path", sorted(K5_PATHS))
def test_k5_plan_accepts_the_paths(path):
    prims, ndif = K5_PATHS[path]
    assert 0 < cuda_mis_bwd.static_smem_bytes(S_PER, prims, ndif) <= LIMIT


# (s_per, primitives, ndif) -> bytes: 4 (ndif P + 16 s_per + 29 + 4 warps x
# (P ndif + 29)).
@pytest.mark.parametrize("shape, expected", [
    ((100, 36, 10), 4 * (360 + 1600 + 29 + 4 * (360 + 29))),
    ((100, 14, 15), 4 * (210 + 1600 + 29 + 4 * (210 + 29))),
    ((6, 14, 15), 4 * (210 + 96 + 29 + 4 * (210 + 29))),
])
def test_k5_plan_is_the_c_formula(shape, expected):
    assert cuda_mis_bwd.static_smem_bytes(*shape) == expected
    assert expected == {(100, 36, 10): 14180, (100, 14, 15): 11180,
                        (6, 14, 15): 5164}[shape]


def test_k5_plan_raises_past_the_limit():
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_mis_bwd.static_smem_bytes(100, 1200, 10)
