"""PyTorch port vs the JAX package: the MIS half of ``sampling.py`` and
``brdf.py`` — hash jitter and sample tables (bit-equal), heuristic, light
and lobe samplers, GGX terms and the microfacet BRDF.

Inputs are made from a seed with numpy and handed to both packages.
Tolerance for the float functions: atol 1e-6 / rtol 1e-5 — the two run the
same f32 expression tree, and differ by the order of a three-term dot
product and an ulp of sqrt, sin, cos and pow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.sampling as jsmp
from gpuraytracer_tpu.brdf import brdf_contribution as jax_brdf
from gpuraytracer_tpu_torch import sampling as tsmp
from gpuraytracer_tpu_torch.brdf import brdf_contribution

TOL = dict(atol=1e-6, rtol=1e-5)
N = 512
ROUGHNESS = (0.0, 0.05, 0.3, 1.0)
METALLIC = (0.0, 0.9)


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _full(value, n=N):
    return np.full((n,), value, np.float32)


def _surface(seed):
    """Unit normals with the view and light directions on their side, as on
    a lit surface, and one normal in the |n.x| > 0.9 branch of the basis."""
    rng = np.random.default_rng(seed)
    n = _unit(rng)
    n[0] = [1.0, 0.0, 0.0]
    v, l = _unit(rng), _unit(rng)
    v *= np.sign(np.sum(v * n, axis=-1, keepdims=True))
    l *= np.sign(np.sum(l * n, axis=-1, keepdims=True))
    return n, v.astype(np.float32), l.astype(np.float32)


# ---------------------------------------------------------------------------
# Hash jitter and sample tables: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", [0, 5])
def test_hash_random_2d_bit_equal_full_frame(i):
    """Every pixel of the reference's 800 x 600 frame, (0, 0) and
    (799, 599) included, at camera rays 0 and 5."""
    idx = np.arange(800 * 600, dtype=np.int64)
    x, y = idx % 800, idx // 800
    ref = np.asarray(jsmp.hash_random_2d(jnp.asarray(x), jnp.asarray(y),
                                         jnp.uint32(i)))
    got = tsmp.hash_random_2d(torch.from_numpy(x), torch.from_numpy(y),
                              i).numpy()
    assert got.dtype == np.float32 and got.shape == (800 * 600, 2)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    for corner in (0, 800 * 600 - 1):
        np.testing.assert_array_equal(_bits(got[corner]), _bits(ref[corner]))
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_hash_random_2d_bit_equal_other_resolution_and_wraparound():
    """A 1920 x 1080 frame (the strides stay 800 / 600), a camera-ray index
    whose product wraps uint32, and coordinates near 2^32."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1920, size=4096)
    y = rng.integers(0, 1080, size=4096)
    for i in (1, 3, 4000000000):
        ref = np.asarray(jsmp.hash_random_2d(
            jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32),
            jnp.uint32(i)))
        got = tsmp.hash_random_2d(torch.from_numpy(x), torch.from_numpy(y),
                                  i).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    big = np.array([(1 << 32) - 1, (1 << 32) - 7, 1 << 31], np.uint32)
    ref = np.asarray(jsmp.hash_random_2d(
        jnp.asarray(big), jnp.asarray(big[::-1].copy()), jnp.uint32(3)))
    got = tsmp.hash_random_2d(torch.from_numpy(big.astype(np.int64)),
                              torch.from_numpy(big[::-1].astype(np.int64)),
                              3).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_halton2_bit_equal():
    idx = np.concatenate([np.arange(300), [1 << 20, (1 << 21) + 17]]
                         ).astype(np.uint32)
    for d in (0, 2, 4, 6):
        with jax.disable_jit():
            ref = np.asarray(jsmp.halton2(jnp.asarray(idx), d))
        got = tsmp.halton2(torch.from_numpy(idx.astype(np.int64)), d).numpy()
        assert got.shape == (idx.size, 2)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("sampler,mis_samples", [
    ("halton", 300), ("halton", 6), ("halton", 3), ("stratified", 12),
    ("stratified", 48)])
def test_mis_sample_table_rows(sampler, mis_samples):
    """Bit-equal to the JAX table evaluated one primitive at a time; within
    one ulp of the jitted one (compiled as a whole for the CPU, XLA fuses
    some of the radical inverse's multiply-adds)."""
    got = tsmp.mis_sample_table_rows(mis_samples, sampler).numpy()
    assert got.shape == (10, mis_samples // 3) and got.dtype == np.float32
    with jax.disable_jit():
        ref = np.asarray(jsmp.mis_sample_table_rows(mis_samples, sampler))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    jitted = np.asarray(jax.jit(jsmp.mis_sample_table_rows,
                                static_argnums=(0, 1))(mis_samples, sampler))
    ulps = np.abs(_bits(got).astype(np.int64) - _bits(jitted).astype(np.int64))
    assert ulps.max() <= 1
    # The first Halton sample is the light rectangle's corner.
    if sampler == "halton":
        assert got[0, 0] == 0.0 and got[1, 0] == 0.0
    assert got.min() >= 0.0 and got.max() < 1.0


def test_mis_sample_table_rejects_bad_sampler_and_count():
    with pytest.raises(ValueError, match="unknown sampler"):
        tsmp.mis_sample_table_rows(6, "sobol")
    with pytest.raises(ValueError, match="square"):
        tsmp.mis_sample_table_rows(9, "stratified")


# ---------------------------------------------------------------------------
# Heuristic, samplers, pdfs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_power_heuristic_3_matches_jax(beta):
    rng = np.random.default_rng(12)
    p = rng.random(size=(3, N)).astype(np.float32) * 4.0
    p[1, :8] = 0.0  # a zero pdf, as cosine_pdf gives on backfacing lanes
    ref = jsmp.power_heuristic_3(*_j(*p), 100, beta)
    got = tsmp.power_heuristic_3(*_t(*p), 100, beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (got >= 0).all() and (got <= 1).all()


def test_cosine_sampler_and_pdf_match_jax():
    rng = np.random.default_rng(13)
    n, _, _ = _surface(13)
    u = rng.random(size=(N, 2)).astype(np.float32)
    ref = jsmp.cosine_weighted_dir(*_j(n, u))
    got = tsmp.cosine_weighted_dir(*_t(n, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (tsmp.dot(got, torch.from_numpy(n)) >= -1e-6).all()
    d = _unit(rng)
    np.testing.assert_allclose(
        tsmp.cosine_pdf(*_t(n, d)).numpy(),
        np.asarray(jsmp.cosine_pdf(*_j(n, d))), **TOL)


def test_square_light_sample_and_pdf_match_jax():
    rng = np.random.default_rng(14)
    origin = (rng.random(size=(N, 3)) * np.array([4.0, 4.0, 4.0])
              - np.array([2.0, 2.4, 2.0])).astype(np.float32)
    u = rng.random(size=(N, 2)).astype(np.float32)
    u[0] = 0.0  # the corner sample
    center = np.array([0.0, 2.49, 0.0], np.float32)
    normal = np.array([0.0, -1.0, 0.0], np.float32)
    w, dpt = np.float32(1.0), np.float32(0.8)
    ref_d, ref_t = jsmp.direct_square_light_sample(
        *_j(origin, center), w, dpt, *_j(normal, u))
    got_d, got_t = tsmp.direct_square_light_sample(
        *_t(origin, center), torch.tensor(w), torch.tensor(dpt),
        *_t(normal, u))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)
    ref = jsmp.square_light_pdf(*_j(origin, center), w, dpt,
                                *_j(normal, np.asarray(ref_d)))
    got = tsmp.square_light_pdf(*_t(origin, center), torch.tensor(w),
                                torch.tensor(dpt),
                                *_t(normal, np.asarray(ref_d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("roughness", ROUGHNESS)
def test_ggx_terms_match_jax(roughness):
    rng = np.random.default_rng(15)
    x, y = rng.random(size=(2, N)).astype(np.float32)
    x[:4] = [0.0, 1.0, 1e-7, 0.5]
    r = _full(roughness)
    np.testing.assert_allclose(
        tsmp.smith_g1_ggx(*_t(x, r)).numpy(),
        np.asarray(jsmp.smith_g1_ggx(*_j(x, r))), **TOL)
    # The NDF peaks at 1 / (pi a^2): relative tolerance only.
    np.testing.assert_allclose(
        tsmp.d_ggx(*_t(x, r)).numpy(), np.asarray(jsmp.d_ggx(*_j(x, r))),
        rtol=1e-5, atol=1e-6 if roughness else 0.0)
    np.testing.assert_allclose(
        tsmp.v_smith_ggx_correlated(*_t(x, y, r)).numpy(),
        np.asarray(jsmp.v_smith_ggx_correlated(*_j(x, y, r))), rtol=1e-5,
        atol=1e-6)


def test_schlick_lambert_reflect_and_safe_normalize_match_jax():
    rng = np.random.default_rng(16)
    ldh = rng.random(size=N).astype(np.float32)
    f0 = rng.random(size=(N, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsmp.f_schlick(*_t(ldh, f0)).numpy(),
        np.asarray(jsmp.f_schlick(*_j(ldh, f0))), **TOL)
    assert tsmp.fd_lambert() == jsmp.fd_lambert()
    a, b = _unit(rng), _unit(rng)
    np.testing.assert_allclose(tsmp.reflect(*_t(a, b)).numpy(),
                               np.asarray(jsmp.reflect(*_j(a, b))), **TOL)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    v[0] = 0.0  # the floor keeps a zero vector finite (and zero)
    got = tsmp._safe_normalize(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsmp._safe_normalize(jnp.asarray(v))), **TOL)
    assert got[0].tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("roughness", ROUGHNESS)
def test_vndf_sampler_and_pdf_match_jax(roughness):
    rng = np.random.default_rng(17)
    n, v, l = _surface(17)
    r = _full(roughness)
    u = rng.random(size=(N, 2)).astype(np.float32)
    ref = np.asarray(jsmp.vndf_dir(*_j(v, n, r, u)))
    got = tsmp.vndf_dir(*_t(v, n, r, u)).numpy()
    # The chain normalizes five times; allow the ulps to add up.
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    ref_pdf = np.asarray(jsmp.vndf_pdf(*_j(v, n, l, r)))
    got_pdf = tsmp.vndf_pdf(*_t(v, n, l, r)).numpy()
    np.testing.assert_allclose(got_pdf, ref_pdf, rtol=1e-5,
                               atol=1e-6 if roughness else 0.0)
    if roughness == 0.0:
        # The lanes the double-where reciprocal of the integrator guards.
        assert (got_pdf == 0.0).all()


@pytest.mark.parametrize("metallic", METALLIC)
@pytest.mark.parametrize("roughness", ROUGHNESS)
def test_brdf_contribution_matches_jax(roughness, metallic):
    rng = np.random.default_rng(18)
    n, v, l = _surface(18)
    diffuse = rng.random(size=(N, 3)).astype(np.float32)
    args = (-v, n, diffuse, _full(metallic), _full(roughness), l)
    ref = np.asarray(jax_brdf(*_j(*args)))
    got = brdf_contribution(*_t(*args)).numpy()
    assert got.shape == (N, 3) and np.isfinite(got).all()
    # At roughness 0.05 the NDF's denominator, 1 - (n.h)^2 (1 - a^2), cancels
    # near the lobe's peak and amplifies the last bit of n.h tenfold
    # (measured: 6 of 1536 values at 8e-5 relative, the rest within 1e-5).
    np.testing.assert_allclose(got, ref, atol=1e-6,
                               rtol=1e-4 if roughness == 0.05 else 1e-5)
    assert (got >= 0.0).all()
