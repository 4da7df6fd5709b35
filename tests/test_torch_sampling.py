"""PyTorch port vs the JAX package: hash, Halton, stratified grid, pixel RNG
offsets (bit-equal) and the camera / light / hemisphere samplers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import gpuraytracer_tpu.sampling as jsmp
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import pixel_rng_offsets as jax_pixel_rng_offsets
from gpuraytracer_tpu_torch import sampling as tsmp
from gpuraytracer_tpu_torch.render import pixel_coords, pixel_rng_offsets
from gpuraytracer_tpu_torch.types import RenderConfig

# The largest Halton index a render evaluates is below 2^20 + spp.
MAX_INDEX = (1 << 21) + 400


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def _indices(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, MAX_INDEX, size=n), np.arange(64),
        [MAX_INDEX - 1, (1 << 20) - 1]]).astype(np.uint32)


def _t(idx):
    return torch.from_numpy(idx.astype(np.int64))


def _op_by_op(fn, *args):
    """Evaluate a JAX function one primitive at a time. Compiled as a whole
    for the CPU, XLA contracts the radical inverse's multiply and add into a
    fused multiply-add, which changes the last bit of some values; that is
    the compiler's choice, not the sequence's definition. Evaluated op by
    op, each operation rounds on its own, as in the JAX package's draws
    kernel and in the port."""
    import jax
    with jax.disable_jit():
        return np.asarray(fn(*args))


def test_hash_u32_bit_equal():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(0, 1 << 32, size=4096),
                        [0, 1, (1 << 32) - 1]]).astype(np.uint32)
    ref = np.asarray(jsmp.hash_u32(jnp.asarray(x)))
    got = tsmp.hash_u32(_t(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.min() >= 0 and got.max() < (1 << 32)


@pytest.mark.parametrize("d", range(17))
def test_halton_bit_equal(d):
    idx = _indices(seed=d)
    ref = _op_by_op(jsmp.halton, jnp.asarray(idx), d)
    got = tsmp.halton(_t(idx), d).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert (got >= 0).all() and (got < 1).all()


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.integers(0, MAX_INDEX - 1), min_size=1, max_size=32),
       st.integers(0, 16))
def test_halton_bit_equal_drawn_indices(indices, d):
    idx = np.asarray(indices, dtype=np.uint32)
    ref = _op_by_op(jsmp.halton, jnp.asarray(idx), d)
    np.testing.assert_array_equal(_bits(tsmp.halton(_t(idx), d).numpy()),
                                  _bits(ref))


@pytest.mark.parametrize("n_total", [4, 16])
def test_stratified2_bit_equal(n_total):
    idx = _indices(seed=7)
    ref = _op_by_op(jsmp.stratified2, jnp.asarray(idx), 0, n_total)
    got = tsmp.stratified2(_t(idx), 0, n_total).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_stratified2_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        tsmp.stratified2(torch.arange(4), 0, 3)


@pytest.mark.parametrize("seed", [0, 3])
def test_pixel_rng_offsets_bit_equal_full_frame(seed):
    """800 x 600, the reference's frame: every pixel up to the largest
    index, at seed 0 and at a seed whose product wraps uint32."""
    ref = np.asarray(jax_pixel_rng_offsets(jtypes.RenderConfig(seed=seed)))
    got = pixel_rng_offsets(RenderConfig(seed=seed)).numpy()
    assert got.shape == (800 * 600,)
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.max() < (1 << 20)


def test_pixel_coords_row_major():
    px, py = pixel_coords(RenderConfig(width=5, height=3))
    assert px.tolist() == [0, 1, 2, 3, 4] * 3
    assert py.tolist() == [0] * 5 + [1] * 5 + [2] * 5


def test_vector_helpers_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(256, 3)).astype(np.float32)
    b = rng.normal(size=(256, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # One ulp of f32 at O(1) magnitudes: summation order and rsqrt differ.
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsmp.dot(ta, tb).numpy(),
                               np.asarray(jsmp.dot(a, b)), **tol)
    np.testing.assert_allclose(tsmp.cross(ta, tb).numpy(),
                               np.asarray(jsmp.cross(a, b)), **tol)
    np.testing.assert_allclose(tsmp.normalize(ta).numpy(),
                               np.asarray(jsmp.normalize(jnp.asarray(a))),
                               **tol)
    np.testing.assert_array_equal(tsmp.saturate(ta).numpy(),
                                  np.clip(a, 0.0, 1.0))
    # The 1e-12 floor keeps a zero vector finite (and zero).
    assert tsmp.normalize(torch.zeros(3)).tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("integer_aspect", [True, False])
def test_generate_camera_ray_matches_jax(integer_aspect):
    rng = np.random.default_rng(3)
    n = 512
    px = rng.integers(0, 800, size=n).astype(np.int32)
    py = rng.integers(0, 600, size=n).astype(np.int32)
    jit = rng.random(size=(n, 2)).astype(np.float32)
    pos = np.array([0.0, 1.0, 3.5], np.float32)
    direction = np.array([0.0, 0.0, -1.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    fov = np.float32(0.7)
    ro, rd = jsmp.generate_camera_ray(
        jnp.asarray(pos), jnp.asarray(direction), jnp.asarray(up),
        (800, 600), jnp.asarray(fov), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(jit), integer_aspect)
    to, td = tsmp.generate_camera_ray(
        torch.from_numpy(pos), torch.from_numpy(direction),
        torch.from_numpy(up), (800, 600), torch.tensor(fov),
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(jit),
        integer_aspect)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), atol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(ro))


def test_sample_area_light_matches_jax():
    rng = np.random.default_rng(4)
    n = 512
    p = (rng.random(size=(n, 3)) * np.array([2.0, 1.5, 2.0])
         - np.array([1.0, 0.0, 1.0])).astype(np.float32)
    u = rng.random(size=(n, 2)).astype(np.float32)
    center = np.array([0.0, 1.98, 0.0], np.float32)
    color = np.array([1.0, 0.9, 0.8], np.float32)
    normal = np.array([0.0, -1.0, 0.0], np.float32)
    ref = jsmp.sample_area_light(jnp.asarray(center), jnp.asarray(color),
                                 jnp.asarray(normal), jnp.asarray(p),
                                 jnp.asarray(u), 0.25)
    got = tsmp.sample_area_light(
        torch.from_numpy(center), torch.from_numpy(color),
        torch.from_numpy(normal), torch.from_numpy(p), torch.from_numpy(u),
        0.25)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_cosine_bounce_matches_jax():
    rng = np.random.default_rng(5)
    n = 512
    u = rng.random(size=(n, 2)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ref_local = jsmp.cosine_hemisphere_y_up(jnp.asarray(u))
    got_local = tsmp.cosine_hemisphere_y_up(torch.from_numpy(u))
    np.testing.assert_allclose(got_local.numpy(), np.asarray(ref_local),
                               atol=1e-6)
    ref = jsmp.align_hemisphere_with_normal(ref_local, jnp.asarray(nrm))
    got = tsmp.align_hemisphere_with_normal(got_local, torch.from_numpy(nrm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # The bounce leaves along the normal's side.
    assert (tsmp.dot(got, torch.from_numpy(nrm)) >= -1e-6).all()


def test_build_orthonormal_basis_matches_jax():
    rng = np.random.default_rng(6)
    nrm = rng.normal(size=(256, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[0] = [1.0, 0.0, 0.0]  # the |n.x| > 0.9 branch
    ref = jsmp.build_orthonormal_basis(jnp.asarray(nrm))
    got = tsmp.build_orthonormal_basis(torch.from_numpy(nrm))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
