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


# ---------------------------------------------------------------------------
# The rest of the sampling library: hash variants, Hammersley, heuristics,
# the uniform hemisphere (bit-equal where the function is integer arithmetic
# and one rounding)
# ---------------------------------------------------------------------------

def _u32_cases():
    rng = np.random.default_rng(11)
    return np.concatenate([rng.integers(0, 1 << 32, size=2048),
                           [0, 1, 2, 3, (1 << 31), (1 << 32) - 1]]
                          ).astype(np.uint32)


def _pdfs(seed):
    rng = np.random.default_rng(seed)
    p = (rng.random((3, 1024)) * 4.0).astype(np.float32)
    p[:, :32] = 0.0  # the pdf1 == 0 branch and all-zero lanes
    return p


def _case_random_float():
    x = _u32_cases()
    return (jsmp.random_float(jnp.asarray(x)), tsmp.random_float(_t(x)),
            True)


def _case_hash_random_3d():
    rng = np.random.default_rng(12)
    xyz = [rng.integers(0, 4096, size=512).astype(np.uint32)
           for _ in range(3)]
    i = rng.integers(0, 1 << 32, size=512).astype(np.uint32)
    return (jsmp.hash_random_3d(tuple(jnp.asarray(v) for v in xyz),
                                jnp.asarray(i)),
            tsmp.hash_random_3d(tuple(_t(v) for v in xyz), _t(i)), True)


def _case_shift_random_points():
    u = np.random.default_rng(13).random((512, 2)).astype(np.float32)
    u[0] = [0.5, 0.0]
    return (jsmp.shift_random_points(jnp.asarray(u)),
            tsmp.shift_random_points(torch.from_numpy(u)), True)


def _case_radical_inverse_2():
    x = _u32_cases()
    return (jsmp.radical_inverse_2(jnp.asarray(x)),
            tsmp.radical_inverse_2(_t(x)), True)


def _case_hammersley_2d():
    i = np.arange(257, dtype=np.uint32)
    return (jsmp.hammersley_2d(jnp.asarray(i), 257),
            tsmp.hammersley_2d(_t(i), 257), True)


def _hammersley_float(dimension):
    def case():
        i = np.arange(300, dtype=np.uint32)
        return (jsmp.hammersley_float(jnp.asarray(i), dimension, 300),
                tsmp.hammersley_float(_t(i), dimension, 300), True)
    return case


def _case_power_heuristic_2():
    p = _pdfs(14)
    return (jsmp.power_heuristic_2(jnp.asarray(p[0]), jnp.asarray(p[1])),
            tsmp.power_heuristic_2(torch.from_numpy(p[0]),
                                   torch.from_numpy(p[1])), False)


def _case_power_heuristic_3_beta2():
    p = _pdfs(15)
    return (jsmp.power_heuristic_3(*(jnp.asarray(x) for x in p), 10, 2.0),
            tsmp.power_heuristic_3(*(torch.from_numpy(x) for x in p), 10,
                                   2.0), False)


def _case_balanced_heuristic_3():
    p = _pdfs(16)
    return (jsmp.balanced_heuristic_3(*(jnp.asarray(x) for x in p)),
            tsmp.balanced_heuristic_3(*(torch.from_numpy(x) for x in p)),
            False)


def _case_uniform_hemisphere_dir():
    rng = np.random.default_rng(17)
    nrm = rng.normal(size=(512, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    u = rng.random((512, 2)).astype(np.float32)
    return (jsmp.uniform_hemisphere_dir(jnp.asarray(nrm), jnp.asarray(u)),
            tsmp.uniform_hemisphere_dir(torch.from_numpy(nrm),
                                        torch.from_numpy(u)), False)


LIBRARY_CASES = {
    "random_float": _case_random_float,
    "hash_random_3d": _case_hash_random_3d,
    "shift_random_points": _case_shift_random_points,
    "radical_inverse_2": _case_radical_inverse_2,
    "hammersley_2d": _case_hammersley_2d,
    "hammersley_float-0": _hammersley_float(0),
    "hammersley_float-1": _hammersley_float(1),
    "hammersley_float-2": _hammersley_float(2),
    "hammersley_float-5": _hammersley_float(5),
    "power_heuristic_2": _case_power_heuristic_2,
    "power_heuristic_3-beta2": _case_power_heuristic_3_beta2,
    "balanced_heuristic_3": _case_balanced_heuristic_3,
    "uniform_hemisphere_dir": _case_uniform_hemisphere_dir,
}


@pytest.mark.parametrize("name", sorted(LIBRARY_CASES))
def test_sampling_library_matches_jax(name):
    ref, got, exact = LIBRARY_CASES[name]()
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 64, 65, 1000, (1 << 20) + 1])
def test_next_power_of_two_matches_jax(n):
    assert tsmp.next_power_of_two(n) == jsmp.next_power_of_two(n)


# ---------------------------------------------------------------------------
# The legacy tier's light samplers and pdfs
# ---------------------------------------------------------------------------

def _points_around(center, seed, n=256, radius=5.0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    p = p / np.linalg.norm(p, axis=-1, keepdims=True) * radius
    return (p + center).astype(np.float32), rng


def test_sphere_light_sampler_and_pdf_match_jax():
    center = np.array([0.0, 1.9, 0.0], np.float32)
    pts, rng = _points_around(center, 21, radius=3.0)
    u = rng.random((256, 2)).astype(np.float32)
    rd, rp = jsmp.sample_sphere_light(jnp.asarray(center), 0.35,
                                      jnp.asarray(pts), jnp.asarray(u))
    gd, gp = tsmp.sample_sphere_light(torch.from_numpy(center),
                                      torch.tensor(0.35), torch.from_numpy(pts),
                                      torch.from_numpy(u))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-5)
    pdf = tsmp.sphere_light_pdf(torch.from_numpy(center), torch.tensor(0.35),
                                torch.from_numpy(pts))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(rp), rtol=1e-5)
    # Every sampled direction lies within the light's cone.
    to_c = center - pts
    to_c /= np.linalg.norm(to_c, axis=-1, keepdims=True)
    cos = (gd.numpy() * to_c).sum(-1)
    sin_max = 0.35 / np.linalg.norm(center - pts, axis=-1)
    assert (cos >= np.sqrt(1.0 - sin_max ** 2) - 1e-5).all()


def test_box_light_sampler_and_pdf_match_jax():
    """The sampler and the slab-test pdf against the JAX package's, and on
    the front faces the pdf of the sampled direction equals the sampler's
    (tests/test_legacy.py's check), on seeded points outside the box."""
    center = np.array([0.0, 2.0, 0.0], np.float32)
    w, h, d = 1.0, 0.5, 2.0
    pts, rng = _points_around(center, 22)
    u3 = rng.random((256, 3)).astype(np.float32)
    rd, rp = jsmp.sample_box_light(jnp.asarray(center), w, h, d,
                                   jnp.asarray(pts), jnp.asarray(u3))
    gd, gp = tsmp.sample_box_light(torch.from_numpy(center), w, h, d,
                                   torch.from_numpy(pts), torch.from_numpy(u3))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-5)
    ref_pdf = jsmp.box_light_pdf(jnp.asarray(center), w, h, d,
                                 jnp.asarray(pts), rd)
    pdf = tsmp.box_light_pdf(torch.from_numpy(center), w, h, d,
                             torch.from_numpy(pts), gd).numpy()
    np.testing.assert_allclose(pdf, np.asarray(ref_pdf), rtol=1e-5)
    front = gp.numpy() < 200.0  # a back face gives d^2 / 1e-6
    assert front.mean() > 0.3
    rel = np.abs(pdf[front] - gp.numpy()[front]) / np.maximum(
        gp.numpy()[front], 1e-3)
    assert np.median(rel) < 1e-3
    assert (rel < 0.05).mean() > 0.95


def test_box_light_pdf_zero_on_miss():
    pdf = tsmp.box_light_pdf(torch.tensor([0.0, 2.0, 0.0]), 1.0, 0.5, 1.0,
                             torch.zeros(1, 3), torch.tensor([[0.0, -1.0,
                                                               0.0]]))
    assert float(pdf[0]) == 0.0
