"""PyTorch port vs the JAX package: closest-hit and any-hit queries on
numpy-seeded rays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.intersect as jint
import gpuraytracer_tpu.scene as jscene
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import intersect as tint

N_RAYS = 4096
# Rays whose two nearest candidates lie closer than this in t may pick
# either one: the two packages round a dot product differently (fused or
# not), and a tie broken by the last bit is not a disagreement.
TIE = 1e-5


def _scenes(name):
    ctor = (jscene.cornell_box if name == "cornell"
            else jscene.cornell_box_with_spheres)
    jax_scene = ctor(resolution=(32, 16))
    return jax_scene, convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene))


def _rays(seed, scene):
    """Origins inside the box, directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    verts = np.asarray(scene.triangles.verts).reshape(-1, 3)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o = (lo + (hi - lo) * (0.05 + 0.9 * rng.random(size=(N_RAYS, 3))))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _near_tie(compiled, spheres, o, d, t_min, t_max):
    """Rays whose best two valid candidates are within TIE of each other,
    or whose best candidate sits within TIE of a validity limit."""
    t, valid = tint._triangle_candidates(compiled, o, d, t_min, t_max)
    if spheres is not None and spheres.num_spheres:
        ts, vs = tint._sphere_candidates(spheres, o, d, t_min, t_max)
        t, valid = torch.cat([t, ts], -1), torch.cat([valid, vs], -1)
    masked = torch.where(valid, t, torch.full_like(t, 1e30))
    best2 = torch.topk(masked, 2, dim=-1, largest=False).values
    gap = best2[..., 1] - best2[..., 0]
    # A ray with no valid candidate (the box is open towards the camera) is
    # a plain miss, not a tie.
    return (best2[..., 0] < 1e29) & (gap < TIE * best2[..., 0].clamp_min(1.0))


@pytest.mark.parametrize("name", ["cornell", "cornell-spheres"])
def test_closest_hit_matches_jax(name):
    jax_scene, scene = _scenes(name)
    o, d = _rays(11, jax_scene)
    jc = jint.compile_scene(jax_scene.triangles, lane_pad=1)
    tc = tint.compile_scene(scene.triangles)
    jsph = jax_scene.spheres if jax_scene.spheres.num_spheres else None
    tsph = scene.spheres if scene.spheres.num_spheres else None
    ref = jint.closest_hit(jc, jnp.asarray(o), jnp.asarray(d), spheres=jsph)
    got = tint.closest_hit(tc, torch.from_numpy(o), torch.from_numpy(d),
                           spheres=tsph)
    keep = ~_near_tie(tc, tsph, torch.from_numpy(o), torch.from_numpy(d),
                      tint.RAY_TMIN, tint.RAY_TMAX).numpy()
    assert keep.mean() > 0.95
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy()[keep], hit[keep])
    both = keep & hit
    assert both.sum() > N_RAYS // 2  # most rays meet a wall
    np.testing.assert_array_equal(got.prim.numpy()[both],
                                  np.asarray(ref.prim)[both])
    # t = (c0 - o.n) / (d.n): the subtraction cancels at coordinates of a
    # few units, which leaves an absolute error of a few f32 ulps of those
    # coordinates (2e-6) under the relative one on hits close to the origin.
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-5, atol=2e-6)
    for field in ("normal", "diffuse", "emissive"):
        np.testing.assert_allclose(
            getattr(got, field).numpy()[both],
            np.asarray(getattr(ref, field))[both], atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(got.is_emissive.numpy()[both],
                                  np.asarray(ref.is_emissive)[both])
    if tsph is not None:
        assert (got.prim.numpy()[both] >= tc.num_triangles).any()


@pytest.mark.parametrize("name", ["cornell", "cornell-spheres"])
def test_any_hit_matches_jax(name):
    jax_scene, scene = _scenes(name)
    o, d = _rays(12, jax_scene)
    rng = np.random.default_rng(13)
    t_max = (0.2 + 3.0 * rng.random(size=N_RAYS)).astype(np.float32)
    jc = jint.compile_scene(jax_scene.triangles, lane_pad=1)
    tc = tint.compile_scene(scene.triangles)
    jsph = jax_scene.spheres if jax_scene.spheres.num_spheres else None
    tsph = scene.spheres if scene.spheres.num_spheres else None
    ref = np.asarray(jint.any_hit(jc, jnp.asarray(o), jnp.asarray(d), 0.0,
                                  jnp.asarray(t_max), jsph))
    got = tint.any_hit(tc, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                       torch.from_numpy(t_max), tsph).numpy()
    # A ray whose nearest candidate lies within TIE of its own t_max may
    # flip; everything else must agree.
    h = tint.closest_hit(tc, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                         1e3, tsph)
    keep = np.abs(h.t.numpy() - t_max) > TIE
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got[keep], ref[keep])
    assert 0.05 < got.mean() < 0.95  # both outcomes are exercised


def test_closest_hit_miss_outside_the_box():
    _, scene = _scenes("cornell")
    tc = tint.compile_scene(scene.triangles)
    o = torch.tensor([[0.0, 50.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])
    h = tint.closest_hit(tc, o, d)
    assert not bool(h.hit[0]) and float(h.t[0]) >= 1e29
    assert not bool(tint.any_hit(tc, o, d)[0])
