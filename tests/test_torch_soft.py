"""PyTorch port vs the JAX package: the edge-aware oracle
(``grad/diff_render.render_direct_soft``) and the silhouette records
(``ops/cuda_soft.silh_records_plain``, the plain version of ``silh_kernel``).

One JAX gradient evaluation of the oracle (module fixture) and one
interpret-mode call of the JAX record kernel per occluder setting, at 24 x 20
(not a multiple of the JAX kernel's 4,096-ray tile) x 2 spp, kappa 0.1, on
the sphere scene.

Tolerances: the oracle's value atol 2e-5 / rtol 1e-4 against the JAX
oracle's (the JAX package's own for path values) and atol 1e-6 against the
port's hard direct render (the soft value is the hard one by construction);
its gradients atol 1e-6 / rtol 1e-4 (the JAX package's own for path
gradients: both sides run the same f32 expression tree with visibility held
constant). The records are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.ops.pallas_soft as jsoft
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.grad.diff_render import \
    render_direct_soft as jax_render_direct_soft
from gpuraytracer_tpu.intersect import \
    potential_occluders as jax_potential_occluders
from gpuraytracer_tpu.ops.pallas_path import LANES, RAY_SUB
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import sampling as smp
from gpuraytracer_tpu_torch.grad.diff_render import render_direct_soft
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_soft
from gpuraytracer_tpu_torch.render import (pixel_coords, pixel_rng_offsets,
                                           render)
from gpuraytracer_tpu_torch.types import RenderConfig

W, H = 24, 20
CFG = dict(width=W, height=H, integrator="direct", spp=2, bounces=1,
           pixel_chunk=W * H)
KAPPA = 0.1
VALUE_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
GROUPS = [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "triangles.verts", "triangles.diffuse", "triangles.emissive",
    "light.color", "light.center", "light.normal",
    "camera.position", "camera.direction",
]


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, the same scene in the port)."""
    jax_scene = jscene.cornell_box_with_spheres(resolution=(W, H))
    return jax_scene, convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene))


def with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,spp", [("halton", 2), ("stratified", 4)])
def test_oracle_value_matches_jax(scenes, sampler, spp):
    """Both oracles take the camera jitter from Halton dimensions 0-1
    whatever the sampler: the same image under either setting."""
    jax_scene, scene = scenes
    kw = dict(CFG, sampler=sampler, spp=spp)
    ref = np.asarray(jax_render_direct_soft(jax_scene,
                                            jtypes.RenderConfig(**kw), KAPPA))
    got = render_direct_soft(scene, RenderConfig(**kw), KAPPA, device="cpu")
    assert got.shape == (H, W, 3) and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, **VALUE_TOL)


def test_oracle_value_equals_the_hard_render(scenes):
    _, scene = scenes
    cfg = RenderConfig(**CFG)
    soft = render_direct_soft(scene, cfg, KAPPA, device="cpu")
    hard = render(scene, cfg, device="cpu").hdr
    np.testing.assert_allclose(soft.numpy(), hard.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def oracle_grads(scenes):
    """(port gradient tree, JAX gradient tree) of the mean of the image."""
    jax_scene, scene = scenes
    ref = jax.grad(
        lambda s: jnp.mean(jax_render_direct_soft(
            s, jtypes.RenderConfig(**CFG), KAPPA)), allow_int=True)(jax_scene)
    scene = with_grad(scene)
    render_direct_soft(scene, RenderConfig(**CFG), KAPPA,
                       device="cpu").mean().backward()
    return convert.grads_to_numpy(scene), ref


@pytest.mark.parametrize("group", GROUPS)
def test_oracle_grads_match_jax(oracle_grads, group):
    got_tree, ref_tree = oracle_grads
    part, field = group.split(".")
    ref = np.asarray(getattr(getattr(ref_tree, part), field))
    got = got_tree[part][field]
    assert np.abs(ref).max() > 0.0, f"JAX gradient of {group} is all zero"
    assert got is not None and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


# ---------------------------------------------------------------------------
# The silhouette records
# ---------------------------------------------------------------------------

_JAX_RECORDS = {}


def jax_records(jax_scene, cull: bool):
    """The JAX record kernel's codes in interpret mode, [spp, H * W] (its
    tile layout unpacked), once per occluder setting."""
    if cull not in _JAX_RECORDS:
        cfg = jtypes.RenderConfig(**CFG)
        occ = jax_potential_occluders(jax_scene, cfg) if cull else None
        code = np.asarray(jsoft._silh_records(jax_scene, cfg, True,
                                              occluders=occ))
        tiles = code.reshape(-1, cfg.spp, RAY_SUB, LANES)
        _JAX_RECORDS[cull] = tiles.transpose(1, 0, 2, 3).reshape(
            cfg.spp, -1)[:, :W * H]
    return _JAX_RECORDS[cull]


def test_code2_constants():
    assert (cuda_soft.B_OCCB, cuda_soft.B_OCCS, cuda_soft.B_FRONT,
            cuda_soft.B_POT, cuda_soft.B_SIDX) == (
        jsoft._B_OCCB, jsoft._B_OCCS, jsoft._B_FRONT, jsoft._B_POT,
        jsoft._B_SIDX)
    assert cuda_soft.NSCAL_SOFT == jsoft.NSCAL_SOFT == 21
    assert cuda_soft.B_SIDX * (cuda_soft.MAX_SPHERES + 1) - 1 <= 2**31 - 1


@pytest.mark.parametrize("cull", [False, True])
def test_records_equal_the_jax_kernel(scenes, cull):
    jax_scene, scene = scenes
    cfg = RenderConfig(**CFG)
    occ = potential_occluders(scene, cfg) if cull else None
    if cull:
        assert occ == jax_potential_occluders(jax_scene,
                                              jtypes.RenderConfig(**CFG))
        assert not all(occ)
    got = cuda_soft.silh_records(scene, cfg, occluders=occ, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (cfg.spp, W * H)
    ref = jax_records(jax_scene, cull)
    np.testing.assert_array_equal(got.numpy(), ref)
    # Every field takes both of its values somewhere in the frame.
    prim, occ_b, occ_s, front, pot, s_idx = (
        f.numpy() for f in cuda_soft._decode(got))
    for field in (occ_b, occ_s, front, pot, prim >= 0):
        assert field.any() and not field.all()
    assert set(np.unique(s_idx)) == {0, 1}


def test_argmin_default_sends_near_misses_to_sphere_0(scenes):
    """A reference quirk kept in both packages: a ray that misses every
    sphere takes sphere 0 as its candidate (the argmin of all-1e30 roots), so
    its soft coverage is measured against sphere 0 even where it passes just
    outside sphere 1. Sphere 1's outer silhouette band then adds nothing to
    d(center of sphere 1)."""
    jax_scene, scene = scenes
    cfg = RenderConfig(**CFG)
    # Rays of the oracle (the records' rays are the same to the last bit or
    # two; the band below keeps a margin of 2 % of the radius).
    px, py = pixel_coords(cfg)
    offsets = pixel_rng_offsets(cfg)
    sp = scene.spheres
    near_miss = []
    for n in range(cfg.spp):
        ih = offsets + n
        uv = torch.stack([smp.halton(ih, 0), smp.halton(ih, 1)], dim=-1)
        cam = scene.camera
        o, d = smp.generate_camera_ray(cam.position, cam.direction, cam.up,
                                       cfg.resolution, cam.horizontal_fov,
                                       px, py, uv, cfg.integer_aspect)
        oc = sp.center[None] - o[:, None]                      # [n, S, 3]
        t_ca = (oc * d[:, None]).sum(-1)
        h = torch.sqrt(torch.clamp_min((oc * oc).sum(-1) - t_ca * t_ca, 0.0))
        ratio = h / sp.radius[None]
        near_miss.append((ratio[:, 0] > 1.02) & (ratio[:, 1] > 1.02)
                         & (ratio[:, 1] < 1.5) & (t_ca[:, 1] > 0))
    near_miss = torch.stack(near_miss).numpy()
    assert near_miss.sum() >= 3
    ref = jax_records(jax_scene, False)
    got = cuda_soft.silh_records(scene, cfg, device="cpu").numpy()
    for codes in (ref, got):
        s_idx = codes // cuda_soft.B_SIDX - 1
        front = (codes & cuda_soft.B_FRONT) != 0
        assert (s_idx[near_miss] == 0).all() and not front[near_miss].any()

    # The consequence: pixels all of whose rays are such near misses give
    # sphere 1's center no gradient at all.
    pixels = near_miss.all(axis=0)
    assert pixels.sum() >= 1
    mask = torch.from_numpy(pixels).reshape(H, W, 1).float()
    scene_g = with_grad(scene)
    (render_direct_soft(scene_g, cfg, KAPPA, device="cpu") * mask).sum(
        ).backward()
    assert torch.equal(scene_g.spheres.center.grad[1], torch.zeros(3))
