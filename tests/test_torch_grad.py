"""PyTorch port vs the JAX package: gradients through the eager oracle.

``torch.autograd`` through ``render.render_path`` against ``jax.grad`` of
the JAX oracle's ``mean(render(scene).hdr)``, for every parameter group the
JAX package's own gradient tests check. One JAX gradient evaluation per scene
(module-scoped fixtures), at the JAX tests' size: 16 x 8, 2 spp, 2 bounces.

Tolerance: atol 1e-6 / rtol 1e-4, the JAX package's own for path gradients
(``tests/test_pallas_shade.py``): both sides hold visibility piecewise
constant and run the same f32 expression tree, so only the order of the sums
and an ulp of sin, cos and rsqrt differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render as jax_render
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import cuda_path
from gpuraytracer_tpu_torch.render import render_path
from gpuraytracer_tpu_torch.scene import (cornell_box,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
CFG = dict(width=16, height=8, integrator="path", spp=2, bounces=2,
           pixel_chunk=128)

BOX_GROUPS = [
    "light.color", "light.center", "light.normal",
    "triangles.verts", "triangles.diffuse", "triangles.emissive",
    "camera.position", "camera.direction", "camera.up",
]
SPHERE_GROUPS = BOX_GROUPS + [
    "spheres.center", "spheres.radius", "spheres.diffuse"]


def with_grad(scene):
    """A copy of ``scene`` whose float tensors are leaves that ask for a
    gradient."""
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _both_grads(ctor_name):
    """(port gradient tree, JAX gradient tree, port scene with .grad set)."""
    jax_scene = getattr(jscene, ctor_name)(resolution=(16, 8))
    jcfg = jtypes.RenderConfig(**CFG)
    g_jax = jax.grad(lambda s: jnp.mean(jax_render(s, jcfg).hdr),
                     allow_int=True)(jax_scene)
    scene = with_grad(convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene)))
    with torch.autograd.set_detect_anomaly(True):
        render_path(scene, RenderConfig(**CFG), device="cpu").hdr.mean(
            ).backward()
    return convert.grads_to_numpy(scene), g_jax, scene


@pytest.fixture(scope="module")
def box_grads():
    return _both_grads("cornell_box")


@pytest.fixture(scope="module")
def sphere_grads():
    return _both_grads("cornell_box_with_spheres")


def _check_group(grads, group):
    got_tree, ref_tree, _ = grads
    part, field = group.split(".")
    got = got_tree[part][field]
    ref = np.asarray(getattr(getattr(ref_tree, part), field))
    assert np.abs(ref).max() > 0.0, f"JAX gradient of {group} is all zero"
    assert got is not None and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("group", BOX_GROUPS)
def test_oracle_grads_match_jax(box_grads, group):
    _check_group(box_grads, group)


@pytest.mark.parametrize("group", SPHERE_GROUPS)
def test_oracle_sphere_scene_grads_match_jax(sphere_grads, group):
    _check_group(sphere_grads, group)


def test_every_gradient_is_finite(box_grads, sphere_grads):
    """No masked lane leaks a NaN or an infinity into a gradient: the guards
    before sqrt, divide and rsqrt hold in the backward pass too (the
    fixtures ran under anomaly detection)."""
    for tree, _, _ in (box_grads, sphere_grads):
        leaves = [g for part in tree.values() for g in part.values()
                  if g is not None]
        assert len(leaves) >= 10
        assert all(np.isfinite(g).all() for g in leaves)


def test_unused_leaves_have_no_gradient(sphere_grads):
    """The path tracer reads neither metallic nor roughness, and integer
    leaves carry no gradient: their entries are None, in a tree shaped like
    ``scene_to_numpy``'s."""
    tree, _, scene = sphere_grads
    shape = convert.scene_to_numpy(scene)
    assert {p: sorted(f) for p, f in tree.items()} == {
        p: sorted(f) for p, f in shape.items()}
    assert tree["triangles"]["metallic"] is None
    assert tree["spheres"]["roughness"] is None
    assert tree["camera"]["resolution"] is None


def test_grads_to_numpy_takes_an_autograd_result():
    scene = cornell_box(resolution=(16, 8))
    color = scene.light.color.clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, light=dataclasses.replace(scene.light, color=color))
    out = render_path(scene, RenderConfig(**CFG), device="cpu").hdr.mean()
    (g,) = torch.autograd.grad(out, [color])
    grads = [g if t is color else None for t in scene.tensors()]
    tree = convert.grads_to_numpy(scene, grads)
    np.testing.assert_array_equal(tree["light"]["color"], g.numpy())
    assert tree["light"]["center"] is None


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres])
def test_three_bounce_gradients_are_finite(ctor):
    """A frame with misses, emissive hits and all three bounces (32 x 16),
    under anomaly detection."""
    scene = with_grad(ctor(resolution=(32, 16)))
    cfg = RenderConfig(width=32, height=16, spp=2, bounces=3, pixel_chunk=512)
    with torch.autograd.set_detect_anomaly(True):
        render_path(scene, cfg, device="cpu").hdr.mean().backward()
    got = [t.grad for t in scene.tensors() if t.grad is not None]
    assert len(got) >= 9
    assert all(torch.isfinite(g).all() for g in got)


def test_struct_map_detach_and_order():
    scene = with_grad(cornell_box_with_spheres(resolution=(16, 8)))
    cut = scene.detach()
    assert not any(t.requires_grad for t in cut.tensors())
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(scene.tensors(), cut.tensors()))
    # map visits the tensors in the order tensors() yields them.
    seen = []
    scene.map(lambda t: seen.append(t) or t)
    assert all(a is b for a, b in zip(seen, scene.tensors()))
    assert len(seen) == len(list(scene.tensors()))


def test_camera_vector_is_the_trace_kernels_camera():
    scene = with_grad(cornell_box(resolution=(32, 16)))
    cfg = RenderConfig(width=32, height=16, integer_aspect=False)
    vec = cuda_path.camera_vector(scene.camera, cfg)
    assert vec.shape == (12,) and vec.requires_grad
    packed = cuda_path._pack_inputs(scene.detach(), cfg)
    assert torch.equal(vec.detach(), packed.cam)
    grads = torch.autograd.grad(vec.sum(), [scene.camera.position,
                                            scene.camera.direction,
                                            scene.camera.up])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
