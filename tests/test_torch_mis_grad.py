"""PyTorch port vs the JAX package: gradients through the MIS oracle.

``torch.autograd`` through ``render.render_mis`` against ``jax.grad`` of the
JAX oracle's ``mean(render_mis(scene).hdr)``, at the size and for the
parameter groups of the JAX package's own MIS gradient tests
(``tests/test_mis_fused.py``: 16 x 8, 2 camera rays, 6 MIS samples; twelve
groups on the box scene, eight on the sphere scene). One JAX gradient
evaluation per scene (module-scoped fixtures).

Tolerance: that file's — atol 1e-5 * max(largest magnitude, 1), rtol 2e-4.
Both sides hold visibility piecewise constant and run the same f32
expression tree; the sums' order and an ulp of sin, cos, pow and rsqrt
differ. On the sphere scene a few isolated elements may sit on a clip or max
gate that an ulp flips in reverse mode (a different, individually valid
subgradient): all but a bounded handful are held to the tight bound, and
those to 1e-3 of the largest magnitude — the form of that file's sphere test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render_mis as jax_render_mis
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import cuda_mis
from gpuraytracer_tpu_torch.render import render_mis
from gpuraytracer_tpu_torch.scene import cornell_box, cornell_box_glossy
from gpuraytracer_tpu_torch.types import RenderConfig

CFG = dict(width=16, height=8, integrator="mis", camera_rays=2,
           mis_samples=6, pixel_chunk=128)

BOX_GROUPS = [
    "light.emitted_radiance", "light.center", "light.normal",
    "light.width", "light.depth",
    "triangles.verts", "triangles.diffuse", "triangles.metallic",
    "triangles.roughness",
    "camera.position", "camera.direction", "camera.up",
]
SPHERE_GROUPS = [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "triangles.verts", "triangles.diffuse",
    "light.emitted_radiance", "light.center", "camera.position",
]


def with_grad(scene):
    """A copy of ``scene`` whose float tensors are leaves that ask for a
    gradient."""
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _both_grads(ctor_name):
    """(port gradient tree, JAX gradient tree, port scene with .grad set)."""
    jax_scene = getattr(jscene, ctor_name)(resolution=(16, 8))
    jcfg = jtypes.RenderConfig(**CFG)
    g_jax = jax.grad(lambda s: jnp.mean(jax_render_mis(s, jcfg).hdr),
                     allow_int=True)(jax_scene)
    scene = with_grad(convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene)))
    with torch.autograd.set_detect_anomaly(True):
        render_mis(scene, RenderConfig(**CFG), device="cpu").hdr.mean(
            ).backward()
    return convert.grads_to_numpy(scene), g_jax, scene


@pytest.fixture(scope="module")
def box_grads():
    return _both_grads("cornell_box")


@pytest.fixture(scope="module")
def sphere_grads():
    return _both_grads("cornell_box_with_spheres")


def _pair(grads, group):
    got_tree, ref_tree, _ = grads
    part, field = group.split(".")
    got = got_tree[part][field]
    ref = np.asarray(getattr(getattr(ref_tree, part), field))
    assert np.abs(ref).max() > 0.0, f"JAX gradient of {group} is all zero"
    assert got is not None and got.shape == ref.shape
    return got, ref


@pytest.mark.parametrize("group", BOX_GROUPS)
def test_mis_oracle_grads_match_jax(box_grads, group):
    got, ref = _pair(box_grads, group)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(scale, 1.0),
                               rtol=2e-4)


@pytest.mark.parametrize("group", SPHERE_GROUPS)
def test_mis_oracle_sphere_scene_grads_match_jax(sphere_grads, group):
    got, ref = _pair(sphere_grads, group)
    scale = np.abs(ref).max()
    d = np.abs(got - ref)
    tight = 1e-5 * max(scale, 1.0) + 2e-4 * np.abs(ref)
    n_out = int((d > tight).sum())
    assert n_out <= max(3, got.size // 20), (group, n_out, got.size)
    assert d.max() <= 1e-3 * max(scale, 1.0), (group, float(d.max()), scale)


def test_every_mis_gradient_is_finite(box_grads, sphere_grads):
    """The fixtures ran under anomaly detection; no masked lane (the
    roughness-0 light material the double-where reciprocal guards) leaks a
    NaN or an infinity into a gradient."""
    for tree, _, _ in (box_grads, sphere_grads):
        leaves = [g for part in tree.values() for g in part.values()
                  if g is not None]
        assert len(leaves) >= 12
        assert all(np.isfinite(g).all() for g in leaves)
    tree, _, _ = box_grads
    # Variant A reads metallic and roughness; the path tracer's light
    # colour it does not.
    assert np.abs(tree["triangles"]["roughness"]).max() > 0.0
    assert (tree["light"]["color"] is None
            or not np.abs(tree["light"]["color"]).any())


@pytest.mark.parametrize("ctor,kw", [
    (cornell_box, dict(width=32, height=16)),
    (cornell_box_glossy, dict(width=32, height=16, mis_samples=12,
                              sampler="stratified")),
])
def test_no_nan_under_anomaly_detection(ctor, kw):
    """A frame with misses, direct hits of the light and specular lobes
    (32 x 16), under anomaly detection."""
    cfg = RenderConfig(**dict(CFG, **kw))
    scene = with_grad(ctor(resolution=cfg.resolution))
    with torch.autograd.set_detect_anomaly(True):
        render_mis(scene, cfg, device="cpu").hdr.mean().backward()
    got = [t.grad for t in scene.tensors() if t.grad is not None]
    assert len(got) >= 12
    assert all(torch.isfinite(g).all() for g in got)


def test_kernel_entry_point_gives_the_oracles_gradients():
    """``render_mis_cuda`` on the CPU: the plain version's image forward,
    autograd through the oracle backward — the oracle's gradients bit for
    bit, for a weighted loss."""
    cfg = RenderConfig(**CFG)
    base = cornell_box(resolution=(16, 8))
    weight = torch.from_numpy(np.random.default_rng(5).random(
        size=(8, 16, 3)).astype(np.float32))
    a, b = with_grad(base), with_grad(base)
    out = cuda_mis.render_mis_cuda(a, cfg, device="cpu")
    assert out.requires_grad
    (out * weight).sum().backward()
    (render_mis(b, cfg, device="cpu").hdr * weight).sum().backward()
    n = 0
    for ta, tb in zip(a.tensors(), b.tensors()):
        assert (ta.grad is None) == (tb.grad is None)
        if ta.grad is not None:
            assert torch.equal(ta.grad, tb.grad)
            n += 1
    assert n >= 12
    # Only the leaves that ask get a gradient.
    c = base.map(lambda t: t.detach().clone())
    em = c.light.emitted_radiance.requires_grad_(True)
    cuda_mis.render_mis_cuda(c, cfg, device="cpu").mean().backward()
    assert em.grad is not None and torch.isfinite(em.grad).all()
    assert all(t.grad is None for t in c.tensors() if t is not em)


def test_kernel_entry_point_backward_in_pixel_ranges(monkeypatch):
    """The backward holds the graph of one pixel range at a time: with room
    for 48 of the 128 pixels (three ranges, the last a remainder) the
    gradients are the whole-frame oracle's up to the order of the sums over
    pixels — atol 1e-6 * max(largest magnitude, 1), rtol 1e-5."""
    cfg = RenderConfig(**CFG)
    steps = cfg.camera_rays * (cfg.mis_samples // 3)
    monkeypatch.setattr(cuda_mis, "BACKWARD_LANE_STEPS", 48 * steps)
    base = cornell_box_glossy(resolution=(16, 8))
    weight = torch.from_numpy(np.random.default_rng(6).random(
        size=(8, 16, 3)).astype(np.float32))
    a, b = with_grad(base), with_grad(base)
    (cuda_mis.render_mis_cuda(a, cfg, device="cpu") * weight).sum().backward()
    (render_mis(b, cfg, device="cpu").hdr * weight).sum().backward()
    n = 0
    for ta, tb in zip(a.tensors(), b.tensors()):
        assert (ta.grad is None) == (tb.grad is None)
        if ta.grad is not None:
            scale = max(float(tb.grad.abs().max()), 1.0)
            np.testing.assert_allclose(ta.grad.numpy(), tb.grad.numpy(),
                                       atol=1e-6 * scale, rtol=1e-5)
            n += 1
    assert n >= 12


def test_unported_backward_raises_instead_of_falling_back():
    """The fast differentiable path's backward kernel waits for its slice:
    a scene that asks for gradients raises, naming it; the bare trace
    refuses gradients too."""
    cfg = RenderConfig(**CFG)
    scene = with_grad(cornell_box(resolution=(16, 8)))
    with pytest.raises(NotImplementedError, match="K5"):
        cuda_mis.render_mis_decoupled(scene, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="render_mis_cuda"):
        cuda_mis.render_mis_cuda_impl(scene, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="render_mis_cuda"):
        cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                      device="cpu")
    out = cuda_mis.render_mis_decoupled(scene.detach(), cfg, device="cpu")
    assert not out.requires_grad and out.shape == (8, 16, 3)
