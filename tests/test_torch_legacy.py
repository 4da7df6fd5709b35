"""PyTorch port vs the JAX package: the legacy tier — its scenes, the
recursive beta = 2 integrator (values and gradients) and its dispatch.

The light samplers and pdfs are held in tests/test_torch_sampling.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render_legacy import render_legacy as jax_render_legacy
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch.render import render
from gpuraytracer_tpu_torch.render_legacy import render_legacy
from gpuraytracer_tpu_torch.types import RenderConfig

# The path tolerances of ROADMAP.md: values, gradients.
HDR_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
KINDS = ("sphere", "box", "square")
# legacy_samples = legacy_bounce_samples = 3 and two bounces: one sample per
# strategy at both levels, so the nested recursion runs at the least cost.
NESTED = dict(width=16, height=16, integrator="legacy", legacy_samples=3,
              legacy_bounce_samples=3, legacy_bounces=2, pixel_chunk=256)
GRAD = dict(NESTED, legacy_bounces=1)


def _to_port(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's frames at NESTED, one per light kind."""
    cfg = jtypes.RenderConfig(**NESTED)
    return {kind: np.asarray(jax.jit(lambda s: jax_render_legacy(s, cfg).hdr)(
        jscene.legacy_cornell(kind, resolution=(16, 16)))) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_legacy_cornell_equals_jax(kind):
    """The port's legacy scenes equal the JAX package's, carried across by
    ``convert`` both ways with equal bits."""
    ours = tscene.legacy_cornell(kind, resolution=(40, 30))
    jax_scene = jscene.legacy_cornell(kind, resolution=(40, 30))
    assert convert.scenes_equal(ours, _to_port(jax_scene))
    tree = convert.scene_to_numpy(ours)
    for part, fields in tree.items():
        for name, value in fields.items():
            theirs = np.asarray(getattr(getattr(jax_scene, part), name))
            assert value.dtype == theirs.dtype and value.shape == theirs.shape
            assert value.tobytes() == theirs.tobytes(), (part, name)
    assert ours.sphere_lights.num_lights == (kind == "sphere")
    assert ours.box_lights.num_lights == (kind == "box")


def test_light_constructors_equal_jax():
    args = ([(0.0, 2.0, 0.0), (1.0, 0.5, -1.0)], [0.3, 0.1],
            [(1.0, 0.9, 0.8), (0.2, 0.4, 0.6)])
    ours = tscene.make_sphere_lights(*args)
    theirs = jscene.make_sphere_lights(*args)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(theirs, f.name)))
    args = ([(0.0, 2.0, 0.0)], [(1.0, 0.5, 2.0)], [(1.0, 1.0, 1.0)])
    ours = tscene.make_box_lights(*args)
    theirs = jscene.make_box_lights(*args)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(theirs, f.name)))
    with pytest.raises(ValueError):
        tscene.legacy_cornell("cone")


@pytest.mark.parametrize("kind", KINDS)
def test_render_legacy_matches_jax(kind, jax_frames):
    """Both recursion levels run (two bounces); the frame equals the JAX
    package's within the path tolerance, and it is lit."""
    scene = tscene.legacy_cornell(kind, resolution=(16, 16))
    with torch.no_grad():
        out = render_legacy(scene, RenderConfig(**NESTED), device="cpu")
    assert out.ldr is None
    hdr = out.hdr.numpy()
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert (hdr >= 0.0).all() and hdr.max() > 0.0
    np.testing.assert_allclose(hdr, jax_frames[kind], **HDR_TOL)


def test_render_dispatches_legacy(jax_frames):
    out = render(tscene.legacy_cornell("box", resolution=(16, 16)),
                 RenderConfig(**NESTED), device="cpu")
    np.testing.assert_allclose(out.hdr.detach().numpy(), jax_frames["box"],
                               **HDR_TOL)


def test_sphere_light_directly_visible():
    """Camera rays that land on the emissive sphere return its radiance
    (intersectLight -> HitLight, shaders_old.metal:138-170)."""
    scene = tscene.legacy_cornell("sphere", resolution=(48, 48))
    cfg = RenderConfig(**dict(NESTED, width=48, height=48,
                              pixel_chunk=2304, legacy_bounces=1))
    with torch.no_grad():
        hdr = render_legacy(scene, cfg, device="cpu").hdr.numpy()
    emitted = scene.sphere_lights.emitted_radiance[0].numpy()
    hits = np.all(hdr == emitted, axis=-1)
    assert 0 < hits.sum() < hdr.shape[0] * hdr.shape[1] // 4
    # The light sits at (0, 1.9, 0): the upper middle of the frame.
    rows, cols = np.nonzero(hits)
    assert rows.max() < 24 and abs(cols.mean() - 23.5) < 4


def test_legacy_gradients_match_jax_grad():
    """d mean(hdr) / d (sphere-light radiance, sphere centers) against
    jax.grad of the JAX package's integrator (one bounce, one sample per
    strategy), through the port's per-sample checkpoints."""
    jax_scene = jscene.legacy_cornell("sphere", resolution=(16, 16))
    jcfg = jtypes.RenderConfig(**GRAD)

    def loss(emitted, centers):
        s = dataclasses.replace(
            jax_scene,
            sphere_lights=dataclasses.replace(jax_scene.sphere_lights,
                                              emitted_radiance=emitted),
            spheres=dataclasses.replace(jax_scene.spheres, center=centers))
        return jnp.mean(jax_render_legacy(s, jcfg).hdr)

    ref_em, ref_c = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax_scene.sphere_lights.emitted_radiance, jax_scene.spheres.center)

    scene = tscene.legacy_cornell("sphere", resolution=(16, 16))
    emitted = scene.sphere_lights.emitted_radiance.clone().requires_grad_()
    centers = scene.spheres.center.clone().requires_grad_()
    scene = dataclasses.replace(
        scene,
        sphere_lights=dataclasses.replace(scene.sphere_lights,
                                          emitted_radiance=emitted),
        spheres=dataclasses.replace(scene.spheres, center=centers))
    value = render_legacy(scene, RenderConfig(**GRAD), device="cpu").hdr.mean()
    g_em, g_c = torch.autograd.grad(value, [emitted, centers])
    assert np.abs(np.asarray(ref_em)).sum() > 0
    assert np.abs(np.asarray(ref_c)).sum() > 0
    np.testing.assert_allclose(g_em.numpy(), np.asarray(ref_em), **GRAD_TOL)
    np.testing.assert_allclose(g_c.numpy(), np.asarray(ref_c), **GRAD_TOL)
