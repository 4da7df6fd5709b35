"""PyTorch port vs the JAX package: the variant-A MIS integrator's eager
oracle (``render.render_mis``), on the five shapes the JAX package's own
kernel-parity tests use.

One JAX oracle render per shape (module-scoped fixture). Tolerance: the JAX
package's own for MIS values, atol 5e-4 / rtol 1e-3
(``tests/test_pallas.py``): a pixel is a sum of a few thousand f32 terms whose
BRDF and pdf factors carry an ulp of sin, cos, pow and rsqrt each, and the
specular lobe amplifies the last bit of its half vector.
"""
import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render_mis as jax_render_mis
from gpuraytracer_tpu.render import tonemap_mis as jax_tonemap_mis
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch.render import (camera_exposure, reinhard, render,
                                           render_mis, tonemap_mis)
from gpuraytracer_tpu_torch.types import RenderConfig

MIS_TOL = dict(atol=5e-4, rtol=1e-3)

# name -> (scene constructor, resolution, config overrides)
SHAPES = {
    "box": ("cornell_box", (32, 16), dict(camera_rays=1, mis_samples=6)),
    "two-camera-rays": ("cornell_box", (32, 16),
                        dict(camera_rays=2, mis_samples=3)),
    "spheres": ("cornell_box_with_spheres", (32, 32),
                dict(camera_rays=1, mis_samples=6)),
    "non-tile-multiple": ("cornell_box", (24, 18),
                          dict(camera_rays=1, mis_samples=6)),
    "glossy-stratified": ("cornell_box_glossy", (32, 16),
                          dict(camera_rays=1, mis_samples=12,
                               sampler="stratified")),
}


def mis_config(cls, resolution, **kw):
    base = dict(width=resolution[0], height=resolution[1], integrator="mis",
                pixel_chunk=512)
    base.update(kw)
    return cls(**base)


def carry(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


@pytest.fixture(scope="module", params=sorted(SHAPES))
def shape(request):
    ctor, resolution, kw = SHAPES[request.param]
    jax_scene = getattr(jscene, ctor)(resolution=resolution)
    ref = jax_render_mis(jax_scene,
                         mis_config(jtypes.RenderConfig, resolution, **kw))
    return (carry(jax_scene), mis_config(RenderConfig, resolution, **kw),
            np.asarray(ref.hdr), np.asarray(ref.ldr))


def test_render_mis_matches_jax(shape):
    scene, cfg, ref_hdr, ref_ldr = shape
    out = render_mis(scene, cfg, device="cpu")
    assert out.hdr.shape == (cfg.height, cfg.width, 3)
    assert out.hdr.dtype == torch.float32
    worst = np.abs(out.hdr.numpy() - ref_hdr).max()
    np.testing.assert_allclose(
        out.hdr.numpy(), ref_hdr, **MIS_TOL,
        err_msg=f"largest |port - jax| = {worst:.3e}")
    # The tone curve compresses: the ldr images agree far tighter.
    np.testing.assert_allclose(out.ldr.numpy(), ref_ldr, atol=1e-4)
    assert out.ldr.min() >= 0.0 and out.ldr.max() <= 1.0


def test_render_dispatches_mis_and_chunks_do_not_matter(shape):
    scene, cfg, _, _ = shape
    whole = render(scene, cfg.replace(pixel_chunk=cfg.num_pixels),
                   device="cpu")
    chunked = render_mis(scene, cfg.replace(pixel_chunk=100), device="cpu")
    assert whole.ldr is not None
    assert torch.equal(whole.hdr, chunked.hdr)


def test_tonemap_mis_matches_jax():
    rng = np.random.default_rng(21)
    acc = (rng.random(size=(12, 16, 3)) * 60.0).astype(np.float32)
    acc[0, 0] = 0.0
    for rays, ev100 in ((6, 5.0), (1, 3.5)):
        ref = np.asarray(jax_tonemap_mis(acc, rays, np.float32(ev100)))
        got = tonemap_mis(torch.from_numpy(acc), rays,
                          torch.tensor(ev100)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        camera_exposure(torch.tensor(5.0)).item(), 1.0 / (1.2 * 32.0),
        rtol=1e-6)
    assert reinhard(torch.tensor([-1.0, 0.0, 1.0, 1e9])).tolist() == [
        0.0, 0.0, 0.5, 1.0]


def test_glossy_scene_materials():
    """``cornell_box_glossy`` is the one stock scene whose metallic and
    roughness are non-trivial; both packages build it bit for bit, and the
    material rows cross ``convert.scene_from_numpy`` untouched."""
    jax_scene = jscene.cornell_box_glossy(resolution=(32, 16))
    scene = tscene.cornell_box_glossy(resolution=(32, 16))
    assert convert.scenes_equal(scene, carry(jax_scene))
    tri = scene.triangles
    for field in ("metallic", "roughness", "emissive", "diffuse"):
        np.testing.assert_array_equal(
            getattr(tri, field).numpy(),
            np.asarray(getattr(jax_scene.triangles, field)))
    # Tall box specular (0.9 / 0.3), short box glossy (0.9 / 0.1), light 0 / 0.
    assert tri.metallic[10:22].tolist() == pytest.approx([0.9] * 12)
    assert tri.roughness[10:22].tolist() == pytest.approx([0.3] * 12)
    assert tri.roughness[22:34].tolist() == pytest.approx([0.1] * 12)
    assert tri.roughness[34:].tolist() == [0.0, 0.0]
    assert tri.emissive[34:].tolist() == [[1.0, 1.0, 1.0]] * 2


def test_sphere_scene_materials_cross_convert_bit_for_bit():
    jax_scene = jscene.cornell_box_with_spheres(resolution=(32, 32))
    scene = carry(jax_scene)
    for field in ("metallic", "roughness", "emissive"):
        for part in ("triangles", "spheres"):
            np.testing.assert_array_equal(
                getattr(getattr(scene, part), field).numpy(),
                np.asarray(getattr(getattr(jax_scene, part), field)))
    assert scene.spheres.metallic.tolist() == pytest.approx([0.05, 0.3])


def test_render_mis_rejects_empty_sample_counts():
    scene = tscene.cornell_box(resolution=(8, 8))
    cfg = mis_config(RenderConfig, (8, 8))
    with pytest.raises(ValueError, match="mis_samples"):
        render_mis(scene, cfg.replace(mis_samples=2), device="cpu")
    with pytest.raises(ValueError, match="camera_rays"):
        render_mis(scene, cfg.replace(camera_rays=0), device="cpu")
