"""PyTorch port vs the JAX package: the module that holds the MIS kernel
(``ops/cuda_mis.py``), through its plain version on the CPU.

The JAX side runs its Pallas kernel in interpret mode with records on, once
per shape (module-scoped fixture; interpret mode is slow): the same five
shapes as ``test_torch_mis.py``. Image tolerance: the JAX package's own for
MIS values, atol 5e-4 / rtol 1e-3. Records: the two int32 streams are
compared everywhere, dead lanes included, after un-tiling the JAX kernel's
tile-major planes; a share of at most 0.5 % may differ (an ulp between the
two compilers flips a closest hit or a probe on a knife-edge ray), and the
count is printed.
"""
import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.ops.pallas_mis as jmis
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_mis
from gpuraytracer_tpu_torch.ops.cuda_path import shadow_indices
from gpuraytracer_tpu_torch.render import render_mis
from gpuraytracer_tpu_torch.types import RenderConfig
from test_torch_mis import MIS_TOL, SHAPES, carry, mis_config

FLIP_SHARE_MAX = 0.005


def untile(planes, camera_rays, s_per, n):
    """The JAX kernel's record planes — blocks of [32, 128] pixels per
    (tile, camera ray), sample-major inside a block — as the port's
    ``[camera_rays, N]`` and ``[camera_rays, s_per, N]``."""
    cam, smp = (np.asarray(p) for p in planes)
    tiles = cam.size // (camera_rays * jmis.TILE)
    cam = cam.reshape(tiles, camera_rays, jmis.TILE).transpose(1, 0, 2)
    smp = smp.reshape(tiles, camera_rays, s_per, jmis.TILE).transpose(
        1, 2, 0, 3)
    return (cam.reshape(camera_rays, -1)[:, :n],
            smp.reshape(camera_rays, s_per, -1)[..., :n])


@pytest.fixture(scope="module", params=sorted(SHAPES))
def traced(request):
    """(port scene, config, JAX kernel hdr, JAX camera records, JAX sample
    records, the plain version's hdr and records) for one shape."""
    ctor, resolution, kw = SHAPES[request.param]
    jax_scene = getattr(jscene, ctor)(resolution=resolution)
    jcfg = mis_config(jtypes.RenderConfig, resolution, **kw)
    hdr, planes = jmis._render_mis_impl(jax_scene, jcfg, interpret=True,
                                        emit_records=True)
    cfg = mis_config(RenderConfig, resolution, **kw)
    cam, smp = untile(planes, cfg.camera_rays, cfg.mis_samples // 3,
                      cfg.num_pixels)
    scene = carry(jax_scene)
    got_hdr, got_rec = cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, device="cpu")
    return scene, cfg, np.asarray(hdr), cam, smp, got_hdr, got_rec


def test_plain_version_matches_jax_kernel(traced):
    _, cfg, ref, _, _, hdr, _ = traced
    assert hdr.shape == (cfg.height, cfg.width, 3)
    worst = np.abs(hdr.numpy() - ref).max()
    np.testing.assert_allclose(hdr.numpy(), ref, **MIS_TOL,
                               err_msg=f"largest |port - jax| = {worst:.3e}")


def test_plain_version_matches_port_oracle(traced):
    scene, cfg, _, _, _, hdr, _ = traced
    oracle = render_mis(scene, cfg, device="cpu").hdr
    worst = (hdr - oracle).abs().max().item()
    np.testing.assert_allclose(hdr.numpy(), oracle.numpy(), **MIS_TOL,
                               err_msg=f"largest |plain - oracle| = {worst:.3e}")


def test_records_match_jax_kernel(traced, capsys):
    _, cfg, _, cam, smp, _, rec = traced
    s_per = cfg.mis_samples // 3
    assert rec.camera.shape == (cfg.camera_rays, cfg.num_pixels)
    assert rec.samples.shape == (cfg.camera_rays, s_per, cfg.num_pixels)
    assert rec.camera.dtype == rec.samples.dtype == torch.int32
    cam_differ = int((rec.camera.numpy() != cam).sum())
    smp_differ = int((rec.samples.numpy() != smp).sum())
    with capsys.disabled():
        print(f"\n  records that differ from the JAX kernel's: camera "
              f"{cam_differ}/{cam.size}, samples {smp_differ}/{smp.size}")
    assert cam_differ <= FLIP_SHARE_MAX * cam.size
    assert smp_differ <= FLIP_SHARE_MAX * smp.size


def test_record_fields_are_the_documented_layout(traced):
    """reach bits, then two 14-bit codes of prim + 1 (0 = miss); the lobe
    winners lie in the scene, and the camera record decides which lanes'
    samples feed the image."""
    scene, cfg, _, _, _, hdr, rec = traced
    n_prims = scene.triangles.num_triangles + scene.spheres.num_spheres
    s = rec.samples
    mask = cuda_mis.REC_CODE_MASK
    cos_code = (s >> cuda_mis.REC_SHIFT_C) & mask
    vndf_code = (s >> cuda_mis.REC_SHIFT_V) & mask
    assert int(cos_code.max()) <= n_prims and int(vndf_code.max()) <= n_prims
    assert int(rec.camera.min()) >= 0 and int(rec.camera.max()) <= n_prims
    rebuilt = ((s & 1) | (s & 2) | (s & 4) | (cos_code << cuda_mis.REC_SHIFT_C)
               | (vndf_code << cuda_mis.REC_SHIFT_V))
    assert torch.equal(rebuilt, s)
    # A pixel none of whose camera rays hit anything is black.
    missed = (rec.camera == 0).all(dim=0).reshape(cfg.height, cfg.width)
    assert torch.equal(hdr[missed], torch.zeros_like(hdr[missed]))


def test_records_on_and_off_give_the_same_image(traced):
    scene, cfg, _, _, _, hdr, _ = traced
    assert torch.equal(
        cuda_mis.render_mis_cuda_impl(scene, cfg, device="cpu"), hdr)
    assert torch.equal(cuda_mis.render_mis_cuda(scene, cfg, device="cpu"),
                       hdr)


def test_occluder_cull_preserves_the_render(traced):
    """Culling the triangles that cannot block a light probe changes no
    decision that feeds the image: atol 5e-8 / rtol 1e-6, the JAX package's
    own limit for this (``tests/test_mis_fused.py``)."""
    scene, cfg, _, _, _, hdr, rec = traced
    occ = potential_occluders(scene, cfg)
    assert not all(occ), "expected at least one culled triangle"
    culled, rec_c = cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, occluders=occ, device="cpu")
    np.testing.assert_allclose(culled.numpy(), hdr.numpy(), atol=5e-8,
                               rtol=1e-6)
    assert torch.equal(rec_c.camera, rec.camera)
    assert torch.equal(
        cuda_mis.render_mis_decoupled(scene, cfg, occluders=occ,
                                      device="cpu"), culled)


def test_pixel_ranges_concatenate_to_the_frame(traced):
    scene, cfg, _, _, _, hdr, rec = traced
    n, cut = cfg.num_pixels, 5 * cfg.width + 3
    parts = [cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, local_n=local_n, rid_base=base,
        flat_output=True, device="cpu")
        for base, local_n in ((0, cut), (cut, n - cut))]
    flat = torch.cat([p[0] for p in parts])
    assert flat.shape == (n, 3)
    assert torch.equal(flat.reshape(cfg.height, cfg.width, 3), hdr)
    assert torch.equal(torch.cat([p[1].camera for p in parts], dim=-1),
                       rec.camera)
    assert torch.equal(torch.cat([p[1].samples for p in parts], dim=-1),
                       rec.samples)


def test_jax_hdr_only_kernel_agrees_too():
    """``render_mis_pallas_interpret`` (records off) on the smallest shape."""
    ctor, resolution, kw = SHAPES["non-tile-multiple"]
    jax_scene = getattr(jscene, ctor)(resolution=resolution)
    ref = np.asarray(jmis.render_mis_pallas_interpret(
        jax_scene, mis_config(jtypes.RenderConfig, resolution, **kw)))
    hdr = cuda_mis.render_mis_cuda_impl(
        carry(jax_scene), mis_config(RenderConfig, resolution, **kw),
        device="cpu")
    np.testing.assert_allclose(hdr.numpy(), ref, **MIS_TOL)


# ---------------------------------------------------------------------------
# Packing and argument checks (no JAX kernel run)
# ---------------------------------------------------------------------------

def _small():
    ctor, resolution, kw = SHAPES["spheres"]
    jax_scene = getattr(jscene, ctor)(resolution=resolution)
    return (jax_scene, mis_config(jtypes.RenderConfig, resolution, **kw),
            carry(jax_scene), mis_config(RenderConfig, resolution, **kw))


def test_pack_inputs_matches_jax_tables():
    """The packed tables against ``pallas_mis._pack_inputs``: geometry rows
    within an ulp or two (``compile_scene`` sums in another order), every
    material, light and sphere row bit for bit, and the ten draw rows of the
    sample table bit-equal to the op-by-op JAX evaluation."""
    jax_scene, jcfg, scene, cfg = _small()
    tri, cam, light, tabs, sph, atab = (
        np.asarray(x) for x in jmis._pack_inputs(jax_scene, jcfg))
    packed = cuda_mis._pack_inputs(scene, cfg)
    assert packed.tri.shape == (cuda_mis.NROWS, 12)
    np.testing.assert_allclose(packed.tri[:12].numpy(), tri[:12], atol=1e-6)
    np.testing.assert_array_equal(packed.tri[12:].numpy(), tri[12:])
    np.testing.assert_allclose(packed.cam.numpy(), cam.reshape(-1), atol=1e-6)
    np.testing.assert_array_equal(packed.light.numpy(), light.reshape(-1))
    np.testing.assert_array_equal(packed.sph.numpy(), sph)
    assert packed.atab.shape == (cuda_mis.NATTR, 14)
    np.testing.assert_allclose(packed.atab[:3].numpy(), atab[:3], atol=1e-6)
    np.testing.assert_array_equal(packed.atab[3:].numpy(), atab[3:])
    assert packed.tabs.shape == (cuda_mis.NTAB_EXT, cfg.mis_samples // 3)
    with jax.disable_jit():
        rows = np.asarray(jmis.smp.mis_sample_table_rows(cfg.mis_samples,
                                                         cfg.sampler))
    np.testing.assert_array_equal(packed.tabs[:10].numpy(), rows)


def test_sample_table_derived_rows_match_jax_backward_tables():
    """Rows 10-15 are the scalars the JAX backward kernel precomputes on the
    host (``pallas_mis_bwd._sample_tables``): same formulas, an ulp of sin
    and cos apart."""
    import gpuraytracer_tpu.ops.pallas_mis_bwd as jbwd
    for sampler, mis_samples in (("halton", 300), ("stratified", 48)):
        cfg = RenderConfig(integrator="mis", mis_samples=mis_samples,
                           sampler=sampler)
        ref = np.asarray(jbwd._sample_tables(jtypes.RenderConfig(
            integrator="mis", mis_samples=mis_samples, sampler=sampler)))
        got = cuda_mis.sample_table(cfg).numpy()
        assert got.shape == ref.shape == (16, mis_samples // 3)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, scene, cfg = _small()
    with pytest.raises(ValueError, match="flat_output"):
        cuda_mis.render_mis_cuda_impl(scene, cfg, local_n=10, device="cpu")
    with pytest.raises(ValueError, match="occluders has"):
        cuda_mis.render_mis_cuda_impl(scene, cfg, occluders=(True,) * 3,
                                      device="cpu")
    with pytest.raises(ValueError, match="mis_samples"):
        cuda_mis.render_mis_cuda_impl(scene, cfg.replace(mis_samples=2),
                                      device="cpu")
    packed = cuda_mis._pack_inputs(scene, cfg)
    idx = shadow_indices(None, 12, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mis.mis_trace_kernel(cfg.num_pixels, 0, packed, idx, cfg, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cuda_mis.render_mis_cuda(scene, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            cuda_mis.render_mis_decoupled(scene, cfg)
    assert cuda_mis.LAUNCHES == {"mis_kernel": 0}


def test_kernel_source_is_registered_for_the_build():
    from gpuraytracer_tpu_torch.ops import _build
    assert "mis_kernels" in _build.SOURCES
    assert all((_build.CSRC_DIR / f"{name}.cu").is_file()
               for name in _build.SOURCES)
    text = (_build.CSRC_DIR / "mis_kernels.cu").read_text()
    assert "mis_kernel<true><<<" in text and "grt_mis_trace" in text
