"""PyTorch port vs the JAX package: the module that holds the two kernels
(``ops/cuda_path.py``), through their plain versions on the CPU.

The JAX side runs its Pallas kernels in interpret mode (two traces in this
file, cached in module-scoped fixtures; interpret mode is slow).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.ops.decoupled as jdec
import gpuraytracer_tpu.ops.pallas_path as jpp
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import sampling as tsmp
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_path, decoupled
from gpuraytracer_tpu_torch.render import pixel_rng_offsets
from gpuraytracer_tpu_torch.scene import (cornell_box,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

# The JAX package's own kernel-vs-oracle tolerance (f32 sums of a few
# bounces, one ulp of rsqrt/sin/cos between compilers).
HDR_TOL = dict(atol=2e-5, rtol=1e-4)


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def _cfg(cls=RenderConfig, **kw):
    base = dict(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    base.update(kw)
    return cls(**base)


def _carry(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


@pytest.fixture(scope="module")
def jax_cornell_trace():
    """JAX ``trace_records`` (interpret mode) on the 36-triangle box."""
    scene = jscene.cornell_box(resolution=(32, 16))
    hdr, aux = jdec.trace_records(scene, _cfg(jtypes.RenderConfig),
                                  interpret=True)
    return _carry(scene), np.asarray(hdr), jax.tree.map(np.asarray, aux)


@pytest.fixture(scope="module")
def jax_spheres_trace():
    """JAX ``trace_records`` (interpret mode) on the sphere scene."""
    scene = jscene.cornell_box_with_spheres(resolution=(32, 16))
    hdr, aux = jdec.trace_records(
        scene, _cfg(jtypes.RenderConfig, bounces=1), interpret=True)
    return _carry(scene), np.asarray(hdr), jax.tree.map(np.asarray, aux)


# ---------------------------------------------------------------------------
# K1, plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,spp", [("halton", 2), ("stratified", 4)])
def test_pregen_draws_equals_halton_planes(sampler, spp):
    cfg = _cfg(spp=spp, bounces=3, sampler=sampler, seed=3)
    draws = cuda_path.pregen_draws(cfg, device="cpu")
    off = pixel_rng_offsets(cfg)
    n = cfg.num_pixels
    assert [tuple(d.shape) for d in draws] == (
        [(spp, 3, n)] * 4 + [(spp, n)] * 2)
    assert all(d.dtype == torch.float32 for d in draws)
    for s in range(spp):
        ih = off + s
        if sampler == "stratified":
            uv = tsmp.stratified2(ih, 0, spp)
            jx, jy = uv[..., 0], uv[..., 1]
        else:
            jx, jy = tsmp.halton(ih, 0), tsmp.halton(ih, 1)
        assert torch.equal(draws[4][s], jx) and torch.equal(draws[5][s], jy)
        for b in range(3):
            for k in range(4):
                assert torch.equal(draws[k][s, b],
                                   tsmp.halton(ih, 2 + 5 * b + k))


def test_pregen_draws_takes_a_pixel_range():
    cfg = _cfg(spp=2)
    full = cuda_path.pregen_draws(cfg, device="cpu")
    off = pixel_rng_offsets(cfg)[100:200]
    part = cuda_path.pregen_draws(cfg, off, device="cpu")
    for f, p in zip(full, part):
        assert torch.equal(f[..., 100:200], p)


def test_draws_bit_equal_to_jax_kernel_arithmetic():
    """The JAX draws kernel's radical inverse (``_halton_tile``: digits
    extracted in f32, product and sum rounded separately), evaluated one
    primitive at a time, gives the port's draw planes bit for bit."""
    cfg = _cfg(spp=2, bounces=3, seed=3)
    draws = cuda_path.pregen_draws(cfg, device="cpu")
    off = pixel_rng_offsets(cfg).numpy().astype(np.uint32)
    with jax.disable_jit():
        for s in range(cfg.spp):
            ih = jnp.asarray(off + np.uint32(s))
            for k, d in ((4, 0), (5, 1)):
                ref = np.asarray(jpp._halton_tile(ih, d))
                np.testing.assert_array_equal(_bits(draws[k][s].numpy()),
                                              _bits(ref))
            for b in range(cfg.bounces):
                for k in range(4):
                    ref = np.asarray(jpp._halton_tile(ih, 2 + 5 * b + k))
                    np.testing.assert_array_equal(
                        _bits(draws[k][s, b].numpy()), _bits(ref))


def test_draws_match_jax_kernel_planes(jax_cornell_trace):
    """Against the planes the interpret-mode JAX kernel emits. Compiled as
    a whole for the CPU, XLA fuses some of the radical inverse's
    multiply-adds, so its planes differ from the separately rounded
    arithmetic (previous test) in the last bit of some values: at most one
    ulp is allowed here, and nothing more."""
    _, _, aux = jax_cornell_trace
    draws = cuda_path.pregen_draws(_cfg(), device="cpu")
    names = ("nee_u0", "nee_u1", "cos_u0", "cos_u1", "jitter_x", "jitter_y")
    for name, got in zip(names, draws):
        ref = getattr(aux, name)
        assert got.shape == ref.shape, name
        ulps = np.abs(_bits(got.numpy()).astype(np.int64)
                      - _bits(ref).astype(np.int64))
        assert ulps.max() <= 1, name


# ---------------------------------------------------------------------------
# K2, plain version, against the JAX kernel
# ---------------------------------------------------------------------------

def test_trace_matches_jax_kernel_cornell(jax_cornell_trace):
    scene, ref_hdr, ref_aux = jax_cornell_trace
    hdr, aux = decoupled.trace_records(scene, _cfg(), device="cpu")
    assert aux.records.dtype == torch.int32
    assert aux.records.shape == ref_aux.records.shape == (1, 2, 512)
    np.testing.assert_array_equal(aux.records.numpy(), ref_aux.records)
    np.testing.assert_allclose(hdr.numpy(), ref_hdr, **HDR_TOL)
    # Both outcomes of both decisions occur in the frame.
    rec = aux.records.numpy()
    assert (rec == 0).any() and (rec & (cuda_path.OCC_BIT - 1)).max() <= 36
    assert (rec >= cuda_path.OCC_BIT).any()


def test_trace_matches_jax_kernel_spheres(jax_spheres_trace):
    scene, ref_hdr, ref_aux = jax_spheres_trace
    cfg = _cfg(bounces=1)
    hdr, aux = decoupled.trace_records(scene, cfg, device="cpu")
    np.testing.assert_array_equal(aux.records.numpy(), ref_aux.records)
    np.testing.assert_allclose(hdr.numpy(), ref_hdr, **HDR_TOL)
    prim = aux.records.numpy() & (cuda_path.OCC_BIT - 1)
    num_tris = scene.triangles.num_triangles
    assert (prim > num_tris).any()  # a sphere won somewhere
    assert prim.max() <= num_tris + scene.spheres.num_spheres


# ---------------------------------------------------------------------------
# K2, plain version: modes, cull, shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_ctor", [cornell_box, cornell_box_with_spheres])
@pytest.mark.parametrize("sampler,spp", [("halton", 2), ("stratified", 4)])
def test_three_modes_agree(scene_ctor, sampler, spp):
    scene = scene_ctor(resolution=(32, 16))
    cfg = _cfg(spp=spp, bounces=3, sampler=sampler)
    impl = cuda_path.render_path_cuda_impl
    hdr_only = impl(scene, cfg, device="cpu")
    hdr_rec, aux = impl(scene, cfg, emit_records=True, device="cpu")
    hdr_ro, aux_ro = impl(scene, cfg, emit_records=True, records_only=True,
                          device="cpu")
    assert hdr_only.shape == (16, 32, 3) and hdr_only.dtype == torch.float32
    # The same arithmetic on the same draws, whether read or regenerated.
    assert torch.equal(hdr_only, hdr_rec) and torch.equal(hdr_only, hdr_ro)
    assert torch.equal(aux.records, aux_ro.records)
    assert aux_ro.nee_u0 is None and aux_ro.jitter_y is None
    assert aux.nee_u0.shape == (spp, 3, 512)
    assert torch.isfinite(hdr_only).all() and hdr_only.max() > 0


@pytest.mark.parametrize("scene_ctor", [cornell_box, cornell_box_with_spheres])
def test_occluder_cull_leaves_decisions_unchanged(scene_ctor):
    scene = scene_ctor(resolution=(32, 16))
    cfg = _cfg(spp=2, bounces=3)
    occ = potential_occluders(scene, cfg)
    assert not all(occ)
    draws = cuda_path.pregen_draws(cfg, device="cpu")
    hdr_a, aux_a = decoupled.trace_records(scene, cfg, device="cpu")
    hdr_b, aux_b = decoupled.trace_records(scene, cfg, draws=draws,
                                           occluders=occ, device="cpu")
    assert torch.equal(aux_a.records, aux_b.records)
    assert torch.equal(hdr_a, hdr_b)
    assert aux_b.nee_u0 is draws[0]


def test_non_tile_multiple_frame():
    scene = cornell_box(resolution=(24, 18))
    cfg = _cfg(width=24, height=18, bounces=3, pixel_chunk=100)
    hdr = cuda_path.render_path_cuda(scene, cfg, device="cpu")
    assert hdr.shape == (18, 24, 3)
    # The plain version's chunking does not change a pixel.
    whole = cuda_path.render_path_cuda(scene, cfg.replace(pixel_chunk=512),
                                       device="cpu")
    assert torch.equal(hdr, whole)


def test_pixel_range_hooks():
    """local_offsets / rid_base / flat_output render a slice of the frame."""
    scene = cornell_box(resolution=(32, 16))
    cfg = _cfg(bounces=3)
    full = cuda_path.render_path_cuda(scene, cfg, device="cpu")
    off = pixel_rng_offsets(cfg)[128:384]
    part = cuda_path.render_path_cuda_impl(
        scene, cfg, local_offsets=off, rid_base=128, flat_output=True,
        device="cpu")
    assert part.shape == (256, 3)
    assert torch.equal(part, full.reshape(-1, 3)[128:384])
    with pytest.raises(ValueError, match="flat_output"):
        cuda_path.render_path_cuda_impl(scene, cfg, local_offsets=off,
                                        rid_base=128, device="cpu")


def test_decoupled_returns_the_trace_image():
    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = _cfg(spp=2, bounces=3)
    hdr = decoupled.render_path_decoupled(scene, cfg, device="cpu")
    assert torch.equal(hdr, cuda_path.render_path_cuda(scene, cfg,
                                                       device="cpu"))


def test_auto_records_only_rule():
    small = RenderConfig(width=512, height=512, spp=16, bounces=3)
    frame = RenderConfig(width=800, height=600, spp=400, bounces=3)
    assert not decoupled._auto_records_only(small)
    assert decoupled._auto_records_only(frame)
    assert not decoupled._auto_records_only(frame, n_pixels=1000)


# ---------------------------------------------------------------------------
# What must raise
# ---------------------------------------------------------------------------

def test_draws_in_a_mode_that_cannot_read_them_raises():
    scene = cornell_box(resolution=(32, 16))
    cfg = _cfg()
    draws = cuda_path.pregen_draws(cfg, device="cpu")
    impl = cuda_path.render_path_cuda_impl
    with pytest.raises(ValueError, match="regenerates draws"):
        impl(scene, cfg, draws=draws, device="cpu")
    with pytest.raises(ValueError, match="regenerates draws"):
        impl(scene, cfg, emit_records=True, records_only=True, draws=draws,
             device="cpu")
    with pytest.raises(ValueError, match="records_only requires"):
        impl(scene, cfg, records_only=True, device="cpu")


def test_draws_of_the_wrong_shape_raise():
    scene = cornell_box(resolution=(32, 16))
    stale = cuda_path.pregen_draws(_cfg(spp=2), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        decoupled.trace_records(scene, _cfg(spp=1), draws=stale, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        decoupled.trace_records(scene, _cfg(spp=2), draws=stale[:5],
                                device="cpu")


def test_72_triangles_take_grouped_tier_equal_brute_force():
    """The 72-triangle doubled box takes the grouped tier: its plain
    version's records and image equal the brute-force plain version's."""
    scene = cornell_box(resolution=(32, 16))
    tri = scene.triangles
    doubled = dataclasses.replace(tri, **{
        f.name: torch.cat([getattr(tri, f.name)] * 2)
        for f in dataclasses.fields(tri)})
    big = dataclasses.replace(scene, triangles=doubled)
    assert big.triangles.num_triangles == 72
    cfg = _cfg(spp=2)
    hdr = cuda_path.render_path_cuda(big, cfg, device="cpu")
    hdr_g, aux_g = cuda_path.render_path_cuda_impl(
        big, cfg, emit_records=True, device="cpu")
    hdr_b, aux_b = cuda_path.render_path_cuda_impl(
        big, cfg, emit_records=True, grouped=False, device="cpu")
    assert torch.equal(aux_g.records, aux_b.records)
    assert torch.equal(hdr, hdr_b) and torch.equal(hdr_g, hdr_b)
    # The copies lie on the originals: a triangle's twin never wins.
    assert int((aux_b.records % cuda_path.OCC_BIT).max()) <= 36


def test_requires_grad_raises():
    scene = cornell_box(resolution=(32, 16))
    light = dataclasses.replace(
        scene.light, color=scene.light.color.clone().requires_grad_(True))
    wants_grad = dataclasses.replace(scene, light=light)
    # The bare trace carries no gradient and says so; the differentiable
    # entry points trace a detached copy and attach the backward kernel.
    with pytest.raises(NotImplementedError, match="backward kernel"):
        decoupled.trace_records(wants_grad, _cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="backward kernel"):
        cuda_path.render_path_cuda_impl(wants_grad, _cfg(), device="cpu")
    for entry in (decoupled.render_path_decoupled, cuda_path.render_path_cuda):
        hdr = entry(wants_grad, _cfg(), device="cpu")
        (g,) = torch.autograd.grad(hdr.mean(), [wants_grad.light.color])
        assert torch.isfinite(g).all() and g.abs().max() > 0


def test_wrong_occluder_count_and_bounces_raise():
    scene = cornell_box(resolution=(32, 16))
    with pytest.raises(ValueError, match="occluders"):
        decoupled.trace_records(scene, _cfg(), occluders=(True,) * 5,
                                device="cpu")
    with pytest.raises(ValueError, match="Halton dimension"):
        cuda_path.render_path_cuda(scene, _cfg(bounces=5), device="cpu")
    with pytest.raises(ValueError, match="square"):
        cuda_path.render_path_cuda(scene, _cfg(spp=2, sampler="stratified"),
                                   device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises: it has no other path."""
    cfg = _cfg()
    off = pixel_rng_offsets(cfg).to(torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_path.pregen_draws_kernel(off, cfg)
    scene = cornell_box(resolution=(32, 16))
    packed = cuda_path._pack_inputs(scene, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_path.path_trace_kernel(
            off, 0, packed, cuda_path.shadow_indices(None, 36, "cpu"), None,
            cfg, False)
    grouped = cuda_path._pack_inputs(scene, cfg, grouped=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_path.path_trace_kernel(
            off, 0, grouped, cuda_path.shadow_indices(None, 36, "cpu"), None,
            cfg, False)
    assert cuda_path.LAUNCHES == {"draws_kernel": 0, "path_kernel": 0,
                                  "path_kernel_grouped": 0}


def test_default_device_raises_without_a_card():
    """device defaults to the card; where there is none the entry points
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    scene = cornell_box(resolution=(32, 16))
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_path.render_path_cuda(scene, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_path.pregen_draws(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        decoupled.render_path_decoupled(scene, cfg)
