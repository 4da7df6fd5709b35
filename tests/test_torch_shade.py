"""PyTorch port vs the JAX package: the module that holds the backward kernel
(``ops/cuda_shade.py``) and the replay (``ops/decoupled.py``), through the
kernel's plain version on the CPU.

The JAX side runs its Pallas kernels in interpret mode, which is slow: each
of the four cases below (two scenes x two samplers, the two draw modes spread
over them) is traced, replayed and differentiated once and kept for all the
tests that read it. Size: the JAX tests' own 16 x 8, 2 bounces.

Tolerances. Replay values: atol 2e-5 / rtol 1e-4, the JAX package's
kernel-vs-oracle tolerance (f32 sums over a few bounces, an ulp of sin, cos
and rsqrt between compilers). Gradients: atol 1e-6 / rtol 1e-4, its tolerance
for path gradients (``tests/test_pallas_shade.py``). Draws read against draws
regenerated: atol 1e-7 / rtol 1e-5, as there. Packed parameter views: bit
for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.ops.decoupled as jdec
import gpuraytracer_tpu.ops.pallas_shade as jshade
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import cuda_path, cuda_shade, decoupled
from gpuraytracer_tpu_torch.render import pixel_rng_offsets, render
from gpuraytracer_tpu_torch.scene import (cornell_box,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

HDR_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
MODES_TOL = dict(atol=1e-7, rtol=1e-5)

BOX_GROUPS = [
    "light.color", "light.center", "light.normal",
    "triangles.verts", "triangles.diffuse", "triangles.emissive",
    "camera.position", "camera.direction", "camera.up",
]
SPHERE_GROUPS = BOX_GROUPS + [
    "spheres.center", "spheres.radius", "spheres.diffuse"]

# name -> (scene constructor, sampler, spp, records_only on the JAX side)
CASES = {
    "box-halton-planes": ("cornell_box", "halton", 2, False),
    "spheres-halton-regenerated": ("cornell_box_with_spheres", "halton", 2,
                                   True),
    "box-stratified-regenerated": ("cornell_box", "stratified", 4, True),
    "spheres-stratified-planes": ("cornell_box_with_spheres", "stratified",
                                  4, False),
}
CASE_GROUPS = [(name, group) for name, case in CASES.items()
               for group in (SPHERE_GROUPS if "spheres" in case[0]
                             else BOX_GROUPS)]


def with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _carry(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


def _fused_grads(scene, cfg, records_only, **kw):
    """Gradient tree of mean(hdr) through the differentiable kernel path
    (the backward kernel's plain version on the CPU)."""
    scene = with_grad(scene)
    hdr = cuda_shade.render_path_decoupled_fused(
        scene, cfg, records_only=records_only, device="cpu", **kw)
    hdr.mean().backward()
    return convert.grads_to_numpy(scene)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Everything the JAX side computes for one case, once."""
    ctor, sampler, spp, records_only = CASES[name]
    kw = dict(width=16, height=8, integrator="path", spp=spp, bounces=2,
              pixel_chunk=128, sampler=sampler)
    jax_scene = getattr(jscene, ctor)(resolution=(16, 8))
    jcfg = jtypes.RenderConfig(**kw)
    hdr, aux = jdec.trace_records(jax_scene, jcfg, interpret=True)
    replay = jdec.shade_replay(jax_scene, aux, jcfg)
    grads = jax.grad(lambda s: jnp.mean(jshade.render_path_decoupled_fused(
        s, jcfg, interpret=True, records_only=records_only)),
        allow_int=True)(jax_scene)

    scene, cfg = _carry(jax_scene), RenderConfig(**kw)
    port_hdr, port_aux = decoupled.trace_records(scene, cfg, device="cpu")
    return dict(
        scene=scene, cfg=cfg, records_only=records_only,
        jax_hdr=np.asarray(hdr), jax_aux=jax.tree.map(np.asarray, aux),
        jax_replay=np.asarray(replay), jax_grads=grads,
        port_hdr=port_hdr, port_aux=port_aux,
        port_grads={ro: _fused_grads(scene, cfg, ro) for ro in (False, True)})


# ---------------------------------------------------------------------------
# The replay (plain version of the backward kernel's forward half)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_records_equal_the_jax_kernels(name):
    case = _case(name)
    np.testing.assert_array_equal(case["port_aux"].records.numpy(),
                                  case["jax_aux"].records)
    np.testing.assert_allclose(case["port_hdr"].numpy(), case["jax_hdr"],
                               **HDR_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax_replay_and_oracle(name):
    """The port's replay on the JAX kernel's own records and draws."""
    case = _case(name)
    aux = cuda_path.TraceAux(*(torch.from_numpy(np.array(x))
                               for x in case["jax_aux"]))
    replay = decoupled.shade_replay(case["scene"], aux, case["cfg"])
    assert replay.shape == (8, 16, 3) and replay.dtype == torch.float32
    np.testing.assert_allclose(replay.numpy(), case["jax_replay"], **HDR_TOL)
    oracle = render(case["scene"], case["cfg"], device="cpu").hdr
    np.testing.assert_allclose(replay.numpy(), oracle.numpy(), **HDR_TOL)


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres])
def test_replay_chunk_size_is_value_invariant(ctor):
    scene = ctor(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=4, bounces=3, pixel_chunk=512,
                       replay_sample_chunk=2)
    hdr, aux = decoupled.trace_records(scene, cfg, device="cpu")
    a = decoupled.shade_replay(scene, aux, cfg)
    np.testing.assert_allclose(a.numpy(), hdr.numpy(), **HDR_TOL)
    for chunk in (1, 3, 4):  # 3 does not divide spp: the divisor below it
        b = decoupled.shade_replay(scene, aux,
                                   cfg.replace(replay_sample_chunk=chunk))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)
    assert cuda_shade.sample_chunk(cfg.replace(replay_sample_chunk=3)) == 2


@pytest.mark.parametrize("sampler,spp", [("halton", 2), ("stratified", 4)])
def test_replay_regenerates_missing_draws(sampler, spp):
    """After a ``records_only`` trace the replay makes the draws again from
    the pixel offsets: the same image, bit for bit."""
    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=spp, bounces=3,
                       pixel_chunk=512, sampler=sampler)
    _, aux = decoupled.trace_records(scene, cfg, device="cpu")
    _, bare = decoupled.trace_records(scene, cfg, records_only=True,
                                      device="cpu")
    assert bare.nee_u0 is None
    assert torch.equal(decoupled.shade_replay(scene, aux, cfg),
                       decoupled.shade_replay(scene, bare, cfg))


# ---------------------------------------------------------------------------
# Parameter views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctor", ["cornell_box", "cornell_box_with_spheres"])
def test_pack_diff_inputs_equals_jax_bit_for_bit(ctor):
    """Camera, light and every row copied from the scene: bit for bit. The
    geometry rows (n, c0) come from ``compile_scene``: bit for bit on the
    sphere scene's axis-aligned walls; on the box scene the normals of the
    two rotated boxes leave the two packages' cross product and
    normalization one ulp apart, so those rows are held to one ulp of a
    unit normal (1.2e-7 absolute)."""
    jax_scene = getattr(jscene, ctor)(resolution=(32, 16))
    kw = dict(width=32, height=16, spp=1)
    ref = jshade._pack_diff_inputs(jax_scene, jtypes.RenderConfig(**kw))
    got = cuda_shade._pack_diff_inputs(_carry(jax_scene), RenderConfig(**kw))
    rows = (cuda_shade.NROWS_TAB_SPH if "spheres" in ctor
            else cuda_shade.NROWS_TAB)
    assert got[0].shape == (rows, 12 + 2 if "spheres" in ctor else 36)
    assert got[1].shape == (12,) and got[2].shape == (9,)
    for g, r in zip(got, ref):
        r = np.asarray(r).reshape(g.shape)
        assert g.dtype == torch.float32
        g = g.numpy()
        if g.ndim == 2 and "spheres" not in ctor:
            np.testing.assert_allclose(g[:4], r[:4], atol=1.2e-7, rtol=0)
            g, r = g[4:], r[4:]
        np.testing.assert_array_equal(g.view(np.uint32), r.view(np.uint32))


def test_pack_diff_inputs_is_differentiable_in_every_group():
    scene = with_grad(cornell_box_with_spheres(resolution=(32, 16)))
    table, cam, light = cuda_shade._pack_diff_inputs(
        scene, RenderConfig(width=32, height=16))
    (table.sum() + cam.sum() + light.sum()).backward()
    tree = convert.grads_to_numpy(scene)
    for group in SPHERE_GROUPS:
        part, field = group.split(".")
        assert tree[part][field] is not None, group
        assert np.isfinite(tree[part][field]).all(), group
    # The light's normal enters as the scene holds it: not normalized.
    assert torch.equal(light[6:9].detach(), scene.light.normal.detach())


# ---------------------------------------------------------------------------
# The differentiable kernel path against jax.grad of the JAX fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,group", CASE_GROUPS)
def test_decoupled_grads_match_jax_fused(name, group):
    case = _case(name)
    if not np.array_equal(case["port_aux"].records.numpy(),
                          case["jax_aux"].records):
        pytest.fail("the two packages recorded different decisions (a "
                    "knife-edge ray): their gradients cannot be compared")
    part, field = group.split(".")
    ref = np.asarray(getattr(getattr(case["jax_grads"], part), field))
    got = case["port_grads"][case["records_only"]][part][field]
    assert np.abs(ref).max() > 0.0, f"JAX gradient of {group} is all zero"
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_draw_modes_give_the_same_gradients(name):
    """Draws read from planes against draws regenerated from the offsets."""
    read, regenerated = (_case(name)["port_grads"][ro]
                         for ro in (False, True))
    compared = 0
    for part in read:
        for field, a in read[part].items():
            b = regenerated[part][field]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, **MODES_TOL)
                compared += 1
    assert compared >= 10


@pytest.mark.parametrize("ctor", [cornell_box, cornell_box_with_spheres])
def test_entry_points_share_value_and_gradients(ctor):
    """``render_path_decoupled`` (hoisted draws, occluder cull) and
    ``render_path_cuda`` (re-trace in the backward) return the trace
    kernel's image and the fused path's gradients."""
    from gpuraytracer_tpu_torch.intersect import potential_occluders
    scene = ctor(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=2, bounces=3, pixel_chunk=512)
    ref = _fused_grads(scene, cfg, None)
    plain_hdr = cuda_path.render_path_cuda(scene, cfg, device="cpu")

    a = with_grad(scene)
    hdr_a = decoupled.render_path_decoupled(
        a, cfg, draws=cuda_path.pregen_draws(cfg, device="cpu"),
        occluders=potential_occluders(scene, cfg), device="cpu")
    assert hdr_a.requires_grad and torch.equal(hdr_a.detach(), plain_hdr)
    hdr_a.mean().backward()

    b = with_grad(scene)
    hdr_b = cuda_path.render_path_cuda(b, cfg, device="cpu")
    assert hdr_b.requires_grad and torch.equal(hdr_b.detach(), plain_hdr)
    hdr_b.mean().backward()

    for got in (convert.grads_to_numpy(a), convert.grads_to_numpy(b)):
        for part in ref:
            for field, r in ref[part].items():
                if r is None:
                    assert got[part][field] is None
                else:
                    np.testing.assert_array_equal(got[part][field], r)


def test_without_requires_grad_the_image_carries_no_graph():
    scene = cornell_box(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    hdr = decoupled.render_path_decoupled(scene, cfg, device="cpu")
    assert not hdr.requires_grad and hdr.grad_fn is None


def test_pixel_ranges_sum_to_the_frame():
    """``render_path_fused_local``: flat [n, 3] images of two pixel ranges
    are the frame's rows, and their gradients add up to the frame's."""
    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=2, bounces=3, pixel_chunk=512)
    whole = with_grad(scene)
    hdr = cuda_shade.render_path_decoupled_fused(whole, cfg, device="cpu")
    g = torch.randn(hdr.shape, generator=torch.Generator().manual_seed(7))
    (hdr * g).sum().backward()
    ref = convert.grads_to_numpy(whole)

    offsets = pixel_rng_offsets(cfg)
    parts = with_grad(scene)
    for lo, hi, records_only in ((0, 200, False), (200, 512, True)):
        flat = cuda_shade.render_path_fused_local(
            parts, cfg, offsets[lo:hi], lo, records_only=records_only,
            device="cpu")
        assert flat.shape == (hi - lo, 3)
        assert torch.equal(flat.detach(),
                           hdr.detach().reshape(-1, 3)[lo:hi])
        (flat * g.reshape(-1, 3)[lo:hi]).sum().backward()
    got = convert.grads_to_numpy(parts)
    for group in SPHERE_GROUPS:
        part, field = group.split(".")
        scale = np.abs(ref[part][field]).max()
        # Two partial sums instead of one: f32 summation order only.
        np.testing.assert_allclose(got[part][field], ref[part][field],
                                   atol=1e-6 + 1e-5 * scale, rtol=1e-4)


# ---------------------------------------------------------------------------
# The backward's plain version on its own
# ---------------------------------------------------------------------------

def _views(scene, cfg):
    _, aux = decoupled.trace_records(scene, cfg, device="cpu")
    views = [v.detach().contiguous()
             for v in cuda_shade._pack_diff_inputs(scene, cfg)]
    return aux, views


@pytest.mark.parametrize("ctor,ntab", [(cornell_box, 10),
                                       (cornell_box_with_spheres, 14)])
def test_plain_backward_shapes_and_light_color(ctor, ntab):
    scene = ctor(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=2, bounces=3, pixel_chunk=512)
    aux, views = _views(scene, cfg)
    g = torch.randn((3, 512), generator=torch.Generator().manual_seed(3))
    dtab, dscal = cuda_shade.shade_bwd_plain(
        g / cfg.spp, aux.records, tuple(aux[1:]), None, *views, cfg)
    assert dtab.shape == (views[0].shape[1], ntab) and dscal.shape == (21,)
    assert torch.isfinite(dtab).all() and torch.isfinite(dscal).all()
    # The same cotangent through the replay, by the light's color.
    color = scene.light.color.clone().requires_grad_(True)
    lit = dataclasses.replace(
        scene, light=dataclasses.replace(scene.light, color=color))
    hdr = decoupled.shade_replay(lit, aux, cfg)
    (d_color,) = torch.autograd.grad(
        (hdr.reshape(-1, 3).T * g).sum(), [color])
    np.testing.assert_allclose(dscal[15:18].numpy(), d_color.numpy(),
                               atol=1e-6, rtol=1e-4)
    # Regenerated draws: the offsets in place of the planes.
    again = cuda_shade.shade_bwd_plain(
        g / cfg.spp, aux.records, None, pixel_rng_offsets(cfg), *views, cfg)
    assert torch.equal(again[0], dtab) and torch.equal(again[1], dscal)


def test_paths_that_miss_add_exactly_zero():
    """A cotangent that lives only on pixels whose camera ray hits nothing
    or hits the light gives all-zero geometry and camera cotangents: dead
    lanes read primitive 0 and are masked, not multiplied by garbage."""
    scene = cornell_box(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=3, pixel_chunk=512)
    aux, views = _views(scene, cfg)
    prim = (aux.records[0, 0] % cuda_path.OCC_BIT).long() - 1
    is_em = views[0][10] > 0.5
    sees_light = (prim >= 0) & is_em[prim.clamp_min(0)]
    dead = (prim < 0) | sees_light
    assert (prim < 0).any()
    g = torch.where(dead, torch.ones(512), torch.zeros(512)).expand(3, 512)
    dtab, dscal = cuda_shade.shade_bwd_plain(
        g.contiguous(), aux.records, tuple(aux[1:]), None, *views, cfg)
    assert torch.count_nonzero(dtab[:, :7]) == 0   # d normal, c0, diffuse
    assert torch.count_nonzero(dscal) == 0         # camera and light
    # d emissive: only where a camera ray lands on the light itself.
    assert bool(torch.count_nonzero(dtab[:, 7:10])) == bool(sees_light.any())


# ---------------------------------------------------------------------------
# What must raise
# ---------------------------------------------------------------------------

def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises: it has no other
    path, and it counts no launch."""
    scene = cornell_box(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    aux, views = _views(scene, cfg)
    for grouped in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_shade.shade_bwd_kernel(torch.zeros((3, 512)), aux.records,
                                        tuple(aux[1:]), None, *views, cfg,
                                        grouped=grouped)
    assert cuda_shade.LAUNCHES == {"shade_bwd_kernel": 0,
                                   "shade_bwd_grouped_kernel": 0}


def test_backward_checks_its_inputs():
    scene = cornell_box(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    aux, views = _views(scene, cfg)
    g = torch.zeros((3, 512))
    with pytest.raises(ValueError, match="records"):
        cuda_shade.shade_bwd_plain(g, aux.records[:, :1], tuple(aux[1:]),
                                   None, *views, cfg)
    with pytest.raises(ValueError, match="cam_vec"):
        cuda_shade.shade_bwd_plain(g, aux.records, tuple(aux[1:]), None,
                                   views[0], views[1][:9], views[2], cfg)


def test_bare_trace_refuses_a_scene_that_asks_for_gradients():
    scene = with_grad(cornell_box(resolution=(32, 16)))
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        decoupled.trace_records(scene, cfg, device="cpu")
    hdr, _ = decoupled.trace_records(scene.detach(), cfg, device="cpu")
    assert not hdr.requires_grad


def test_72_triangles_with_gradients_take_grouped_tier_equal_brute_force():
    """The 72-triangle doubled box, which asks for gradients, takes the
    grouped tier (the trace's grouped sweep and the grouped backward's plain
    version): its image and its gradients equal those of the brute-force
    tier forced onto the same scene."""
    scene = cornell_box(resolution=(32, 16))
    tri = scene.triangles
    doubled = dataclasses.replace(tri, **{
        f.name: torch.cat([getattr(tri, f.name)] * 2)
        for f in dataclasses.fields(tri)})
    big = dataclasses.replace(scene, triangles=doubled)
    assert big.triangles.num_triangles == 72
    cfg = RenderConfig(width=32, height=16, spp=1, bounces=2, pixel_chunk=512)
    got = with_grad(big)
    hdr = decoupled.render_path_decoupled(got, cfg, device="cpu")
    hdr.mean().backward()
    # Brute force: the static tier's trace and the autograd replay of its
    # records, on the same scene.
    brute, aux = cuda_path.render_path_cuda_impl(
        big, cfg, emit_records=True, grouped=False, device="cpu")
    assert torch.equal(hdr.detach(), brute)
    ref = with_grad(big)
    decoupled.shade_replay(ref, aux, cfg).mean().backward()
    got, ref = convert.grads_to_numpy(got), convert.grads_to_numpy(ref)
    for group in BOX_GROUPS:
        part, field = group.split(".")
        assert np.abs(ref[part][field]).max() > 0.0, group
        np.testing.assert_allclose(got[part][field], ref[part][field],
                                   **GRAD_TOL, err_msg=group)
