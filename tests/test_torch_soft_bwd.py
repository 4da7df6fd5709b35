"""The silhouette backward (``ops/cuda_soft.py``): the hand-written reverse
against autograd, and the differentiable entry against the JAX package's
oracle.

  * ``soft_bwd_plain`` (the plain version of ``soft_bwd_kernel``) against
    autograd through ``soft_replay`` on the same records, both samplers and
    two edge widths: atol 1e-6 max(scale, 1) + rtol 1e-4 of each group's
    largest magnitude (the same function, differentiated by hand and by
    autograd; only the order of the sums differs).
  * ``render_direct_soft_fused`` on the CPU (plain versions of the trace
    kernel, the record kernel and the backward kernel) against the JAX
    package's oracle ``render_direct_soft`` and ``jax.grad`` of it, at the
    JAX package's own test size and tolerances
    (``tests/test_soft_fused.py``: value atol 2e-5 / rtol 1e-4, gradients
    atol 1e-6 / rtol 1e-4 in all 11 groups). The JAX pair's equality with
    that oracle is ``test_soft_fused.py``'s to hold.
  * The occluder cull changes nothing: atol 5e-8 / rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.grad.diff_render import \
    render_direct_soft as jax_render_direct_soft
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_shade, cuda_soft
from gpuraytracer_tpu_torch.ops.cuda_soft import render_direct_soft_fused
from gpuraytracer_tpu_torch.render import pixel_rng_offsets
from gpuraytracer_tpu_torch.scene import cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig

CFG = dict(width=24, height=24, integrator="direct", spp=2, bounces=1,
           pixel_chunk=576)
KAPPA = 0.1
GROUPS = [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "triangles.verts", "triangles.diffuse", "triangles.emissive",
    "light.color", "light.center", "light.normal",
    "camera.position", "camera.direction",
]
# Columns of the backward's table cotangent and slices of its scalars.
TAB_GROUPS = {"d normal": slice(0, 3), "d c0": slice(3, 4),
              "d diffuse": slice(4, 7), "d emissive": slice(7, 10),
              "d center": slice(10, 13), "d radius": slice(13, 14)}
SCAL_GROUPS = {"camera position": slice(0, 3), "camera u": slice(3, 6),
               "camera v": slice(6, 9), "camera w": slice(9, 12),
               "light center": slice(12, 15), "light color": slice(15, 18),
               "light normal": slice(18, 21)}


def with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


# ---------------------------------------------------------------------------
# The hand-written reverse against autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,kappa", [
    ("halton", 0.05), ("halton", 0.1), ("stratified", 0.05),
    ("stratified", 0.1)])
def test_reverse_matches_autograd_through_the_replay(sampler, kappa):
    cfg = RenderConfig(width=40, height=32, integrator="direct", spp=4,
                       bounces=1, sampler=sampler, pixel_chunk=1280)
    scene = cornell_box_with_spheres(resolution=(40, 32))
    codes = cuda_soft.silh_records(scene, cfg, device="cpu")
    offsets = pixel_rng_offsets(cfg)
    table, cam, light = (v.contiguous() for v in
                         cuda_shade._pack_diff_inputs(scene, cfg))
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((3, cfg.num_pixels)).astype(
        np.float32) / cfg.spp)
    T = scene.triangles.num_triangles
    dtab, dscal = cuda_soft.soft_bwd_plain(g, codes, offsets, table, cam,
                                           light, cfg, kappa, T)

    views = [v.detach().requires_grad_(True) for v in (table, cam, light)]
    lum = cuda_soft.soft_replay(*views, codes, offsets, cfg, kappa, T)
    r_tab, r_cam, r_light = torch.autograd.grad((g * lum).sum(), views)
    # The selector rows (is_emissive, is_sphere) have no cotangent.
    ref_tab = r_tab[[r for r in range(16) if r not in (10, 15)]].T
    ref_scal = torch.cat([r_cam, r_light])
    assert not r_tab[10].any() and not r_tab[15].any()
    pairs = [(name, dtab[:, sl], ref_tab[:, sl])
             for name, sl in TAB_GROUPS.items()]
    pairs += [(name, dscal[sl], ref_scal[sl])
              for name, sl in SCAL_GROUPS.items()]
    for name, got, ref in pairs:
        scale = ref.abs().max().item()
        assert scale > 0.0, name
        err = (got - ref).abs().max().item()
        assert err <= 1e-6 * max(scale, 1.0) + 1e-4 * scale, (
            f"{name}: {err:.3e} (largest magnitude {scale:.3e})")


def test_kernels_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise: a CPU tensor never reaches
    the plain version through them."""
    cfg = RenderConfig(width=8, height=8, integrator="direct", spp=1,
                       bounces=1)
    scene = cornell_box_with_spheres(resolution=(8, 8))
    packed = cuda_soft._pack_inputs(scene, cfg)
    offsets = pixel_rng_offsets(cfg).to(torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_soft.silh_records_kernel(offsets, packed,
                                      torch.zeros(0, dtype=torch.int32), cfg)
    table, cam, light = cuda_shade._pack_diff_inputs(scene, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_soft.soft_bwd_kernel(
            torch.zeros((3, 64)), torch.zeros((1, 64), dtype=torch.int32),
            offsets, table, cam, light, cfg, KAPPA, 12)


def test_entry_asserts_its_scope():
    cfg = RenderConfig(**CFG)
    from gpuraytracer_tpu_torch.scene import cornell_box
    with pytest.raises(AssertionError, match="spheres"):
        render_direct_soft_fused(cornell_box(resolution=(24, 24)), cfg,
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            render_direct_soft_fused(
                cornell_box_with_spheres(resolution=(24, 24)), cfg)


# ---------------------------------------------------------------------------
# The differentiable entry against the JAX oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_and_oracle():
    """(port value, port gradient tree) of the fused render on the CPU and
    (value, gradient tree) of the JAX package's oracle."""
    jax_scene = jscene.cornell_box_with_spheres(resolution=(24, 24))
    jcfg = jtypes.RenderConfig(**CFG)
    ref_value = np.asarray(jax_render_direct_soft(jax_scene, jcfg, KAPPA))
    ref_grads = jax.grad(
        lambda s: jnp.mean(jax_render_direct_soft(s, jcfg, KAPPA)),
        allow_int=True)(jax_scene)
    scene = with_grad(convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene)))
    value = render_direct_soft_fused(scene, RenderConfig(**CFG), KAPPA,
                                     device="cpu")
    value.mean().backward()
    return (value.detach().numpy(), convert.grads_to_numpy(scene),
            ref_value, ref_grads)


def test_fused_value_matches_the_jax_oracle(fused_and_oracle):
    value, _, ref, _ = fused_and_oracle
    assert value.shape == (24, 24, 3) and np.abs(ref).max() > 0
    np.testing.assert_allclose(value, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("group", GROUPS)
def test_fused_grads_match_the_jax_oracle(fused_and_oracle, group):
    _, got_tree, _, ref_tree = fused_and_oracle
    part, field = group.split(".")
    ref = np.asarray(getattr(getattr(ref_tree, part), field))
    got = got_tree[part][field]
    assert np.abs(ref).max() > 0.0, f"JAX gradient of {group} is all zero"
    assert got is not None and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-4)


def test_occluders_change_nothing():
    """The occluder cull on the records changes neither the value nor the
    gradients (its endpoint set holds the camera, from where the sphere
    layer probes on lanes that do not hit a sphere)."""
    cfg = RenderConfig(**CFG)
    base = cornell_box_with_spheres(resolution=(24, 24))
    occ = potential_occluders(base, cfg)
    assert not all(occ)
    out = []
    for occluders in (occ, None):
        scene = with_grad(base)
        value = render_direct_soft_fused(scene, cfg, KAPPA,
                                         occluders=occluders, device="cpu")
        value.mean().backward()
        out.append((value.detach(), convert.grads_to_numpy(scene)))
    (v_a, g_a), (v_b, g_b) = out
    assert torch.equal(v_a, v_b)
    n_groups = 0
    for part in g_b:
        for field, b in g_b[part].items():
            if b is not None:
                np.testing.assert_allclose(g_a[part][field], b, atol=5e-8,
                                           rtol=1e-5)
                n_groups += 1
    assert n_groups >= 11
