"""PyTorch port vs the JAX package: the grouped tier of the variant-A MIS
integrator (more than 64 triangles), through its plain versions on the CPU.

Scenes: ``cornell_box_tessellated(wall_subdiv=3, sphere_subdiv=1)`` (252
triangles) and the same walls with the two analytic spheres of
``cornell_box_with_spheres`` added (``tests/test_mis_grouped.py``'s
construction), at 16 x 8 x 2 camera rays x 6 MIS samples, built by the JAX
package and carried across with ``convert``. The JAX side runs its grouped
MIS trace in interpret mode once (a module fixture: the records the port
must make); values and gradients are held against its jnp oracle
``render_mis`` and ``jax.grad`` of it, which ``tests/test_mis_grouped.py``
holds the JAX grouped kernels against. The JAX grouped backward is not run
here: the chain port -> oracle <- JAX kernel closes without it.

Tolerances. Packing: bit for bit (the same float32 operations in the same
order on the same input table; the attribute table's normal rows within an
ulp, as ``compile_scene`` on rotated triangles). The plain grouped sweep
against the brute-force plain version: records equal on every lane (the
sweep's boxes are padded, so it skips no box that holds the winner), image
atol 5e-8 / rtol 1e-6. Records against the JAX grouped kernel: on the live
decisions, at most ``FLIP_SHARE_MAX`` differ (dead lanes fetch row 0 in the
port and row 0 or zeros in the JAX grouped kernel; they feed nothing, and
their count is printed). Value against the JAX oracle: the JAX package's MIS
tolerance, atol 5e-4 / rtol 1e-3. Gradients against ``jax.grad`` of the
oracle: atol 1e-5 max(scale, 1) / rtol 2e-4, on the sphere scene that
file's flip-aware rule (all but a bounded handful of elements tight, those
within 1e-3 of the largest magnitude). Occluder cull on and off: atol 5e-8 /
rtol 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.intersect as jint
import gpuraytracer_tpu.ops.pallas_mis as jmis
import gpuraytracer_tpu.ops.pallas_path as jpp
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render_mis as jax_render_mis
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_mis_bwd, cuda_path
from gpuraytracer_tpu_torch.types import RenderConfig
from test_torch_mis_kernel import FLIP_SHARE_MAX, untile

MIS_TOL = dict(atol=5e-4, rtol=1e-3)
SWEEP_TOL = dict(atol=5e-8, rtol=1e-6)
SMALL = dict(wall_subdiv=3, sphere_subdiv=1)
CFG = dict(width=16, height=8, integrator="mis", camera_rays=2,
           mis_samples=6, pixel_chunk=128)

# tests/test_mis_grouped.py's gradient groups on the two scenes.
TESS_GROUPS = ["light.emitted_radiance", "light.center", "light.normal",
               "light.width", "light.depth", "triangles.verts",
               "triangles.diffuse", "triangles.metallic",
               "triangles.roughness", "camera.position", "camera.direction",
               "camera.up"]
SPHERE_GROUPS = ["spheres.center", "spheres.radius", "spheres.diffuse",
                 "triangles.verts", "light.emitted_radiance",
                 "camera.position"]
CASE_GROUPS = ([("tess", g) for g in TESS_GROUPS]
               + [("spheres", g) for g in SPHERE_GROUPS])


def _jax_scene(name, resolution=(16, 8)):
    tess = jscene.cornell_box_tessellated(resolution=resolution, **SMALL)
    if name == "tess":
        return tess
    sph = jscene.cornell_box_with_spheres(resolution=resolution).spheres
    return dataclasses.replace(tess, spheres=sph)


def _carry(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


def _with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def _doubled_box():
    """The 36-triangle box with every triangle twice: 72 triangles, so the
    grouped tier by default; the copies lie on the originals."""
    scene = tscene.cornell_box(resolution=(16, 8))
    tri = scene.triangles
    doubled = dataclasses.replace(tri, **{
        f.name: torch.cat([getattr(tri, f.name)] * 2)
        for f in dataclasses.fields(tri)})
    return dataclasses.replace(scene, triangles=doubled)


def _fields(rec):
    """The camera record and the sample record's five decisions, numpy;
    ``rec`` a MisRecords or a (camera, samples) pair of arrays."""
    if isinstance(rec, cuda_mis.MisRecords):
        rec = (rec.camera.numpy(), rec.samples.numpy())
    cam, s = rec
    mask = cuda_mis.REC_CODE_MASK
    return cam, dict(reach1=(s & 1) != 0, reach2=(s & 2) != 0,
                     reach3=(s & 4) != 0,
                     cos=(s >> cuda_mis.REC_SHIFT_C) & mask,
                     vndf=(s >> cuda_mis.REC_SHIFT_V) & mask)


def _live(cam, f, is_em):
    """Where each decision feeds the image (``chip_smoke.mis_live``): the
    camera record everywhere; the light probe and the lobe winners where the
    primary ray landed on a non-emissive surface; a secondary probe where,
    besides, its lobe ray landed on non-emissive geometry."""
    def on_geometry(code):
        return (code > 0) & ~is_em[np.maximum(code - 1, 0)]
    surf = on_geometry(cam)[:, None, :]
    return dict(reach1=surf, cos=surf, vndf=surf,
                reach2=surf & on_geometry(f["cos"]),
                reach3=surf & on_geometry(f["vndf"]))


def _is_emissive(scene, cfg):
    return cuda_mis._pack_inputs(scene, cfg).atab[8].numpy() > 0.5


@functools.lru_cache(maxsize=None)
def _case(name):
    """The scene in both packages, the JAX oracle's image and gradients, and
    the port's image, records and gradients through
    ``render_mis_decoupled`` (the plain grouped sweep and the plain backward
    on the CPU)."""
    jax_scene = _jax_scene(name)
    jcfg = jtypes.RenderConfig(**CFG)
    oracle = np.asarray(jax_render_mis(jax_scene, jcfg).hdr)
    grads = jax.grad(lambda s: jnp.mean(jax_render_mis(s, jcfg).hdr),
                     allow_int=True)(jax_scene)
    scene, cfg = _carry(jax_scene), RenderConfig(**CFG)
    hdr, rec = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                             device="cpu")
    leaves = _with_grad(scene)
    img = cuda_mis_bwd.render_mis_decoupled(leaves, cfg, device="cpu")
    img.mean().backward()
    return dict(scene=scene, cfg=cfg, oracle=oracle, jax_grads=grads,
                hdr=hdr, rec=rec, img=img.detach(),
                port_grads=convert.grads_to_numpy(leaves))


@pytest.fixture(scope="module")
def jax_grouped_trace():
    """The JAX package's grouped MIS trace (interpret mode, records on) on
    the 252-triangle scene: its image and its two record streams in the
    port's layout."""
    jax_scene = _jax_scene("tess")
    assert jax_scene.triangles.num_triangles > jpp.STATIC_UNROLL_MAX
    cfg = RenderConfig(**CFG)
    hdr, planes = jmis._render_mis_impl(jax_scene, jtypes.RenderConfig(**CFG),
                                        interpret=True, emit_records=True)
    cam, smp = untile(planes, cfg.camera_rays, cfg.mis_samples // 3,
                      cfg.num_pixels)
    return np.asarray(hdr), cam, smp


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tess", "spheres"])
@pytest.mark.parametrize("cull", [False, True], ids=["all", "culled"])
def test_grouped_packing_equals_jax(name, cull):
    """The grouped tables of ``cuda_mis._pack_inputs(grouped=True,
    occluders=)`` against ``pallas_mis._pack_inputs(grouped=True,
    occluders=)``: bit for bit on the same triangle table (the JAX
    package's), and the attribute table the port transposes at launch equal
    to the JAX package's transposed one up to its padding."""
    jax_scene = _jax_scene(name)
    jcfg = jtypes.RenderConfig(**CFG)
    occ = jint.potential_occluders(jax_scene, jcfg) if cull else None
    ref = [np.asarray(x) for x in jmis._pack_inputs(
        jax_scene, jcfg, grouped=True, occluders=occ)]
    (geo_j, _, _, _, _, atab_t_j, shadow_geo_j, aabb_j, sup_j,
     shadow_aabb_j, shadow_sup_j) = ref
    tri = torch.from_numpy(np.array(jmis._pack_inputs(jax_scene, jcfg)[0]))
    scene, cfg = _carry(jax_scene), RenderConfig(**CFG)
    got = cuda_path._pack_grouped(scene, tri, occ)
    for g, r in ((got.geo, geo_j), (got.aabb, aabb_j), (got.sup, sup_j),
                 (got.shadow_geo, shadow_geo_j),
                 (got.shadow_aabb, shadow_aabb_j),
                 (got.shadow_sup, shadow_sup_j)):
        assert g.shape == r.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    assert got.num_tris == 252
    assert got.num_shadow == (sum(occ) if cull else 252)
    assert not cull or got.num_shadow < 252
    # The packing the kernel takes holds these tables and the attributes.
    packed = cuda_mis._pack_inputs(scene, cfg, grouped=True, occluders=occ)
    for t, r in zip(packed.grouped[:6], (geo_j, aabb_j, sup_j, shadow_geo_j,
                                         shadow_aabb_j, shadow_sup_j)):
        assert t.shape == r.shape
    n_prims = 252 + scene.spheres.num_spheres
    atab = packed.atab.numpy()
    assert atab.shape == (cuda_mis.NATTR, n_prims)
    np.testing.assert_allclose(atab[:3], atab_t_j.T[:3, :n_prims], atol=1e-6)
    np.testing.assert_array_equal(atab[3:], atab_t_j.T[3:, :n_prims])
    assert not atab_t_j[n_prims:].any()


# ---------------------------------------------------------------------------
# The plain grouped sweep against the brute-force plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tess", "spheres"])
@pytest.mark.parametrize("cull", [False, True], ids=["all", "culled"])
def test_plain_sweep_equals_brute_force(name, cull):
    scene, cfg = _carry(_jax_scene(name)), RenderConfig(**CFG)
    occ = potential_occluders(scene, cfg) if cull else None
    hdr_g, rec_g = cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, occluders=occ, grouped=True,
        device="cpu")
    hdr_b, rec_b = cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, occluders=occ, grouped=False,
        device="cpu")
    assert torch.equal(rec_g.camera, rec_b.camera)
    assert torch.equal(rec_g.samples, rec_b.samples)
    assert (rec_g.camera > 0).float().mean() > 0.5
    np.testing.assert_allclose(hdr_g.numpy(), hdr_b.numpy(), **SWEEP_TOL)


def test_sweep_counts_its_work():
    """The grouped sweep tests only the triangles of the groups a ray
    reaches, and its counters see the primary rays, the lobe rays and the
    light probes apart."""
    scene, cfg = _carry(_jax_scene("tess")), RenderConfig(**CFG)
    packed = cuda_mis._pack_inputs(scene, cfg, grouped=True)
    stats = {}
    cuda_mis.render_mis_plain(cfg.num_pixels, 0, packed, None, cfg, True,
                              stats)
    rays = cfg.num_pixels * cfg.camera_rays
    samples = rays * (cfg.mis_samples // 3)
    assert stats["camera"]["rays_all"] == stats["camera"]["rays"] == rays
    assert stats["closest"]["rays_all"] == 2 * samples
    assert stats["shadow"]["rays_all"] == 3 * samples
    for key in ("camera", "closest", "shadow"):
        c = stats[key]
        assert 0 < c["rays"] <= c["rays_all"]
        assert 0 < c["triangles"] <= c["triangles_all"]
        assert c["triangles_all"] < 0.5 * 252 * c["rays_all"]
        assert c["boxes_all"] >= 2 * c["rays_all"] or key == "shadow"


def test_sampled_pixel_ids_give_the_frame_s_pixels():
    """``rid_base`` as a tensor of pixel ids: every 5th pixel of the frame
    gives those pixels' image and records."""
    scene, cfg = _carry(_jax_scene("spheres")), RenderConfig(**CFG)
    packed = cuda_mis._pack_inputs(scene, cfg, grouped=True)
    hdr, rec = cuda_mis.render_mis_plain(cfg.num_pixels, 0, packed, None,
                                         cfg, True)
    pix = torch.arange(0, cfg.num_pixels, 5)
    hdr_s, rec_s = cuda_mis.render_mis_plain(pix.numel(), pix, packed, None,
                                             cfg.replace(pixel_chunk=7), True)
    assert torch.equal(hdr_s, hdr[:, pix])
    assert torch.equal(rec_s.camera, rec.camera[:, pix])
    assert torch.equal(rec_s.samples, rec.samples[..., pix])


# ---------------------------------------------------------------------------
# The port against the JAX package's grouped kernel and oracle
# ---------------------------------------------------------------------------

def test_records_equal_the_jax_grouped_kernel(jax_grouped_trace, capsys):
    hdr_j, cam_j, smp_j = jax_grouped_trace
    case = _case("tess")
    rec = case["rec"]
    assert rec.camera.shape == cam_j.shape and rec.samples.shape == smp_j.shape
    cam, f = _fields(rec)
    cam_r, f_r = _fields((cam_j, smp_j))
    live = _live(cam_r, f_r, _is_emissive(case["scene"], case["cfg"]))
    n_live = cam.size + sum(int(w.sum()) for w in live.values())
    n_differ = int((cam != cam_r).sum()) + sum(
        int(((f[k] != f_r[k]) & w).sum()) for k, w in live.items())
    dead = int((rec.samples.numpy() != smp_j).sum()) - sum(
        int(((f[k] != f_r[k]) & w).sum()) for k, w in live.items())
    with capsys.disabled():
        print(f"\n  live decisions that differ from the JAX grouped kernel's: "
              f"{n_differ}/{n_live}; sample records that differ on dead "
              f"lanes only (not held): {dead}")
    assert n_differ <= FLIP_SHARE_MAX * n_live
    np.testing.assert_allclose(case["hdr"].numpy(), hdr_j, **MIS_TOL)


@pytest.mark.parametrize("name", ["tess", "spheres"])
def test_value_matches_jax_oracle(name):
    case = _case(name)
    assert case["img"].shape == (8, 16, 3)
    assert torch.equal(case["img"], case["hdr"])
    np.testing.assert_allclose(case["img"].numpy(), case["oracle"], **MIS_TOL)


@pytest.mark.parametrize("name,group", CASE_GROUPS)
def test_grads_match_jax_oracle(name, group, jax_grouped_trace):
    case = _case(name)
    # Guard: the port took the JAX package's decisions. On the tessellated
    # scene its live records equal the JAX grouped kernel's; on the sphere
    # scene its image equals the oracle's at MIS_TOL.
    if name == "tess":
        _, cam_j, smp_j = jax_grouped_trace
        cam, f = _fields(case["rec"])
        cam_r, f_r = _fields((cam_j, smp_j))
        assert np.array_equal(cam, cam_r)
        live = _live(cam_r, f_r, _is_emissive(case["scene"], case["cfg"]))
        for k, w in live.items():
            w = np.broadcast_to(w, f[k].shape)
            assert np.array_equal(f[k][w], f_r[k][w]), k
    else:
        np.testing.assert_allclose(case["img"].numpy(), case["oracle"],
                                   **MIS_TOL)
    part, field = group.split(".")
    ref = np.asarray(getattr(getattr(case["jax_grads"], part), field))
    got = case["port_grads"][part][field]
    assert np.abs(ref).max() > 0.0, f"oracle gradient of {group} is all zero"
    assert got is not None and got.shape == ref.shape
    scale = np.abs(ref).max()
    if name == "tess":
        np.testing.assert_allclose(got, ref, atol=1e-5 * max(scale, 1.0),
                                   rtol=2e-4)
        return
    # tests/test_mis_grouped.py:95-115: isolated gate-boundary elements may
    # carry another valid subgradient.
    d = np.abs(got - ref)
    tight = 1e-5 * max(scale, 1.0) + 2e-4 * np.abs(ref)
    n_out = int((d > tight).sum())
    assert n_out <= max(3, got.size // 20), (group, n_out, got.size)
    assert d.max() <= 1e-3 * max(scale, 1.0), (group, float(d.max()), scale)


@pytest.mark.parametrize("name", ["tess", "spheres"])
def test_occluder_cull_leaves_the_render_unchanged(name):
    scene, cfg = _carry(_jax_scene(name)), RenderConfig(**CFG)
    occ = potential_occluders(scene, cfg)
    assert not all(occ), "the tessellated walls should be culled"
    a = cuda_mis.render_mis_cuda(scene, cfg, device="cpu")
    b = cuda_mis_bwd.render_mis_decoupled(scene, cfg, occluders=occ,
                                          device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **SWEEP_TOL)


# ---------------------------------------------------------------------------
# Tiers, record codes, pixel ranges
# ---------------------------------------------------------------------------

def test_72_triangle_box_grouped_equals_static():
    """The doubled box takes the grouped tier by default; forced onto the
    static tier it gives the same records and image, and a twin never wins
    over its original."""
    big, cfg = _doubled_box(), RenderConfig(**CFG)
    assert big.triangles.num_triangles == 72
    hdr_g, rec_g = cuda_mis.render_mis_cuda_impl(big, cfg, emit_records=True,
                                                 device="cpu")
    hdr_s, rec_s = cuda_mis.render_mis_cuda_impl(
        big, cfg, emit_records=True, grouped=False, device="cpu")
    assert torch.equal(rec_g.camera, rec_s.camera)
    assert torch.equal(rec_g.samples, rec_s.samples)
    assert torch.equal(hdr_g, hdr_s)
    assert int(rec_g.camera.max()) <= 36


def test_record_codes_above_10_bits_at_1282_triangles():
    """At 1,282 triangles the 14-bit primitive codes of the records reach
    above 1,023, and the grouped sweep's records equal the brute force's."""
    scene = tscene.cornell_box_tessellated(resolution=(4, 4), wall_subdiv=8,
                                           sphere_subdiv=2)
    assert scene.triangles.num_triangles == 1282
    cfg = RenderConfig(**dict(CFG, width=4, height=4))
    _, rec_g = cuda_mis.render_mis_cuda_impl(scene, cfg, emit_records=True,
                                             device="cpu")
    _, rec_b = cuda_mis.render_mis_cuda_impl(
        scene, cfg, emit_records=True, grouped=False, device="cpu")
    assert torch.equal(rec_g.camera, rec_b.camera)
    assert torch.equal(rec_g.samples, rec_b.samples)
    mask = cuda_mis.REC_CODE_MASK
    codes = torch.cat([rec_g.camera.flatten(),
                       ((rec_g.samples >> cuda_mis.REC_SHIFT_C) & mask)
                       .flatten(),
                       ((rec_g.samples >> cuda_mis.REC_SHIFT_V) & mask)
                       .flatten()])
    assert int(codes.max()) > 1023
    assert int(codes.max()) <= 1282


def test_fused_local_pixel_ranges_concatenate_to_the_frame():
    """``render_mis_fused_local`` over two pixel ranges: the images
    concatenate to the whole frame's, and the gradients of the two ranges
    sum to the whole frame's (the same per-lane terms, summed in another
    order: atol 1e-6 max(scale, 1) / rtol 1e-5)."""
    scene, cfg = _carry(_jax_scene("spheres")), RenderConfig(**CFG)
    whole = _with_grad(scene)
    frame = cuda_mis_bwd.render_mis_fused(whole, cfg, device="cpu")
    frame.sum().backward()
    parts = _with_grad(scene)
    n, cut = cfg.num_pixels, 3 * cfg.width + 5
    flat = torch.cat([cuda_mis_bwd.render_mis_fused_local(
        parts, cfg, local_n, base, device="cpu")
        for base, local_n in ((0, cut), (cut, n - cut))])
    assert torch.equal(flat.detach().reshape(cfg.height, cfg.width, 3),
                       frame.detach())
    flat.sum().backward()
    got, ref = convert.grads_to_numpy(parts), convert.grads_to_numpy(whole)
    compared = 0
    for part in ref:
        for field, r in ref[part].items():
            if r is None:
                assert got[part][field] is None
                continue
            scale = max(np.abs(r).max(), 1.0)
            np.testing.assert_allclose(got[part][field], r,
                                       atol=1e-6 * scale, rtol=1e-5,
                                       err_msg=f"{part}.{field}")
            compared += 1
    assert compared >= 10
