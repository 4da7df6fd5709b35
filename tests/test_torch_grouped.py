"""PyTorch port vs the JAX package: the grouped tier of the variant-B path
tracer (more than 64 triangles), through its plain versions on the CPU.

Scenes: ``cornell_box_tessellated(wall_subdiv=3, sphere_subdiv=1)`` (252
triangles) and the same walls with the two analytic spheres of
``cornell_box_with_spheres`` added (``tests/test_mis_grouped.py``'s
construction), at 16 x 8 x 2 spp x 2 bounces, built by the JAX package and
carried across with ``convert``. The JAX side runs its grouped trace kernel
in interpret mode once (a module fixture: the records the port must equal);
values and gradients are held against its jnp oracle ``render`` and
``jax.grad`` of it, which ``tests/test_grouped.py`` holds the JAX grouped
kernels against.

Tolerances. Scene builders, box tables, shadow tables, occluder masks and
records: bit for bit (the same float32 operations in the same order; the
records are decisions). The plain grouped sweep against the brute-force
plain version: records equal on live lanes, image atol 5e-8 / rtol 1e-6 (the
same decisions; the JAX package's grouped-vs-static tolerance). Image against
the JAX oracle: atol 2e-5 / rtol 1e-4, the JAX package's kernel-vs-oracle
tolerance. Gradients against ``jax.grad`` of the oracle: atol 1e-6 / rtol
1e-4 (``GRAD_TOL`` of ``tests/test_torch_shade.py``). Draws read against
draws regenerated: atol 5e-8 / rtol 1e-5; occluder cull on and off: atol
5e-8 / rtol 1e-6 (``tests/test_grouped.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.intersect as jint
import gpuraytracer_tpu.ops.decoupled as jdec
import gpuraytracer_tpu.ops.pallas_path as jpp
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render as jax_render
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch import intersect
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_path, cuda_shade, decoupled
from gpuraytracer_tpu_torch.types import RenderConfig

HDR_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
SWEEP_TOL = dict(atol=5e-8, rtol=1e-6)
MODES_TOL = dict(atol=5e-8, rtol=1e-5)
SMALL = dict(wall_subdiv=3, sphere_subdiv=1)
CFG = dict(width=16, height=8, integrator="path", spp=2, bounces=2,
           pixel_chunk=128)

# tests/test_grouped.py's gradient groups; the sphere scene adds the spheres'
# center and radius.
TESS_GROUPS = ["triangles.verts", "triangles.diffuse", "triangles.emissive",
               "light.color", "light.center", "camera.position",
               "camera.direction"]
SPHERE_GROUPS = TESS_GROUPS + ["spheres.center", "spheres.radius"]
CASE_GROUPS = ([("tess", g) for g in TESS_GROUPS]
               + [("spheres", g) for g in SPHERE_GROUPS])


def _jax_scene(name):
    tess = jscene.cornell_box_tessellated(resolution=(16, 8), **SMALL)
    if name == "tess":
        return tess
    sph = jscene.cornell_box_with_spheres(resolution=(16, 8)).spheres
    return dataclasses.replace(tess, spheres=sph)


def _carry(jax_scene):
    return convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))


def _with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def _live(records, is_em):
    """(alive, shaded) masks of a record stream [spp, bounces, n]: the
    iterations that start with a live path, and those of them that shade a
    surface (the decisions; dead lanes write records that feed nothing)."""
    prim = records % cuda_path.OCC_BIT
    alive = np.ones(prim.shape, bool)
    shaded = np.zeros(prim.shape, bool)
    for b in range(prim.shape[1]):
        if b:
            alive[:, b] = shaded[:, b - 1]
        shaded[:, b] = (alive[:, b] & (prim[:, b] > 0)
                        & ~is_em[np.maximum(prim[:, b] - 1, 0)])
    return alive, shaded


def _assert_same_decisions(rec, ref, is_em):
    alive, shaded = _live(ref, is_em)
    np.testing.assert_array_equal((rec % cuda_path.OCC_BIT)[alive],
                                  (ref % cuda_path.OCC_BIT)[alive])
    np.testing.assert_array_equal(rec[shaded], ref[shaded])
    return alive


def _is_emissive(packed):
    return packed.atab[9].numpy() > 0.5


@functools.lru_cache(maxsize=None)
def _case(name):
    """The scene in both packages, the JAX oracle's image and gradients, the
    port's image and gradients through ``render_path_decoupled`` (the plain
    grouped sweep and the plain backward on the CPU)."""
    jax_scene = _jax_scene(name)
    jcfg = jtypes.RenderConfig(**CFG)
    oracle = np.asarray(jax_render(jax_scene, jcfg).hdr)
    grads = jax.grad(lambda s: jnp.mean(jax_render(s, jcfg).hdr),
                     allow_int=True)(jax_scene)
    scene, cfg = _carry(jax_scene), RenderConfig(**CFG)
    hdr, aux = decoupled.trace_records(scene, cfg, device="cpu")
    port = {}
    for records_only in (False, True):
        leaves = _with_grad(scene)
        if records_only:
            img = cuda_shade.render_path_decoupled_fused(
                leaves, cfg, records_only=True, device="cpu")
        else:  # the draw planes (the default at this size)
            img = decoupled.render_path_decoupled(leaves, cfg, device="cpu")
        img.mean().backward()
        port[records_only] = convert.grads_to_numpy(leaves)
    return dict(scene=scene, cfg=cfg, oracle=oracle, jax_grads=grads,
                hdr=hdr, aux=aux, port_grads=port)


@pytest.fixture(scope="module")
def jax_grouped_trace():
    """The JAX package's grouped trace kernel (interpret mode) on the
    252-triangle scene: its image and records."""
    jax_scene = _jax_scene("tess")
    assert jax_scene.triangles.num_triangles > jpp.STATIC_UNROLL_MAX
    hdr, aux = jdec.trace_records(jax_scene, jtypes.RenderConfig(**CFG),
                                  interpret=True)
    return np.asarray(hdr), np.asarray(aux.records)


# ---------------------------------------------------------------------------
# Scene builders and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, SMALL], ids=["default", "small"])
def test_tessellated_scene_equals_jax(kw):
    port = tscene.cornell_box_tessellated(resolution=(16, 8), **kw)
    ref = _carry(jscene.cornell_box_tessellated(resolution=(16, 8), **kw))
    assert port.triangles.num_triangles == (1002 if not kw else 252)
    assert convert.scenes_equal(port, ref)


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_icosphere_equals_jax(subdiv):
    port = tscene.icosphere((1.0, -1.7, 0.8), 0.8, subdiv)
    ref = jscene.icosphere((1.0, -1.7, 0.8), 0.8, subdiv)
    assert port.dtype == np.float32 and port.shape == (20 * 4 ** subdiv, 3, 3)
    np.testing.assert_array_equal(_bits(port), _bits(ref))


def test_morton2_equals_jax():
    pairs = [(i, j) for i in range(20) for j in range(20)] + [(1000, 77)]
    assert [tscene._morton2(i, j) for i, j in pairs] == [
        jscene._morton2(i, j) for i, j in pairs]


@pytest.mark.parametrize("name", ["tess", "default", "box"])
def test_group_aabbs_equal_jax(name):
    jax_scene = (jscene.cornell_box(resolution=(16, 8)) if name == "box"
                 else jscene.cornell_box_tessellated(resolution=(16, 8))
                 if name == "default" else _jax_scene("tess"))
    verts = np.asarray(jax_scene.triangles.verts, np.float32)
    ref = jpp.group_aabbs(jnp.asarray(verts))
    got = cuda_path.group_aabbs(torch.from_numpy(verts))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    # Every triangle lies in its group's box; sentinel groups reject.
    lo, hi = got[0][:3].T, got[0][3:].T
    n = verts.shape[0]
    g = torch.arange(n) // cuda_path.GROUP
    v = torch.from_numpy(verts)
    assert bool((v >= lo[g][:, None]).all() and (v <= hi[g][:, None]).all())


@pytest.mark.parametrize("cull", [False, True], ids=["all", "culled"])
def test_shadow_tables_equal_jax(cull):
    """``pad_geo`` and ``pack_shadow_tables`` on the same triangle table and
    vertices as the JAX functions. (The table itself comes from
    ``compile_scene``, which on rotated geometry lies an ulp from the JAX
    package's: ``tests/test_torch_shade.py``.)"""
    jax_scene = _jax_scene("tess")
    jcfg = jtypes.RenderConfig(**CFG)
    occ = jint.potential_occluders(jax_scene, jcfg) if cull else None
    tri = np.array(jpp._pack_inputs(jax_scene, jcfg)[0])
    verts = np.array(jax_scene.triangles.verts, np.float32)
    geo_j = jpp.pad_geo(jnp.asarray(tri[:12]))
    main_j = jpp.group_aabbs(jnp.asarray(verts))
    ref = (geo_j,) + jpp.pack_shadow_tables(
        jnp.asarray(tri), jnp.asarray(verts), occ, geo_j, *main_j)
    tri_t, verts_t = torch.from_numpy(tri), torch.from_numpy(verts)
    geo = cuda_path.pad_geo(tri_t[:12])
    got = (geo,) + cuda_path.pack_shadow_tables(
        tri_t, verts_t, occ, geo, *cuda_path.group_aabbs(verts_t))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    n_kept = got[1].abs().sum(dim=0).gt(0).sum().item()
    assert n_kept == (sum(occ) if cull else 252)
    assert not cull or n_kept < 252
    # The packing the kernels take holds these tables.
    packed = cuda_path._pack_inputs(_carry(jax_scene), RenderConfig(**CFG),
                                    grouped=True, occluders=occ)
    assert packed.grouped.num_shadow == n_kept
    for t, r in zip(packed.grouped[3:6], ref[1:]):
        assert t.shape == r.shape


@pytest.mark.parametrize("slice_elements", [None, 4096],
                         ids=["one-slice", "sliced"])
@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_potential_occluders_equal_jax(kw, slice_elements, monkeypatch):
    """Bit for bit, with the distance matrix built in one slice and in many
    (4,096 elements: 5 and 1 triangles per slice)."""
    if slice_elements is not None:
        monkeypatch.setattr(intersect, "OCCLUDER_SLICE", slice_elements)
    jax_scene = jscene.cornell_box_tessellated(resolution=(16, 8), **kw)
    ref = jint.potential_occluders(jax_scene, jtypes.RenderConfig(**CFG))
    got = potential_occluders(_carry(jax_scene), RenderConfig(**CFG))
    assert got == ref
    assert 0 < sum(got) < len(got)


# ---------------------------------------------------------------------------
# The plain grouped sweep against the brute-force plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tess", "spheres", "box"])
@pytest.mark.parametrize("cull", [False, True], ids=["all", "culled"])
def test_plain_sweep_equals_brute_force(name, cull):
    """The 36-triangle box forced into the grouped tier is the port's
    counterpart of ``test_grouped_equals_static_unroll``."""
    scene = (tscene.cornell_box(resolution=(16, 8)) if name == "box"
             else _carry(_jax_scene(name)))
    cfg = RenderConfig(**CFG)
    occ = potential_occluders(scene, cfg) if cull else None
    hdr_g, aux_g = cuda_path.render_path_cuda_impl(
        scene, cfg, emit_records=True, occluders=occ, grouped=True,
        device="cpu")
    hdr_b, aux_b = cuda_path.render_path_cuda_impl(
        scene, cfg, emit_records=True, occluders=occ, grouped=False,
        device="cpu")
    packed = cuda_path._pack_inputs(scene, cfg)
    alive = _assert_same_decisions(aux_g.records.numpy(),
                                   aux_b.records.numpy(), _is_emissive(packed))
    assert alive.sum() > 0.5 * alive.size
    np.testing.assert_allclose(hdr_g.numpy(), hdr_b.numpy(), **SWEEP_TOL)


def test_sweep_skips_boxes_and_counts_its_work():
    """The sweep tests only the triangles of the groups a ray reaches: far
    fewer than every triangle, and the counters see it."""
    scene = _carry(_jax_scene("tess"))
    cfg = RenderConfig(**CFG)
    packed = cuda_path._pack_inputs(scene, cfg, grouped=True)
    offsets = torch.arange(cfg.num_pixels)
    stats = {}
    cuda_path.render_path_plain(offsets, 0, packed, None, None, cfg, True,
                                stats)
    closest, shadow = stats["closest"], stats["shadow"]
    rays = cfg.num_pixels * cfg.spp * cfg.bounces
    assert closest["rays_all"] == rays == shadow["rays_all"]
    assert 0 < closest["rays"] <= rays and 0 < shadow["rays"] < rays
    assert 0 < closest["triangles_all"] < 0.5 * 252 * rays
    assert closest["boxes_all"] >= 2 * rays  # every ray tests both supers


def _shadow_probe_one_ray(g, h, ld, t_max):
    """K2g's shadow probe for one ray, test by test, as trace.cuh's
    occluded_grouped runs it: (box tests, triangle tests, triangle tests had
    a lane finished every group it entered, occluded)."""
    inv = cuda_path._safe_inv(ld[None])
    t_seg = t_max * (1.0 + cuda_path.T_FAR_SLACK) + cuda_path.T_FAR_SLACK
    boxes = tris = 0
    for sg in range(g.shadow_sup.shape[1]):
        boxes += 1
        if not cuda_path._slab_reach(g.shadow_sup[:, sg], h[None], inv, t_seg):
            continue
        for gi in range(sg * cuda_path.SUPER, (sg + 1) * cuda_path.SUPER):
            boxes += 1
            if not cuda_path._slab_reach(g.shadow_aabb[:, gi], h[None], inv,
                                         t_seg):
                continue
            top = min((gi + 1) * cuda_path.GROUP, g.num_shadow)
            for k in range(gi * cuda_path.GROUP, top):
                tris += 1
                _, hit = cuda_path.triangle_candidates(
                    *cuda_path._geo_rows(g.shadow_geo[:, k:k + 1]), h[None],
                    ld[None], 0.0, t_max)
                if hit.item():
                    return boxes, tris, tris + top - 1 - k, True
    return boxes, tris, tris, False


def test_shadow_counts_stop_at_the_first_occluder():
    """The sweep's shadow counters count what the kernel does: a ray leaves
    the sweep, and the group it is in, at its first occluder."""
    scene = _carry(_jax_scene("tess"))
    g = cuda_path._pack_inputs(scene, RenderConfig(**CFG), grouped=True).grouped
    verts = scene.triangles.verts.reshape(-1, 3)
    lo, hi = verts.min(dim=0).values, verts.max(dim=0).values
    u = np.random.default_rng(0).uniform(0.1, 0.9, (48, 3))
    h = torch.from_numpy(u.astype(np.float32)) * (hi - lo) + lo
    seg = scene.light.center - h
    t_max = seg.norm(dim=-1)
    ld = seg / t_max[:, None]
    stats = {}
    occ = cuda_path.occluded_grouped(g, h, ld, t_max, stats=stats)
    ref = [_shadow_probe_one_ray(g, h[i], ld[i], t_max[i:i + 1])
           for i in range(h.shape[0])]
    boxes, tris, whole, blocked = (list(x) for x in zip(*ref))
    assert occ.tolist() == blocked
    assert 0 < sum(blocked) < len(blocked)
    assert stats["boxes"] == stats["boxes_all"] == sum(boxes)
    assert stats["triangles"] == stats["triangles_all"] == sum(tris)
    assert sum(tris) < sum(whole)


# ---------------------------------------------------------------------------
# The port's trace against the JAX package's grouped kernel and oracle
# ---------------------------------------------------------------------------

def test_records_equal_the_jax_grouped_kernel(jax_grouped_trace):
    hdr_j, rec_j = jax_grouped_trace
    case = _case("tess")
    rec = case["aux"].records.numpy()
    assert rec.shape == rec_j.shape
    packed = cuda_path._pack_inputs(case["scene"], case["cfg"])
    _assert_same_decisions(rec, rec_j, _is_emissive(packed))
    np.testing.assert_allclose(case["hdr"].numpy(), hdr_j, **HDR_TOL)


@pytest.mark.parametrize("name", ["tess", "spheres"])
def test_value_matches_jax_oracle(name):
    case = _case(name)
    assert case["hdr"].shape == (8, 16, 3)
    np.testing.assert_allclose(case["hdr"].numpy(), case["oracle"], **HDR_TOL)


@pytest.mark.parametrize("name,group", CASE_GROUPS)
def test_grads_match_jax_oracle(name, group, jax_grouped_trace):
    case = _case(name)
    # Guard: the two packages took the same decisions. On the 252-triangle
    # scene the records equal the JAX grouped kernel's; on the sphere scene
    # the image equals the JAX oracle's at HDR_TOL, which a flipped decision
    # (another primitive or shadow bit) would break by far more.
    if name == "tess":
        packed = cuda_path._pack_inputs(case["scene"], case["cfg"])
        _assert_same_decisions(case["aux"].records.numpy(),
                               jax_grouped_trace[1], _is_emissive(packed))
    else:
        np.testing.assert_allclose(case["hdr"].numpy(), case["oracle"],
                                   **HDR_TOL)
    part, field = group.split(".")
    ref = np.asarray(getattr(getattr(case["jax_grads"], part), field))
    got = case["port_grads"][False][part][field]
    assert np.abs(ref).max() > 0.0, f"oracle gradient of {group} is all zero"
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("name", ["tess", "spheres"])
def test_records_only_and_planes_give_the_same_grads(name):
    planes, regenerated = (_case(name)["port_grads"][ro]
                           for ro in (False, True))
    compared = 0
    for part in planes:
        for field, a in planes[part].items():
            b = regenerated[part][field]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, **MODES_TOL)
                compared += 1
    assert compared >= 10


@pytest.mark.parametrize("name", ["tess", "spheres"])
def test_occluder_cull_leaves_the_render_unchanged(name):
    scene = _carry(_jax_scene(name))
    cfg = RenderConfig(**CFG)
    occ = potential_occluders(scene, cfg)
    assert not all(occ), "the tessellated walls should be culled"
    a = cuda_path.render_path_cuda(scene, cfg, device="cpu")
    b = decoupled.render_path_decoupled(scene, cfg, occluders=occ,
                                        device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **SWEEP_TOL)
