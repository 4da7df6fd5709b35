"""The packing layer's memo (``cuda_path.kept``) on the CPU, on 8x8 scenes: a
pack that takes its tables from the memo equals a pack made afresh bit for
bit, in both modules and both tiers; the memo makes its tables again after
every change to what they are made from; and it never keeps the tables of a
source that requires grad."""
import dataclasses

import pytest
import torch

from gpuraytracer_tpu_torch.intersect import compile_scene, potential_occluders
from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_path
from gpuraytracer_tpu_torch.scene import cornell_box, cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig

PATH = RenderConfig(width=8, height=8, spp=1, bounces=1)
MIS = RenderConfig(width=8, height=8, integrator="mis", camera_rays=1,
                   mis_samples=3)
SCENES = {"box": cornell_box, "spheres": cornell_box_with_spheres}
MODULES = {"path": (cuda_path, PATH), "mis": (cuda_mis, MIS)}


@pytest.fixture(autouse=True)
def empty_memo():
    cuda_path.KEPT.clear()
    yield
    cuda_path.KEPT.clear()


def _fields(packed):
    """The pack's tensors and numbers by name, the grouped tables' too."""
    out = {}
    for name, value in packed._asdict().items():
        if isinstance(value, cuda_path.GroupedTables):
            out.update({f"grouped.{k}": v
                        for k, v in value._asdict().items()})
        else:
            out[name] = value
    return out


def _assert_bit_equal(got, want):
    got, want = _fields(got), _fields(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)) \
                if w.dtype == torch.float32 else torch.equal(g, w), name
        else:
            assert g == w, name


def _with_verts(scene, verts):
    return dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, verts=verts))


@pytest.mark.parametrize("cull", [False, True], ids=["all", "culled"])
@pytest.mark.parametrize("grouped", [False, True], ids=["static", "grouped"])
@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("module", list(MODULES))
def test_a_kept_pack_equals_a_fresh_pack(module, scene_name, grouped, cull):
    mod, cfg = MODULES[module]
    scene = SCENES[scene_name](resolution=(8, 8))
    occ = potential_occluders(scene, cfg) if cull else None
    before = dict(mod.PACKS)
    mod._pack_inputs(scene, cfg, grouped, occ)
    kept = mod._pack_inputs(scene, cfg, grouped, occ)
    assert mod.PACKS["reused"] - before["reused"] == 1
    assert mod.PACKS["same_geometry"] == before["same_geometry"]
    cuda_path.KEPT.clear()
    fresh = mod._pack_inputs.__wrapped__(scene, cfg, grouped, occ)
    _assert_bit_equal(kept, fresh)
    # The kept geometry rows and the fresh material rows make the table
    # that one stack of every row made.
    c = compile_scene(scene.triangles)
    rows = [c.n[:, 0], c.n[:, 1], c.n[:, 2], c.c0,
            c.s1[:, 0], c.s1[:, 1], c.s1[:, 2], c.c1,
            c.s2[:, 0], c.s2[:, 1], c.s2[:, 2], c.c2,
            c.diffuse[:, 0], c.diffuse[:, 1], c.diffuse[:, 2],
            c.is_emissive.to(torch.float32),
            c.emissive[:, 0], c.emissive[:, 1], c.emissive[:, 2]]
    if module == "mis":
        rows += [c.metallic, c.roughness]
    assert torch.equal(kept.tri.view(torch.int32),
                       torch.stack(rows).view(torch.int32))


def _change(scene, occ, what):
    """``scene``, its cull and the MIS config after the change ``what``."""
    cfg = MIS
    verts = scene.triangles.verts
    if what == "version":
        with torch.no_grad():
            verts[0, 0, 0] += 0.0
    elif what == "storage":
        scene = _with_verts(scene, verts.clone())
    elif what == "occluders":
        occ = tuple(list(occ))
    elif what == "samples":
        cfg = MIS.replace(mis_samples=6)
    elif what == "sampler":
        cfg = MIS.replace(sampler="stratified", mis_samples=12)
    return scene, occ, cfg


@pytest.mark.parametrize("what", ["version", "storage", "occluders",
                                  "samples", "sampler"])
def test_the_memo_makes_its_tables_again_after_a_change(what):
    scene = cornell_box(resolution=(8, 8))
    occ = potential_occluders(scene, MIS)
    first = cuda_mis._pack_inputs(scene, MIS, True, occ)
    assert cuda_mis._pack_inputs(scene, MIS, True, occ).grouped \
        is first.grouped
    scene, occ2, cfg = _change(scene, occ, what)
    assert what != "occluders" or (occ2 == occ and occ2 is not occ)
    before = dict(cuda_mis.PACKS)
    got = cuda_mis._pack_inputs(scene, cfg, True, occ2)
    made_again = {"grouped": got.grouped is not first.grouped,
                  "tabs": got.tabs is not first.tabs}
    assert made_again == {"grouped": what not in ("samples", "sampler"),
                          "tabs": what in ("samples", "sampler")}
    assert cuda_mis.PACKS["reused"] - before["reused"] == (
        what in ("samples", "sampler"))
    cuda_path.KEPT.clear()
    _assert_bit_equal(got, cuda_mis._pack_inputs.__wrapped__(
        scene, cfg, True, occ2))


def test_a_freed_source_is_never_taken_for_its_successor():
    """Vertices freed and made again with the same values (where the
    allocator may hand out the same memory) miss the memo."""
    scene = cornell_box(resolution=(8, 8))
    values = scene.triangles.verts.clone()
    first = cuda_path._pack_inputs(scene, PATH, True)
    key = cuda_path.KEPT["geometry"][0]
    scene = _with_verts(scene, None)
    assert key.storages[0]() is None
    scene = _with_verts(scene, values.clone())
    before = dict(cuda_path.PACKS)
    got = cuda_path._pack_inputs(scene, PATH, True)
    assert got.grouped is not first.grouped
    assert cuda_path.PACKS["reused"] == before["reused"]
    _assert_bit_equal(got, first)


def test_a_source_that_requires_grad_is_never_kept():
    scene = cornell_box(resolution=(8, 8))
    cuda_path._pack_inputs(scene, PATH, True)
    kept_ids = {k: id(v[1]) for k, v in cuda_path.KEPT.items()}
    scene.triangles.verts.requires_grad_(True)
    scene.camera.position.requires_grad_(True)
    for _ in range(2):
        packed = cuda_path._pack_inputs(scene, PATH, True)
        assert packed.tri.requires_grad and packed.cam.requires_grad
        assert packed.grouped.geo.requires_grad
    assert {k: id(v[1]) for k, v in cuda_path.KEPT.items()} == kept_ids
    assert not any(getattr(t, "requires_grad", False)
                   for _, tables in cuda_path.KEPT.values()
                   for t in (tables if isinstance(tables, tuple)
                             else (tables,)))
