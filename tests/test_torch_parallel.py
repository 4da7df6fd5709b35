"""PyTorch port: sharding over ``torch.distributed`` (``parallel/``), in one
process.

The sharded functions' local halves render one pixel range each and issue no
collective, so one process renders every range in turn: their images,
concatenated, equal the single-device render bit for bit (the kernels' plain
versions draw from the global pixel id), and their gradients, summed over the
ranges in rank order, equal the single-device gradients up to f32 summation
order. Tolerances: path gradients atol 1e-8 / rtol 1e-5, MIS gradients atol
1e-5 of the group's largest magnitude / rtol 1e-4, the JAX package's own
(``tests/test_fast_sharded.py``). The sharded oracle is held against the JAX
package's ``render_path_sharded`` (atol 1e-6 / rtol 1e-5,
``tests/test_parallel.py``) and ``render_path_spp_sharded`` (atol 2e-5 / rtol
1e-5, ``tests/test_spp_sharding.py``) on the conftest's virtual CPU devices.
The world-of-one degrade and the two autograd Functions at size 1 run here;
``test_torch_multihost.py`` runs the collectives across gloo processes.
"""
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.parallel.mesh as jmesh
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import cuda_mis_bwd, cuda_shade
from gpuraytracer_tpu_torch.parallel import fast, mesh, multihost
from gpuraytracer_tpu_torch.render import render
from gpuraytracer_tpu_torch.scene import (cornell_box,
                                          cornell_box_tessellated,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

PATH = RenderConfig(width=32, height=16, spp=2, bounces=2, pixel_chunk=512)
MIS = RenderConfig(width=32, height=16, integrator="mis", camera_rays=2,
                   mis_samples=6, pixel_chunk=512)
PATH_GRAD_TOL = dict(atol=1e-8, rtol=1e-5)
SCENES = {"box": cornell_box, "spheres": cornell_box_with_spheres}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def tessellated(resolution):
    """82 triangles: the grouped tier of every kernel."""
    scene = cornell_box_tessellated(resolution=resolution, wall_subdiv=2,
                                    sphere_subdiv=0)
    assert scene.triangles.num_triangles > 64
    return scene


def single_and_shards(scene, cfg, size, single_fn, shard_fn):
    """(image, grads) of the single-device render and of ``size`` shards:
    the shards' images concatenated, their gradients of the frame's mean
    summed in rank order."""
    whole = with_grad(scene)
    hdr = single_fn(whole, cfg, device="cpu")
    hdr.mean().backward()
    parts = with_grad(scene)
    flats = []
    for k in range(size):
        flat = shard_fn(parts, cfg, k, size, device="cpu")
        (flat.sum() / (cfg.num_pixels * 3)).backward()
        flats.append(flat.detach())
    image = torch.cat(flats).reshape(cfg.height, cfg.width, 3)
    return (hdr.detach(), convert.grads_to_numpy(whole),
            image, convert.grads_to_numpy(parts))


def assert_grads(got, ref, mis=False):
    checked = 0
    for part, fields in ref.items():
        for name, r in fields.items():
            g = got[part][name]
            assert (g is None) == (r is None), (part, name)
            if r is None or r.size == 0:
                continue
            if mis:
                scale = max(np.abs(r).max(), 1e-6)
                tol = dict(atol=1e-5 * scale, rtol=1e-4)
            else:
                tol = PATH_GRAD_TOL
            np.testing.assert_allclose(g, r, err_msg=f"{part}.{name}", **tol)
            checked += 1
    assert checked >= 9


# ---------------------------------------------------------------------------
# The local halves against the single-device render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("scene_name", ["box", "spheres"])
def test_path_shards_equal_the_frame(scene_name, size):
    scene = SCENES[scene_name](resolution=PATH.resolution)
    hdr, ref, image, got = single_and_shards(
        scene, PATH, size, cuda_shade.render_path_decoupled_fused,
        fast.render_path_fused_shard)
    assert torch.equal(image, hdr)
    assert_grads(got, ref)


@pytest.mark.parametrize("size", [2, 4])
def test_mis_shards_equal_the_frame(size):
    scene = cornell_box(resolution=MIS.resolution)
    hdr, ref, image, got = single_and_shards(
        scene, MIS, size, cuda_mis_bwd.render_mis_fused,
        fast.render_mis_fused_shard)
    assert torch.equal(image, hdr)
    assert_grads(got, ref, mis=True)


@pytest.mark.parametrize("integrator", ["path", "mis"])
def test_grouped_tier_in_two_shards(integrator):
    cfg = PATH if integrator == "path" else MIS
    single, shard = ((cuda_shade.render_path_decoupled_fused,
                      fast.render_path_fused_shard) if integrator == "path"
                     else (cuda_mis_bwd.render_mis_fused,
                           fast.render_mis_fused_shard))
    hdr, ref, image, got = single_and_shards(
        tessellated(cfg.resolution), cfg, 2, single, shard)
    assert torch.equal(image, hdr)
    assert_grads(got, ref, mis=integrator == "mis")


def test_oracle_shards_equal_the_frame():
    scene = cornell_box_with_spheres(resolution=PATH.resolution)
    hdr = render(scene, PATH, device="cpu").hdr
    image = torch.cat([mesh.render_path_shard(scene, PATH, k, 4, "cpu")
                       for k in range(4)])
    assert torch.equal(image.reshape(hdr.shape), hdr)


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------

def test_indivisible_pixels_and_samples_raise():
    scene = cornell_box(resolution=(33, 9))
    cfg = PATH.replace(width=33, height=9)  # 297 pixels
    with pytest.raises(ValueError):
        fast.render_path_fused_shard(scene, cfg, 0, 2, device="cpu")
    with pytest.raises(ValueError):
        fast.render_mis_fused_shard(scene, MIS.replace(width=33, height=9),
                                    0, 2, device="cpu")
    with pytest.raises(ValueError):
        mesh.render_path_shard(scene, cfg, 0, 8, "cpu")
    with pytest.raises(ValueError):
        mesh.render_path_spp_shard(scene, PATH.replace(spp=8), 0, 1, 0, 3,
                                   "cpu")
    with pytest.raises(ValueError):  # two ranks asked of a world of one
        mesh.make_ray_spp_mesh(1, 2, device="cpu")
    one = mesh.make_ray_mesh("cpu")
    with pytest.raises(ValueError):  # 512 pixels in 3 tiles
        fast.make_overlapped_grad_fn(scene, PATH, one, n_microtiles=3)


def test_no_card_and_shared_cards_raise(monkeypatch):
    """``device="cuda"`` without a card raises before joining any group;
    two ranks on one card under NCCL raise a ValueError that says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.init_distributed("localhost:1", 1, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="card of its own"):
        multihost.init_distributed("localhost:1", 2, 0)
    with pytest.raises(ValueError, match="nccl"):
        multihost.init_distributed("localhost:1", 1, 0, backend="nccl",
                                   device="cpu")


def test_world_of_one_degrade(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False
    assert multihost.is_primary()
    multihost.sync_hosts()  # no-op in one process
    one = mesh.make_ray_mesh("cpu")
    assert one.shape == {"rays": 1} and one.group is None
    assert one.device == torch.device("cpu")
    scene = cornell_box(resolution=PATH.resolution)
    out = mesh.make_sharded_renderer(PATH, one)(scene)
    assert torch.equal(out, render(scene, PATH, device="cpu").hdr)
    img = multihost.gather_image(out)
    assert isinstance(img, np.ndarray) and img.shape == (16, 32, 3)
    assert np.all(np.isfinite(img))


def test_autograd_functions_at_size_one():
    """``gather`` and ``replicate`` over a mesh of one: the identity, and
    the gradients pass through unchanged; ``psum_mean`` likewise."""
    one = mesh.make_ray_mesh("cpu")
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = mesh.gather(x, one)
    assert torch.equal(y, x)
    y2 = mesh.psum_mean(x, one)
    assert torch.equal(y2, x)
    w = torch.arange(18.0).reshape(6, 3)
    ((y + y2) * w).sum().backward()
    assert torch.equal(x.grad, 2 * w)

    scene = with_grad(cornell_box(resolution=PATH.resolution))
    rep = mesh.replicate(scene, one)
    floats = [t for t in scene.tensors() if t.is_floating_point()]
    assert all(torch.equal(a, b) for a, b in zip(rep.tensors(),
                                                 scene.tensors()))
    assert all(a is b for a, b in zip(rep.tensors(), scene.tensors())
               if not b.requires_grad)
    out = cuda_shade.render_path_decoupled_fused(rep, PATH, device="cpu")
    out.mean().backward()
    ref_scene = with_grad(cornell_box(resolution=PATH.resolution))
    cuda_shade.render_path_decoupled_fused(ref_scene, PATH,
                                           device="cpu").mean().backward()
    # An output the image does not use gets a zero cotangent (every rank
    # sends the same shape), where autograd leaves None.
    for a, b in zip(floats, (t for t in ref_scene.tensors()
                             if t.is_floating_point())):
        ref = torch.zeros_like(b) if b.grad is None else b.grad
        assert torch.equal(a.grad, ref)


def test_sharded_entries_at_world_one():
    """The mesh-level entries at one rank: the fused path and MIS images
    equal the single-device ones, the overlapped gradient the plain one."""
    one = mesh.make_ray_mesh("cpu")
    scene = cornell_box(resolution=PATH.resolution)
    assert torch.equal(
        fast.render_path_fused_sharded(scene, PATH, one),
        cuda_shade.render_path_decoupled_fused(scene, PATH, device="cpu"))
    assert torch.equal(
        fast.render_mis_fused_sharded(scene, MIS, one),
        cuda_mis_bwd.render_mis_fused(scene, MIS, device="cpu"))
    target = torch.full((16, 32, 3), 0.25)
    loss, grads = fast.make_overlapped_grad_fn(scene, PATH, one, 2)(scene,
                                                                    target)
    leaves = with_grad(scene)
    plain = torch.mean((fast.render_path_fused_sharded(leaves, PATH, one)
                        - target) ** 2)
    plain.backward()
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-6)
    for g, t in zip(grads.tensors(), leaves.tensors()):
        if t.is_floating_point():
            ref = torch.zeros_like(t) if t.grad is None else t.grad
            np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-6,
                                       rtol=1e-4)


# ---------------------------------------------------------------------------
# The sharded oracle against the JAX package
# ---------------------------------------------------------------------------

def _jax_path_cfg(cfg):
    return jtypes.RenderConfig(width=cfg.width, height=cfg.height,
                               integrator="path", spp=cfg.spp,
                               bounces=cfg.bounces,
                               pixel_chunk=cfg.pixel_chunk)


def test_oracle_shards_match_jax_render_path_sharded():
    size = 8
    ref = np.asarray(jmesh.render_path_sharded(
        jscene.cornell_box(resolution=PATH.resolution), _jax_path_cfg(PATH),
        jmesh.make_ray_mesh()))
    scene = cornell_box(resolution=PATH.resolution)
    got = torch.cat([mesh.render_path_shard(scene, PATH, k, size, "cpu")
                     for k in range(size)]).reshape(ref.shape).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


def test_spp_shards_match_jax_render_path_spp_sharded():
    """A 2 x 4 (rays x spp) mesh: each pixel shard is the mean of its four
    sample shards, as ``psum_mean`` over ``spp`` makes it."""
    cfg = RenderConfig(width=16, height=16, spp=8, bounces=2, pixel_chunk=256)
    ref = np.asarray(jmesh.render_path_spp_sharded(
        jscene.cornell_box(resolution=cfg.resolution), _jax_path_cfg(cfg),
        jmesh.make_ray_spp_mesh(2, 4)))
    scene = cornell_box(resolution=cfg.resolution)
    rows = []
    for r in range(2):
        total = sum(mesh.render_path_spp_shard(scene, cfg, r, 2, s, 4, "cpu")
                    for s in range(4))
        rows.append(total / torch.tensor(4.0))
    got = torch.cat(rows).reshape(ref.shape).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    full = render(scene, cfg, device="cpu").hdr.numpy()
    np.testing.assert_allclose(got, full, atol=2e-5, rtol=1e-5)
