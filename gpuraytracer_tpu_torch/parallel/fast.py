"""Sharded rendering on the fused kernel paths.

Counterpart of ``gpuraytracer_tpu/parallel/fast.py``. ``parallel/mesh.py``
shards the eager oracle; this module shards the trace kernels and their
hand-written backward kernels, so each rank renders at the kernels' speed:
pixels sharded over the ``rays`` axis, the scene replicated, the parameter
gradients summed across ranks by ``mesh.replicate``'s backward (the
``psum`` that ``shard_map``'s transpose inserts in JAX).

The kernels draw their random numbers from the GLOBAL pixel id: each shard
passes its first pixel id (``rid_base``) to them, so the sharded image is
bit-identical per pixel to the single-device one. The gradients are sums of
per-shard partials, in another order than the single-device reduction:
equal up to f32 rounding.

Each sharded function has a local half (``*_shard``) that takes the shard's
index and the number of shards and issues no collective: one process can
render every shard in turn, as the tests and ``chip_smoke.py`` do.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.cuda_mis_bwd import render_mis_fused_local
from ..ops.cuda_shade import render_path_fused_local
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from .mesh import (RAY_AXIS, RayMesh, _Reduction, all_reduce_sum, gather,
                   replicate, shard_range)


def render_path_fused_shard(scene: Scene, config: RenderConfig, index: int,
                            size: int, records_only: Optional[bool] = None,
                            occluders=None, device="cuda") -> torch.Tensor:
    """Shard ``index`` of ``size`` of the fused variant-B render: the pixels
    [index * n / size, (index + 1) * n / size) through
    ``ops.render_path_fused_local`` (the draws made for this range, the
    records_only choice made for its pixel count), flat [n / size, 3] with
    the backward kernel attached; no collective."""
    device = resolve_device(device)
    start, count = shard_range(config.num_pixels, index, size)
    offsets = pixel_rng_offsets(config, device)[start:start + count]
    return render_path_fused_local(scene, config, offsets, start,
                                   records_only=records_only,
                                   occluders=occluders, device=device)


def render_path_fused_sharded(scene: Scene, config: RenderConfig,
                              mesh: RayMesh,
                              records_only: Optional[bool] = None,
                              occluders=None) -> torch.Tensor:
    """Differentiable variant-B render, pixels sharded over ``rays``, on the
    trace kernel and the hand-written backward, on the mesh's device.
    Returns the global [H, W, 3] hdr on every rank. Every rank computes the
    loss from it (``mesh``'s docstring). ``occluders``: an
    ``intersect.potential_occluders`` tuple for the whole scene."""
    axis = mesh.axes[RAY_AXIS]
    scene = replicate(scene.to(mesh.device), mesh)
    flat = render_path_fused_shard(scene, config, axis.index, axis.size,
                                   records_only, occluders, mesh.device)
    return gather(flat, mesh).reshape(config.height, config.width, 3)


def render_mis_fused_shard(scene: Scene, config: RenderConfig, index: int,
                           size: int, occluders=None,
                           device="cuda") -> torch.Tensor:
    """Shard ``index`` of ``size`` of the fused variant-A MIS render,
    through ``ops.render_mis_fused_local``: flat [n / size, 3] raw
    accumulated hdr with the MIS backward kernel attached; no collective."""
    start, count = shard_range(config.num_pixels, index, size)
    return render_mis_fused_local(scene, config, count, start,
                                  occluders=occluders, device=device)


def render_mis_fused_sharded(scene: Scene, config: RenderConfig,
                             mesh: RayMesh, occluders=None) -> torch.Tensor:
    """Differentiable variant-A MIS render, pixels sharded over ``rays``,
    on the MIS trace kernel and its hand-written backward. Returns the
    global [H, W, 3] raw accumulated hdr on every rank, bit-identical per
    pixel to ``ops.render_mis_fused``."""
    axis = mesh.axes[RAY_AXIS]
    scene = replicate(scene.to(mesh.device), mesh)
    flat = render_mis_fused_shard(scene, config, axis.index, axis.size,
                                  occluders, mesh.device)
    return gather(flat, mesh).reshape(config.height, config.width, 3)


def make_overlapped_grad_fn(scene_template: Scene, config: RenderConfig,
                            mesh: RayMesh, n_microtiles: int = 4):
    """Forward, backward and gradient all-reduce, with the all-reduce
    overlapped with the backward.

    ``render_path_fused_sharded`` sums the gradients in one all_reduce at
    the end of the backward. Here each rank splits its pixels into
    ``n_microtiles`` tiles and runs the forward and the backward of each
    tile's squared error in turn, starting an asynchronous all_reduce of
    that tile's flattened cotangents at once, so that under NCCL it runs
    while the next tile computes. Then it waits on them, sums them in tile
    order and scales by 1 / (n_pixels * 3). At the box scene's few KB of
    gradients the collective is latency-bound and the overlap should not
    pay; the structure is for larger parameter counts.

    Returns ``grad_fn(scene, target) -> (loss, grads)``: the global image
    MSE against ``target`` [H, W, 3], and a Scene whose float tensors hold
    the loss's gradients (the other tensors are ``scene``'s). Every rank
    calls it with the same scene and target. ``scene_template`` keeps the
    JAX signature; the scene comes with each call."""
    axis = mesh.axes[RAY_AXIS]
    base, local = shard_range(config.num_pixels, axis.index, axis.size)
    if local % n_microtiles:
        raise ValueError(f"{local} shard pixels must split into "
                         f"{n_microtiles} microtiles")
    tile = local // n_microtiles
    inv_n = 1.0 / (config.num_pixels * 3)
    device = mesh.device

    def grad_fn(scene: Scene, target: torch.Tensor):
        scene = scene.to(device)
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in scene.tensors()]
        it = iter(leaves)
        scene_ = scene.map(lambda _: next(it))
        floats = [t for t in leaves if t.requires_grad]
        target_flat = target.to(device).reshape(-1, 3)
        offsets = pixel_rng_offsets(config, device)
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        pending = []
        for i in range(n_microtiles):
            start = base + i * tile
            hdr = render_path_fused_local(
                scene_, config, offsets[start:start + tile], start,
                device=device)
            sse = torch.sum((hdr - target_flat[start:start + tile]) ** 2)
            grads = torch.autograd.grad(sse, floats, allow_unused=True)
            flat = torch.cat([
                (torch.zeros_like(t) if g is None else g).reshape(-1)
                for t, g in zip(floats, grads)])
            # The overlap point: this collective is independent of tile
            # i + 1's compute.
            pending.append(flat if mesh.group is None
                           else _Reduction(flat, mesh.group, async_op=True))
            loss_acc = loss_acc + sse.detach()
        total = None
        for p in pending:
            flat = p if mesh.group is None else p.wait()
            total = flat if total is None else total + flat
        total = total * inv_n
        loss = all_reduce_sum(loss_acc, mesh.group) * inv_n
        out, at = [], 0
        for t in floats:
            out.append(total[at:at + t.numel()].view_as(t))
            at += t.numel()
        done = iter(out)
        grads_scene = scene.map(
            lambda t: next(done) if t.is_floating_point() else t)
        return loss, grads_scene

    return grad_fn
