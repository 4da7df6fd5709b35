"""The rank mesh, the two autograd Functions of sharding, and the sharded
eager oracle.

Counterpart of ``gpuraytracer_tpu/parallel/mesh.py``. There a ``shard_map``
over a device mesh takes the scene replicated and the pixels sharded, and
returns the image as one global array; its transpose sums the parameter
cotangents across the mesh (a ``psum``). Here every rank is one process with
one device, and two ``torch.autograd.Function``s carry the same semantics:

  * ``gather``: forward, an ``all_gather`` of the ranks' flat [n_local, 3]
    shards into the global image on every rank; backward, this rank's slice
    of the cotangent, with no collective.
  * ``replicate``: forward, the identity on the scene's float tensors that
    ask for gradients; backward, ONE ``all_reduce`` (SUM) of their
    cotangents, concatenated in the scene's field order.

So the loss must be computed on EVERY rank, from the same gathered image:
that is what makes this rank's slice of the cotangent the whole of what the
loss asks of its pixels, and what makes every rank enter the one
``all_reduce`` of ``replicate``'s backward. A loss computed on rank 0 alone
gives wrong gradients and leaves the other ranks waiting in that collective
until the group's timeout. One collective per backward, in a fixed order,
cannot deadlock on a rank whose autograd visits the leaves in another order;
undefined cotangents count as zeros, so every rank sends the same shape.

The pixel axis shards over ``rays``; the sample axis over ``spp``
(``render_path_spp_sharded``). An axis of size 1 has no group and issues no
collective. Randomness is a pure function of (global pixel, sample, bounce,
dimension), so the pixel-sharded image is bit-identical to the single-device
one.

Where the group's backend is gloo and the tensors lie on a card (ranks that
share one card), the collectives copy to the host and back, explicitly:
gloo's CUDA collectives are not relied on. The kernels still run on the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..intersect import compile_scene
from ..render import _path_trace_chunk, pixel_coords, pixel_rng_offsets
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device

RAY_AXIS = "rays"
SPP_AXIS = "spp"


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """This rank's place on one axis: its index, the axis' size, and the
    process group of the ranks along it (None at size 1)."""

    index: int
    size: int
    group: Optional[dist.ProcessGroup]


@dataclasses.dataclass(frozen=True, eq=False)
class RayMesh:
    """The ranks as a mesh of named axes, as seen from one rank: ``axes`` by
    name, ``group`` every rank of the mesh (None at one rank), and this
    rank's ``device``."""

    axes: Dict[str, MeshAxis]
    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {name: axis.size for name, axis in self.axes.items()}


def _rank_device(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_ray_mesh(device="cuda") -> RayMesh:
    """1-D mesh over every rank of the process group (one rank without a
    group); axis name ``rays``. ``device``: this rank's card (the current
    device, which ``init_distributed`` set) unless the CPU is asked for."""
    world, rank = _world()
    group = dist.group.WORLD if world > 1 else None
    return RayMesh({RAY_AXIS: MeshAxis(rank, world, group)}, group,
                   _rank_device(device))


def make_ray_spp_mesh(n_rays: int, n_spp: int, device="cuda") -> RayMesh:
    """2-D mesh: pixels shard over ``rays``, samples over ``spp``. The
    ``spp`` groups are innermost (consecutive ranks), so their reduction
    stays within a host where ranks fill hosts in order. Needs exactly
    ``n_rays * n_spp`` ranks."""
    world, rank = _world()
    if world != n_rays * n_spp:
        raise ValueError(f"need {n_rays * n_spp} ranks, got {world}")
    ray_i, spp_i = divmod(rank, n_spp)
    # Every rank creates every group, in the same order (dist.new_group).
    spp_groups = [dist.new_group([r * n_spp + j for j in range(n_spp)])
                  for r in range(n_rays)] if n_spp > 1 else None
    ray_groups = [dist.new_group([r * n_spp + j for r in range(n_rays)])
                  for j in range(n_spp)] if n_rays > 1 else None
    axes = {RAY_AXIS: MeshAxis(ray_i, n_rays,
                               ray_groups[spp_i] if ray_groups else None),
            SPP_AXIS: MeshAxis(spp_i, n_spp,
                               spp_groups[ray_i] if spp_groups else None)}
    return RayMesh(axes, dist.group.WORLD if world > 1 else None,
                   _rank_device(device))


def shard_range(n: int, index: int, size: int, what: str = "pixels"):
    """(start, count) of shard ``index`` of ``size`` equal shards of ``n``
    items; raises ValueError where ``n`` does not divide."""
    if n % size:
        raise ValueError(f"{n} {what} not divisible by {size} shards")
    count = n // size
    return index * count, count


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class _Reduction:
    """An all_reduce (SUM) of ``t`` over ``group``, started at construction,
    synchronous or not; ``wait()`` returns the sum on ``t``'s device. Under
    gloo a CUDA tensor is reduced in a host copy (see the module's
    docstring)."""

    def __init__(self, t: torch.Tensor, group, async_op: bool = False):
        self.device = t.device
        staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
        self.buf = t.detach().cpu() if staged else t.detach().clone()
        self.work = dist.all_reduce(self.buf, op=dist.ReduceOp.SUM,
                                    group=group, async_op=async_op)

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.buf.to(self.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """SUM of ``t`` over ``group`` (``t`` itself where the group is None)."""
    return t if group is None else _Reduction(t, group).wait()


def _all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``local`` tensors of ``group`` concatenated along dim 0, in
    rank order, on every rank."""
    src = local.detach().contiguous()
    staged = src.device.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(local.device)


class _Gather(torch.autograd.Function):
    """Forward: the shards of ``axis`` gathered in rank order. Backward:
    this rank's slice of the cotangent; the loss is computed on every rank
    from the same gathered image (module docstring)."""

    @staticmethod
    def forward(ctx, local, axis: MeshAxis):
        ctx.index, ctx.n = axis.index, local.shape[0]
        if axis.group is None:
            return local.view_as(local)
        return _all_gather_rows(local, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


class _Replicate(torch.autograd.Function):
    """Forward: the identity. Backward: one all_reduce (SUM) of every
    output's cotangent, concatenated in argument order (undefined ones
    arrive as zeros)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.group is None:
            return (None,) + grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = all_reduce_sum(flat, ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None,) + tuple(out)


class _MeanAcross(torch.autograd.Function):
    """Forward: the mean of ``x`` over ``axis`` (a SUM, then a divide),
    the same on every rank. Backward: the cotangent over the axis' size,
    with no collective (every rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        ctx.size = axis.size
        total = all_reduce_sum(x, axis.group)
        return total / torch.tensor(float(axis.size), device=total.device)

    @staticmethod
    def backward(ctx, g):
        return g / torch.tensor(float(ctx.size), device=g.device), None


def gather(local: torch.Tensor, mesh: RayMesh,
           axis: str = RAY_AXIS) -> torch.Tensor:
    """The global [n, 3] image from this rank's flat [n_local, 3] shard (see
    the module docstring for what its backward assumes)."""
    return _Gather.apply(local, mesh.axes[axis])


def replicate(scene: Scene, mesh: RayMesh) -> Scene:
    """``scene`` with every float tensor that asks for gradients passed
    through one ``_Replicate`` over the whole mesh: its gradients come back
    summed over every rank."""
    leaves = [t for t in scene.tensors() if t.requires_grad]
    if not leaves:
        return scene
    outs = _Replicate.apply(mesh.group, *leaves)
    outs = iter((outs,) if isinstance(outs, torch.Tensor) else outs)
    return scene.map(lambda t: next(outs) if t.requires_grad else t)


def psum_mean(x: torch.Tensor, mesh: RayMesh,
              axis: str = RAY_AXIS) -> torch.Tensor:
    """Mean of ``x`` across the mesh axis, the same on every rank: a SUM and
    a divide (not ``ReduceOp.AVG``, so that gloo and NCCL round alike)."""
    return _MeanAcross.apply(x, mesh.axes[axis])


# ---------------------------------------------------------------------------
# The sharded eager oracle
# ---------------------------------------------------------------------------

def _oracle_range(scene: Scene, config: RenderConfig, start: int, count: int,
                  offset_shift: int, device) -> torch.Tensor:
    """``render._path_trace_chunk`` over pixels [start, start + count), in
    chunks of ``config.pixel_chunk``, the Halton offsets shifted by
    ``offset_shift``; flat [count, 3]."""
    scene = scene.to(device)
    compiled = compile_scene(scene.triangles)
    px, py = pixel_coords(config, device)
    offsets = pixel_rng_offsets(config, device) + offset_shift
    end = start + count
    parts = [
        _path_trace_chunk(compiled, scene, config, px[s:e], py[s:e],
                          offsets[s:e])
        for s in range(start, end, config.pixel_chunk)
        for e in [min(s + config.pixel_chunk, end)]]
    return torch.cat(parts, dim=0)


def render_path_shard(scene: Scene, config: RenderConfig, index: int,
                      size: int, device="cuda") -> torch.Tensor:
    """The local half of ``render_path_sharded``: shard ``index`` of
    ``size`` of the pixels through the eager oracle, flat [n / size, 3]; no
    collective."""
    start, count = shard_range(config.num_pixels, index, size)
    return _oracle_range(scene, config, start, count, 0,
                         resolve_device(device))


def render_path_sharded(scene: Scene, config: RenderConfig,
                        mesh: RayMesh) -> torch.Tensor:
    """Variant-B path render through the eager oracle, pixels sharded over
    ``rays``, scene replicated, on the mesh's device. Returns the global [H,
    W, 3] hdr on every rank; differentiable, the gradients summed across
    ranks."""
    axis = mesh.axes[RAY_AXIS]
    scene = replicate(scene.to(mesh.device), mesh)
    local = render_path_shard(scene, config, axis.index, axis.size,
                              mesh.device)
    return gather(local, mesh).reshape(config.height, config.width, 3)


def make_sharded_renderer(config: RenderConfig, mesh: RayMesh):
    """``scene -> [H, W, 3]`` over ``render_path_sharded`` (the JAX package
    jits it here; eager PyTorch has nothing to compile)."""
    def fn(scene: Scene) -> torch.Tensor:
        return render_path_sharded(scene, config, mesh)
    return fn


def render_path_spp_shard(scene: Scene, config: RenderConfig,
                          ray_index: int, n_rays: int, spp_index: int,
                          n_spp: int, device="cuda") -> torch.Tensor:
    """The local half of ``render_path_spp_sharded``: pixel shard
    ``ray_index`` of ``n_rays`` at samples [spp_index * spp_local, (spp_index
    + 1) * spp_local) of the global sample set (the Halton offsets shifted by
    ``spp_index * spp_local``), flat [n / n_rays, 3], the mean over those
    samples; no collective."""
    _, spp_local = shard_range(config.spp, spp_index, n_spp, "samples")
    start, count = shard_range(config.num_pixels, ray_index, n_rays)
    return _oracle_range(scene, config.replace(spp=spp_local), start, count,
                         spp_index * spp_local, resolve_device(device))


def render_path_spp_sharded(scene: Scene, config: RenderConfig,
                            mesh: RayMesh) -> torch.Tensor:
    """Variant-B render with the sample axis sharded over ``spp`` (and the
    pixels over ``rays``): each rank renders its pixels at spp / n_spp
    samples of the global sample set, the means reduce across ``spp``
    (``psum_mean``), the image gathers across ``rays``. Equal to the
    single-device render up to the order of the f32 sums (allclose, not
    bit-equal: the pixel-sharded path is the bit-stable one)."""
    ray, spp = mesh.axes[RAY_AXIS], mesh.axes[SPP_AXIS]
    scene = replicate(scene.to(mesh.device), mesh)
    lum = render_path_spp_shard(scene, config, ray.index, ray.size,
                                spp.index, spp.size, mesh.device)
    lum = psum_mean(lum, mesh, SPP_AXIS)
    return gather(lum, mesh).reshape(config.height, config.width, 3)
