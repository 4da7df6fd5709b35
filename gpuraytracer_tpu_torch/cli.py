"""Command-line renderer: a scene to PNG, with wall-clock timing.

Counterpart of ``gpuraytracer_tpu/cli.py``: the same flags and prints
(positional output filename, "Render completed in %.2f seconds"), plus
``--device``. ``--kernel eager`` is the plain PyTorch oracle, ``cuda`` the
trace kernel in hdr mode, ``decoupled`` the record-emitting trace with the
static occluder cull (for the path tracer with the draws kernel before it).
``--integrator mis`` renders variant A through the same three routes and
writes the PNG from its own tone curve (``render.tonemap_mis``);
``--integrator legacy`` renders the legacy tier (``render_legacy.py``),
through ``--kernel eager`` only, on the ``legacy-*`` scenes or any other.
``--debug-nans`` stops at the first operation that makes a NaN
(``utils.debug``). ``--devices N`` shards the frame's pixels over N ranks
(``parallel/fast.py``, ``--kernel decoupled`` only): under a launcher
(``torchrun``, whose environment names the coordinator) each process is one
rank; otherwise the command spawns N local ranks itself, over NCCL with a
card each, or over gloo with ``--device cpu``. Rank 0 writes the PNG.
"""
from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpuraytracer-tpu-torch",
        description="PyTorch/CUDA port of the differentiable path tracer",
    )
    p.add_argument("output", nargs="?", default="output.png",
                   help="output PNG filename (positional, like the reference)")
    p.add_argument("--integrator",
                   choices=["path", "mis", "direct", "legacy"],
                   default="path")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=400)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--camera-rays", type=int, default=6)
    p.add_argument("--mis-samples", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene",
                   choices=["cornell", "cornell-spheres", "legacy-sphere",
                            "legacy-box", "legacy-square"],
                   default="cornell")
    p.add_argument("--exposure", type=float, default=2.0,
                   help="variant-B CPU tonemap exposure (image.swift:41)")
    p.add_argument("--debug-output", default=None,
                   help="write row-averaged HDR stats (debugOutput.txt analog)")
    p.add_argument("--kernel", choices=["eager", "cuda", "decoupled"],
                   default="eager",
                   help="the plain PyTorch oracle, the CUDA trace kernel, or "
                        "the record-emitting trace (draws kernel + trace "
                        "kernel + occluder cull)")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop with a traceback at the first operation that "
                        "makes a NaN (utils.debug; waits on the device at "
                        "every operation: slow)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to render; 'cuda' fails when no card is "
                        "present, 'cpu' runs the plain PyTorch versions")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the render over N ranks, one device each "
                        "(pixels sharded, scene replicated, fused kernels; "
                        "requires --kernel decoupled and path, direct or "
                        "mis). Default 1 = single device.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.devices > 1 and not (
            args.kernel == "decoupled"
            and args.integrator in ("path", "direct", "mis")):
        raise SystemExit("--devices N>1 requires --kernel decoupled "
                         "(path/direct/mis: the fused sharded paths)")
    if args.devices > 1 and args.device == "cuda":
        import torch
        count = torch.cuda.device_count()
        if args.devices > count:
            raise SystemExit(f"--devices {args.devices} > available {count} "
                             "CUDA cards")
    if args.devices > 1 and "WORLD_SIZE" not in os.environ:
        import torch.multiprocessing as mp

        from .parallel.multihost import free_port
        coordinator = f"localhost:{free_port()}"
        mp.spawn(_spawned_rank, args=(args, coordinator), nprocs=args.devices,
                 join=True)
        return 0
    return _render(args)


def _spawned_rank(rank: int, args, coordinator: str) -> None:
    """One of the ranks ``main`` spawns; exits through ``_render``'s return."""
    from .parallel.multihost import init_distributed
    init_distributed(coordinator, args.devices, rank, device=args.device)
    _render(args)


def _render(args) -> int:
    import torch

    from . import image as img
    from .renderer import route, write_frame
    from .scene import cornell_box, cornell_box_with_spheres, legacy_cornell
    from .types import RenderConfig
    from .utils.host import resolve_device

    if args.debug_nans:
        from .utils import debug
        debug.enable(nans=True)
    config = RenderConfig(
        width=args.width, height=args.height, integrator=args.integrator,
        spp=args.spp, bounces=args.bounces, camera_rays=args.camera_rays,
        mis_samples=args.mis_samples, seed=args.seed,
    )
    resolution = (args.width, args.height)
    if args.scene == "cornell":
        scene = cornell_box(resolution=resolution)
    elif args.scene == "cornell-spheres":
        scene = cornell_box_with_spheres(resolution=resolution)
    else:
        scene = legacy_cornell(args.scene.split("-", 1)[1],
                               resolution=resolution)

    if args.devices > 1:
        hdr, elapsed = _sharded_frame(scene, config, args)
        if hdr is None:  # not rank 0
            return 0
    else:
        # The timed window holds the route's one-time work (the decoupled
        # route's cull and draws) and the frame.
        start = time.perf_counter()
        try:
            frame = route(scene, config, args.kernel, args.device).frame
        except ValueError as e:  # the legacy tier through a kernel route
            raise SystemExit(str(e)) from None
        device = resolve_device(args.device)
        hdr = frame()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start

    hdr_np = write_frame(args.output, hdr, config, scene, args.exposure)
    if args.debug_output:
        img.write_debug_file(args.debug_output, hdr_np)

    # Timing print (Sources/gpuRaytracer/main.swift:87-91).
    print(f"Render completed in {elapsed:.2f} seconds")
    print(f"Image saved to {args.output}")
    return 0


def _sharded_frame(scene, config, args):
    """The frame sharded over the ranks of the process group, which must
    number ``--devices``: (hdr, seconds) on rank 0, (None, seconds) on the
    others. Rank 0 times from a barrier to the end of the gather; the window
    holds the occluder cull, as the single-device decoupled route's does."""
    import torch
    import torch.distributed as dist

    from .intersect import potential_occluders
    from .parallel.fast import (render_mis_fused_sharded,
                                render_path_fused_sharded)
    from .parallel.mesh import make_ray_mesh
    from .parallel.multihost import init_distributed, is_primary, sync_hosts

    if not dist.is_initialized():  # under a launcher: join its group
        init_distributed(device=args.device)
    if dist.get_world_size() != args.devices:
        raise SystemExit(f"--devices {args.devices} but the process group "
                         f"has {dist.get_world_size()} ranks")
    mesh = make_ray_mesh(args.device)
    cfg = (config.replace(bounces=1) if config.integrator == "direct"
           else config)
    sync_hosts("render")
    start = time.perf_counter()
    occluders = potential_occluders(scene, cfg)
    if cfg.integrator == "mis":
        hdr = render_mis_fused_sharded(scene, cfg, mesh, occluders=occluders)
    else:
        hdr = render_path_fused_sharded(scene, cfg, mesh,
                                        occluders=occluders)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    elapsed = time.perf_counter() - start
    primary = is_primary()
    sync_hosts("rendered")
    dist.destroy_process_group()
    return (hdr if primary else None), elapsed


if __name__ == "__main__":
    raise SystemExit(main())
