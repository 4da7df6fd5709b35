"""Command-line renderer: a scene to PNG, with wall-clock timing.

Counterpart of ``gpuraytracer_tpu/cli.py``: the same flags and prints
(positional output filename, "Render completed in %.2f seconds"), plus
``--device``. ``--kernel eager`` is the plain PyTorch oracle, ``cuda`` the
trace kernel in hdr mode, ``decoupled`` the record-emitting trace with the
static occluder cull (for the path tracer with the draws kernel before it).
``--integrator mis`` renders variant A through the same three routes and
writes the PNG from its own tone curve (``render.tonemap_mis``).
"""
from __future__ import annotations

import argparse
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
    p.add_argument("--scene", choices=["cornell", "cornell-spheres"],
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to render; 'cuda' fails when no card is "
                        "present, 'cpu' runs the plain PyTorch versions")
    p.add_argument("--devices", type=int, default=1,
                   help="number of cards; only 1 is supported so far")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.integrator == "legacy":
        raise SystemExit(
            "--integrator legacy is not ported yet (a later slice of the "
            "port: the legacy tier)")
    if args.devices != 1:
        raise SystemExit(
            "--devices N>1 is not ported yet (a later slice of the port: "
            "sharded rendering over torch.distributed)")

    import torch

    from . import image as img
    from .render import render, tonemap_mis
    from .scene import cornell_box, cornell_box_with_spheres
    from .types import RenderConfig
    from .utils.host import fetch, resolve_device

    device = resolve_device(args.device)
    config = RenderConfig(
        width=args.width, height=args.height, integrator=args.integrator,
        spp=args.spp, bounces=args.bounces, camera_rays=args.camera_rays,
        mis_samples=args.mis_samples, seed=args.seed,
    )
    if args.scene == "cornell":
        scene = cornell_box(resolution=(args.width, args.height))
    else:
        scene = cornell_box_with_spheres(resolution=(args.width, args.height))
    cfg = (config.replace(bounces=1) if args.integrator == "direct"
           else config)

    start = time.perf_counter()
    if args.integrator == "mis":
        if args.kernel == "cuda":
            from .ops import render_mis_cuda
            hdr = render_mis_cuda(scene, config, device=device)
        elif args.kernel == "decoupled":
            from .intersect import potential_occluders
            from .ops import render_mis_decoupled
            hdr = render_mis_decoupled(
                scene, config, occluders=potential_occluders(scene, config),
                device=device)
        else:
            hdr = render(scene, config, device=device).hdr
    elif args.kernel == "cuda":
        from .ops import render_path_cuda
        hdr = render_path_cuda(scene, cfg, device=device)
    elif args.kernel == "decoupled":
        # Static shadow-probe culling and hoisted draws: the scene is
        # concrete here, and both are invariant across frames.
        from .intersect import potential_occluders
        from .ops import pregen_draws, render_path_decoupled
        from .ops.decoupled import _auto_records_only
        occ = potential_occluders(scene, cfg)
        draws = (None if _auto_records_only(cfg)
                 else pregen_draws(cfg, device=device))
        hdr = render_path_decoupled(scene, cfg, draws=draws, occluders=occ,
                                    device=device)
    else:
        hdr = render(scene, config, device=device).hdr
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - start

    hdr_np = fetch(hdr)
    if args.integrator == "mis":
        # Variant A tonemaps with the camera's exposure (mean over camera
        # rays, ev100, Reinhard, gamma 2.2).
        ldr = tonemap_mis(hdr, config.camera_rays, scene.camera.ev100)
        img.write_png(args.output, img.to_uint8(fetch(ldr)))
    else:
        img.write_png(args.output,
                      img.tonemap(hdr_np, exposure=args.exposure))
    if args.debug_output:
        img.write_debug_file(args.debug_output, hdr_np)

    # Timing print (Sources/gpuRaytracer/main.swift:87-91).
    print(f"Render completed in {elapsed:.2f} seconds")
    print(f"Image saved to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
