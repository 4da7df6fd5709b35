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
(``utils.debug``).
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
                   help="number of cards; only 1 is supported so far")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.devices != 1:
        raise SystemExit(
            "--devices N>1 is not ported yet (a later slice of the port: "
            "sharded rendering over torch.distributed)")

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


if __name__ == "__main__":
    raise SystemExit(main())
