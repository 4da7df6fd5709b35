"""Where K3's float32 cotangents lose their accuracy on a scene with small
spheres in view: the plain version's replay (``cuda_shade.replay_packed``,
the function K3 differentiates) against its float64 evaluation on the same
records and draws, lane by lane.

    python tools/sphere_conditioning.py [--width 128 --height 96 --spp 4]

The scene is ``chip_smoke.spheres_at_static_limit(in_view=True)`` (the box
scene with 155 seeded spheres of radii 0.1-0.3 inside the box), traced on
the CPU with the cull; the cotangent is a seeded Gaussian, as
``chip_smoke.ShadeInputs`` makes it. Printed:

  * rho = disc / b^2 of the sphere quadratic on every camera ray that meets
    an added sphere (float64): b^2 - 4ac cancels log2(1 / rho) bits;
  * per bin of rho, the lanes' share of each group's cotangent: the camera
    (one leaf per lane) and the centre and radius of the sphere each lane
    hits (the gathered attributes, one leaf per lane and bounce): the sum of
    |lane|, the sum of |float32 - float64|, their ratio, and the largest
    lane's |float32 - float64| over the whole frame's largest magnitude;
  * the whole frame's distance from float64, over each group's largest
    magnitude, with the quadratic in float32 (as the kernels and the JAX
    package compute it), in float64 from the same float32 inputs, and in the
    geometric form (the centre's distance from the ray, r^2 - |oc - (oc.d)
    d|^2) in float32.

It runs on the CPU in a few seconds and needs neither a card nor JAX.
"""
from __future__ import annotations

import argparse
import inspect
import sys
import textwrap
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from gpuraytracer_tpu_torch.ops import cuda_path, cuda_shade, decoupled  # noqa: E402
from gpuraytracer_tpu_torch.types import RenderConfig  # noqa: E402

RHO_BINS = (0.0, 1e-5, 1e-4, 1e-3, 1e-2)
CAMERA = {"camera position": slice(0, 3), "camera u": slice(3, 6),
          "camera v": slice(6, 9), "camera w": slice(9, 12)}
SPHERE = {"d center": slice(11, 14), "d radius": slice(14, 15)}

# The replay with two hooks: the gathered attributes of each bounce pass
# through ``GATHERED`` (which may make them leaves), and the sphere
# quadratic is replaced by ``QUADRATIC`` (None keeps the replay's own).
_QUAD_START = "            ocx, ocy, ocz = ox - scx, oy - scy, oz - scz\n"
_QUAD_END = "            t1_ok = (t1 > 1e-3) & (t1 < 1e3)\n"


def _hooked_replay():
    src = textwrap.dedent(inspect.getsource(cuda_shade.replay_packed))
    gather = "        at = table[:, pc]  # [rows, C, n]: an indexed load per attribute\n"
    start, end = src.index(_QUAD_START), src.index(_QUAD_END)
    assert gather in src
    src = (src[:start]
           + "            t1, t2 = QUADRATIC(ox, oy, oz, dx, dy, dz, scx, scy, "
             "scz, srad)\n" + src[end:])
    src = src.replace(gather, gather + "        at = GATHERED(at)\n")
    scope = dict(vars(cuda_shade))
    exec(compile(src, cuda_shade.__file__, "exec"), scope)
    return scope


def quadratic_f32(ox, oy, oz, dx, dy, dz, scx, scy, scz, srad):
    """The replay's own: ``intersect.sphere_candidates`` in the dtype of
    its inputs."""
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    a_q = dx * dx + dy * dy + dz * dz
    b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - srad * srad
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = torch.sqrt(torch.where(disc > 0.0, disc, torch.ones_like(disc)))
    return (-b_q - sq) / (2.0 * a_q), (-b_q + sq) / (2.0 * a_q)


def quadratic_f64(*args):
    """The same arithmetic in float64 from the float32 inputs."""
    t1, t2 = quadratic_f32(*(x.double() for x in args))
    return t1.to(args[0].dtype), t2.to(args[0].dtype)


def quadratic_geometric(ox, oy, oz, dx, dy, dz, scx, scy, scz, srad):
    """disc = 4 a (r^2 - |oc - (oc.d / a) d|^2): the centre's squared
    distance from the ray, without b^2 - 4ac's cancellation."""
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    a_q = dx * dx + dy * dy + dz * dz
    proj = ocx * dx + ocy * dy + ocz * dz
    b_q = 2.0 * proj
    tca = proj / a_q
    px, py, pz = ocx - tca * dx, ocy - tca * dy, ocz - tca * dz
    disc = 4.0 * a_q * (srad * srad - (px * px + py * py + pz * pz))
    sq = torch.sqrt(torch.where(disc > 0.0, disc, torch.ones_like(disc)))
    return (-b_q - sq) / (2.0 * a_q), (-b_q + sq) / (2.0 * a_q)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=cs.SMALL["width"])
    ap.add_argument("--height", type=int, default=cs.SMALL["height"])
    ap.add_argument("--spp", type=int, default=cs.SMALL["spp"])
    args = ap.parse_args()
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=cs.SMALL["bounces"])
    scene = cs.spheres_at_static_limit(cfg.resolution, in_view=True)
    occluders = cs.potential_occluders(scene, cfg)
    _, aux = decoupled.trace_records(scene, cfg, occluders=occluders,
                                     device="cpu")
    records, draws = aux.records, list(aux[1:])
    table, cam, light = (v.detach() for v in
                         cuda_shade._pack_diff_inputs(scene, cfg))
    n = cfg.num_pixels
    gen = torch.Generator().manual_seed(1234)
    g = torch.randn((3, n), generator=gen) / cfg.spp
    first, count = scene.triangles.num_triangles, cs.PROBE_PRIMS - 14
    prim = (records % cuda_path.OCC_BIT).long() - 1
    added = (prim >= first) & (prim < first + count)
    camera_hit = added[:, 0]  # [spp, n]

    scope = _hooked_replay()

    def run(dtype, quadratic):
        """Per-lane camera cotangents [12, spp, n], per-lane gathered
        attribute cotangents of each bounce [16, spp, n], and the whole
        table's."""
        gathered = []

        def leaf(at):
            at = at.detach().requires_grad_(True)
            gathered.append(at)
            return at

        scope["QUADRATIC"], scope["GATHERED"] = quadratic, leaf
        cam_l = cam.to(dtype)[:, None, None].expand(12, cfg.spp, n).clone()
        tab = table.to(dtype)
        cam_l.requires_grad_(True)
        lum = scope["replay_packed"](tab, cam_l, light.to(dtype), records,
                                     [d.to(dtype) for d in draws], cfg)
        grads = torch.autograd.grad((g.to(dtype) * lum).sum(),
                                    [cam_l] + gathered)
        per_lane = [x.double() for x in grads]
        # The table's cotangent: each bounce's lanes scattered to the
        # primitive they hit.
        whole = torch.zeros(table.shape, dtype=torch.float64)
        for b, at in enumerate(per_lane[1:]):
            pc = torch.clamp(prim[:, b], 0, table.shape[1] - 1)
            whole.index_add_(1, pc.reshape(-1), at.reshape(16, -1))
        return per_lane[0], per_lane[1:], whole

    exact = run(torch.float64, quadratic_f32)
    f32 = run(torch.float32, quadratic_f32)

    # rho of every camera ray that meets an added sphere, in float64.
    c64, w, h = cam.double(), cfg.width, cfg.height
    rid = torch.arange(n)
    px, py = (rid % w).double(), (rid // w).double()
    s = ((px + draws[4].double()) / w) * 2 - 1
    t = -(((py + draws[5].double()) / h) * 2 - 1)
    ray = [s * c64[3 + k] + t * c64[6 + k] - c64[9 + k] for k in range(3)]
    norm = torch.sqrt(sum(x * x for x in ray))
    d = [x / norm for x in ray]
    p0 = torch.clamp(prim[:, 0], 0, table.shape[1] - 1)
    tab = table.double()
    oc = [c64[k] - tab[11 + k][p0] for k in range(3)]
    b = 2 * sum(o * x for o, x in zip(oc, d))
    c = sum(o * o for o in oc) - tab[14][p0] ** 2
    rho = (b * b - 4 * sum(x * x for x in d) * c) / (b * b)
    hit_rho = rho[camera_hit]
    q = torch.quantile(hit_rho, torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0],
                                             dtype=torch.float64))
    print(f"scene: {first} triangles, {scene.spheres.num_spheres} spheres, "
          f"{cfg.width}x{cfg.height} x {cfg.spp} spp x {cfg.bounces} bounces;"
          f" {int(camera_hit.sum())} of {camera_hit.numel()} camera rays meet "
          "an added sphere; rho = disc / b^2 there: min, 1 %, median, 99 %, "
          "max " + ", ".join(f"{v:.2e}" for v in q.tolist()))

    bins = [(lo, hi) for lo, hi in zip(RHO_BINS, RHO_BINS[1:] + (2.0,))]
    classes = [("camera ray misses the added spheres", ~camera_hit)] + [
        (f"camera ray meets one, rho in [{lo:g}, {hi:g})",
         camera_hit & (rho >= lo) & (rho < hi)) for lo, hi in bins]
    print("| lanes | count | group | sum of abs(lane) | sum of abs(f32 - "
          "f64) | ratio | largest lane over the frame's largest |")
    print("|---|---|---|---|---|---|---|")
    for label, sel in classes:
        if not sel.any():
            continue
        groups = [(name, f32[0][rows], exact[0][rows], exact[0][rows].sum(
            dim=(1, 2)).abs().max()) for name, rows in CAMERA.items()]
        groups += [(name, f32[1][0][rows], exact[1][0][rows],
                    exact[2][rows].abs().max()) for name, rows in
                   SPHERE.items()]
        for name, got, ref, scale in groups:
            err = (got - ref).abs().sum(dim=0)[sel]
            mag = ref.abs().sum(dim=0)[sel]
            ratio = err.sum() / mag.sum() if mag.sum() > 0 else 0.0
            print(f"| {label} | {int(sel.sum())} | {name} | {mag.sum():.4g} | "
                  f"{err.sum():.4g} | {ratio:.3g} | "
                  f"{err.max() / scale:.3g} |")

    print("| quadratic | " + " | ".join(list(CAMERA) + list(SPHERE)) + " |")
    print("|---" * (1 + len(CAMERA) + len(SPHERE)) + "|")
    for label, quadratic in (("float32 (as shipped)", quadratic_f32),
                             ("float64 from float32 inputs", quadratic_f64),
                             ("geometric form, float32", quadratic_geometric)):
        got = run(torch.float32, quadratic)
        parts = []
        for rows in CAMERA.values():
            ref = exact[0][rows].sum(dim=(1, 2))
            parts.append((got[0][rows].sum(dim=(1, 2)) - ref).abs().max()
                         / ref.abs().max())
        for rows in SPHERE.values():
            ref = exact[2][rows]
            parts.append((got[2][rows] - ref).abs().max() / ref.abs().max())
        print(f"| {label} | " + " | ".join(f"{float(v):.3g}" for v in parts)
              + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
