#!/usr/bin/env python3
"""Compare the variant-B and silhouette kernels of two checkouts on one
NVIDIA GPU.

    python3 tools/compare_trees.py PARENT_DIR

PARENT_DIR holds an earlier commit's ``gpuraytracer_tpu_torch`` package
(unpacked from ``git archive``). A slice that redesigns a kernel runs this
once, to show that the kernels it left alone compile to the parent's SASS
and that the redesigned one (``REDESIGNED``, K1) and the kernels that share
its radical inverse (``HALTON_CONSUMERS``: K2, K2g, K3, K3g, K6, K7) give the
parent's bits:

  * K1's six draw planes at path C's shape (512 x 512 x 16 x 3) and at 128 x
    96 x 4 x 3 with both samplers must be equal by sha256 in both
    checkouts;
  * K2's and K2g's images and records at the shapes of paths A-D, K and L
    (hdr, records_only, records + draws read + cull) must be equal by
    sha256;
  * the backward's outputs (K3 at D and E and at S, the static tier's
    limit with spheres: ``chip_smoke.spheres_at_static_limit`` in view at
    128 x 96 x 4 spp; K3g at K and L; draws read, at D, E and S also
    regenerated) on those records and a seeded cotangent must be equal by
    sha256; where they differ, per output group, the largest difference
    beside ``chip_smoke.compare_grads``' limit is printed;
  * K6's records (``chip_smoke.SoftInputs``: the sphere scene, direct
    lighting) at path J's shape (256 x 256 x 4), at 128 x 96 x 4 with and
    without the occluder cull, at 800 x 600 x 16 and at the recovery's 32 x
    32 x 2, and K7's outputs on those records and a seeded cotangent
    (without the cull), must be equal by sha256;
  * every kernel other than those named in ``REDESIGNED`` and
    ``HALTON_CONSUMERS`` must compile to the same SASS (``cuobjdump
    -sass``); for those, whether the SASS changed is printed; a function
    that only this checkout has is listed;
  * K1 at C, K2 at A and B (hdr), K3 at D (draws read and regenerated), K2g
    at K (hdr), and K6 and K7 at J (also by the profiler's device time) are
    timed in each, in turns: parent, this, this, parent.

Each checkout runs ``--fingerprint`` in a process of its own with its
package first on the path and ``chip_smoke.py``'s helpers from this
checkout. Prints one JSON object, then the card's name and power limit.
"""
from __future__ import annotations

import difflib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# The kernels whose SASS may differ from the parent's: the one the slice
# redesigns, and those that share its radical inverse (halton.cuh), whose
# outputs must still be the parent's bits.
REDESIGNED = ("draws_kernel",)
HALTON_CONSUMERS = ("path_kernel", "path_grouped_kernel", "shade_bwd_kernel",
                    "shade_bwd_grouped_kernel", "silh_kernel", "soft_bwd_kernel")
# Launches of K6 and K7 in one profiler window.
PROFILED_LAUNCHES = 20


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy()).hexdigest()


def fingerprint(outdir: Path) -> dict:
    """K1's, K2's, K2g's, K3's, K3g's, K6's and K7's outputs in the checkout
    whose package this process imports, through the wrappers every version
    of the port has: sha256 of the draw planes, images, records and
    cotangents (the cotangents also saved under ``outdir``), the times of K1
    at C, K2 at A and B, K3 at D, K2g at K and K6 and K7 at J, the built
    libraries."""
    import torch

    import chip_smoke as cs
    from gpuraytracer_tpu_torch.intersect import potential_occluders
    from gpuraytracer_tpu_torch.ops import _build, cuda_path
    from gpuraytracer_tpu_torch.render import pixel_rng_offsets
    from gpuraytracer_tpu_torch.scene import cornell_box_tessellated
    from gpuraytracer_tpu_torch.types import RenderConfig

    out = {"hashes": {}, "ms": {}, "device_ms": {}}
    dev = torch.device("cuda")
    for label, size, sampler in (("C", cs.BENCH, "halton"), ("small", cs.SMALL, "halton"),
                                 ("small", cs.SMALL, "stratified")):
        cfg = RenderConfig(sampler=sampler, **size)
        offsets = pixel_rng_offsets(cfg, dev).to(torch.int32).contiguous()
        planes = cuda_path.pregen_draws_kernel(offsets, cfg)
        out["hashes"][f"K1 {label} {sampler} planes"] = sha(torch.stack(planes[4:]))
        out["hashes"][f"K1 {label} {sampler} bounce planes"] = sha(torch.stack(planes[:4]))
        if label == "C":
            def k1():
                return cuda_path.pregen_draws_kernel(offsets, cfg)
            out["ms"]["K1 C"] = cs.time_draws(k1)
            out["device_ms"]["K1 C"] = (cs.draws_device_ms(k1), 0.0)
        del planes
    for label, size, mode in (
            ("A", cs.FRAME, "hdr"), ("A", cs.FRAME, "records_only"),
            ("B", cs.FRAME, "hdr"), ("B", cs.FRAME, "records_only"),
            ("C", cs.BENCH, "records"), ("D", cs.BENCH, "records_only"),
            ("K", cs.BENCH, "hdr"), ("K", cs.BENCH, "records"),
            ("L", cs.BENCH, "hdr"), ("L", cs.BENCH, "records")):
        cfg = RenderConfig(**size)
        grouped = label in "KL"
        if grouped:
            scene = cornell_box_tessellated(
                resolution=cfg.resolution,
                **(cs.TESS_K if label == "K" else cs.TESS_L))
        else:
            scene = cs.SCENES["cornell-spheres" if label == "B" else "cornell"](
                resolution=cfg.resolution)
        cull = mode != "hdr" and label not in "AB"
        occluders = potential_occluders(scene, cfg) if cull else None
        packed = cuda_path._pack_inputs(scene.to(dev), cfg, grouped, occluders)
        idx = cuda_path.shadow_indices(occluders, scene.triangles.num_triangles,
                                       dev)
        offsets = pixel_rng_offsets(cfg, dev).to(torch.int32).contiguous()
        draws = (cuda_path.pregen_draws_kernel(offsets, cfg)
                 if mode == "records" else None)

        def launch():
            return cuda_path.path_trace_kernel(offsets, 0, packed, idx, draws,
                                               cfg, mode != "hdr")

        hdr, rec = launch()
        key = f"{label} {mode}"
        out["hashes"][key + " image"] = sha(hdr)
        if rec is not None:
            out["hashes"][key + " records"] = sha(rec)
        del hdr, rec
        if key in ("A hdr", "B hdr"):
            out["ms"]["K2 " + key] = cs.time_ms(launch)
        if key == "K hdr":
            out["ms"]["K2g " + key] = cs.time_ms(launch)
        del packed, draws
        torch.cuda.empty_cache()
    for label, scene_name, size, tess in (
            ("D", "cornell", cs.BENCH, None), ("E", "cornell-spheres", cs.INVERSE, None),
            ("S", None, cs.SMALL, None),
            ("K", None, cs.BENCH, cs.TESS_K), ("L", None, cs.BENCH, cs.TESS_L)):
        cfg = RenderConfig(**size)
        scene = (cs.spheres_at_static_limit(cfg.resolution, in_view=True)
                 if label == "S" else tess and cornell_box_tessellated(
                     resolution=cfg.resolution, **tess))
        sh = cs.ShadeInputs(scene_name, cfg, grouped=tess is not None, scene=scene)
        for mode in ("read", "regenerated") if tess is None else ("read",):
            got = sh.kernel(regenerate=mode == "regenerated")
            key = f"{label} draws {mode}"
            out["hashes"][f"{key} cotangents"] = sha(torch.cat([got[0].flatten(),
                                                                 got[1]]))
            torch.save([t.cpu() for t in got], outdir / f"{key}.pt")
        if label == "D":
            for mode in ("read", "regenerated"):
                out["ms"][f"K3 D draws {mode}"] = cs.time_ms(
                    lambda: sh.kernel(regenerate=mode == "regenerated"))
        del sh
        torch.cuda.empty_cache()
    for label, size, cull in (("J", cs.SOFT_J, False), ("small", cs.SOFT_SIZES[0], False),
                              ("small", cs.SOFT_SIZES[0], True),
                              ("frame", cs.SOFT_SIZES[-1], False),
                              ("recovery", cs.SOFT_RECOVERY, False)):
        inp = cs.SoftInputs(cs.soft_cfg(size), cull)
        out["hashes"][f"K6 {label}{', cull' if cull else ''} records"] = sha(inp.codes)
        if not cull:
            got = inp.bwd_kernel()
            out["hashes"][f"K7 {label} cotangents"] = sha(torch.cat([got[0].flatten(),
                                                                    got[1]]))
            torch.save([t.cpu() for t in got], outdir / f"K7 {label}.pt")
        if label == "J":
            for kernel, fn, name in (("K6", inp.silh_kernel, "silh_kernel"),
                                     ("K7", inp.bwd_kernel, "soft_bwd_kernel")):
                out["ms"][f"{kernel} {label}"] = cs.time_ms(fn)
                cs.device_busy(lambda: [fn() for _ in range(PROFILED_LAUNCHES)])
                out["device_ms"][f"{kernel} {label}"] = (
                    cs.profiled_ms(name) / PROFILED_LAUNCHES,
                    cs.profiled_ms("reduce_partials") / PROFILED_LAUNCHES)
        del inp
        torch.cuda.empty_cache()
    out["libraries"] = {lib.path.name.split("-")[0]: str(lib.path)
                        for lib in _build.load_libraries()}
    return out


def run(root: Path, outdir: Path) -> dict:
    """``--fingerprint`` with ``root``'s package first on the path."""
    outdir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-P", str(Path(__file__).resolve()), "--fingerprint",
         str(outdir)],
        cwd=root, env=dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{HERE}"),
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"fingerprint in {root} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare(parent: Path) -> dict:
    sys.path.insert(0, str(HERE))
    work = Path(tempfile.mkdtemp(prefix="compare_trees_"))
    try:
        return _compare(parent, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _compare(parent: Path, work: Path) -> dict:
    """``compare`` with the cotangents of each side saved under ``work``."""
    import torch

    import chip_smoke as cs
    from gpuraytracer_tpu_torch.ops import _build

    runs = [("parent", run(parent, work / "parent")), ("this", run(HERE, work / "this")),
            ("this, again", run(HERE, work / "this")),
            ("parent, again", run(parent, work / "parent"))]
    first, mine = runs[0][1], runs[1][1]
    for label, r in runs:
        cs.log(f"  {label}: " + ", ".join(
            f"{k} {v[1]:.4f} ms (min {v[0]:.4f}, max {v[2]:.4f})"
            for k, v in r["ms"].items()))
        cs.log(f"  {label}, device time (kernel, reduction): " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in r.get("device_ms", {}).items()))
    equal = {k: first["hashes"][k] == mine["hashes"].get(k)
             for k in first["hashes"]}
    cs.log("  equal by sha256: " + ", ".join(
        f"{k} {'yes' if v else 'NO'}" for k, v in equal.items()))
    # Where the cotangents differ: per group, the largest difference over
    # compare_grads' limit (atol + rtol * the group's largest magnitude) for
    # K3 and K3g, over compare_scaled's (atol max(scale, 1) + rtol scale)
    # for K7.
    cotangents = {}
    for key in sorted(k[:-len(" cotangents")] for k in equal if k.endswith("cotangents")):
        if equal[f"{key} cotangents"]:
            continue
        got, ref = (cs.grad_groups(*torch.load(work / side / f"{key}.pt"))
                    for side in ("this", "parent"))
        ratios = {}
        for name, r in ref.items():
            scale = r.abs().max().item()
            if key.startswith("K7"):
                limit = cs.GRAD_ATOL * max(scale, 1.0) + cs.GRAD_RTOL * scale
            else:
                limit = cs.GRAD_ATOL + (cs.SPHERE_GEOMETRY_RTOL
                                        if name in ("d center", "d radius")
                                        else cs.GRAD_RTOL) * scale
            ratios[name] = (got[name] - r).abs().max().item() / limit
        cotangents[key] = ratios
        cs.log(f"  {key}: largest difference over the limit: " + ", ".join(
            f"{name} {v:.2e}" for name, v in ratios.items()))
    sass, consumers, new, listings = {}, {}, [], {}
    for name in _build.SOURCES:
        a = cs.sass_by_function(first["libraries"][f"lib{name}"])
        b = cs.sass_by_function(mine["libraries"][f"lib{name}"])
        listings[f"lib{name}"] = (a, b)
        for fn in sorted(set(a) | set(b)):
            if fn not in a:
                new.append(f"{name}: {fn}")
            elif any(kernel in fn for kernel in REDESIGNED + HALTON_CONSUMERS):
                consumers[f"{name}: {fn}"] = a.get(fn) == b.get(fn)
            else:
                sass[f"{name}: {fn}"] = a.get(fn) == b.get(fn)
    cs.log(f"  SASS of {len(sass)} other kernels equal: {sum(sass.values())}; "
           f"differ: {[k for k, v in sass.items() if not v]}; only in this "
           f"checkout: {new}")
    cs.log(f"  SASS of K1 and the Halton consumers changed: "
           f"{[k for k, v in consumers.items() if not v]}; unchanged: "
           f"{[k for k, v in consumers.items() if v]}")
    for key in (k for k, v in sass.items() if not v):
        name, fn = key.split(": ")
        diff = difflib.unified_diff(
            listings[f"lib{name}"][0].get(fn, "").splitlines(),
            listings[f"lib{name}"][1].get(fn, "").splitlines(), "parent", "this",
            lineterm="", n=1)
        cs.log(f"  {key}, first differing lines:\n" + "\n".join(list(diff)[:40]))
    cs.check(all(equal.values()), f"draws, images, records or cotangents differ "
             f"from {parent}: {[k for k, v in equal.items() if not v]}")
    cs.check(all(sass.values()), f"kernels other than {REDESIGNED + HALTON_CONSUMERS} "
             "changed SASS")
    return dict(ms={label: r["ms"] for label, r in runs},
                device_ms={label: r["device_ms"] for label, r in runs}, hashes_equal=equal,
                cotangents_over_limit=cotangents, sass_equal=sass,
                consumer_sass_equal=consumers, new_kernels=new,
                card=cs.card_name_and_limit())


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--fingerprint":
        print(json.dumps(fingerprint(Path(args[1]))), flush=True)
        return 0
    if len(args) != 1:
        print("usage: python3 tools/compare_trees.py PARENT_DIR",
              file=sys.stderr)
        return 2
    result = compare(Path(args[0]).resolve())
    print(json.dumps({k: v for k, v in result.items() if k != "card"}),
          flush=True)
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
