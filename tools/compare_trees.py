#!/usr/bin/env python3
"""Compare the variant-B trace kernels of two checkouts on one NVIDIA GPU.

    python3 tools/compare_trees.py PARENT_DIR

PARENT_DIR holds an earlier commit's ``gpuraytracer_tpu_torch`` package
(unpacked from ``git archive``). A slice that redesigns a kernel runs this
once, to show that the kernels it left alone compile to the parent's SASS
and that the redesigned ones make the parent's decisions:

  * K2's and K2g's images and records at the shapes of paths A-D, K and L
    (hdr, records_only, records + draws read + cull) must be equal by
    sha256 in both checkouts;
  * every kernel other than ``path_kernel`` and ``path_grouped_kernel``
    must compile to the same SASS (``cuobjdump -sass``);
  * K2 at path A (hdr) is timed in each, in turns: parent, this, this,
    parent.

Each checkout runs ``--fingerprint`` in a process of its own with its
package first on the path and ``chip_smoke.py``'s helpers from this
checkout. Prints one JSON object, then the card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy()).hexdigest()


def fingerprint() -> dict:
    """K2's and K2g's outputs in the checkout whose package this process
    imports, through the wrappers every version of the port has: sha256 of
    the images and records, K2's time at A (hdr), the built libraries."""
    import torch

    import chip_smoke as cs
    from gpuraytracer_tpu_torch.intersect import potential_occluders
    from gpuraytracer_tpu_torch.ops import _build, cuda_path
    from gpuraytracer_tpu_torch.render import pixel_rng_offsets
    from gpuraytracer_tpu_torch.scene import cornell_box_tessellated
    from gpuraytracer_tpu_torch.types import RenderConfig

    out = {"hashes": {}, "ms": {}}
    dev = torch.device("cuda")
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
        if key == "A hdr":
            out["ms"][key] = cs.time_ms(launch)
        del packed, draws
        torch.cuda.empty_cache()
    out["libraries"] = {lib.path.name.split("-")[0]: str(lib.path)
                        for lib in _build.load_libraries()}
    return out


def sass_by_function(lib_path: str) -> dict:
    """{mangled kernel name: its SASS text} of a built library. nvcc names a
    source's anonymous namespace after a hash of the file's path, so that
    name is replaced by one the two checkouts share."""
    from gpuraytracer_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", text)
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def run(root: Path) -> dict:
    """``--fingerprint`` with ``root``'s package first on the path."""
    proc = subprocess.run(
        [sys.executable, "-P", str(Path(__file__).resolve()), "--fingerprint"],
        cwd=root, env=dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{HERE}"),
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"fingerprint in {root} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare(parent: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from gpuraytracer_tpu_torch.ops import _build

    runs = [("parent", run(parent)), ("this", run(HERE)),
            ("this, again", run(HERE)), ("parent, again", run(parent))]
    first, mine = runs[0][1], runs[1][1]
    for label, r in runs:
        cs.log(f"  {label}: " + ", ".join(
            f"{k} {v[1]:.3f} ms (min {v[0]:.3f}, max {v[2]:.3f})"
            for k, v in r["ms"].items()))
    equal = {k: first["hashes"][k] == mine["hashes"].get(k)
             for k in first["hashes"]}
    cs.log("  images and records equal by sha256: " + ", ".join(
        f"{k} {'yes' if v else 'NO'}" for k, v in equal.items()))
    sass = {}
    for name in _build.SOURCES:
        a = sass_by_function(first["libraries"][f"lib{name}"])
        b = sass_by_function(mine["libraries"][f"lib{name}"])
        for fn in sorted(set(a) | set(b)):
            if "path_kernel" in fn or "path_grouped_kernel" in fn:
                continue
            sass[f"{name}: {fn}"] = a.get(fn) == b.get(fn)
    cs.log(f"  SASS of {len(sass)} other kernels equal: {sum(sass.values())}; "
           f"differ: {[k for k, v in sass.items() if not v]}")
    cs.check(all(equal.values()), f"images or records differ from {parent}")
    cs.check(all(sass.values()), "kernels other than K2 and K2g changed SASS")
    return dict(ms={label: r["ms"] for label, r in runs}, hashes_equal=equal,
                sass_equal=sass, card=cs.card_name_and_limit())


def main() -> int:
    args = sys.argv[1:]
    if args == ["--fingerprint"]:
        print(json.dumps(fingerprint()), flush=True)
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
