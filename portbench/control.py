"""The check's control: the plain reference in the program's place,
computed in bfloat16, the nearest precision below the configurations'
float32. It has to fail the check. Also reads the numbers of sound runs of
the program on many seeds in one process (for setting the limits).

    python3 -m portbench.control --workload <cell> --seeds 11 12 13
    python3 -m portbench.control --workload <cell> --seeds 1 2 ... --program
    python3 -m portbench.control --workload <cell> --seeds 1 2 3 --program \
        --fault half_batch

Prints one JSON line per seed: the numbers the check compares and the
limits. The control runs at the cell's own sizes, so it needs the card; a
fit's control takes its three steps, a frame's renders the pixels a run
keeps. A cell on more than one card is read by its ranks, one a card, as
its runs are (``portbench.ranks``): the program's step is the sharded one,
and each rank's card takes the reference's blocks of its rows.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, spec
from .reference import Reference, adam
from .scenes import BUILDERS

CONTROL_DTYPE = torch.bfloat16


def _setup(cell_name: str, seed: int, traffic_override=None):
    cell = spec.load_cell(cell_name)
    traffic = dict(cell.traffic, **(traffic_override or {}))
    tree = BUILDERS[cell.config["scene"]](
        resolution=(traffic["width"], traffic["height"]),
        **cell.config.get("args", {}))
    return cell, dict(traffic, seed=seed & 0x7FFFFFFF), tree


def control_numbers(cell_name: str, seed: int, device="cuda",
                    traffic_override=None, frames: int = 200,
                    reference=Reference):
    """The check's numbers with the bfloat16 reference as the program.
    ``reference``: the reference's class, or a rank's share of it
    (``ranks.ShardedReference``)."""
    from . import program
    cell, traffic, tree = _setup(cell_name, seed, traffic_override)
    low = reference(tree, traffic, dtype=CONTROL_DTYPE, device=device)
    ref = reference(tree, traffic, device=device)
    if traffic["job"] == "frame":
        rng = np.random.Generator(np.random.PCG64(seed))
        n = traffic["width"] * traffic["height"]
        ids = [rng.integers(0, n, program.FRAME_SAMPLE)
               for _ in range(frames)]
        uniq = np.unique(np.concatenate(ids))
        vals = low.image(torch.as_tensor(uniq, device=device), {}).float() \
            .cpu().numpy()
        lookup = dict(zip(uniq.tolist(), range(len(uniq))))
        kept = [vals[[lookup[i] for i in f]] for f in ids]
        return cell, check.frame_numbers(kept, ids, ref)
    start = program.initial_values(tree, traffic, seed, device)
    target = program.target_image(traffic, seed, device)
    opt = traffic["optimizer"]
    losses, first, after = adam(
        {k: v.to(CONTROL_DTYPE) for k, v in start.items()},
        lambda vals: low.loss_and_grads(vals, target), 3, opt["lr"],
        tuple(opt["betas"]), opt["eps"])
    return cell, check.fit_numbers(
        losses, {k: v.float() for k, v in first.items()}, start,
        {k: v.float() for k, v in after.items()}, ref, target, opt["lr"],
        tuple(opt["betas"]), opt["eps"])


def program_numbers(cell_name: str, seed: int, device="cuda",
                    traffic_override=None, fault=None, reference=Reference):
    """A fit's readings: the program's first three steps, as a run makes
    them in set-up, against the reference; sound, or with one of
    ``program.FAULTS`` planted."""
    from . import program
    from .tracing import Spans
    cell, traffic, tree = _setup(cell_name, seed, traffic_override)
    job = program.JOBS[traffic["job"]](tree, traffic, seed, device,
                                       Spans(False), fault)
    r = job.first_steps()
    target = job.target.detach().clone()
    job.release()
    ref = reference(tree, traffic, device=device)
    opt = traffic["optimizer"]
    return cell, check.fit_numbers(
        r["losses"], r["first_grad"], r["start"], r["after"], ref, target,
        opt["lr"], tuple(opt["betas"]), opt["eps"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", action="store_true",
                        help="the program's readings instead of the control")
    parser.add_argument("--fault", default=None,
                        help="with --program: a fault of program.FAULTS")
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} card(s)", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from . import ranks
        lines = ranks.launch_readings(
            args.workload, args.seeds, "program" if args.program
            else "control", cell.chips, fault=args.fault)
        for line in lines:
            print(line, flush=True)
        return 0 if lines else 1
    for seed in args.seeds:
        t = time.perf_counter()
        if args.program:
            cell, numbers = program_numbers(args.workload, seed,
                                            fault=args.fault)
        else:
            cell, numbers = control_numbers(args.workload, seed)
        print(reading_line(args.workload, seed, args.program, args.fault,
                           cell, numbers, time.perf_counter() - t),
              flush=True)
        torch.cuda.empty_cache()
    return 0


def reading_line(workload: str, seed: int, program: bool, fault, cell,
                 numbers, seconds: float) -> str:
    """One seed's JSON line: the side, the verdict and the numbers."""
    correct, _ = check.verdict(numbers, cell.limits)
    side = "control" if not program else fault or "program"
    return json.dumps({"workload": workload, "seed": seed, "side": side,
                       "correct": correct, "numbers": numbers,
                       "seconds": seconds})


if __name__ == "__main__":
    sys.exit(main())
