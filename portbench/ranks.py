"""Cells on more than one card: one rank a card.

``python3 -m portbench.run`` hands a cell whose ``chips`` is above one to
``launch_run``. The launcher builds the port's kernel libraries once, picks
a free port on localhost and starts one worker a card,
``python3 -m portbench.ranks``, with ``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set. Each rank joins the process
group through ``parallel.multihost.init_distributed`` (NCCL between cards,
gloo on the CPU), builds the cell's job on its card and makes the fit's
first three steps (the ones the reference follows) and two more, whose mean
time fixes the window's step count; rank 0 sends the count once, so every
rank makes the same number of steps and the loop holds no collective of the
benchmark's own. The window is timed on rank 0 between two barriers;
``setup_s`` runs from the launcher's start to the first timed step.

After the window: each card's peak memory; in a traced run, rank 0 times
the same traffic on its card alone (``FitJob``, ``scaling_pct``'s t1) while
the others wait at a barrier; then the check, the plain reference over the
whole frame, each rank's card taking the blocks of its own rows and their
loss and gradients summed over the ranks (``ShardedReference``). In a traced
run each rank reads the per-layer metrics from its own trace, with its share
of the pixels as the traffic, and the cell reports their mean. Rank 0 prints
the result; the launcher prints the ranks' logs, the numbers compared and,
last, the result line. A rank that fails, or a group still running at the
time limit, ends the run with no result.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

from . import run as _run  # fixes the build and kernel caches' directories

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from .reference import Reference  # noqa: E402

ROOT = _run.ROOT
# The port's kernel libraries a traffic's integrator runs.
LIBRARIES = {"path": ("path_kernels", "shade_kernels"),
             "mis": ("mis_kernels", "mis_bwd_kernels")}
# Seconds a group of ranks may take for one run (the command has 360).
RUN_TIMEOUT = 330.0
# Per seed, for the readings of ``portbench.control``.
READING_TIMEOUT = 240.0
# Steps timed for t1, after one that warms the shape.
ONE_CARD_STEPS = 3
WARM_STEPS = 2


def _log(msg: str) -> None:
    rank = dist.get_rank() if dist.is_initialized() else "-"
    print(f"[rank {rank}] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _ranks(worker_args: Sequence[str], world: int, device: str,
           root: Path, timeout: float
           ) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """Start ``world`` ranks of ``python3 -m portbench.ranks worker_args``
    and wait for them: (the failure, or None; each rank's standard output
    and error). A rank that exits with another code than 0, or a group
    still running after ``timeout`` seconds, is a failure; the others are
    then killed."""
    from gpuraytracer_tpu_torch.parallel.multihost import free_port
    port = free_port()
    cmd = [sys.executable, "-m", f"{__package__}.ranks", *worker_args,
           "--device", device]
    procs = []
    files = []
    failure = None
    # A launcher ended by a signal still ends its ranks (``finally``).
    previous = signal.signal(signal.SIGTERM, _exit_on_signal)
    try:
        for rank in range(world):
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            files.append((out, err))
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world))
            procs.append(subprocess.Popen(cmd, cwd=root, env=env,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"rank {bad[0]} exited with {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = f"the ranks still ran after {timeout:.0f} s"
            else:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, previous)
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    return failure, texts


def _exit_on_signal(signum, frame):
    raise SystemExit(128 + signum)


def _build(integrator: str, device: str) -> None:
    """Build the libraries the ranks will load, once, so that they do not
    race on the build directory."""
    if device == "cuda":
        from gpuraytracer_tpu_torch.ops import _build
        _build.load_libraries(LIBRARIES[integrator])


def launch_run(cell_name: str, seed: int, seconds: float, trace: bool,
               world: int, device: str = "cuda", fault: Optional[str] = None,
               traffic_override: Optional[Dict] = None, root: Path = ROOT,
               started: Optional[float] = None,
               err: Optional[TextIO] = None) -> Optional[Dict]:
    """One run of a multi-card cell: rank 0's result object, or None when
    the run gave none. The ranks' logs go to ``err`` (standard error)."""
    from . import spec
    err = err or sys.stderr
    started = _run.PROCESS_START if started is None else started
    cell = spec.load_cell(cell_name, root)
    traffic = dict(cell.traffic, **(traffic_override or {}))
    _build(traffic["integrator"], device)
    args = ["--workload", cell_name, "--seed", str(seed), "--seconds",
            repr(float(seconds)), "--trace", str(int(trace)), "--started",
            repr(started)]
    if fault:
        args += ["--fault", fault]
    if traffic_override:
        args += ["--traffic", json.dumps(traffic_override)]
    failure, texts = _ranks(args, world, device, root, RUN_TIMEOUT)
    for _, text in texts:
        err.write(text)
    lines = texts[0][0].strip().splitlines() if texts else []
    if failure is None and not lines:
        failure = "rank 0 printed no result"
    if failure is not None:
        print(f"no result: {failure}", file=err, flush=True)
        return None
    err.flush()
    return json.loads(lines[-1])


def launch_readings(cell_name: str, seeds: Sequence[int], side: str,
                    world: int, fault: Optional[str] = None,
                    device: str = "cuda",
                    traffic_override: Optional[Dict] = None,
                    root: Path = ROOT,
                    err: Optional[TextIO] = None) -> List[str]:
    """``portbench.control``'s readings of a multi-card cell, one JSON line
    a seed (``side``: ``control`` or ``program``); empty when the ranks
    failed."""
    from . import spec
    err = err or sys.stderr
    cell = spec.load_cell(cell_name, root)
    traffic = dict(cell.traffic, **(traffic_override or {}))
    _build(traffic["integrator"], device)
    args = ["--workload", cell_name, "--readings", side, "--seeds",
            *map(str, seeds)]
    if fault:
        args += ["--fault", fault]
    if traffic_override:
        args += ["--traffic", json.dumps(traffic_override)]
    failure, texts = _ranks(args, world, device, root,
                            READING_TIMEOUT * len(seeds))
    for _, text in texts:
        err.write(text)
    if failure is not None:
        print(f"no readings: {failure}", file=err, flush=True)
        return []
    return texts[0][0].strip().splitlines()


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------

def _barrier(device: torch.device) -> None:
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


class ShardedReference(Reference):
    """The plain reference over this rank's rows of the frame: its loss and
    gradients are that share's terms, summed over the ranks in float64, so
    each rank's card traces a ``size``-th of the rays. Every rank must call
    ``loss_and_grads`` alike."""

    def __init__(self, tree: Dict, traffic: Dict, dtype=torch.float32,
                 device="cuda", index: int = 0, size: int = 1):
        super().__init__(tree, traffic, dtype=dtype, device=device)
        n = traffic["width"] * traffic["height"]
        self.pixels = torch.arange(index * n // size,
                                   (index + 1) * n // size, device=device)

    def loss_and_grads(self, values: Dict[str, torch.Tensor],
                       target: torch.Tensor):
        loss, grads = super().loss_and_grads(values, target, self.pixels)
        names = list(grads)
        flat = torch.cat([loss.reshape(1).double()]
                         + [grads[k].reshape(-1).double() for k in names])
        dist.all_reduce(flat)
        out, at = {}, 1
        for k in names:
            g = grads[k]
            out[k] = flat[at:at + g.numel()].view_as(g).to(g.dtype)
            at += g.numel()
        return flat[0].to(loss.dtype), out


def one_card_step_s(tree: Dict, traffic: Dict, seed: int,
                    device: torch.device) -> float:
    """The mean step of the same traffic on this card alone, through
    ``FitJob`` (``fast_pixel_loss``): one step warms the shape, then
    ``ONE_CARD_STEPS`` are timed."""
    from . import program
    from .tracing import Spans
    job = program.FitJob(tree, traffic, seed, device, Spans(False))
    job.iterate()
    t = time.perf_counter()
    for _ in range(ONE_CARD_STEPS):
        job.iterate()
    seconds = (time.perf_counter() - t) / ONE_CARD_STEPS
    job.release()
    return seconds


def _mean(values: List[Optional[float]]) -> Optional[float]:
    read = [v for v in values if v is not None]
    return statistics.fmean(read) if read else None


def run_rank(cell_name: str, seed: int, seconds: float, trace: bool,
             started: float, device: torch.device, fault=None,
             traffic_override=None, root: Path = ROOT) -> Optional[Dict]:
    """This rank's part of one run; rank 0 returns the result object, the
    others None."""
    from . import check, program, spec
    from .rays import nominal_rays
    from .scenes import BUILDERS
    from .tracing import Spans, export, summarize

    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = device.type == "cuda"
    cell = spec.load_cell(cell_name, root)
    traffic = dict(cell.traffic, **(traffic_override or {}))
    cfg = cell.config
    tree = BUILDERS[cfg["scene"]](
        resolution=(traffic["width"], traffic["height"]),
        **cfg.get("args", {}))
    job = program.JOBS[traffic["job"]](tree, traffic, seed, device,
                                       Spans(trace), fault)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # Set-up: the first three steps (the reference follows them), then two
    # more whose mean time fixes the window's count.
    readings = job.first_steps()
    _log(f"first three losses: {json.dumps(readings['losses'])}")
    warm = []
    for _ in range(WARM_STEPS):
        t = time.perf_counter()
        job.iterate()
        warm.append(time.perf_counter() - t)
    window_limit = min(seconds, _run.TRACE_SECONDS) if trace else seconds
    count = [max(_run.MIN_TRACED_ITERATIONS if trace else 1,
                 math.ceil(window_limit / statistics.fmean(warm)))]
    dist.broadcast_object_list(count, src=0)
    steps = count[0]
    before = _run._launches()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    sync()
    _barrier(device)
    t0 = time.perf_counter()
    setup_s = time.time() - started
    times = []
    for _ in range(steps):
        start = time.perf_counter()
        job.iterate()
        times.append(time.perf_counter() - start)
    sync()
    _barrier(device)
    window_s = time.perf_counter() - t0
    path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = export(prof, _run.CACHE / f"rank{rank}")
    launched = {k: v - before[k] for k, v in _run._launches().items()
                if v != before[k]}
    if cuda:
        _log(f"card {device.index}: {_run.card_line()}")
    _log(f"launches in the window ({steps} iterations): "
         + json.dumps(launched))
    peaks: List[int] = [0] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(device)
                           if cuda else 0)

    one_card = None
    if trace:
        if rank == 0:
            one_card = one_card_step_s(tree, traffic, seed, device)
            _log(f"one card alone: {1e3 * one_card:.3f} ms a step")
        _barrier(device)

    # The check, once the window has closed and the program's state is
    # freed.
    ref_traffic = program.traffic_for_reference(traffic, seed)
    target = job.target.detach().clone()
    opt = traffic["optimizer"]
    job.release()
    del job
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ShardedReference(tree, ref_traffic, device=device, index=rank,
                           size=world)
    numbers = check.fit_numbers(
        readings["losses"], readings["first_grad"], readings["start"],
        readings["after"], ref, target, opt["lr"], tuple(opt["betas"]),
        opt["eps"])
    correct, table = check.verdict(numbers, cell.limits)
    _log(f"reference: {time.perf_counter() - t_ref:.1f} s")

    metrics = {}
    result = {"correct": correct, "attempted": steps, "failed": 0}
    if not trace:
        p95 = (statistics.quantiles(times, n=20)[-1] if len(times) > 1
               else times[0])
        values = {
            "mrays_s": nominal_rays(traffic) * steps / window_s / 1e6,
            "step_p95_ms": 1e3 * p95,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[spec.base_name(m.name)],
                               "unit": m.unit}
    else:
        summary = summarize(path)
        share = dict(traffic, height=traffic["height"] // world)
        ctx = SimpleNamespace(traffic=share, config=cfg,
                              num_triangles=tree["triangles"]["verts"]
                              .shape[0], trace_path=path, ranks=world,
                              one_card_step_s=one_card)
        mine = {m.name: spec.metric_reader(m.name)(summary, ctx)
                for m in cell.per_layer}
        path.unlink()
        _log(f"traced {summary.iterations} iterations, "
             f"{summary.unattributed} activities outside the spans: "
             + json.dumps(mine))
        gathered: List = [None] * world
        dist.all_gather_object(gathered, (mine, summary.busy_s,
                                          summary.window_s))
        for m in cell.per_layer:
            value = _mean([g[0][m.name] for g in gathered])
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        result["breakdown"] = summary.breakdown()
    if rank != 0:
        return None
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": world, "memory_peak_bytes": max(peaks)}
    if trace:
        result["device"]["busy_s"] = _mean([g[1] for g in gathered])
        result["device"]["window_s"] = _mean([g[2] for g in gathered])
    result["checks"] = table
    return result


def _die_with_parent() -> None:
    """Ask Linux to kill this rank when its launcher ends (prctl
    PR_SET_PDEATHSIG), so that no rank outlives a launcher that was
    killed."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int)
    parser.add_argument("--seconds", type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--started", type=float)
    parser.add_argument("--readings", choices=("control", "program"))
    parser.add_argument("--seeds", type=int, nargs="*")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--traffic", default=None,
                        help="JSON of traffic keys to override (tests)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    _die_with_parent()
    from gpuraytracer_tpu_torch.parallel.multihost import init_distributed
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device=args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    override = json.loads(args.traffic) if args.traffic else None
    reference = functools.partial(ShardedReference, index=dist.get_rank(),
                                  size=dist.get_world_size())
    lines = []
    try:
        if args.readings is None:
            result = run_rank(args.workload, args.seed, args.seconds,
                              bool(args.trace), args.started, device,
                              args.fault, override)
            if result is not None:
                lines.append(json.dumps(result))
        else:
            from .control import (control_numbers, program_numbers,
                                  reading_line)
            for seed in args.seeds:
                t = time.perf_counter()
                if args.readings == "control":
                    cell, numbers = control_numbers(
                        args.workload, seed, device, override,
                        reference=reference)
                else:
                    cell, numbers = program_numbers(
                        args.workload, seed, device, override, args.fault,
                        reference=reference)
                lines.append(reading_line(
                    args.workload, seed, args.readings == "program",
                    args.fault, cell, numbers, time.perf_counter() - t))
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    found = _run.forbidden_modules()
    if found:
        print(f"no result: the rank loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
