"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``gpuraytracer_tpu_torch/``, on a machine with an NVIDIA card. Set-up
builds the scene from the benchmark's arrays, makes the cell's one-time
work and warms every shape the cell uses (a fit's first three steps); the
window then runs the cell's closed loop for ``--seconds``; the plain
reference checks what the timed path produced once the window has closed.
The last line of standard output is one JSON object; the numbers the check
compared are the last lines of standard error. With ``--trace 1`` the window
runs under ``torch.profiler`` (at most ``TRACE_SECONDS``) and the line holds
the per-layer metrics instead of the end-to-end ones. A cell on more than
one card runs one rank a card (``portbench.ranks``); this process launches
them and prints rank 0's line.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "gpuraytracer_tpu")
TRACE_SECONDS = 2.0
MIN_TRACED_ITERATIONS = 3


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        out = f"nvidia-smi unavailable ({err})"
    return out


def _launches():
    from gpuraytracer_tpu_torch.ops import (cuda_mis, cuda_mis_bwd,
                                            cuda_path, cuda_shade)
    out = {}
    for mod in (cuda_path, cuda_shade, cuda_mis, cuda_mis_bwd):
        out.update(mod.LAUNCHES)
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = ROOT, fault=None, traffic_override=None,
        log=print):
    """One run: returns the result object the command prints."""
    import torch

    from . import check, program, spec
    from .rays import nominal_rays
    from .reference import Reference
    from .scenes import BUILDERS
    from .tracing import Spans

    cell = spec.load_cell(cell_name, root)
    traffic = dict(cell.traffic, **(traffic_override or {}))
    cfg = cell.config
    tree = BUILDERS[cfg["scene"]](
        resolution=(traffic["width"], traffic["height"]),
        **cfg.get("args", {}))
    device = torch.device(device)
    spans = Spans(trace)
    job = program.JOBS[traffic["job"]](tree, traffic, seed, device, spans,
                                       fault)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Set-up: the first iterations warm every shape the loop uses; a fit's
    # first three steps are the ones the reference follows.
    readings = job.first_steps() if traffic["job"] == "fit" else None
    if readings is None:
        job.iterate()
        job.kept.clear()
        job.kept_ids.clear()
    sync()
    before = _launches()
    window_limit = min(seconds, TRACE_SECONDS) if trace else seconds
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    times = []
    t0 = time.perf_counter()
    setup_s = time.time() - PROCESS_START
    while True:
        start = time.perf_counter()
        job.iterate()
        end = time.perf_counter()
        times.append(end - start)
        if end - t0 >= window_limit and (
                not trace or len(times) >= MIN_TRACED_ITERATIONS):
            break
    window_s = end - t0
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
    launched = {k: v - before[k] for k, v in _launches().items()
                if v != before[k]}
    log(f"card: {card_line() if device.type == 'cuda' else device.type}")
    log(f"launches in the window ({len(times)} iterations): "
        + json.dumps(launched))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # The check, once the window has closed and the program's state is
    # freed.
    ref_traffic = program.traffic_for_reference(traffic, seed)
    kept = ((job.kept, job.kept_ids) if traffic["job"] == "frame" else None)
    target = None if kept else job.target.detach().clone()
    opt = traffic.get("optimizer", {})
    job.release()
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(tree, ref_traffic, device=device)
    if kept:
        numbers = check.frame_numbers(*kept, ref)
    else:
        numbers = check.fit_numbers(
            readings["losses"], readings["first_grad"], readings["start"],
            readings["after"], ref, target, opt["lr"], tuple(opt["betas"]),
            opt["eps"])
    correct, table = check.verdict(numbers, cell.limits)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")

    metrics = {}
    result = {"correct": correct, "attempted": len(times), "failed": 0}
    if not trace:
        p95 = (statistics.quantiles(times, n=20)[-1] if len(times) > 1
               else times[0])
        values = {
            "mrays_s": nominal_rays(traffic) * len(times) / window_s / 1e6,
            "frame_p95_ms": 1e3 * p95,
            "step_p95_ms": 1e3 * p95,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[spec.base_name(m.name)],
                               "unit": m.unit}
    else:
        from .tracing import export, summarize
        path = export(prof, CACHE)
        summary = summarize(path)
        path.unlink()
        log(f"traced {summary.iterations} iterations, "
            f"{summary.unattributed} activities outside the spans")
        ctx = SimpleNamespace(traffic=traffic, config=cfg,
                              num_triangles=tree["triangles"]["verts"]
                              .shape[0])
        for m in cell.per_layer:
            value = spec.metric_reader(m.name)(summary, ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        result["breakdown"] = summary.breakdown()
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
    result["checks"] = table
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from . import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"no result: this cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from .ranks import launch_run
        result = launch_run(args.workload, args.seed, args.seconds,
                            bool(args.trace), cell.chips,
                            started=PROCESS_START)
        if result is None:
            return 1
    else:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
