"""The program's own spans in a traced run, beside the benchmark's.

The port marks its host layers with ``grt.`` spans
(``gpuraytracer_tpu_torch.utils.metrics.span``), profiler events that record
only while the profiler does. They nest, and run on more than one thread
(autograd's device thread runs a backward's body), so they are read here,
from the same Chrome trace that ``tracing.summarize`` reduces, and never
taken as the benchmark's spans: every reading of those stays as it was.
``self_intervals`` cuts each span into its self time, the part its child
spans on its thread do not cover; ``table`` gives each name's host self time
and the card-idle time under it; ``host_glue_ms`` and ``idle_glue_pct`` read
the work spans (``WORK``) whole.

    python3 -m portbench.program_spans --workload <cell> --seed <n>

traces one cell's window as a ``--trace 1`` run of ``portbench.run`` does,
without the check against the reference, and prints one JSON object: the
card, the iterations, each span's host self ms and card-idle ms per
iteration, ``host_glue_ms``, ``idle_glue_pct``, ``device_idle_pct``, the
window's scene packs (the program's ``PACKS``) and the breakdown.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .tracing import TraceSummary

PROGRAM_PREFIX = "grt."
# The program's spans in which the host works; the others are a kernel
# launch (``launch.<key>``) or a wait on the stream (``upload``, ``fetch``,
# ``sync``).
WORK = ("render", "plan", "pack", "pack.grouped", "pack.samples",
        "pack_diff", "attach")


@dataclasses.dataclass
class ProgramSpan:
    name: str  # without the prefix
    start: float  # microseconds
    end: float
    thread: Tuple[int, int]  # (pid, tid)


def read_spans(trace_path: Path) -> List[ProgramSpan]:
    """The ``grt.`` spans of an exported Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [ProgramSpan(e["name"][len(PROGRAM_PREFIX):], float(e["ts"]),
                        float(e["ts"]) + e["dur"],
                        (e.get("pid", 0), e.get("tid", 0)))
            for e in events
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PROGRAM_PREFIX)
            and "dur" in e]


def _merge(ivs) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _gaps(lo: float, hi: float, cuts) -> List[Tuple[float, float]]:
    """``[lo, hi)`` less the disjoint, sorted ``cuts``."""
    edges = [lo] + [x for iv in cuts for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def overlap(ivs, merged) -> float:
    """Microseconds of ``ivs`` inside the disjoint, sorted ``merged``."""
    starts = [s for s, _ in merged]
    total = 0.0
    for s, e in ivs:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(merged) and merged[i][0] < e:
            total += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
    return total


def idle_intervals(summary: TraceSummary) -> List[Tuple[float, float]]:
    """The window's gaps between ``summary.busy_intervals()``."""
    return _gaps(*summary.window, summary.busy_intervals())


def self_intervals(summary: TraceSummary, program: List[ProgramSpan]
                   ) -> List[Tuple[ProgramSpan, List[Tuple[float, float]]]]:
    """Each program span inside the window with its self intervals: its
    interval, clipped to the window, less those of its children (the spans
    it holds on its own thread)."""
    lo, hi = summary.window
    by_thread: Dict[Tuple[int, int], List[ProgramSpan]] = defaultdict(list)
    for p in program:
        if p.end > lo and p.start < hi:
            by_thread[p.thread].append(p)
    out = []
    for spans in by_thread.values():
        spans.sort(key=lambda p: (p.start, -p.end))
        children: Dict[int, list] = defaultdict(list)
        stack: List[int] = []
        for k, p in enumerate(spans):
            while stack and spans[stack[-1]].end <= p.start:
                stack.pop()
            if stack:
                children[stack[-1]].append(p)
            stack.append(k)
        for k, p in enumerate(spans):
            s, e = max(p.start, lo), min(p.end, hi)
            cuts = _merge((max(c.start, s), min(c.end, e))
                          for c in children[k])
            out.append((p, _gaps(s, e, cuts)))
    return out


def table(summary: TraceSummary, program: List[ProgramSpan]
          ) -> Dict[str, Tuple[float, float]]:
    """Per program span name: (host self seconds, seconds of that self time
    in which the card ran nothing), summed over the window."""
    idle = idle_intervals(summary)
    rows: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for p, ivs in self_intervals(summary, program):
        row = rows[p.name]
        row[0] += sum(e - s for s, e in ivs) * 1e-6
        row[1] += overlap(ivs, idle) * 1e-6
    return {name: (a, b) for name, (a, b) in sorted(rows.items())}


def host_glue_ms(summary: TraceSummary, program: List[ProgramSpan]
                 ) -> Optional[float]:
    """The self time of the work spans, less their launches and waits,
    summed over every thread, per iteration; None without work spans."""
    rows = [ivs for p, ivs in self_intervals(summary, program)
            if p.name in WORK]
    if not rows or summary.iterations <= 0:
        return None
    seconds = sum(e - s for ivs in rows for s, e in ivs) * 1e-6
    return 1e3 * seconds / summary.iterations


def idle_glue_pct(summary: TraceSummary, program: List[ProgramSpan]
                  ) -> Optional[float]:
    """The share of the window in which the card runs no kernel, copy or
    fill while some thread is in a work span's self time: the part of
    ``device_idle_pct`` the packing and the glue hold. None without work
    spans or device activity."""
    work = _merge(iv for p, ivs in self_intervals(summary, program)
                  if p.name in WORK for iv in ivs)
    if not work or summary.window_s <= 0.0 or not summary.activities:
        return None
    return 100.0 * overlap(work, idle_intervals(summary)) * 1e-6 / (
        summary.window_s)


def packs() -> Dict[str, int]:
    """The program's scene packs (``PACKS``), summed over its modules;
    empty for a program that counts none."""
    from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_path
    out: Dict[str, int] = {}
    for mod in (cuda_path, cuda_mis):
        for k, v in getattr(mod, "PACKS", {}).items():
            out[k] = out.get(k, 0) + v
    return out


def trace_cell(cell_name: str, seed: int, seconds: float):
    """Set up ``cell_name`` on the card as ``run.run`` does and trace its
    window: returns the summary, the program's spans, the window's packs
    and the card's line."""
    import torch

    from . import program, spec
    from .run import (CACHE, MIN_TRACED_ITERATIONS, TRACE_SECONDS,
                      card_line)
    from .scenes import BUILDERS
    from .tracing import Spans, export, summarize

    cell = spec.load_cell(cell_name)
    traffic, cfg = cell.traffic, cell.config
    tree = BUILDERS[cfg["scene"]](
        resolution=(traffic["width"], traffic["height"]),
        **cfg.get("args", {}))
    device = torch.device("cuda")
    job = program.JOBS[traffic["job"]](tree, traffic, seed, device,
                                       Spans(True))
    if traffic["job"] == "fit":
        job.first_steps()
    else:
        job.iterate()
        job.kept.clear()
        job.kept_ids.clear()
    torch.cuda.synchronize(device)
    before = packs()
    limit = min(seconds, TRACE_SECONDS)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0, n = time.perf_counter(), 0
        while (time.perf_counter() - t0 < limit
               or n < MIN_TRACED_ITERATIONS):
            job.iterate()
            n += 1
        torch.cuda.synchronize(device)
    counters = {k: v - before.get(k, 0) for k, v in packs().items()}
    job.release()
    path = export(prof, CACHE / "program_spans")
    summary, spans = summarize(path), read_spans(path)
    path.unlink()
    return summary, spans, counters, card_line()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    from .metrics import device_idle_pct
    summary, spans, counters, card = trace_cell(args.workload, args.seed,
                                                args.seconds)
    n = max(summary.iterations, 1)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": card,
        "iterations": summary.iterations,
        "spans_ms_per_iteration": {
            name: [1e3 * a / n, 1e3 * b / n]
            for name, (a, b) in table(summary, spans).items()},
        "spans_per_iteration": len(
            [p for p in spans if summary.window[0] <= p.start
             < summary.window[1]]) / n,
        "host_glue_ms": host_glue_ms(summary, spans),
        "idle_glue_pct": idle_glue_pct(summary, spans),
        "device_idle_pct": device_idle_pct.read(summary, None),
        "packs": counters,
        "breakdown": summary.breakdown()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
