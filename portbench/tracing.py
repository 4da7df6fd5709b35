"""The benchmark's spans and the reduction of a profiler trace.

The loop marks each call into a layer with ``Spans.span(name)``: a
``torch.profiler.record_function`` in a traced run, nothing otherwise. A
traced run's Chrome trace is reduced to a ``TraceSummary``: every device
activity (kernels, copies, fills) with the span its launch was made in (the
launch is found through the profiler's correlation id), the spans
themselves, and the traced window. Kernels are never matched by name.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "portbench."


class Spans:
    def __init__(self, traced: bool) -> None:
        self.traced = traced

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Activity:
    name: str
    start: float  # microseconds
    end: float
    span: Optional[str]  # the benchmark's span the launch was made in
    span_index: int  # which occurrence of that span


@dataclasses.dataclass
class TraceSummary:
    activities: List[Activity]
    spans: List[Tuple[str, float, float]]  # (name, start, end), in order
    window: Tuple[float, float]
    iterations: int
    unattributed: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the window, merged."""
        lo, hi = self.window
        ivs = sorted((max(a.start, lo), min(a.end, hi))
                     for a in self.activities if a.end > lo and a.start < hi)
        merged: List[List[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def span_device_seconds(self, span: str) -> List[float]:
        """Device seconds of the activity launched in each occurrence of
        ``span``."""
        count = sum(1 for n, _, _ in self.spans if n == span)
        out = [0.0] * count
        for a in self.activities:
            if a.span == span:
                out[a.span_index] += (a.end - a.start) * 1e-6
        return out

    def host_span_at(self, t: float) -> str:
        i = bisect.bisect_right([s for _, s, _ in self.spans], t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return "outside the benchmark's spans"

    def breakdown(self) -> Dict:
        per_op: Dict[str, float] = defaultdict(float)
        for a in self.activities:
            per_op[a.name] += (a.end - a.start) * 1e-6
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_span_at(s), (e - s) * 1e-6]
                              for s, e in gaps[:10]]}


def summarize(trace_path: Path) -> TraceSummary:
    """Reduce an exported Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        ((e["name"][len(PREFIX):], float(e["ts"]), float(e["ts"]) + e["dur"])
         for e in events
         if e.get("cat") == "user_annotation"
         and str(e.get("name", "")).startswith(PREFIX) and "dur" in e),
        key=lambda span: span[1])
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    occurrence = defaultdict(int)
    indexed = []
    for name, s, t_end in spans:
        indexed.append((name, s, t_end, occurrence[name]))
        occurrence[name] += 1

    starts = [s for _, s, _, _ in indexed]

    def locate(t: float):
        # The spans follow one another on the loop's one thread.
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < indexed[i][2]:
            return indexed[i][0], indexed[i][3]
        return None, -1

    acts, unattributed = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        span, k = locate(launch) if launch is not None else (None, -1)
        unattributed += span is None
        acts.append(Activity(e["name"], float(e["ts"]),
                             float(e["ts"]) + e["dur"], span, k))
    window = ((spans[0][1], spans[-1][2]) if spans else (0.0, 0.0))
    iterations = occurrence.get("forward", 0)
    return TraceSummary(acts, [(n, s, e) for n, s, e in spans], window,
                        iterations, unattributed)


def export(prof, directory: Path) -> Path:
    """Write the profiler's Chrome trace to a fixed file of ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "trace.json"
    if path.exists():
        os.remove(path)
    prof.export_chrome_trace(str(path))
    return path
