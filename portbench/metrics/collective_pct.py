"""collective_pct: exposed communication. The share of the traced window in
which a collective's device activity runs on the card and nothing else
does; per rank, and the cell reports the ranks' mean (the cards' windows
are one barrier-to-barrier window, so this is the share of their summed
windows).

A device activity is a collective's when the launch that made it (found
through the profiler's correlation id, as ``tracing.summarize`` finds a
launch's span) was made inside one of the profiler's host operations of
``torch.distributed`` (``c10d::`` / ``nccl:`` records) on the same thread:
never by a kernel's name. Reads the run's Chrome trace
(``ctx.trace_path``); None without it, or where no collective ran on the
card (a group on the CPU). Moves ``mrays_s.4card``."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

from ..program_spans import _merge, overlap
from ..tracing import DEVICE_CATS, LAUNCH_CATS

COLLECTIVE_OPS = ("c10d::", "nccl:")


def _collective_correlations(events: List[Dict]) -> set:
    ops: Dict[Tuple, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if (e.get("cat") == "cpu_op" and "dur" in e
                and str(e.get("name", "")).startswith(COLLECTIVE_OPS)):
            ops[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + e["dur"]))
    merged = {k: _merge(v) for k, v in ops.items()}
    found = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in LAUNCH_CATS or corr is None:
            continue
        t = float(e["ts"])
        if any(s <= t <= end for s, end in
               merged.get((e.get("pid"), e.get("tid")), ())):
            found.add(corr)
    return found


def read(summary, cell):
    path = getattr(cell, "trace_path", None)
    if path is None or summary.window_s <= 0.0:
        return None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    corrs = _collective_correlations(events)
    lo, hi = summary.window
    coll, other = [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = max(float(e["ts"]), lo)
        end = min(float(e["ts"]) + e["dur"], hi)
        if end <= s:
            continue
        is_coll = e.get("args", {}).get("correlation") in corrs
        (coll if is_coll else other).append((s, end))
    if not coll:
        return None
    coll = _merge(coll)
    alone = sum(e - s for s, e in coll) - overlap(coll, _merge(other))
    return 100.0 * alone * 1e-6 / summary.window_s
