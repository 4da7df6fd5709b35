"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is ``configs/<name>.json`` (the scene builder and its
arguments, the source, what was assumed), the traffic is
``traffic/<name>.json`` (the job, the integrator, its sizes, the parameters
and optimizer of a fit), the limits of the correctness check are
``limits/<cell>.json``, and each per-layer metric is the module
``metrics/<name>.py`` (the name before its first dot). Nothing here knows
a cell by name: a new cell, mix, configuration or metric is a new file and
a new entry.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT,
              bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError`` for
    an unknown cell."""
    bench = bench if bench is not None else _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = root / HERE.name
    config = _read(here / "configs" / f"{entry['config']}.json")
    traffic = _read(here / "traffic" / f"{entry['traffic']}.json")
    limits = _read(here / "limits" / f"{name}.json")

    def metrics(key: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"])
                for m in bench[key] if _applies(m, name)]

    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def base_name(name: str) -> str:
    """A metric's quantity: its name before the first dot. A quantity
    whose cells move different end-to-end metrics is split by a suffix
    (``fwd_roofline_pct.host_bound``); the parts share one reader."""
    return name.split(".")[0]


def metric_reader(name: str):
    """``metrics/<quantity>.py``'s ``read`` function."""
    return importlib.import_module(
        f"{__package__}.metrics.{base_name(name)}").read
