"""The harness end to end on the CPU, at tiny sizes: it finds a new
configuration, traffic mix and metric by name alone; ``--trace 0`` and
``--trace 1`` print the contract's last line; without a card the command
fails and prints no result."""
from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from conftest import ROOT

TINY = {
    "cornell.path_frame": dict(width=24, height=16, spp=2),
    "tess1002.path_fit": dict(width=12, height=12, spp=2),
    "tess1002.mis_fit": dict(width=8, height=8, camera_rays=1,
                             mis_samples=6),
    "cornell.mis_fit": dict(width=12, height=12, camera_rays=2,
                            mis_samples=6),
}


def test_a_cell_of_new_files_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "cornell.json").read_text())
    (pb / "configs" / "cornell_small.json").write_text(json.dumps(
        dict(cfg, notes="a copy under another name")))
    (pb / "traffic" / "path_tiny.json").write_text(json.dumps(dict(
        job="frame", kernel="cuda", integrator="path", width=16, height=12,
        spp=2, bounces=2)))
    (pb / "metrics" / "traced_iterations.py").write_text(
        "def read(summary, cell):\n    return float(summary.iterations)\n")
    (pb / "limits" / "cornell_small.path_tiny.json").write_text(
        json.dumps({"frame_rel_l1": 1e-3}))
    bench["configs"].append(dict(bench["configs"][0], name="cornell_small",
                                 file="portbench/configs/cornell_small.json"))
    bench["workloads"].append(dict(name="cornell_small.path_tiny",
                                   config="cornell_small",
                                   traffic="path_tiny", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="traced_iterations", unit="count", better="higher",
        source="device_trace", layer="entry and loop", moves="mrays_s",
        workloads=["cornell_small.path_tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"r = run.run('cornell_small.path_tiny', 5, 0.2, True, "
        f"device='cpu', root=__import__('pathlib').Path({str(tmp_path)!r}),"
        " log=lambda *a: None)\n"
        "print(run.__file__)\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, check=True)
    where, line = out.stdout.strip().splitlines()[-2:]
    assert where.startswith(str(tmp_path))
    result = json.loads(line)
    assert result["correct"] is True
    assert result["metrics"]["traced_iterations"]["value"] >= 3


@pytest.mark.parametrize("trace", [0, 1])
def test_the_command_prints_the_contracts_last_line(monkeypatch, trace):
    from portbench import run
    real = run.run
    cell = "tess1002.path_fit"

    def on_cpu(name, seed, seconds, traced):
        return real(name, seed, seconds, traced, device="cpu",
                    traffic_override=TINY[name])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", on_cpu)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(2**31 + 99),
                       "--seconds", "0.2", "--trace", str(trace)])
    assert rc == 0
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    # A one-card cell's line has the keys it had before the launcher of
    # multi-card cells, in the same order.
    assert list(last) == (["correct", "attempted", "failed"]
                          + ["breakdown"] * trace
                          + ["metrics", "device", "checks"])
    assert list(last["device"]) == (["platform", "kind", "count",
                                     "memory_peak_bytes"]
                                    + ["busy_s", "window_s"] * trace)
    assert last["device"]["count"] == 1
    assert last["correct"] is True
    names = set(last["metrics"])
    if trace:
        assert "breakdown" in last
        assert {"busy_s", "window_s"} <= set(last["device"])
    else:
        assert names == {"mrays_s.host_bound", "step_p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in last["metrics"].values())


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cornell.path_frame", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in sorted(TINY)
    for fault in (None, "frozen_step", "half_batch", "altered_answer")
    # A frame has no state to step.
    if not (fault == "frozen_step" and cell.endswith("frame"))])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault):
    """The rest of a run, on the program's CPU path, with the timed path
    broken underneath: a step that leaves its state unchanged, half of the
    batch left out with the mean over the rest (a frame: half the
    samples), an answer altered where it is made. Sound, it is correct."""
    from portbench import run
    result = run.run(cell, 2**31 + 7, 0.1, False, device="cpu",
                     fault=fault, traffic_override=TINY[cell],
                     log=lambda *a: None)
    assert result["correct"] is (fault is None), result["checks"]
