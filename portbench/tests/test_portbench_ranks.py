"""A cell on four cards, run on the CPU: four ranks over gloo at a tiny
size, through the launcher the command uses. The sharded fit comes out
correct and takes the same first three steps as the one-process fit; each
planted fault comes out not correct; a rank that fails ends the run with no
result; ``run.main`` hands the cell to the launcher and prints rank 0's
line."""
from __future__ import annotations

import io
import json
import re

import pytest
import torch

CELL = "cornell.path_fit_4card"
TINY = dict(width=32, height=32, spp=4, bounces=2)
SEED = 2**31 + 77


def _launch(trace=False, fault=None, override=TINY, seconds=0.2):
    from portbench import ranks
    err = io.StringIO()
    result = ranks.launch_run(CELL, SEED, seconds, trace, 4, device="cpu",
                              fault=fault, traffic_override=override,
                              err=err)
    return result, err.getvalue()


def test_four_ranks_fit_as_one_process():
    from portbench import program, spec
    from portbench.scenes import BUILDERS
    from portbench.tracing import Spans
    result, log = _launch()
    assert result is not None, log
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"mrays_s.4card", "step_p95_ms",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    losses = [json.loads(m) for m in
              re.findall(r"first three losses: (\[.*\])", log)]
    assert len(losses) == 4 and all(x == losses[0] for x in losses)
    traffic = dict(spec.load_cell(CELL).traffic, job="fit", **TINY)
    tree = BUILDERS["cornell_box"](resolution=(32, 32))
    job = program.FitJob(tree, traffic, SEED, torch.device("cpu"),
                         Spans(False))
    one = job.first_steps()["losses"]
    assert losses[0][0] == one[0]  # the gathered image is bit-equal
    assert losses[0] == pytest.approx(one, rel=1e-6, abs=0.0)


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch",
                                   "altered_answer"])
def test_a_broken_sharded_step_comes_out_not_correct(fault):
    result, log = _launch(fault=fault)
    assert result is not None, log
    assert result["correct"] is False, result["checks"]


def test_a_traced_run_reads_every_rank():
    result, log = _launch(trace=True)
    assert result is not None, log
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert "breakdown" in result
    # On the CPU nothing runs on a card: the trace's device readers find
    # nothing; the packing counter and the one-card step do.
    assert set(result["metrics"]) == {"repack_pct.4card",
                                      "scaling_pct.4card"}
    assert 0.0 < result["metrics"]["scaling_pct.4card"]["value"]


def test_a_failing_rank_ends_the_run_with_no_result():
    result, log = _launch(override=dict(TINY, width=31, height=31))
    assert result is None
    assert "no result: rank" in log


def test_the_command_hands_the_cell_to_the_launcher(monkeypatch, capsys):
    from portbench import ranks, run
    real = ranks.launch_run

    def on_cpu(name, seed, seconds, trace, world, **kw):
        return real(name, seed, seconds, trace, world, device="cpu",
                    traffic_override=TINY, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(ranks, "launch_run", on_cpu)
    assert run.main(["--workload", CELL, "--seed", str(SEED),
                     "--seconds", "0.2"]) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["correct"] is True and last["device"]["count"] == 4
    assert err.strip().splitlines()[-1].startswith("check change3_gap")


def test_fewer_cards_than_the_cell_asks_give_no_result(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds",
                     "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no result" in err
