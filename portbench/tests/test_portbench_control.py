"""The check's control on the card: the plain reference in bfloat16, put
in the program's place at each cell's own sizes, on three seeds, comes out
not correct. A cell on more than one card reads it on its ranks, one a
card, and skips where the machine has fewer. (Run with
``python3 -m pytest portbench/tests -m card``.)"""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS if w["chips"] == 1]
MULTI_CARD = [(w["name"], w["chips"]) for w in WORKLOADS if w["chips"] > 1]
SEEDS = [2**31 + 11, 2**31 + 12, 2**31 + 13]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check(card, cell, seed):
    from portbench import check
    from portbench.control import control_numbers
    spec_cell, numbers = control_numbers(cell, seed, device=card)
    correct, table = check.verdict(numbers, spec_cell.limits)
    assert not correct, table


@pytest.mark.card
@pytest.mark.parametrize("cell,chips", MULTI_CARD)
def test_the_bfloat16_control_fails_a_multi_card_check(card, cell, chips):
    import torch
    from portbench.ranks import launch_readings
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    lines = launch_readings(cell, SEEDS, "control", chips)
    readings = [json.loads(line) for line in lines]
    print("\n".join(lines))
    assert [r["seed"] for r in readings] == SEEDS
    assert not any(r["correct"] for r in readings), readings
