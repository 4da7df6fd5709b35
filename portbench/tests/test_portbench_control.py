"""The check's control on the card: the plain reference in bfloat16, put
in the program's place at each cell's own sizes, on three seeds, comes out
not correct. (Run with ``python3 -m pytest portbench/tests -m card``.)"""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check(card, cell, seed):
    from portbench import check
    from portbench.control import control_numbers
    spec_cell, numbers = control_numbers(cell, seed, device=card)
    correct, table = check.verdict(numbers, spec_cell.limits)
    assert not correct, table
