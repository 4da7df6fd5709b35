"""scaling_pct: scaling efficiency from one card to the cell's cards,
100 t1 / (n t_n), for the same traffic (BASELINE.json's "rays/s scaling
efficiency 1->N", within one host). t_n is the traced window's mean step
(its length over its steps); t1 the mean step of the same traffic on one
card alone, through the one-card fit (``grad.inverse.fast_pixel_loss``),
timed after the window by ``ranks.one_card_step_s`` on rank 0
(``ctx.one_card_step_s``). Recorded, not gated: the traced step carries
the profiler's cost. None on a rank that did not time t1. Moves
``mrays_s.4card``."""
from __future__ import annotations


def read(summary, cell):
    one = getattr(cell, "one_card_step_s", None)
    if one is None or summary.iterations <= 0 or summary.window_s <= 0.0:
        return None
    step = summary.window_s / summary.iterations
    return 100.0 * one / (cell.ranks * step)
