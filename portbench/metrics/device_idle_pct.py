"""device_idle_pct: the share of the traced window in which no kernel, copy
or fill runs on the card. Moves ``mrays_s``."""
from __future__ import annotations


def read(summary, cell):
    if summary.window_s <= 0.0 or not summary.activities:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
