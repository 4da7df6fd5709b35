"""fwd_roofline_pct: the forward render's share of its roofline.

The work is ``fwd_work.count``; the time is the device time of everything
launched inside the loop's ``forward`` span (the program's render call),
per iteration. Moves ``mrays_s``."""
from __future__ import annotations

from . import fwd_work
from ._share import roofline_pct


def read(summary, cell):
    ops, nbytes = fwd_work.count(cell.traffic, cell.num_triangles)
    return roofline_pct(summary, "forward", ops, nbytes)
