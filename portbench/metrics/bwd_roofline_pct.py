"""bwd_roofline_pct: a fit step's backward pass's share of its roofline.

The work is ``bwd_work.count``; the time is the device time of everything
launched inside the loop's ``backward`` span (``loss.backward()``), per
step. None in a frame cell, which has no backward. Moves ``mrays_s``."""
from __future__ import annotations

from . import bwd_work
from ._share import roofline_pct


def read(summary, cell):
    ops, nbytes = bwd_work.count(cell.traffic, cell.num_triangles)
    return roofline_pct(summary, "backward", ops, nbytes)
