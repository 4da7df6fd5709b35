"""A roofline share: the fixed work of the iterations a trace holds over
the device time of the activity launched in one span of the loop."""
from __future__ import annotations

from typing import Optional

from ..peaks import roofline_seconds


def roofline_pct(summary, span: str, ops: int, nbytes: int) -> Optional[float]:
    times = [t for t in summary.span_device_seconds(span) if t > 0.0]
    if not times:
        return None
    return 100.0 * roofline_seconds(ops, nbytes) * len(times) / sum(times)
