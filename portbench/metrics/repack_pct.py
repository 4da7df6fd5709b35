"""repack_pct: the packing layer's wasted work. Of the scene packs the run
has made before the reading (set-up and window: the program's ``PACKS``
counters, summed over its modules), the share whose geometry (vertices,
spheres, cull) was that of the pack before it: tables made again from what
the previous pack had. The run's first pack has no pack before it, so a run
of n packs that all repeat the geometry reads 100 (n - 1) / n. None where
the program counts no pack. Moves ``mrays_s``."""
from __future__ import annotations

from ..program_spans import packs


def read(summary, cell):
    counts = packs()
    if counts.get("scene", 0) <= 0:
        return None
    return 100.0 * counts.get("same_geometry", 0) / counts["scene"]
