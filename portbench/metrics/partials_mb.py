"""partials_mb: the partial tables of the backward kernel, MB a launch.

K3 and K3g scatter each warp's (K3: each block's) gradient rows into a
partial table of their own, then reduce the tables: a launch zeroes,
scatters into and reads all of them. Read from the program's ``PARTIALS``
counter (``ops.cuda_shade``): its bytes over its launches, the run's counts
at the reading, set-up included. None where the program has no such counter
or counted no launch. Moves the cell's rate."""
from __future__ import annotations


def read(summary, cell):
    from gpuraytracer_tpu_torch.ops import cuda_shade
    counts = getattr(cuda_shade, "PARTIALS", {})
    if counts.get("launches", 0) <= 0:
        return None
    return counts["bytes"] / counts["launches"] / 1e6
