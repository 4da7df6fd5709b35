"""bwd_grid_pct: the backward kernel's grid as a share of the grid the card
would run without the cap on its partial tables.

K3g runs a persistent grid of as many blocks as the card holds at once (or
as the pixels fill), cut so that its per-warp partial tables stay within
their cap (768 MiB); K3's grid has no cap. Read from the program's
``PARTIALS`` counter (``ops.cuda_shade``): 100 x its blocks over the blocks
without the cap, the run's counts at the reading, set-up included. None
where the program has no such counter or counted no launch. Moves the
cell's rate."""
from __future__ import annotations


def read(summary, cell):
    from gpuraytracer_tpu_torch.ops import cuda_shade
    counts = getattr(cuda_shade, "PARTIALS", {})
    if counts.get("launches", 0) <= 0 or counts.get("blocks_full", 0) <= 0:
        return None
    return 100.0 * counts["blocks"] / counts["blocks_full"]
