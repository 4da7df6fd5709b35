"""K3g's partial tables and the closest-hit sweep's form at the sizes of the
tessellated box (no kernel, no JAX).

``cuda_shade.PARTIALS`` counts, at every launch of K3 or K3g, the bytes of
its partial tables, its grid's blocks and the blocks it would run without
K3g's 768 MiB cap on those tables (``full_blocks``). Here the plan and the
count are held at 512x512 on a 132-SM card at 4 blocks an SM: at 12,802
primitives (``cornell_box_tessellated(16, 4)``) the cap binds, at 1,002
(``(6, 2)``) it does not. The trace takes its wide closest-hit sweep above
``WIDE_SUPERS`` supers (``csrc/path_kernels.cu``): the packed tables of the
larger scene have more, those of the smaller one fewer.
"""
import pytest
import torch

from gpuraytracer_tpu_torch import RenderConfig, scene
from gpuraytracer_tpu_torch.ops import cuda_path, cuda_shade

PIXELS = 512 * 512
SMS = 132       # H100 SXM
PER_SM = 4      # K3g's blocks an SM (PERF.md's kernel table, rows K and L)


# primitives -> (blocks, blocks without the cap); a warp's table is P * 10 +
# 21 floats, four warps a block: 2,048,656 B a block at 12,802 (768 MiB /
# 2,048,656 = 393.1), 160,656 B at 1,002.
@pytest.mark.parametrize("prims, blocks, full, block_bytes", [
    (12802, 393, 528, 4 * 4 * (12802 * 10 + 21)),
    (1002, 528, 528, 4 * 4 * (1002 * 10 + 21)),
])
def test_partials_count_the_tables_and_the_cut_grid(prims, blocks, full,
                                                    block_bytes):
    assert cuda_shade.full_blocks(PIXELS, PER_SM, SMS) == full
    got = cuda_shade.grouped_blocks(PIXELS, prims, False, PER_SM, SMS)
    assert got == blocks
    assert (full * block_bytes > 768 << 20) == (blocks < full)
    # The tables a launch of that grid allocates, one per warp (shape
    # alone: a meta tensor holds no memory).
    partials = torch.empty((blocks * 4, prims * cuda_shade.NTAB
                            + cuda_shade.NSCAL), dtype=torch.float32,
                           device="meta")
    before = dict(cuda_shade.PARTIALS)
    cuda_shade.count_partials(partials, blocks, full)
    added = {k: v - before[k] for k, v in cuda_shade.PARTIALS.items()}
    assert added == {"launches": 1, "bytes": blocks * block_bytes,
                     "blocks": blocks, "blocks_full": full}
    assert added["bytes"] == {12802: 805_121_808, 1002: 84_826_368}[prims]


@pytest.mark.parametrize("subdiv, wide", [((16, 4), True), ((6, 2), False)])
def test_the_larger_box_keeps_the_wide_sweep(subdiv, wide):
    sc = scene.cornell_box_tessellated(resolution=(512, 512),
                                       wall_subdiv=subdiv[0],
                                       sphere_subdiv=subdiv[1])
    cfg = RenderConfig(width=512, height=512, spp=16, bounces=3)
    grp = cuda_path._pack_inputs(sc, cfg, grouped=True).grouped
    n_super = grp.sup.shape[1]
    assert n_super == -(-grp.num_tris // (cuda_path.SUPER * cuda_path.GROUP))
    assert (n_super > cuda_path.WIDE_SUPERS) == wide
    assert n_super == {True: 101, False: 8}[wide]
