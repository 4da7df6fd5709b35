"""K6's and K7's host-side plans against their C formulas and K7's limit,
their item mappings and K7's scatter as numpy models, and the plain
records' pixel subsets and probe counts (no kernel, no JAX).

``ops/csrc/soft_kernels.cu`` sizes K6's grid and shared memory
(``grt_silh_blocks``, ``grt_silh_smem``) and K7's persistent grid and shared
memory (``grt_soft_bwd_blocks``, ``grt_soft_bwd_smem``); the wrapper mirrors
them (``cuda_soft.silh_blocks``, ``silh_smem_bytes``, ``soft_bwd_blocks``,
``soft_bwd_smem_bytes``), and ``chip_smoke.py`` holds the exported functions
against the mirrors on the card. Here the mirrors are held against the
formulas as the C source writes them, at the shapes of path J (256 x 256 x
4), of the recovery (32 x 32 x 2) and of the largest comparison frame (800 x
600 x 16), and at the most primitives the silhouette path takes.
"""
import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.ops import cuda_path, cuda_soft
from gpuraytracer_tpu_torch.render import pixel_rng_offsets
from gpuraytracer_tpu_torch.scene import cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig

SMS = 132                    # H100 SXM
SM_SMEM = 228 * 1024         # shared memory of one SM
BLOCK_RESERVED = 1024        # shared memory the runtime keeps per block
OPT_IN_MAX = 227 * 1024      # the most one block may opt in to
BWD_MIN_BLOCKS = 4           # soft_kernels.cu: K7 is compiled for 4 per SM

# (pixels, samples) of path J, the recovery and the largest comparison frame.
J, RECOVERY, FRAME = (256 * 256, 4), (32 * 32, 2), (800 * 600, 16)


# K6: one thread per (sample, pixel) item, 128 a block.
@pytest.mark.parametrize("shape, expected", [(J, 2048), (RECOVERY, 16),
                                             (FRAME, 60000), ((33 * 7, 3), 6)])
def test_k6_grid_is_the_c_formula(shape, expected):
    n, spp = shape
    assert cuda_soft.silh_blocks(n, spp) == (n * spp + 127) // 128 == expected


# (triangles, occluders, spheres) -> 4 (12 (T + n_shadow) + 4 S + T): the
# sphere scene without and with the cull, and the largest scene.
@pytest.mark.parametrize("tables, expected", [((12, 12, 2), 1232), ((12, 8, 2), 1040),
                                              ((64, 64, 127), 8432)])
def test_k6_shared_memory_is_the_c_formula(tables, expected):
    t, n_shadow, s = tables
    assert cuda_soft.silh_smem_bytes(*tables) == 4 * (12 * (t + n_shadow) + 4 * s + t)
    assert cuda_soft.silh_smem_bytes(*tables) == expected


# K7: the blocks the card holds at 4 per SM, at most one per four 32-item
# tiles; one partial row per block.
@pytest.mark.parametrize("shape, expected", [(J, 528), (RECOVERY, 16), (FRAME, 528),
                                             ((33 * 7, 3), 6)])
def test_k7_grid_is_the_c_formula(shape, expected):
    n, spp = shape
    tiles = (n * spp + 31) // 32
    blocks = cuda_soft.soft_bwd_blocks(n, spp, BWD_MIN_BLOCKS, SMS)
    assert blocks == min(SMS * BWD_MIN_BLOCKS, (tiles + 3) // 4) == expected


# primitives -> 4 (16 P + 21 + 4 (14 P + 21)): the sphere scene (12
# triangles + 2 spheres), the previous 48 KiB limit and the most the path
# takes (64 triangles + 127 spheres).
@pytest.mark.parametrize("prims, expected", [(14, 4452), (169, 49092), (191, 55428)])
def test_k7_shared_memory_is_the_c_formula(prims, expected):
    assert cuda_soft.soft_bwd_smem_bytes(prims) == (
        4 * (16 * prims + 21 + 4 * (14 * prims + 21))) == expected


@pytest.mark.parametrize("prims", [169, 191])
def test_k7_plan_takes_the_largest_scene(prims):
    # Every scene K6 takes: at most 64 triangles and 127 spheres.
    assert cuda_soft.MAX_PRIMS == cuda_path.STATIC_TIER_MAX + cuda_soft.MAX_SPHERES == 191
    smem = cuda_soft.soft_bwd_smem_bytes(prims)
    assert smem <= OPT_IN_MAX
    # The blocks per SM its shared memory allows: at least the 4 it is
    # compiled for, so that the grid at the limit is the grid at J.
    assert SM_SMEM // (smem + BLOCK_RESERVED) == 4 >= BWD_MIN_BLOCKS


@pytest.mark.parametrize("prims", [0, 192])
def test_k7_plan_raises_past_the_largest_scene(prims):
    with pytest.raises(ValueError, match="191"):
        cuda_soft.soft_bwd_smem_bytes(prims)


def k7_items(n, spp, blocks, warps=4):
    """The numpy model of K7's mapping: per warp of the grid, the items of
    its lanes in the order it takes them (warp w: tiles w, w + W, ...)."""
    items, n_warps = n * spp, blocks * warps
    tiles = (items + 31) // 32
    out = []
    for w in range(n_warps):
        mine = (np.arange(w, tiles, n_warps)[:, None] * 32 + np.arange(32)).ravel()
        out.append(mine[mine < items])
    return out


@pytest.mark.parametrize("shape", [J, RECOVERY, (33 * 7, 3)])
def test_k7_items_cover_each_sample_and_pixel_once_in_a_fixed_order(shape):
    n, spp = shape
    blocks = cuda_soft.soft_bwd_blocks(n, spp, BWD_MIN_BLOCKS, SMS)
    per_warp = k7_items(n, spp, blocks)
    every = np.concatenate(per_warp)
    assert np.array_equal(np.sort(every), np.arange(n * spp))
    assert all(np.all(np.diff(w) > 0) for w in per_warp)
    # Item n * N + i is sample n of pixel i: the records' own index.
    sample, pixel = np.divmod(every, n)
    assert sample.max() == spp - 1 and pixel.max() == n - 1


@pytest.mark.parametrize("shape", [J, RECOVERY, (33 * 7, 3)])
def test_k6_items_cover_each_sample_and_pixel_once(shape):
    n, spp = shape
    threads = np.arange(cuda_soft.silh_blocks(n, spp) * 128)
    live = threads[threads < n * spp]
    assert np.array_equal(live, np.arange(n * spp))
    assert len(threads) - len(live) < 128


def scatter_row_model(rows):
    """The numpy model of soft_kernels.cu's scatter_row for one key: rows
    [32, 10] float32 (zero on lanes without the key). Returns per lane its
    column (-1: none) and the sum it holds."""
    s = [list(r) for r in rows.astype(np.float32)]
    lo, length = np.zeros(32, int), np.full(32, 10)
    for m, off in ((10, 16), (5, 8), (3, 4), (2, 2), (1, 1)):
        h = (m + 1) // 2
        sent = []
        for lane in range(32):
            upper = lane & off
            rest = [s[lane][h + j] if h + j < m else np.float32(0) for j in range(h)]
            sent.append(s[lane][:h] if upper else rest)
        new = []
        for lane in range(32):
            upper = lane & off
            rest = [s[lane][h + j] if h + j < m else np.float32(0) for j in range(h)]
            own = rest if upper else s[lane][:h]
            new.append([np.float32(a + b) for a, b in zip(own, sent[lane ^ off])])
            if upper:
                lo[lane] += h
                length[lane] = max(length[lane] - h, 0)
            else:
                length[lane] = min(length[lane], h)
        s = new
    return np.where(length > 0, lo, -1), np.array([v[0] for v in s], np.float32)


@pytest.mark.parametrize("lanes", [32, 23, 1])
def test_k7_scatter_gives_each_column_to_one_lane(lanes):
    rng = np.random.default_rng(lanes)
    rows = np.zeros((32, 10), np.float32)
    rows[rng.choice(32, lanes, replace=False)] = rng.standard_normal((lanes, 10))
    column, held = scatter_row_model(rows)
    assert sorted(column[column >= 0]) == list(range(10))
    for c in range(10):
        assert held[column == c][0] == pytest.approx(rows[:, c].astype(np.float64).sum(),
                                                     rel=1e-5, abs=1e-5)


def test_plain_records_of_some_pixels_and_their_probe_counts():
    cfg = RenderConfig(width=16, height=12, spp=2, integrator="direct", bounces=1)
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    packed = cuda_path._pack_inputs(scene, cfg)
    shadow_idx = cuda_path.shadow_indices(None, scene.triangles.num_triangles, "cpu")
    offsets = pixel_rng_offsets(cfg, "cpu")
    whole = cuda_soft.silh_records_plain(offsets, packed, shadow_idx, cfg)
    pix = torch.arange(0, cfg.num_pixels, 13)
    stats = {}
    some = cuda_soft.silh_records_plain(offsets[pix], packed, shadow_idx,
                                        cfg.replace(pixel_chunk=pix.numel()),
                                        pix=pix, stats=stats)
    assert torch.equal(some, whole[:, pix])
    # Two probes per item; the blocked ones are the records' shadow bits.
    _, occ_b, occ_s, _, _, _ = cuda_soft._decode(some)
    assert stats["blocked"] == int(occ_b.sum() + occ_s.sum())
    assert stats["reached"] + stats["blocked"] == 2 * some.numel()
    assert stats["triangles"] == stats["reached"] * len(shadow_idx)
    # In the box the planes of the walls lie behind the shading point or
    # beyond the light: few tests, if any, pass both prefilters.
    assert 0 <= stats["passed"] <= stats["triangles"]
