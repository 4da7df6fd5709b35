"""K3's and K3g's host-side plans against their C formulas, and the
wrapper's limits (no kernel, no JAX).

``ops/csrc/shade_kernels.cu`` sizes a block's shared memory
(``grt_shade_bwd_smem``) and K3g's persistent grid
(``grt_shade_bwd_grouped_blocks``); the wrapper
mirrors them (``cuda_shade.static_smem_bytes``, ``grouped_smem_bytes``,
``grouped_blocks``), and ``chip_smoke.py`` holds the
exported functions against the mirrors on the card. Here the mirrors are
held against the formulas as the C source writes them, at the shapes of
paths D (36 triangles), E (12 triangles + 2 spheres), K (1,002 triangles)
and L (12,802), and at the static scenes that phase grouped forces onto K3g.
"""
import pytest
import torch

from gpuraytracer_tpu_torch.ops import cuda_shade
from gpuraytracer_tpu_torch.types import RenderConfig

LIMIT = 48 * 1024
PIXELS = 512 * 512  # paths D, K and L
SMS = 132           # H100 SXM


# (primitives, spheres?) -> 4 (rows P + 21 + 4 (P ntab + 21) + 128 stage):
# the table, the scalars, the four warps' tables and scalars, the peer
# scatter's staging rows (11 or 15 floats a thread).
@pytest.mark.parametrize("shape, expected", [
    ((36, False), 4 * (11 * 36 + 21 + 4 * (36 * 10 + 21) + 128 * 11)),
    ((14, True), 4 * (16 * 14 + 21 + 4 * (14 * 14 + 21) + 128 * 15)),
    ((64, False), 4 * (11 * 64 + 21 + 4 * (64 * 10 + 21) + 128 * 11)),
])
def test_k3_plan_is_the_c_formula(shape, expected):
    assert cuda_shade.static_smem_bytes(*shape) == expected
    assert expected == {(36, False): 13396, (14, True): 12132,
                        (64, False): 19108}[shape]


# The static tier takes a scene whose tables (all but the staging rows) fit
# 48 KiB: with spheres up to 169 primitives, 4 (16 P + 21 + 4 (14 P + 21)) =
# 49,092 B at 169 and 49,380 B at 170.
@pytest.mark.parametrize("prims", [170, 200])
def test_k3_plan_raises_past_48_kib(prims):
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_shade.static_smem_bytes(prims, True)


def test_k3_plan_takes_the_largest_static_scene_with_spheres():
    # 49,092 B of tables and 7,680 B of staging rows: past 48 KiB, so the
    # launch opts in; 4 blocks of it fit an SM's 228 KiB.
    smem = cuda_shade.static_smem_bytes(169, True)
    assert smem == 4 * (16 * 169 + 21 + 4 * (169 * 14 + 21) + 128 * 15) == 56772
    assert smem - 4 * 128 * 15 <= LIMIT < smem
    assert 4 * (smem + 1024) <= 228 * 1024


# spheres? -> 4 * 128 stage: the staging rows of the peer scatter, whatever
# the primitive count.
@pytest.mark.parametrize("sph, expected", [(False, 4 * 128 * 11), (True, 4 * 128 * 15)])
def test_k3g_plan_is_the_c_formula(sph, expected):
    assert cuda_shade.grouped_smem_bytes(sph) == expected
    assert expected == {False: 5632, True: 7680}[sph]


# K3g's grid: at 4 blocks per SM K holds every resident block; at L the 768
# MiB cap on the tables of P ntab + 21 floats binds (768 2^20 / (16 *
# 128,041) = 393.1); a small frame takes one block per 4 tiles.
@pytest.mark.parametrize("shape, expected", [
    ((PIXELS, 1002, False, 4), 528),
    ((PIXELS, 12802, False, 4), 393),
    ((128 * 96, 252, False, 4), 96),
    ((PIXELS, 12802, False, 2), 264),
    ((PIXELS, 1002, True, 3), 396),
    ((33, 1002, True, 4), 1),
])
def test_k3g_grid_is_the_c_formula(shape, expected):
    n, prims, sph, per_sm = shape
    assert cuda_shade.grouped_blocks(n, prims, sph, per_sm, SMS) == expected


@pytest.mark.parametrize("grouped", [False, True])
def test_wrapper_refuses_cpu_tensors(grouped):
    cfg = RenderConfig(width=4, height=2, spp=1, bounces=2)
    n = cfg.num_pixels
    before = dict(cuda_shade.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_shade.shade_bwd_kernel(
            torch.zeros((3, n)), torch.zeros((1, 2, n), dtype=torch.int32),
            None, torch.zeros(n, dtype=torch.int32),
            torch.zeros((cuda_shade.NROWS_TAB, 36)), torch.zeros(12),
            torch.zeros(9), cfg, grouped=grouped)
    assert cuda_shade.LAUNCHES == before
