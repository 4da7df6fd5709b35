"""The shared-memory plans of the MIS grouped pair (K4g, K5g) on the CPU.

``cuda_mis.grouped_smem_bytes`` and ``cuda_mis_bwd.grouped_smem_bytes`` are
the wrappers' mirrors of the C sides' ``grouped_smem`` (``ops/csrc/
mis_kernels.cu``, ``ops/csrc/mis_bwd_kernels.cu``), which the libraries export
as ``grt_mis_grouped_smem`` and ``grt_mis_bwd_grouped_smem``; ``chip_smoke.py``
holds the two against each other on the card. Here the mirrors are held
against the C formulas with the numbers written out, at the shapes of paths M
and N (1,002 and 12,802 triangles, 642 and 10,242 of them in the culled
shadow table: 8 / 6 and 101 / 81 supers of 128 triangles) and past the most
one block may use. No kernel runs.
"""
import pytest

from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_mis_bwd
from gpuraytracer_tpu_torch.ops.cuda_path import GROUP, SUPER

LIMIT = 227 * 1024  # one block's most on sm_90

# Paths M and N: triangles, shadow-table triangles, spheres.
PATHS = {"M": (1002, 642, 0), "M+spheres": (1002, 642, 2), "N": (12802, 10242, 0)}
S_PER = 100  # 300 MIS samples: 100 per strategy


def supers(n):
    return -(-n // (SUPER * GROUP))


def test_supers_of_the_paths():
    assert [supers(n) for n in (1002, 642, 12802, 10242)] == [8, 6, 101, 81]


@pytest.mark.parametrize("path, wide", [("M", False), ("N", True)])
def test_k4g_takes_the_wide_sweep_above_32_supers(path, wide):
    assert (supers(PATHS[path][0]) > cuda_mis.WIDE_SUPERS) is wide


@pytest.mark.parametrize("path", sorted(PATHS))
def test_k4g_plan_accepts_the_paths(path):
    tris, shadow, spheres = PATHS[path]
    smem = cuda_mis.grouped_smem_bytes(S_PER, spheres, supers(tris), supers(shadow))
    assert 0 < smem <= LIMIT


# (s_per, spheres, n_super, n_shadow_super) -> bytes: 4 (16 s_per + 4 S)
# + 16 x 18 (n_super + n_shadow_super): a super and its eight groups, two
# float4 a box.
@pytest.mark.parametrize("shape, expected", [
    ((100, 0, 101, 81), 4 * 1600 + 16 * 18 * 182),
    ((100, 2, 8, 6), 4 * (1600 + 8) + 16 * 18 * 14),
    ((4, 0, 1, 1), 4 * 64 + 16 * 18 * 2),
])
def test_k4g_plan_is_the_c_formula(shape, expected):
    assert cuda_mis.grouped_smem_bytes(*shape) == expected
    assert expected == {(100, 0, 101, 81): 58816, (100, 2, 8, 6): 10464,
                        (4, 0, 1, 1): 832}[shape]


@pytest.mark.parametrize("shape", [(3000, 0, 101, 81), (100, 0, 400, 400)])
def test_k4g_plan_raises_past_the_limit(shape):
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_mis.grouped_smem_bytes(*shape)


@pytest.mark.parametrize("ndif", [10, 15])
def test_k5g_plan_accepts_the_paths(ndif):
    assert 0 < cuda_mis_bwd.grouped_smem_bytes(S_PER, ndif) <= LIMIT


# (s_per, ndif) -> bytes: 4 (16 s_per + 29 + 128 threads x (105 + 2 ndif)).
@pytest.mark.parametrize("shape, expected", [
    ((100, 10), 4 * (1600 + 29 + 128 * 125)),
    ((100, 15), 4 * (1600 + 29 + 128 * 135)),
    ((6, 15), 4 * (96 + 29 + 128 * 135)),
])
def test_k5g_plan_is_the_c_formula(shape, expected):
    assert cuda_mis_bwd.grouped_smem_bytes(*shape) == expected
    assert cuda_mis_bwd.grouped_state_floats(shape[1]) % 2 == 1  # odd stride
    assert expected == {(100, 10): 70516, (100, 15): 75636, (6, 15): 69620}[shape]


def test_k5g_plan_raises_past_the_limit():
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_mis_bwd.grouped_smem_bytes(3000, 15)
