"""The work counts of the roofline shares: each cell's count held to a hand
value from its shapes, and a signature that names no tier, kernel or
launch, so the count is the same whichever kernels the program runs."""
from __future__ import annotations

import ast
import inspect

import pytest

from portbench import spec
from portbench.metrics import bwd_work, fwd_work
from portbench.rays import nominal_rays

# (rays, forward operations, forward bytes, backward operations, backward
# bytes) worked out by hand from the shapes below.
CELLS = {
    # 800x600 x 400 spp x 3 bounces, 36 triangles: 1,152,000,000 rays x 44
    # + 192,000,000 (pixel, sample) x (22 + 3 x 116).
    "cornell.path_frame": (1_152_000_000, 50_688_000_000 + 71_040_000_000,
                           36 * 68 + 5_760_000, None, None),
    # 512x512 x 6 camera rays x 300 samples, 1,002 triangles:
    # 1,572,864 x 501 rays; 1,572,864 x (31 + 100 x 847) shading.
    "tess1002.mis_fit": (788_004_864, 788_004_864 * 44 + 133_270_339_584,
                         1002 * 68 + 3_145_728, 133_270_339_584,
                         3_145_728 + 2 * 1002 * 68),
    # 512x512 x 16 spp x 3 bounces: 4,194,304 x (22 + 348) shading.
    "tess1002.path_fit": (25_165_824, 25_165_824 * 44 + 1_551_892_480,
                          1002 * 68 + 3_145_728, 1_551_892_480,
                          3_145_728 + 2 * 1002 * 68),
    "cornell.mis_fit": (788_004_864, 788_004_864 * 44 + 133_270_339_584,
                        36 * 68 + 3_145_728, 133_270_339_584,
                        3_145_728 + 2 * 36 * 68),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_cells_count_equals_its_hand_value(name):
    cell = spec.load_cell(name)
    tris = cell.config["triangles"]
    rays, f_ops, f_bytes, b_ops, b_bytes = CELLS[name]
    assert nominal_rays(cell.traffic) == rays
    assert fwd_work.count(cell.traffic, tris) == (f_ops, f_bytes)
    if b_ops is not None:
        assert bwd_work.count(cell.traffic, tris) == (b_ops, b_bytes)


@pytest.mark.parametrize("count", [fwd_work.count, bwd_work.count])
def test_counts_take_the_shapes_and_nothing_of_the_kernels(count):
    assert list(inspect.signature(count).parameters) == [
        "traffic", "num_triangles"]
    # No name in the module's code (docstrings aside) refers to them.
    tree = ast.parse(inspect.getsource(inspect.getmodule(count)))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} | {
        a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
        for a in n.names} | {
        n.module or "" for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom)}
    for name in names:
        for word in ("tier", "grouped", "launch", "kernel", "share",
                     "prefilter", "gpuraytracer"):
            assert word not in name.lower(), name
