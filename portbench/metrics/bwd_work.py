"""The work of one backward pass, from the cell's shapes and scene alone.

The reverse of the forward's shading (``fwd_work.shading_ops``), charged one
operation for each forward one; no traversal is charged, since the backward
needs none. Bytes: the image's cotangent, the scene and the gradients of the
parameters, each once (float32)."""
from __future__ import annotations

from typing import Dict, Tuple

from .fwd_work import SCENE_BYTES_PER_TRIANGLE, shading_ops


def count(traffic: Dict, num_triangles: int) -> Tuple[int, int]:
    """(operations, bytes) of one backward pass."""
    image = traffic["width"] * traffic["height"] * 3 * 4
    scene = num_triangles * SCENE_BYTES_PER_TRIANGLE
    return shading_ops(traffic), image + 2 * scene
