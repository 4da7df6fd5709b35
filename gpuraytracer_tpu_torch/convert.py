"""Scenes to and from trees of numpy arrays.

The two packages hold the same scene in different containers: the JAX
package as pytrees, this one as dataclasses of ``torch`` tensors. A scene
crosses between them as a plain nested dict of numpy arrays, keyed by field
name:

    {"camera": {"position": ..., ...}, "light": {...}, "triangles": {...},
     "spheres": {...}, "sphere_lights": {...}, "box_lights": {...}}

``scene_from_numpy`` also accepts any object with those attributes whose
leaves ``numpy.asarray`` understands (so a test can hand over the other
package's ``Scene`` after mapping its leaves to numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .types import (BoxLights, Camera, Scene, SphereLights, Spheres,
                    SquareLight, TriangleScene)

_PARTS = {
    "camera": Camera, "light": SquareLight, "triangles": TriangleScene,
    "spheres": Spheres, "sphere_lights": SphereLights,
    "box_lights": BoxLights,
}


def _get(node: Any, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def scene_from_numpy(tree: Any) -> Scene:
    """Build a ``Scene`` of CPU tensors from a numpy tree, keeping every
    leaf's dtype and bits."""
    parts = {}
    for part, cls in _PARTS.items():
        node = _get(tree, part)
        parts[part] = cls(**{
            f.name: torch.from_numpy(
                np.array(np.asarray(_get(node, f.name)), order="C"))
            for f in dataclasses.fields(cls)})
    return Scene(**parts)


def scene_to_numpy(scene: Scene) -> Dict[str, Dict[str, np.ndarray]]:
    """The nested dict of numpy arrays for ``scene``."""
    return {
        part: {f.name: getattr(getattr(scene, part), f.name)
               .detach().cpu().numpy()
               for f in dataclasses.fields(cls)}
        for part, cls in _PARTS.items()}


def scenes_equal(a: Scene, b: Scene) -> bool:
    """True when two scenes have identical dtypes, shapes and bits."""
    ta, tb = scene_to_numpy(a), scene_to_numpy(b)
    return all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes()
        for part in _PARTS
        for x, y in ((ta[part][k], tb[part][k]) for k in ta[part]))
