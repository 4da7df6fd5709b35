"""Scene construction: Cornell box with every constant from the reference.

Counterpart of ``gpuraytracer_tpu/scene.py``. Construction runs on the host
in numpy (float32, the same operations in the same order, so the two
packages build bit-identical scenes); the result is a ``Scene`` of CPU
``torch`` tensors — move it with ``scene.to(device)``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .types import (Camera, Scene, Spheres, SquareLight, TriangleScene,
                    empty_box_lights, empty_sphere_lights, empty_spheres)

_F = np.float32


def _t(x) -> torch.Tensor:
    """numpy array or scalar -> CPU tensor of the same dtype."""
    return torch.from_numpy(np.array(x, order="C"))


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def make_camera(
    position=(0.0, 0.0, 9.0),
    look_at=(0.0, 0.0, -2.5),
    up=(0.0, 1.0, 0.0),
    resolution=(800, 600),
    horizontal_fov=math.pi / 4.0,
    ev100=5.0,
) -> Camera:
    """Camera looking into the room from the front (scene.swift:14-18)."""
    position = np.asarray(position, _F)
    direction = _normalize(np.asarray(look_at, _F) - position)
    return Camera(
        position=_t(position),
        direction=_t(direction),
        up=_t(np.asarray(up, _F)),
        resolution=_t(np.asarray(resolution, np.int32)),
        horizontal_fov=_t(_F(horizontal_fov)),
        ev100=_t(_F(ev100)),
    )


def photometric_luminance(
    diffuse_rgb: np.ndarray, luminous_efficacy: float, watts: float,
    width: float, depth: float,
) -> np.ndarray:
    """lm -> cd/m^2 conversion (scene.swift:257-270): luminance =
    (efficacy*watts) / area / pi, tinted by the material diffuse."""
    luminous_flux = luminous_efficacy * watts
    area = width * depth
    luminance = luminous_flux / area / math.pi
    return np.asarray(diffuse_rgb, _F) * _F(luminance)


def make_square_light(
    center=(0.0, 2.49, 0.0),
    width: float = 1.0,
    depth: float = 1.0,
    diffuse=(1.0, 0.95, 0.9),
    luminous_efficacy: float = 100.0,
    watts: float = 12.0,
    normal=(0.0, -1.0, 0.0),
) -> SquareLight:
    """Ceiling light, warm white bulb (scene.swift:23-53)."""
    diffuse = np.asarray(diffuse, _F)
    return SquareLight(
        center=_t(np.asarray(center, _F)),
        color=_t(diffuse),
        emitted_radiance=_t(photometric_luminance(
            diffuse, luminous_efficacy, watts, width, depth)),
        width=_t(_F(width)),
        depth=_t(_F(depth)),
        normal=_t(np.asarray(normal, _F)),
    )


class _TriBuilder:
    """Accumulates triangles + per-triangle materials into SoA arrays."""

    def __init__(self) -> None:
        self.verts: List[np.ndarray] = []
        self.diffuse: List[np.ndarray] = []
        self.metallic: List[float] = []
        self.roughness: List[float] = []
        self.emissive: List[np.ndarray] = []

    def add(self, v0, v1, v2, material: dict) -> None:
        self.verts.append(np.stack([np.asarray(v0, _F), np.asarray(v1, _F),
                                    np.asarray(v2, _F)]))
        self.diffuse.append(np.asarray(material["diffuse"], _F))
        self.metallic.append(material.get("metallic", 0.0))
        self.roughness.append(material.get("roughness", 0.0))
        self.emissive.append(
            np.asarray(material.get("emissive", (0.0, 0.0, 0.0)), _F))

    def build(self) -> TriangleScene:
        return TriangleScene(
            verts=_t(np.stack(self.verts)),
            diffuse=_t(np.stack(self.diffuse)),
            metallic=_t(np.asarray(self.metallic, _F)),
            roughness=_t(np.asarray(self.roughness, _F)),
            emissive=_t(np.stack(self.emissive)),
        )


def rotated_box_vertices(center, width, height, depth, rotation_y) -> np.ndarray:
    """8 box corners, Y-rotated then translated (scene.swift:177-210).
    Corner order matches the reference exactly."""
    hw, hh, hd = width / 2.0, height / 2.0, depth / 2.0
    base = np.array(
        [
            [-hw, -hh, -hd], [hw, -hh, -hd], [hw, hh, -hd], [-hw, hh, -hd],
            [-hw, -hh, hd], [hw, -hh, hd], [hw, hh, hd], [-hw, hh, hd],
        ],
        _F,
    )
    c, s = math.cos(rotation_y), math.sin(rotation_y)
    # simd_float4x4 is column-major: row-major rotation rows
    # (c,0,-s),(0,1,0),(s,0,c) (scene.swift:197-202).
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], _F)
    return base @ rot.T + np.asarray(center, _F)


# 12 triangles per box; index triples into the 8-corner array, in the exact
# winding order of createBoxTriangles (scene.swift:212-240).
_BOX_TRI_INDICES = [
    (0, 2, 1), (0, 3, 2),  # back
    (4, 5, 6), (4, 6, 7),  # front
    (0, 4, 7), (0, 7, 3),  # left
    (1, 6, 5), (1, 2, 6),  # right
    (0, 5, 4), (0, 1, 5),  # bottom
    (3, 6, 2), (3, 7, 6),  # top
]


def add_box(tris: _TriBuilder, vertices: np.ndarray, material: dict) -> None:
    for a, b, c in _BOX_TRI_INDICES:
        tris.add(vertices[a], vertices[b], vertices[c], material)


# Materials (scene.swift:72-76).
RED = dict(diffuse=(0.9, 0.0, 0.0), metallic=0.05, roughness=0.3)
GREEN = dict(diffuse=(0.0, 0.7, 0.0), metallic=0.05, roughness=0.8)
WHITE = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.8)
DIFFUSE_BOX = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.3)
SPECULAR_BOX = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.9, roughness=0.3)
# Glossier variant of the specular material (not in the reference): the
# tighter lobe stresses the VNDF sampling branch harder than roughness 0.3.
GLOSSY_BOX = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.9, roughness=0.1)
LIGHT_MATERIAL = dict(diffuse=(1.0, 0.95, 0.9), metallic=0.0, roughness=0.0,
                      emissive=(1.0, 1.0, 1.0))


def cornell_box_triangles(
    room_size: float = 5.0,
    tall_box_material: dict = DIFFUSE_BOX,
    short_box_material: dict = DIFFUSE_BOX,
) -> _TriBuilder:
    """The 32 wall/box triangles (createCornellBoxScene, scene.swift:64-175)."""
    half = room_size / 2.0
    b = _TriBuilder()

    # Back wall (z=-half), white.
    b.add([-half, -half, -half], [half, half, -half], [-half, half, -half], WHITE)
    b.add([-half, -half, -half], [half, -half, -half], [half, half, -half], WHITE)
    # Left wall (x=-half), red.
    b.add([-half, -half, -half], [-half, half, half], [-half, -half, half], RED)
    b.add([-half, -half, -half], [-half, half, -half], [-half, half, half], RED)
    # Right wall (x=+half), green.
    b.add([half, -half, -half], [half, half, half], [half, half, -half], GREEN)
    b.add([half, -half, -half], [half, -half, half], [half, half, half], GREEN)
    # Floor (y=-half), white.
    b.add([-half, -half, -half], [half, -half, half], [half, -half, -half], WHITE)
    b.add([-half, -half, -half], [-half, -half, half], [half, -half, half], WHITE)
    # Ceiling (y=+half), white.
    b.add([-half, half, -half], [half, half, half], [-half, half, half], WHITE)
    b.add([-half, half, -half], [half, half, -half], [half, half, half], WHITE)

    # Tall box: 1.2 x 2.8 x 1.2 at (-1, -half+1.4-0.05, -1.5), rot pi/2.4
    # (scene.swift:141-155).
    tall = rotated_box_vertices(
        center=(-1.0, -half + 2.8 / 2 - 0.05, -1.5),
        width=1.2, height=2.8, depth=1.2, rotation_y=math.pi / 2.4,
    )
    add_box(b, tall, tall_box_material)

    # Short box: 1.2^3 at (0.7, -half+0.6-0.05, 1.2), rot -pi/2.5
    # (scene.swift:157-172).
    short = rotated_box_vertices(
        center=(0.7, -half + 1.2 / 2 - 0.05, 1.2),
        width=1.2, height=1.2, depth=1.2, rotation_y=-math.pi / 2.5,
    )
    add_box(b, short, short_box_material)
    return b


def _add_light_panel(b: _TriBuilder, light_y: float, lw: float,
                     ld: float) -> None:
    """The two emissive ceiling-panel triangles (scene.swift:58-59)."""
    hw, hd = lw / 2, ld / 2
    v0 = (-hw, light_y, -hd)
    v1 = (hw, light_y, -hd)
    v2 = (hw, light_y, hd)
    v3 = (-hw, light_y, hd)
    b.add(v0, v1, v2, LIGHT_MATERIAL)
    b.add(v0, v2, v3, LIGHT_MATERIAL)


def cornell_box(
    resolution: Tuple[int, int] = (800, 600),
    room_size: float = 5.0,
    tall_box_material: dict = DIFFUSE_BOX,
    short_box_material: dict = DIFFUSE_BOX,
    spheres: Optional[Spheres] = None,
) -> Scene:
    """Full Cornell-box scene: 32 wall/box triangles + 2 light triangles
    (initCornellBox, scene.swift:14-62)."""
    light_y = room_size / 2.0 - 0.01
    lw = ld = 1.0
    b = cornell_box_triangles(room_size, tall_box_material, short_box_material)
    _add_light_panel(b, light_y, lw, ld)  # appended last
    return Scene(
        camera=make_camera(resolution=resolution),
        light=make_square_light(center=(0.0, light_y, 0.0), width=lw, depth=ld),
        triangles=b.build(),
        spheres=spheres if spheres is not None else empty_spheres(),
        sphere_lights=empty_sphere_lights(),
        box_lights=empty_box_lights(),
    )


def cornell_box_glossy(resolution: Tuple[int, int] = (512, 512),
                       room_size: float = 5.0) -> Scene:
    """The Cornell box with glossy/specular box materials: the reference's
    unused specular material (metallic 0.9 / roughness 0.3,
    RTrace/scene.swift:76) on the tall box and a tighter-lobe glossy variant
    on the short box. The only stock scene where metallic and roughness are
    non-trivial; render it with the MIS integrator (the specular BRDF and
    VNDF branches are variant A's) and ``sampler="stratified"``."""
    return cornell_box(resolution=resolution, room_size=room_size,
                       tall_box_material=SPECULAR_BOX,
                       short_box_material=GLOSSY_BOX)


def make_spheres(centers, radii, materials) -> Spheres:
    """Build a sphere SoA from lists (reference: Sphere struct,
    scene.swift:284-288)."""
    centers = np.asarray(centers, _F).reshape(-1, 3)
    radii = np.asarray(radii, _F).reshape(-1)
    diffuse = np.stack([np.asarray(m["diffuse"], _F) for m in materials])
    metallic = np.asarray([m.get("metallic", 0.0) for m in materials], _F)
    roughness = np.asarray([m.get("roughness", 0.0) for m in materials], _F)
    emissive = np.stack(
        [np.asarray(m.get("emissive", (0.0, 0.0, 0.0)), _F) for m in materials]
    )
    return Spheres(
        center=_t(centers), radius=_t(radii), diffuse=_t(diffuse),
        metallic=_t(metallic), roughness=_t(roughness), emissive=_t(emissive),
    )


def cornell_box_with_spheres(resolution: Tuple[int, int] = (256, 256)) -> Scene:
    """Cornell box walls + two analytic spheres instead of boxes."""
    light_y = 2.5 - 0.01
    lw = ld = 1.0
    b = _TriBuilder()
    # Walls only (first 10 triangles of the standard box).
    walls = cornell_box_triangles(5.0)
    for i in range(10):
        b.verts.append(walls.verts[i])
        b.diffuse.append(walls.diffuse[i])
        b.metallic.append(walls.metallic[i])
        b.roughness.append(walls.roughness[i])
        b.emissive.append(walls.emissive[i])
    _add_light_panel(b, light_y, lw, ld)

    spheres = make_spheres(
        centers=[(-1.0, -1.6, -1.0), (1.0, -1.7, 0.8)],
        radii=[0.9, 0.8],
        materials=[
            dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.3),
            dict(diffuse=(0.25, 0.25, 0.75), metallic=0.3, roughness=0.6),
        ],
    )
    return Scene(
        camera=make_camera(resolution=resolution),
        light=make_square_light(center=(0.0, light_y, 0.0), width=lw, depth=ld),
        triangles=b.build(),
        spheres=spheres,
        sphere_lights=empty_sphere_lights(),
        box_lights=empty_box_lights(),
    )
