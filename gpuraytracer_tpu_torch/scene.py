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

from .types import (BoxLights, Camera, Scene, SphereLights, Spheres,
                    SquareLight, TriangleScene, empty_box_lights,
                    empty_sphere_lights, empty_spheres)

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


# ---------------------------------------------------------------------------
# High-triangle-count scene (the grouped tier of the trace kernel)
# ---------------------------------------------------------------------------

def _morton2(i: int, j: int) -> int:
    """Interleave the bits of (i, j): the Z-order curve index."""
    code = 0
    for b in range(16):
        code |= (((i >> b) & 1) << (2 * b)) | (((j >> b) & 1) << (2 * b + 1))
    return code


def _tessellate_quad(b: _TriBuilder, corners, n: int, material: dict) -> None:
    """Split the quad (c0, c1, c2, c3 in winding order) into an n x n grid of
    cells, two triangles each, keeping the outward orientation of the corner
    order. Cells are emitted in Morton (Z-curve) order, so that any run of
    consecutive triangles covers a compact patch: the grouped traversal's
    groups of 16 consecutive triangles then have small bounding boxes. The
    records name triangles by index, so this order is part of the scene."""
    c0, c1, c2, c3 = (np.asarray(c, np.float64) for c in corners)
    for i, j in sorted(((i, j) for i in range(n) for j in range(n)),
                       key=lambda ij: _morton2(*ij)):
        u0, u1 = i / n, (i + 1) / n
        v0, v1 = j / n, (j + 1) / n

        def lerp(u, v):
            top = c0 + (c1 - c0) * u
            bot = c3 + (c2 - c3) * u
            return (top + (bot - top) * v).astype(_F)

        p00, p10, p11, p01 = lerp(u0, v0), lerp(u1, v0), lerp(u1, v1), \
            lerp(u0, v1)
        b.add(p00, p10, p11, material)
        b.add(p00, p11, p01, material)


def icosphere(center, radius, subdiv: int = 2) -> np.ndarray:
    """Triangle mesh of a sphere: an icosahedron subdivided ``subdiv`` times
    (20 * 4^subdiv triangles), vertices projected onto the sphere, in float64
    then rounded once to float32. Returns [T, 3, 3] float32 vertices: the
    arbitrary triangle geometry the reference's driver BVH takes
    (RTrace/computeShader.swift:45-97)."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    tris = [(v[a], v[b], v[c]) for a, b, c in faces]
    for _ in range(subdiv):
        nxt = []
        for a, b, c in tris:
            ab = (a + b) / 2.0
            bc = (b + c) / 2.0
            ca = (c + a) / 2.0
            ab /= np.linalg.norm(ab)
            bc /= np.linalg.norm(bc)
            ca /= np.linalg.norm(ca)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = nxt
    out = np.asarray(tris, np.float64) * radius + np.asarray(center,
                                                             np.float64)
    return out.astype(_F)


def cornell_box_tessellated(
    resolution: Tuple[int, int] = (512, 512),
    wall_subdiv: int = 6,
    sphere_subdiv: int = 2,
    room_size: float = 5.0,
) -> Scene:
    """High-triangle-count Cornell scene for the grouped tier of the trace
    and backward kernels: the 5 walls tessellated into ``2 * wall_subdiv^2``
    triangles each, two icosphere meshes (20 * 4^sphere_subdiv triangles
    each) where the analytic spheres of ``cornell_box_with_spheres`` sit, and
    the 2-triangle ceiling light panel. The defaults give 5 * 72 + 2 * 320 +
    2 = 1,002 triangles; ``wall_subdiv=16, sphere_subdiv=4`` gives 12,802.
    Same camera, light and materials as the sphere scene."""
    half = room_size / 2.0
    light_y = half - 0.01
    b = _TriBuilder()
    h = half
    # Walls as quads, corner order matching the flat walls' outward normals:
    # back, left, right, floor, ceiling (materials of cornell_box_triangles).
    _tessellate_quad(b, [(-h, -h, -h), (h, -h, -h), (h, h, -h), (-h, h, -h)],
                     wall_subdiv, WHITE)                      # back (z=-h)
    _tessellate_quad(b, [(-h, -h, h), (-h, -h, -h), (-h, h, -h), (-h, h, h)],
                     wall_subdiv, RED)                        # left (x=-h)
    _tessellate_quad(b, [(h, -h, -h), (h, -h, h), (h, h, h), (h, h, -h)],
                     wall_subdiv, GREEN)                      # right (x=+h)
    _tessellate_quad(b, [(-h, -h, h), (h, -h, h), (h, -h, -h), (-h, -h, -h)],
                     wall_subdiv, WHITE)                      # floor (y=-h)
    _tessellate_quad(b, [(-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h)],
                     wall_subdiv, WHITE)                      # ceiling (y=+h)

    for center, radius, mat in [
        ((-1.0, -1.6, -1.0), 0.9,
         dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.3)),
        ((1.0, -1.7, 0.8), 0.8,
         dict(diffuse=(0.25, 0.25, 0.75), metallic=0.3, roughness=0.6)),
    ]:
        for tri in icosphere(center, radius, sphere_subdiv):
            b.add(tri[0], tri[1], tri[2], mat)

    lw = ld = 1.0
    hw, hd = lw / 2, ld / 2
    b.add((-hw, light_y, -hd), (hw, light_y, -hd), (hw, light_y, hd),
          LIGHT_MATERIAL)
    b.add((-hw, light_y, -hd), (hw, light_y, hd), (-hw, light_y, hd),
          LIGHT_MATERIAL)

    return Scene(
        camera=make_camera(resolution=resolution),
        light=make_square_light(center=(0.0, light_y, 0.0), width=lw,
                                depth=ld),
        triangles=b.build(),
        spheres=empty_spheres(),
        sphere_lights=empty_sphere_lights(),
        box_lights=empty_box_lights(),
    )


# ---------------------------------------------------------------------------
# Legacy-tier lights and scenes (the scene model of shaders_old.metal)
# ---------------------------------------------------------------------------

def make_sphere_lights(centers, radii, colors,
                       luminous_efficacy: float = 100.0,
                       watts: float = 12.0) -> SphereLights:
    """Sphere lights (SphereLightGPU, shaderTypes.h:40-45). Emitted radiance
    follows the reference's photometric recipe (scene.swift:257-270) with the
    sphere's surface area 4 pi r^2 as the emitting area."""
    centers = np.asarray(centers, _F).reshape(-1, 3)
    radii = np.asarray(radii, _F).reshape(-1)
    colors = np.asarray(colors, _F).reshape(-1, 3)
    area = 4.0 * math.pi * radii * radii
    luminance = (luminous_efficacy * watts) / area / math.pi
    return SphereLights(
        center=_t(centers), radius=_t(radii), color=_t(colors),
        emitted_radiance=_t(colors * luminance[:, None].astype(_F)))


def make_box_lights(centers, sizes, colors,
                    luminous_efficacy: float = 100.0,
                    watts: float = 12.0) -> BoxLights:
    """Box lights (BoxLightGPU, shaderTypes.h:47-54); the emitting area is
    the box's total surface area (the pdf's measure,
    shaders_old.metal:668-671). ``sizes`` rows are (width, height, depth)."""
    centers = np.asarray(centers, _F).reshape(-1, 3)
    sizes = np.asarray(sizes, _F).reshape(-1, 3)
    colors = np.asarray(colors, _F).reshape(-1, 3)
    w, h, d = sizes[:, 0], sizes[:, 1], sizes[:, 2]
    area = 2.0 * (w * h + w * d + h * d)
    luminance = (luminous_efficacy * watts) / area / math.pi
    return BoxLights(
        center=_t(centers), width=_t(w), height=_t(h), depth=_t(d),
        color=_t(colors),
        emitted_radiance=_t(colors * luminance[:, None].astype(_F)))


def legacy_cornell(light_kind: str = "sphere",
                   resolution: Tuple[int, int] = (256, 256)) -> Scene:
    """Legacy-tier scene: the Cornell walls, two spheres and a sphere, box
    or square light — the scene model of shaders_old.metal (spheres
    intersected analytically :108-136, sphere lights hit-tested by
    intersectLight :138-170; box lights sampled for next-event estimation
    :292-404 and hit-tested here as 12 emissive triangles)."""
    half = 2.5
    light_y = half - 0.01
    b = _TriBuilder()
    walls = cornell_box_triangles(5.0)
    for i in range(10):
        b.verts.append(np.asarray(walls.verts[i]))
        b.diffuse.append(np.asarray(walls.diffuse[i]))
        b.metallic.append(walls.metallic[i])
        b.roughness.append(walls.roughness[i])
        b.emissive.append(np.asarray(walls.emissive[i]))

    sphere_lights = empty_sphere_lights()
    box_lights = empty_box_lights()
    if light_kind == "sphere":
        sphere_lights = make_sphere_lights(
            centers=[(0.0, 1.9, 0.0)], radii=[0.35],
            colors=[(1.0, 0.95, 0.9)])
    elif light_kind == "box":
        box_lights = make_box_lights(
            centers=[(0.0, 2.2, 0.0)], sizes=[(1.0, 0.3, 1.0)],
            colors=[(1.0, 0.95, 0.9)])
        # The hit-testable body: 12 emissive triangles of the sampled box.
        emitted = box_lights.emitted_radiance[0].numpy()
        mat = dict(diffuse=(1.0, 0.95, 0.9), metallic=0.0, roughness=0.0,
                   emissive=tuple(float(x) for x in emitted))
        add_box(b, rotated_box_vertices((0.0, 2.2, 0.0), 1.0, 0.3, 1.0, 0.0),
                mat)
    elif light_kind == "square":
        _add_light_panel(b, light_y, 1.0, 1.0)
    else:
        raise ValueError(f"unknown light kind: {light_kind!r}")

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
        light=make_square_light(center=(0.0, light_y, 0.0)),
        triangles=b.build(),
        spheres=spheres,
        sphere_lights=sphere_lights,
        box_lights=box_lights,
    )
