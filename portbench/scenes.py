"""The benchmark's own copies of the scene builders, as numpy trees.

Frozen copies of ``gpuraytracer_tpu_torch.scene.cornell_box`` and
``cornell_box_tessellated`` (after the reference's ``initCornellBox``,
RTrace/scene.swift:14-62): the same float32 numpy operations in the same
order, so the arrays are bit-equal to the port's (``tests/
test_portbench_reference.py`` holds them so). A scene is a dict of parts
(``camera``, ``light``, ``triangles``, ``spheres``, ``sphere_lights``,
``box_lights``), each a dict of numpy arrays: the layout
``gpuraytracer_tpu_torch.convert.scene_from_numpy`` reads. The benchmark
builds the scene once and hands the same arrays to the program and to the
plain reference.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

_F = np.float32

Tree = Dict[str, Dict[str, np.ndarray]]


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def make_camera(resolution, position=(0.0, 0.0, 9.0),
                look_at=(0.0, 0.0, -2.5), up=(0.0, 1.0, 0.0),
                horizontal_fov=math.pi / 4.0, ev100=5.0) -> Dict:
    position = np.asarray(position, _F)
    direction = _normalize(np.asarray(look_at, _F) - position)
    return dict(position=position, direction=direction,
                up=np.asarray(up, _F),
                resolution=np.asarray(resolution, np.int32),
                horizontal_fov=np.array(_F(horizontal_fov)),
                ev100=np.array(_F(ev100)))


def make_square_light(center, width=1.0, depth=1.0, diffuse=(1.0, 0.95, 0.9),
                      luminous_efficacy=100.0, watts=12.0,
                      normal=(0.0, -1.0, 0.0)) -> Dict:
    """Ceiling light (scene.swift:23-53); the luminance is the lm -> cd/m^2
    conversion of scene.swift:257-270, tinted by the diffuse colour."""
    diffuse = np.asarray(diffuse, _F)
    luminance = luminous_efficacy * watts / (width * depth) / math.pi
    return dict(center=np.asarray(center, _F), color=diffuse,
                emitted_radiance=diffuse * _F(luminance),
                width=np.array(_F(width)), depth=np.array(_F(depth)),
                normal=np.asarray(normal, _F))


class _Tris:
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

    def build(self) -> Dict:
        return dict(verts=np.stack(self.verts),
                    diffuse=np.stack(self.diffuse),
                    metallic=np.asarray(self.metallic, _F),
                    roughness=np.asarray(self.roughness, _F),
                    emissive=np.stack(self.emissive))


def _empty(**shapes) -> Dict:
    return {k: np.zeros(s, _F) for k, s in shapes.items()}


def _scene(resolution, light_y: float, tris: _Tris) -> Tree:
    return dict(
        camera=make_camera(resolution),
        light=make_square_light(center=(0.0, light_y, 0.0)),
        triangles=tris.build(),
        spheres=_empty(center=(0, 3), radius=(0,), diffuse=(0, 3),
                       metallic=(0,), roughness=(0,), emissive=(0, 3)),
        sphere_lights=_empty(center=(0, 3), radius=(0,), color=(0, 3),
                             emitted_radiance=(0, 3)),
        box_lights=_empty(center=(0, 3), width=(0,), height=(0,),
                          depth=(0,), color=(0, 3), emitted_radiance=(0, 3)),
    )


def rotated_box_vertices(center, width, height, depth, rotation_y):
    """8 corners, rotated about y then translated (scene.swift:177-210)."""
    hw, hh, hd = width / 2.0, height / 2.0, depth / 2.0
    base = np.array([[-hw, -hh, -hd], [hw, -hh, -hd], [hw, hh, -hd],
                     [-hw, hh, -hd], [-hw, -hh, hd], [hw, -hh, hd],
                     [hw, hh, hd], [-hw, hh, hd]], _F)
    c, s = math.cos(rotation_y), math.sin(rotation_y)
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], _F)
    return base @ rot.T + np.asarray(center, _F)


# createBoxTriangles' winding (scene.swift:212-240).
_BOX = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 4, 7), (0, 7, 3),
        (1, 6, 5), (1, 2, 6), (0, 5, 4), (0, 1, 5), (3, 6, 2), (3, 7, 6)]

# Materials (scene.swift:72-76).
RED = dict(diffuse=(0.9, 0.0, 0.0), metallic=0.05, roughness=0.3)
GREEN = dict(diffuse=(0.0, 0.7, 0.0), metallic=0.05, roughness=0.8)
WHITE = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.8)
DIFFUSE_BOX = dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.3)
LIGHT = dict(diffuse=(1.0, 0.95, 0.9), metallic=0.0, roughness=0.0,
             emissive=(1.0, 1.0, 1.0))


def _light_panel(b: _Tris, light_y: float) -> None:
    """The two emissive panel triangles (scene.swift:58-59)."""
    v0, v1, v2, v3 = ((-0.5, light_y, -0.5), (0.5, light_y, -0.5),
                      (0.5, light_y, 0.5), (-0.5, light_y, 0.5))
    b.add(v0, v1, v2, LIGHT)
    b.add(v0, v2, v3, LIGHT)


def cornell_box(resolution=(800, 600)) -> Tree:
    """32 wall and box triangles, then the 2 light triangles
    (initCornellBox, scene.swift:14-62)."""
    half = 2.5
    b = _Tris()
    for v in [
        ([-half, -half, -half], [half, half, -half], [-half, half, -half], WHITE),
        ([-half, -half, -half], [half, -half, -half], [half, half, -half], WHITE),
        ([-half, -half, -half], [-half, half, half], [-half, -half, half], RED),
        ([-half, -half, -half], [-half, half, -half], [-half, half, half], RED),
        ([half, -half, -half], [half, half, half], [half, half, -half], GREEN),
        ([half, -half, -half], [half, -half, half], [half, half, half], GREEN),
        ([-half, -half, -half], [half, -half, half], [half, -half, -half], WHITE),
        ([-half, -half, -half], [-half, -half, half], [half, -half, half], WHITE),
        ([-half, half, -half], [half, half, half], [-half, half, half], WHITE),
        ([-half, half, -half], [half, half, -half], [half, half, half], WHITE),
    ]:
        b.add(*v)
    for center, size, rot in [
            ((-1.0, -half + 2.8 / 2 - 0.05, -1.5), (1.2, 2.8, 1.2),
             math.pi / 2.4),
            ((0.7, -half + 1.2 / 2 - 0.05, 1.2), (1.2, 1.2, 1.2),
             -math.pi / 2.5)]:
        corners = rotated_box_vertices(center, *size, rot)
        for i, j, k in _BOX:
            b.add(corners[i], corners[j], corners[k], DIFFUSE_BOX)
    light_y = half - 0.01
    _light_panel(b, light_y)
    return _scene(resolution, light_y, b)


def _morton2(i: int, j: int) -> int:
    code = 0
    for bit in range(16):
        code |= (((i >> bit) & 1) << (2 * bit)) | (((j >> bit) & 1)
                                                    << (2 * bit + 1))
    return code


def _tessellate_quad(b: _Tris, corners, n: int, material: dict) -> None:
    """An n x n grid of cells, two triangles each, in Morton order."""
    c0, c1, c2, c3 = (np.asarray(c, np.float64) for c in corners)
    for i, j in sorted(((i, j) for i in range(n) for j in range(n)),
                       key=lambda ij: _morton2(*ij)):
        u0, u1, v0, v1 = i / n, (i + 1) / n, j / n, (j + 1) / n

        def lerp(u, v):
            top = c0 + (c1 - c0) * u
            bot = c3 + (c2 - c3) * u
            return (top + (bot - top) * v).astype(_F)

        p00, p10, p11, p01 = lerp(u0, v0), lerp(u1, v0), lerp(u1, v1), \
            lerp(u0, v1)
        b.add(p00, p10, p11, material)
        b.add(p00, p11, p01, material)


def icosphere(center, radius, subdiv: int) -> np.ndarray:
    """An icosahedron subdivided ``subdiv`` times, projected onto the
    sphere in float64, rounded once to float32: [20 * 4^subdiv, 3, 3]."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    tris = [(v[a], v[b], v[c]) for a, b, c in faces]
    for _ in range(subdiv):
        nxt = []
        for a, b, c in tris:
            ab, bc, ca = (a + b) / 2.0, (b + c) / 2.0, (c + a) / 2.0
            ab /= np.linalg.norm(ab)
            bc /= np.linalg.norm(bc)
            ca /= np.linalg.norm(ca)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = nxt
    out = np.asarray(tris, np.float64) * radius + np.asarray(center,
                                                             np.float64)
    return out.astype(_F)


def cornell_box_tessellated(resolution=(512, 512), wall_subdiv: int = 6,
                            sphere_subdiv: int = 2) -> Tree:
    """Five walls of 2 * wall_subdiv^2 triangles, two icospheres where the
    sphere scene's analytic spheres sit, the 2-triangle light panel: 1,002
    triangles at the defaults."""
    h = 2.5
    light_y = h - 0.01
    b = _Tris()
    for corners, mat in [
            ([(-h, -h, -h), (h, -h, -h), (h, h, -h), (-h, h, -h)], WHITE),
            ([(-h, -h, h), (-h, -h, -h), (-h, h, -h), (-h, h, h)], RED),
            ([(h, -h, -h), (h, -h, h), (h, h, h), (h, h, -h)], GREEN),
            ([(-h, -h, h), (h, -h, h), (h, -h, -h), (-h, -h, -h)], WHITE),
            ([(-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h)], WHITE)]:
        _tessellate_quad(b, corners, wall_subdiv, mat)
    for center, radius, mat in [
            ((-1.0, -1.6, -1.0), 0.9,
             dict(diffuse=(0.9, 0.9, 0.9), metallic=0.05, roughness=0.3)),
            ((1.0, -1.7, 0.8), 0.8,
             dict(diffuse=(0.25, 0.25, 0.75), metallic=0.3,
                  roughness=0.6))]:
        for tri in icosphere(center, radius, sphere_subdiv):
            b.add(tri[0], tri[1], tri[2], mat)
    b.add((-0.5, light_y, -0.5), (0.5, light_y, -0.5), (0.5, light_y, 0.5),
          LIGHT)
    b.add((-0.5, light_y, -0.5), (0.5, light_y, 0.5), (-0.5, light_y, 0.5),
          LIGHT)
    return _scene(resolution, light_y, b)


BUILDERS = {"cornell_box": cornell_box,
            "cornell_box_tessellated": cornell_box_tessellated}
