"""Scene and configuration types of the PyTorch port.

Counterpart of ``gpuraytracer_tpu/types.py``: the same struct-of-arrays
scene, as plain dataclasses of ``torch`` tensors instead of JAX pytrees.
Every struct has a ``map(fn)`` that rebuilds it with ``fn`` applied to each
of its tensors (nested structs included), ``.to(device)`` and ``.detach()``
built on it, and a ``tensors()`` iterator over the tensors in the same order.

All geometry and shading math is float32; images accumulate in float32 and
are quantized to uint8 only at the PNG boundary (``image.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch


class _TensorStruct:
    """Mixin for dataclasses whose fields are tensors or nested structs."""

    def map(self, fn):
        """Copy of this struct with ``fn`` applied to every tensor, in the
        order ``tensors()`` yields them."""
        def apply(value):
            return value.map(fn) if isinstance(value, _TensorStruct) \
                else fn(value)
        return dataclasses.replace(self, **{
            f.name: apply(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    def to(self, device):
        """Copy of this struct with every tensor moved to ``device``."""
        return self.map(lambda t: t.to(device))

    def detach(self):
        """Copy of this struct whose tensors are cut from the autograd
        graph (the discrete trace runs on such a copy)."""
        return self.map(lambda t: t.detach())

    def tensors(self) -> Iterator[torch.Tensor]:
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, _TensorStruct):
                yield from value.tensors()
            else:
                yield value


@dataclasses.dataclass(frozen=True)
class Camera(_TensorStruct):
    """Pinhole camera (reference: Camera struct, RTrace/scene.swift:290-301)."""

    position: torch.Tensor  # [3] f32
    direction: torch.Tensor  # [3] f32, normalized
    up: torch.Tensor  # [3] f32
    resolution: torch.Tensor  # [2] i32 (width, height)
    horizontal_fov: torch.Tensor  # scalar f32, radians
    ev100: torch.Tensor  # scalar f32


@dataclasses.dataclass(frozen=True)
class SquareLight(_TensorStruct):
    """Rectangular area light (reference: SquareLightGPU, shaderTypes.h:56-62).

    ``color`` is the light material's diffuse rgb (used by the variant-B
    ``sampleAreaLight``) while ``emitted_radiance`` is the photometric
    luminance (used by the variant-A MIS integrator)."""

    center: torch.Tensor  # [3] f32
    color: torch.Tensor  # [3] f32
    emitted_radiance: torch.Tensor  # [3] f32
    width: torch.Tensor  # scalar f32
    depth: torch.Tensor  # scalar f32
    normal: torch.Tensor  # [3] f32


@dataclasses.dataclass(frozen=True)
class TriangleScene(_TensorStruct):
    """Triangle soup with per-triangle materials; ``verts[t, k, :]`` is
    vertex k of triangle t."""

    verts: torch.Tensor  # [T, 3, 3] f32
    diffuse: torch.Tensor  # [T, 3] f32
    metallic: torch.Tensor  # [T] f32
    roughness: torch.Tensor  # [T] f32
    emissive: torch.Tensor  # [T, 3] f32

    @property
    def num_triangles(self) -> int:
        return self.verts.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres(_TensorStruct):
    """Analytic spheres (reference: SphereGPU, shaderTypes.h:25-29)."""

    center: torch.Tensor  # [S, 3] f32
    radius: torch.Tensor  # [S] f32
    diffuse: torch.Tensor  # [S, 3] f32
    metallic: torch.Tensor  # [S] f32
    roughness: torch.Tensor  # [S] f32
    emissive: torch.Tensor  # [S, 3] f32

    @property
    def num_spheres(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class SphereLights(_TensorStruct):
    """Sphere lights of the legacy tier (SphereLightGPU,
    shaderTypes.h:40-45): sampled and hit-tested by ``render_legacy``, which
    appends them to the spheres as emissive spheres. The other integrators
    do not read them. Empty (L == 0) in every scene but
    ``scene.legacy_cornell("sphere")``."""

    center: torch.Tensor  # [L, 3] f32
    radius: torch.Tensor  # [L] f32
    color: torch.Tensor  # [L, 3] f32
    emitted_radiance: torch.Tensor  # [L, 3] f32

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class BoxLights(_TensorStruct):
    """Box lights of the legacy tier (BoxLightGPU, shaderTypes.h:47-54):
    ``render_legacy`` samples them and takes their pdf; the scene holds the
    same box as 12 emissive triangles for hit tests. Empty in every scene
    but ``scene.legacy_cornell("box")``."""

    center: torch.Tensor  # [L, 3] f32
    width: torch.Tensor  # [L] f32
    height: torch.Tensor  # [L] f32
    depth: torch.Tensor  # [L] f32
    color: torch.Tensor  # [L, 3] f32
    emitted_radiance: torch.Tensor  # [L, 3] f32

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene(_TensorStruct):
    """Full scene: camera, primary light and geometry."""

    camera: Camera
    light: SquareLight
    triangles: TriangleScene
    spheres: Spheres  # may be empty (S == 0)
    sphere_lights: SphereLights  # the legacy tier's; may be empty
    box_lights: BoxLights  # the legacy tier's; may be empty


@dataclasses.dataclass(frozen=True)
class CompiledScene(_TensorStruct):
    """Intersection-ready triangles: per-triangle plane and dual basis.

      n       geometric normal (normalized cross(e1, e2))
      c0      dot(n, v0)              -> t = (c0 - o.n) / (d.n)
      s1, s2  dual basis of (e1, e2)  -> u = (h - v0).s1, v = (h - v0).s2
      c1, c2  dot(v0, s1), dot(v0, s2)

    The JAX package pads the triangle axis to a lane multiple; there is no
    such constraint here, so the arrays have exactly T rows."""

    n: torch.Tensor  # [T, 3] f32
    c0: torch.Tensor  # [T] f32
    s1: torch.Tensor  # [T, 3] f32
    s2: torch.Tensor  # [T, 3] f32
    c1: torch.Tensor  # [T] f32
    c2: torch.Tensor  # [T] f32
    diffuse: torch.Tensor  # [T, 3] f32
    metallic: torch.Tensor  # [T] f32
    roughness: torch.Tensor  # [T] f32
    emissive: torch.Tensor  # [T, 3] f32
    is_emissive: torch.Tensor  # [T] bool (length(emissive) > 0)

    @property
    def num_triangles(self) -> int:
        return self.n.shape[0]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration, field for field the JAX package's.

    Compat flags replicate reference quirks bit for bit:
      integer_aspect          aspect = float(resx // resy)
      area_light_half_extent  hardcoded 0.25 half-extents in sampleAreaLight
                              regardless of the scene's actual 1x1 light.

    ``lane_pad`` is carried for parity of the two configs and is not read
    by this port; ``replay_sample_chunk`` is the sample chunk of
    ``ops.decoupled.shade_replay``.
    """

    width: int = 800
    height: int = 600
    integrator: str = "path"  # "path" (variant B) | "mis" (variant A) | "direct"
    spp: int = 400  # variant B samples per pixel
    bounces: int = 3  # variant B bounce count
    camera_rays: int = 6  # variant A camera rays per pixel
    mis_samples: int = 300  # variant A total MIS samples
    legacy_samples: int = 30
    legacy_bounces: int = 2
    legacy_bounce_samples: int = 30
    # "halton" replicates the reference's low-discrepancy draws;
    # "stratified" jitter-grids the camera subpixel samples over spp cells
    # (square sample counts required).
    sampler: str = "halton"
    seed: int = 0
    integer_aspect: bool = True
    area_light_half_extent: float = 0.25
    lane_pad: int = 128
    pixel_chunk: int = 16384  # pixels per step of the eager renderers
    replay_sample_chunk: int = 16

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def _zeros(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def empty_spheres() -> Spheres:
    return Spheres(center=_zeros(0, 3), radius=_zeros(0), diffuse=_zeros(0, 3),
                   metallic=_zeros(0), roughness=_zeros(0),
                   emissive=_zeros(0, 3))


def empty_sphere_lights() -> SphereLights:
    return SphereLights(center=_zeros(0, 3), radius=_zeros(0),
                        color=_zeros(0, 3), emitted_radiance=_zeros(0, 3))


def empty_box_lights() -> BoxLights:
    return BoxLights(center=_zeros(0, 3), width=_zeros(0), height=_zeros(0),
                     depth=_zeros(0), color=_zeros(0, 3),
                     emitted_radiance=_zeros(0, 3))
