"""gpuraytracer_tpu_torch — the PyTorch/CUDA port of the path tracer.

Module for module the counterpart of ``gpuraytracer_tpu`` (which stays the
reference), for NVIDIA Hopper:

  * ``types``     scene dataclasses of tensors, ``RenderConfig``
  * ``scene``     Cornell-box constructors, the legacy tier's scenes
  * ``sampling``  Halton/hash RNG, camera, hemisphere, light and GGX samplers
  * ``brdf``      metallic-roughness microfacet BRDF
  * ``intersect`` brute-force batched ray-scene queries
  * ``render``    eager PyTorch oracles (path / direct / mis; legacy in
                  ``render_legacy``)
  * ``renderer``  ``Renderer``: one-time work, then frames and progressive
                  accumulation
  * ``ops``       hand-written CUDA kernels for the hot path, forward and
                  backward
  * ``grad``      the edge-aware oracle, pixel losses, inverse rendering
  * ``image``     tonemap + PNG I/O (``native``: the C++ host runtime)
  * ``convert``   scenes to and from numpy trees
  * ``utils``     device selection, checkpoints, debug checks, metrics
  * ``parallel``  sharded rendering and training over ``torch.distributed``
  * ``cli``       command-line renderer

Every entry point takes ``device`` (default ``"cuda"``) and raises when the
card is asked for and absent. Importing the package needs neither a card
nor a CUDA toolchain: kernels are built inside the first call that launches
them.
"""

from .types import (BoxLights, Camera, CompiledScene, RenderConfig, Scene,
                    SphereLights, Spheres, SquareLight, TriangleScene)
from .scene import (cornell_box, cornell_box_glossy, cornell_box_tessellated,
                    cornell_box_with_spheres, legacy_cornell)
from .brdf import brdf_contribution
from .intersect import any_hit, closest_hit, compile_scene
from .render import RenderOutput, render, render_mis, tonemap_mis
from .renderer import Renderer

__version__ = "0.1.0"
