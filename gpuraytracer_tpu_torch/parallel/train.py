"""The sharded inverse-rendering training step: forward render, pixel loss,
backward and optimizer update, pixels sharded over the ``rays`` axis of the
ranks and the scene parameters replicated.

Counterpart of ``gpuraytracer_tpu/parallel/train.py``. There ``jax.grad``
differentiates through the ``shard_map``'d renderer and XLA inserts the
gradient all-reduce; here ``mesh.replicate``'s backward does it (the
analogue of DDP's gradient all-reduce). Every rank steps its optimizer on
the same summed gradient, so the parameters stay bit-identical across
ranks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..grad.inverse import SceneParams, apply_params
from ..types import RenderConfig, Scene
from .fast import render_path_fused_sharded
from .mesh import RayMesh, render_path_sharded


class TrainState(NamedTuple):
    params: SceneParams               # leaves on the mesh's device
    opt_state: torch.optim.Optimizer  # holds its moments over ``params``


def make_train_step(scene: Scene, config: RenderConfig, mesh: RayMesh,
                    learning_rate: float = 1e-2,
                    optimizer: Optional[Callable[[Sequence[torch.Tensor]],
                                                 torch.optim.Optimizer]] = None,
                    renderer=None):
    """Returns (init_fn, step_fn):
      init_fn(params) -> TrainState (copies of the parameters, as leaves)
      step_fn(state, target_hdr) -> (TrainState, loss)

    ``optimizer``: a factory ``params -> torch.optim.Optimizer``, by default
    ``torch.optim.Adam(params, lr=learning_rate)`` (optax ``adam``'s
    defaults). ``renderer(scene, config, mesh)`` defaults to the eager
    oracle (``render_path_sharded``); ``make_train_step_fused`` passes the
    kernel path. Every rank calls ``step_fn`` with the same target: the loss
    is computed on every rank from the gathered image."""
    factory = optimizer or (lambda params: torch.optim.Adam(
        params, lr=learning_rate))
    render_fn = renderer or render_path_sharded
    scene = scene.to(mesh.device)  # once, not at every step

    def loss_fn(params: SceneParams, target: torch.Tensor) -> torch.Tensor:
        img = render_fn(apply_params(scene, params), config, mesh)
        return torch.mean((img - target.to(img.device)) ** 2)

    def init_fn(params: SceneParams) -> TrainState:
        leaves = SceneParams(*(
            p.detach().to(mesh.device).clone().requires_grad_(True)
            for p in params))
        return TrainState(params=leaves, opt_state=factory(list(leaves)))

    def step_fn(state: TrainState, target: torch.Tensor):
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, target)
        loss.backward()
        state.opt_state.step()
        return state, loss.detach()

    return init_fn, step_fn


def make_train_step_fused(scene: Scene, config: RenderConfig, mesh: RayMesh,
                          learning_rate: float = 1e-2, optimizer=None):
    """The sharded training step on the kernel path: the trace kernel and
    the hand-written backward per shard (``fast.render_path_fused_sharded``),
    the gradients summed across ranks. Triangle and sphere scenes, both
    tiers."""
    return make_train_step(scene, config, mesh, learning_rate, optimizer,
                           renderer=render_path_fused_sharded)
