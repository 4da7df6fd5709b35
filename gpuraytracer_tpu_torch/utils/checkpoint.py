"""Progressive and resumable rendering, and checkpoints of tensor trees.

Counterpart of ``gpuraytracer_tpu/utils/checkpoint.py``. The reference has
no checkpointing; its closest aim is the commented "temporal accumulation"
note (RTrace/sampling.metal:127-128: keep a running average across frames).
Here that is an explicit accumulator (radiance sum + sample count) that can
be saved and loaded, so

  * a long render resumes after an interruption (render N more spp, save),
  * a progressive preview is the same mechanism (tonemap sum / count at any
    time),
  * an inverse-rendering state rides the same save / load.

The files are plain ``.npz``, laid out as the JAX package lays them out:
``leaf_{i}`` for the i-th leaf in field order and ``__meta__``, UTF-8 JSON as
bytes. An accumulator saved by either package loads in the other with equal
bits.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..types import RenderConfig, Scene
from .host import resolve_device

class Accumulator(NamedTuple):
    """Running radiance accumulator: mean = radiance_sum / spp_done."""

    radiance_sum: torch.Tensor  # [H, W, 3] f32
    spp_done: torch.Tensor  # 0-dim i32
    seed_cursor: torch.Tensor  # 0-dim i32: the next batch's seed offset


def init_accumulator(config: RenderConfig, device="cuda") -> Accumulator:
    device = resolve_device(device)
    return Accumulator(
        radiance_sum=torch.zeros((config.height, config.width, 3),
                                 dtype=torch.float32, device=device),
        spp_done=torch.tensor(0, dtype=torch.int32, device=device),
        seed_cursor=torch.tensor(0, dtype=torch.int32, device=device),
    )


def accumulate(scene: Scene, config: RenderConfig, acc: Accumulator,
               spp_step: int, kernel: str = "eager", device="cuda",
               occluders=None) -> Accumulator:
    """Render ``spp_step`` more samples and fold them into ``acc``.

    Batches are decorrelated by advancing the config's seed by
    ``acc.seed_cursor``, which re-derives the per-pixel Halton offsets
    (``render.pixel_rng_offsets``): every batch draws a fresh,
    deterministic sample set.

    ``kernel``: a route of ``renderer.route``; ``"cuda"`` and
    ``"decoupled"`` take the path tracer only (``path`` / ``direct``), as
    the JAX package's ``pallas`` / ``decoupled`` do, and raise
    ``ValueError`` for another integrator. The draws depend on the seed, so
    the ``decoupled`` route makes them for each batch; ``occluders``: its
    shadow-loop cull (``intersect.potential_occluders``), which does not
    depend on the seed (made for each batch where not given)."""
    from ..renderer import route
    if kernel != "eager" and config.integrator not in ("path", "direct"):
        raise ValueError(f"kernel {kernel!r} accumulates the path tracer "
                         f"only, not integrator {config.integrator!r}")
    step_cfg = config.replace(spp=spp_step,
                              seed=config.seed + int(acc.seed_cursor))
    hdr = route(scene, step_cfg, kernel, device, occluders).frame()
    return Accumulator(
        radiance_sum=acc.radiance_sum + hdr * spp_step,
        spp_done=acc.spp_done + spp_step,
        seed_cursor=acc.seed_cursor + 1,
    )


def resolve(acc: Accumulator) -> torch.Tensor:
    """The current mean radiance estimate [H, W, 3]."""
    n = torch.clamp_min(acc.spp_done, 1).to(torch.float32)
    return acc.radiance_sum / n


# ---------------------------------------------------------------------------
# Tensor trees <-> .npz
# ---------------------------------------------------------------------------

def _flatten(tree: Any) -> List[Any]:
    """Leaves of a tree of (named) tuples, lists and dicts, in the JAX
    package's order: fields and items in order, dict keys sorted; None is
    an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write ``tree``'s leaves and ``meta`` to ``path`` (.npz): to a
    temporary file first, then ``os.replace``d, so that a reader never sees
    a half-written checkpoint. ``np.savez`` appends ``.npz`` to the
    temporary name, as in the JAX package."""
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(_flatten(tree))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz", path)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Load a tree saved by ``save_pytree`` (either package's), shaped like
    ``like``; each leaf goes to the device of ``like``'s leaf."""
    with np.load(path) as data:
        targets = _flatten(like)
        loaded = []
        for i, target in enumerate(targets):
            arr = torch.from_numpy(np.array(data[f"leaf_{i}"], order="C"))
            if isinstance(target, torch.Tensor):
                arr = arr.to(target.device)
            loaded.append(arr)
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data.files else {})
    return _unflatten(like, iter(loaded)), meta


def save_accumulator(path: str, acc: Accumulator,
                     config: RenderConfig) -> None:
    save_pytree(path, acc, meta=dataclasses.asdict(config))


def load_accumulator(path: str, config: RenderConfig,
                     device="cuda") -> Accumulator:
    """Load an accumulator saved for ``config``; raises ``ValueError`` when
    the file's width, height or integrator differ from ``config``'s."""
    acc, meta = load_pytree(path, init_accumulator(config, device))
    stored = {k: meta.get(k) for k in ("width", "height", "integrator")}
    current = {k: getattr(config, k) for k in stored}
    if stored != current:
        raise ValueError(f"checkpoint config mismatch: {stored} != {current}")
    return acc
