"""The plain reference: frames and fit steps in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
builds its inputs from the benchmark's own scene arrays (``portbench/
scenes.py``) and the cell's traffic, and works in the dtype it is given
(float32, the configurations' precision; the control runs it in
bfloat16). Matrix products run without TF32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import sampling as smp
from .integrators import mis_blocks, path_blocks
from .trace import Tracer, compile_triangles

# Lanes of one block: pixels x samples.
PATH_LANES = 1 << 21
MIS_LANES = 1 << 22


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scene_tensors(tree: Dict, dtype, device) -> Dict:
    """The scene's camera, light and triangles as tensors of ``dtype``."""
    def conv(part):
        return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
                for k, v in tree[part].items() if k != "resolution"}
    if tree["spheres"]["center"].shape[0]:
        raise ValueError("the plain reference renders triangle scenes only")
    return dict(camera=conv("camera"), light=conv("light"),
                triangles=conv("triangles"),
                resolution=tuple(int(x) for x in
                                 tree["camera"]["resolution"]))


def _blocks(sc: Dict, light: Dict, traffic: Dict, tracer: Tracer,
            pixels: torch.Tensor, dtype):
    if traffic["integrator"] == "path":
        offsets = smp.pixel_offsets(traffic["width"] * traffic["height"],
                                    traffic["seed"], pixels.device)[pixels]
        sb = min(traffic["spp"], max(1, PATH_LANES // pixels.shape[0]))
        pb = max(1, PATH_LANES // sb)
        return path_blocks(sc["camera"], sc["resolution"], light, tracer,
                           pixels, offsets, traffic["spp"],
                           traffic["bounces"], pb, sb, dtype)
    s_per = traffic["mis_samples"] // 3
    sb = min(s_per, 50)
    pb = max(1, MIS_LANES // sb)
    return mis_blocks(sc["camera"], sc["resolution"], light, tracer, pixels,
                      traffic["camera_rays"], traffic["mis_samples"], pb, sb,
                      dtype)


class Reference:
    """One scene and one traffic mix; ``params`` names scene tensors
    (``triangles.diffuse``, ``light.color``, ``light.emitted_radiance``)
    whose values a caller sets. Triangle diffuse is clamped to [0, 1], as
    the program's fit clamps it."""

    def __init__(self, tree: Dict, traffic: Dict, dtype=torch.float32,
                 device="cuda"):
        _no_tf32()
        self.traffic, self.dtype, self.device = traffic, dtype, device
        self.sc = scene_tensors(tree, dtype, device)
        self.tracer = Tracer(compile_triangles(self.sc["triangles"]["verts"]))
        self.traced = False

    def _materials(self, values: Dict[str, torch.Tensor]):
        tri = dict(self.sc["triangles"])
        light = dict(self.sc["light"])
        for name, v in values.items():
            part, key = name.split(".")
            if name == "triangles.diffuse":
                v = torch.clamp(v, 0.0, 1.0)
            (tri if part == "triangles" else light)[key] = v
        self.tracer.set_materials(tri["diffuse"], tri["metallic"],
                                  tri["roughness"], tri["emissive"])
        return light

    def image(self, pixels: torch.Tensor, values: Dict[str, torch.Tensor],
              mode: str = "direct") -> torch.Tensor:
        """[P, 3] values at flat pixel ids, without gradients."""
        light = self._materials(values)
        self.tracer.start(mode)
        out = torch.zeros(pixels.shape + (3,), dtype=self.dtype,
                          device=self.device)
        with torch.no_grad():
            for sl, c in _blocks(self.sc, light, self.traffic, self.tracer,
                                 pixels, self.dtype):
                out[sl] += c
        return out

    def loss_and_grads(self, values: Dict[str, torch.Tensor],
                       target: torch.Tensor,
                       pixels: Optional[torch.Tensor] = None):
        """The mean squared pixel loss over the whole frame and its
        gradients in ``values``: the image once without gradients, then
        each block again with them, its vector-Jacobian product taken
        against the loss's cotangent. The first call tests every ray and
        keeps the decisions; later calls replay them. ``pixels``: flat ids
        of a share of the frame; the loss and gradients are then that
        share's terms of the whole frame's, which add up over the shares."""
        t = self.traffic
        n = t["width"] * t["height"]
        whole = pixels is None
        if whole:
            pixels = torch.arange(n, device=self.device)
        img = self.image(pixels, values,
                         "replay" if self.traced else "record")
        self.traced = True
        flat_target = target.reshape(-1, 3)
        if not whole:
            flat_target = flat_target[pixels]
        flat_target = flat_target.to(self.dtype)
        loss = (torch.mean((img - flat_target) ** 2) if whole
                else torch.sum((img - flat_target) ** 2) / (3 * n))
        cot = 2.0 * (img - flat_target) / (3 * n)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in values.items()}
        light = self._materials(leaves)
        self.tracer.start("replay")
        for sl, c in _blocks(self.sc, light, t, self.tracer, pixels,
                             self.dtype):
            if c.requires_grad:
                (c * cot[sl]).sum().backward(retain_graph=True)
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        return loss, grads


def adam(values: Dict[str, torch.Tensor], grad_fn, steps: int, lr: float,
         betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8):
    """``steps`` Adam steps written out: returns the losses, the first
    gradients and the values after the last step."""
    b1, b2 = betas
    m = {k: torch.zeros_like(v) for k, v in values.items()}
    v2 = {k: torch.zeros_like(v) for k, v in values.items()}
    values = {k: v.clone() for k, v in values.items()}
    losses: List[float] = []
    first = None
    for step in range(1, steps + 1):
        loss, grads = grad_fn(values)
        losses.append(float(loss))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        for k in values:
            g = grads[k]
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            m_hat = m[k] / (1 - b1 ** step)
            v_hat = v2[k] / (1 - b2 ** step)
            values[k] = values[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, values
