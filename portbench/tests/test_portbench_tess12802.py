"""The configuration ``tess12802`` and its cell ``tess12802.path_fit`` on the
CPU: the benchmark's scene copy bit for bit at ``(16, 4)``, the plain
reference against the port's eager oracle on the whole 12,802-triangle
scene (image and gradients, at a tiny frame), the harness through the cell
at a tiny size, and the cell's two readers of the program's ``PARTIALS``
counter, which find nothing to read in a program without it."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.metrics import bwd_grid_pct, partials_mb
from portbench.reference import Reference

CELL = "tess12802.path_fit"
ARGS = dict(wall_subdiv=16, sphere_subdiv=4)
TINY = dict(width=12, height=12, spp=2)


def test_scene_copy_is_bit_equal_to_the_ports_at_16_4():
    from gpuraytracer_tpu_torch import convert, scene
    ours = scenes.cornell_box_tessellated(resolution=(512, 512), **ARGS)
    port = convert.scene_to_numpy(
        scene.cornell_box_tessellated(resolution=(512, 512), **ARGS))
    assert ours["triangles"]["verts"].shape == (12802, 3, 3)
    for part, arrays in port.items():
        for key, value in arrays.items():
            mine = np.asarray(ours[part][key])
            assert mine.dtype == value.dtype and mine.shape == value.shape
            assert mine.tobytes() == value.tobytes(), (part, key)


def test_reference_agrees_with_autograd_through_the_oracle():
    """The reference's image, loss and gradients (``triangles.diffuse``,
    ``light.color``) against the port's eager oracle differentiated by
    autograd, on all 12,802 triangles at 12x10 x 3 spp x 3 bounces with
    seeded random albedos. The tolerances are
    ``test_portbench_reference.py``'s: both sides sum the same float32 terms
    in different orders (the reference in blocks of lanes, autograd through
    the oracle's chunks), so the image agrees to 1e-4 relative and the
    gradients, sums over many lanes and triangles, to 1e-3; the absolute
    floors take the triangles that a few lanes reach."""
    from gpuraytracer_tpu_torch import RenderConfig, convert
    from gpuraytracer_tpu_torch.render import render
    traffic = dict(integrator="path", width=12, height=10, spp=3, bounces=3,
                   seed=7)
    tree = scenes.cornell_box_tessellated(resolution=(12, 10), **ARGS)
    cfg = RenderConfig(**traffic)
    gen = torch.Generator().manual_seed(5)
    diffuse = torch.rand(tree["triangles"]["diffuse"].shape, generator=gen)
    target = torch.rand(cfg.height, cfg.width, 3, generator=gen) * 0.5
    color = torch.as_tensor(tree["light"]["color"])
    d = diffuse.clone().requires_grad_(True)
    c = color.clone().requires_grad_(True)
    scene = convert.scene_from_numpy(tree)
    scene = dataclasses.replace(
        scene,
        triangles=dataclasses.replace(scene.triangles,
                                      diffuse=torch.clamp(d, 0.0, 1.0)),
        light=dataclasses.replace(scene.light, color=c))
    img = render(scene, cfg, device="cpu").hdr
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    ref = Reference(tree, traffic, device="cpu")
    values = {"triangles.diffuse": diffuse, "light.color": color}
    mine = ref.image(torch.arange(cfg.num_pixels), values)
    torch.testing.assert_close(mine, img.detach().reshape(-1, 3), rtol=1e-4,
                               atol=1e-5)
    ref_loss, grads = ref.loss_and_grads(values, target)
    torch.testing.assert_close(ref_loss, loss.detach(), rtol=1e-4, atol=0)
    assert int((d.grad != 0).sum()) > 0
    torch.testing.assert_close(grads["triangles.diffuse"], d.grad,
                               rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(grads["light.color"], c.grad, rtol=1e-3,
                               atol=1e-9)


@pytest.mark.parametrize("fault", [None, "frozen_step", "half_batch",
                                   "altered_answer"])
def test_the_cell_runs_end_to_end_on_the_cpu(fault):
    """The harness through the new cell on the program's CPU path at a tiny
    size: sound, it is correct; with a fault planted, not correct."""
    from portbench import run
    lines = []
    result = run.run(CELL, 2**31 + 22, 0.1, False, device="cpu",
                     fault=fault, traffic_override=TINY, log=lines.append)
    assert result["correct"] is (fault is None), result["checks"]
    assert set(result["metrics"]) == {"mrays_s.host_bound", "step_p95_ms",
                                      "setup_s"}
    assert any(line.startswith("reference: ") for line in lines)


@pytest.mark.parametrize("reader", [partials_mb, bwd_grid_pct])
def test_readers_find_nothing_without_the_counter(monkeypatch, reader):
    from gpuraytracer_tpu_torch.ops import cuda_shade
    ctx = SimpleNamespace(traffic={}, config={}, num_triangles=12802)
    monkeypatch.delattr(cuda_shade, "PARTIALS")
    assert reader.read(None, ctx) is None
    monkeypatch.setattr(cuda_shade, "PARTIALS", dict(
        launches=0, bytes=0, blocks=0, blocks_full=0), raising=False)
    assert reader.read(None, ctx) is None


@pytest.mark.parametrize("reader, expected", [
    (partials_mb, 805.121808), (bwd_grid_pct, 100.0 * 393 / 528)])
def test_readers_read_the_counter(monkeypatch, reader, expected):
    """Two launches of K3g at 12,802 triangles on a 132-SM card: 393 of 528
    blocks, 2,048,656 B of tables a block."""
    from gpuraytracer_tpu_torch.ops import cuda_shade
    monkeypatch.setattr(cuda_shade, "PARTIALS", dict(
        launches=2, bytes=2 * 393 * 2_048_656, blocks=2 * 393,
        blocks_full=2 * 528))
    assert reader.read(None, None) == pytest.approx(expected, rel=1e-12)
