"""The benchmark's frozen inputs and its plain reference against the port
at this commit: the scene copies bit for bit, the reference against the
port's eager oracle at a tiny size (image and gradients), and the
reference's imports."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.reference import Reference
from portbench.rays import nominal_rays
from conftest import ROOT


@pytest.mark.parametrize("name,resolution", [
    ("cornell_box", (800, 600)), ("cornell_box_tessellated", (512, 512))])
def test_scene_copies_are_bit_equal_to_the_ports(name, resolution):
    from gpuraytracer_tpu_torch import convert, scene
    ours = scenes.BUILDERS[name](resolution=resolution)
    port = convert.scene_to_numpy(getattr(scene, name)(resolution=resolution))
    for part, arrays in port.items():
        for key, value in arrays.items():
            mine = np.asarray(ours[part][key])
            assert mine.dtype == value.dtype and mine.shape == value.shape
            assert mine.tobytes() == value.tobytes(), (part, key)


@pytest.mark.parametrize("traffic", [
    dict(integrator="path", width=40, height=30, spp=4, bounces=3),
    dict(integrator="mis", width=40, height=30, camera_rays=2,
         mis_samples=9)])
def test_nominal_rays_copy_equals_the_ports(traffic):
    from gpuraytracer_tpu_torch import RenderConfig
    from gpuraytracer_tpu_torch.utils.metrics import nominal_rays as port
    assert nominal_rays(traffic) == port(RenderConfig(**traffic))


def _tiny(integrator, scene_name):
    t = (dict(integrator="path", width=12, height=10, spp=3, bounces=3)
         if integrator == "path" else
         dict(integrator="mis", width=10, height=8, camera_rays=2,
              mis_samples=9))
    return dict(t, seed=7), scenes.BUILDERS[scene_name](
        resolution=(t["width"], t["height"]))


@pytest.mark.parametrize("scene_name", ["cornell_box",
                                        "cornell_box_tessellated"])
@pytest.mark.parametrize("integrator", ["path", "mis"])
def test_reference_image_agrees_with_the_ports_eager_oracle(integrator,
                                                            scene_name):
    from gpuraytracer_tpu_torch import RenderConfig, convert
    from gpuraytracer_tpu_torch.render import render
    traffic, tree = _tiny(integrator, scene_name)
    cfg = RenderConfig(**{k: v for k, v in traffic.items()})
    oracle = render(convert.scene_from_numpy(tree), cfg,
                           device="cpu").hdr.reshape(-1, 3)
    ref = Reference(tree, traffic, device="cpu")
    mine = ref.image(torch.arange(cfg.num_pixels), {})
    torch.testing.assert_close(mine, oracle, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("integrator", ["path", "mis"])
def test_reference_gradients_agree_with_autograd_through_the_oracle(
        integrator):
    import dataclasses
    from gpuraytracer_tpu_torch import RenderConfig, convert
    from gpuraytracer_tpu_torch.render import render
    traffic, tree = _tiny(integrator, "cornell_box")
    emission = "light.color" if integrator == "path" else \
        "light.emitted_radiance"
    cfg = RenderConfig(**traffic)
    gen = torch.Generator().manual_seed(3)
    target = torch.rand(cfg.height, cfg.width, 3, generator=gen) * (
        0.5 if integrator == "path" else 50.0)
    diffuse = torch.as_tensor(tree["triangles"]["diffuse"]) * 0.8
    light_value = torch.as_tensor(tree["light"][emission.split(".")[1]])
    # The oracle, differentiated by autograd.
    d = diffuse.clone().requires_grad_(True)
    e = light_value.clone().requires_grad_(True)
    scene = convert.scene_from_numpy(tree)
    scene = dataclasses.replace(
        scene,
        triangles=dataclasses.replace(scene.triangles,
                                      diffuse=torch.clamp(d, 0.0, 1.0)),
        light=dataclasses.replace(scene.light,
                                  **{emission.split(".")[1]: e}))
    img = render(scene, cfg, device="cpu").hdr
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    ref = Reference(tree, traffic, device="cpu")
    ref_loss, grads = ref.loss_and_grads(
        {"triangles.diffuse": diffuse, emission: light_value}, target)
    torch.testing.assert_close(ref_loss, loss.detach(), rtol=1e-4, atol=0)
    torch.testing.assert_close(grads["triangles.diffuse"], d.grad,
                               rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(grads[emission], e.grad, rtol=1e-3,
                               atol=1e-9)


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from portbench.reference import Reference\n"
        "from portbench import check, scenes, rays\n"
        "tree = scenes.cornell_box(resolution=(8, 6))\n"
        "t = dict(integrator='path', width=8, height=6, spp=2, bounces=2,"
        " seed=1)\n"
        "Reference(tree, t, device='cpu').image(torch.arange(48), {})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"gpuraytracer_tpu_torch", "gpuraytracer_tpu", "jax",
                      "jaxlib"}
