"""PyTorch port vs the JAX package: inverse rendering (``grad/inverse.py``),
the slice as a whole on the CPU.

Gradient parity with the JAX package is checked step by step — the loss and
its gradient at the parameters each of the first optimizer steps starts from —
not by comparing trajectories, which amplify rounding. Tolerance: atol 1e-6 +
rtol 1e-4 (the JAX package's own for path gradients), the absolute part
scaled by each parameter group's largest gradient, because a pixel loss
multiplies two f32 images that agree to 2e-5 only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.grad.inverse as jinv
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.grad import inverse
from gpuraytracer_tpu_torch.grad.inverse import (SceneParams, apply_params,
                                                 extract_params,
                                                 fast_pixel_loss,
                                                 finite_difference_grad,
                                                 inverse_render, pixel_loss,
                                                 render_hdr)
from gpuraytracer_tpu_torch.scene import cornell_box_with_spheres
from gpuraytracer_tpu_torch.types import RenderConfig

GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _direct_cfg(**kw):
    base = dict(width=24, height=24, integrator="direct", spp=2, bounces=1,
                pixel_chunk=576)
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def scene():
    return cornell_box_with_spheres(resolution=(24, 24))


def _with_light_scale(scene, scale):
    light = dataclasses.replace(scene.light, color=scene.light.color * scale)
    return dataclasses.replace(scene, light=light)


def recording(base, log, **kw):
    """``params -> optimizer`` that notes, at every step, the parameters the
    step starts from and their gradients."""
    class Recording(base):
        def step(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            log.append(([p.detach().clone() for p in params],
                        [p.grad.detach().clone() for p in params]))
            return super().step(closure)
    return lambda params: Recording(params, **kw)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_params_cross_to_the_jax_package_and_back():
    jax_scene = jscene.cornell_box_with_spheres(resolution=(24, 24))
    ref = jinv.extract_params(jax_scene)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref))
    assert isinstance(params, SceneParams)
    port = extract_params(convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene)))
    for a, b, r in zip(params, port, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    back = convert.params_to_numpy(params)
    assert sorted(back) == sorted(SceneParams._fields)
    again = convert.params_from_numpy(back)
    assert all(torch.equal(a, b) for a, b in zip(params, again))
    from_tuple = convert.params_from_numpy(tuple(back[f]
                                                 for f in SceneParams._fields))
    assert all(torch.equal(a, b) for a, b in zip(params, from_tuple))


def test_apply_params_clamps_the_albedo(scene):
    params = extract_params(scene)
    wild = params._replace(
        sphere_diffuse=params.sphere_diffuse * 3.0 - 0.5,
        light_emission=params.light_emission * 2.0)
    out = apply_params(scene, wild)
    assert out.spheres.diffuse.min() >= 0.0 and out.spheres.diffuse.max() <= 1.0
    assert torch.equal(out.light.color, wild.light_emission)
    assert torch.equal(out.spheres.center, params.sphere_centers)
    assert torch.equal(out.triangles.verts, scene.triangles.verts)


def test_pixel_loss_zero_at_truth(scene):
    cfg = _direct_cfg()
    params = extract_params(scene)
    target = render_hdr(apply_params(scene, params), cfg, device="cpu")
    assert pixel_loss(params, scene, cfg, target, device="cpu").item() == 0.0


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def test_finite_differences_match_autograd_on_light_emission(scene):
    cfg = _direct_cfg()

    def f(scale):
        return render_hdr(_with_light_scale(scene, scale), cfg,
                          device="cpu").mean()

    x = torch.tensor(1.0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(f(x), [x])
    g_fd = finite_difference_grad(f, torch.tensor(1.0), 1e-2)
    assert g_fd.shape == () and g_ad.item() > 0
    assert g_ad.item() == pytest.approx(g_fd.item(), rel=1e-3)


def test_finite_differences_match_autograd_on_sphere_albedo(scene):
    cfg = _direct_cfg()
    base = scene.spheres.diffuse

    def f(diffuse):
        spheres = dataclasses.replace(scene.spheres, diffuse=diffuse)
        return render_hdr(dataclasses.replace(scene, spheres=spheres), cfg,
                          device="cpu").mean()

    x = base.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(f(x), [x])
    g_fd = finite_difference_grad(f, base, 1e-2)
    assert g_fd.shape == base.shape
    np.testing.assert_allclose(g_ad.numpy(), g_fd.numpy(), rtol=1e-3,
                               atol=1e-7)


def test_fast_pixel_loss_grads_match_oracle():
    """``fast_pixel_loss`` (trace + the backward kernel's plain version)
    gives the parameter gradients of ``pixel_loss`` (eager oracle)."""
    scene = cornell_box_with_spheres(resolution=(64, 64))
    cfg = RenderConfig(width=64, height=64, integrator="path", spp=1,
                       bounces=2, pixel_chunk=4096, replay_sample_chunk=1)
    target = torch.zeros((64, 64, 3))
    grads = []
    for loss_fn in (fast_pixel_loss, pixel_loss):
        params = SceneParams(*(p.clone().requires_grad_(True)
                               for p in extract_params(scene)))
        loss = loss_fn(params, scene, cfg, target, device="cpu")
        grads.append(torch.autograd.grad(loss, list(params)))
    for a, b in zip(*grads):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_first_steps_match_jax_gradients():
    """The loss and the gradient ``inverse_render(fast=True)`` hands its
    optimizer at each of its first three steps equal ``jax.grad`` of the JAX
    package's ``pixel_loss`` at the same parameters and target."""
    kw = dict(width=32, height=16, integrator="path", spp=1, bounces=2,
              pixel_chunk=512)
    jax_scene = jscene.cornell_box_with_spheres(resolution=(32, 16))
    jcfg = jtypes.RenderConfig(**kw)
    target = np.asarray(jinv.render_hdr(jax_scene, jcfg))
    scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))
    true = extract_params(scene)
    init = SceneParams(sphere_centers=true.sphere_centers + 0.05,
                       sphere_diffuse=true.sphere_diffuse * 0.8,
                       light_emission=true.light_emission * 1.2)
    log = []
    result = inverse_render(
        scene, torch.from_numpy(target), init, RenderConfig(**kw), steps=3,
        fast=True, device="cpu",
        optimizer=recording(torch.optim.Adam, log, lr=1e-2))
    assert len(log) == 3 and result.losses.shape == (3,)
    assert all(torch.equal(a, b) for a, b in zip(log[0][0], init))
    for (at, grads), loss in zip(log, result.losses):
        params = jinv.SceneParams(*(jnp.asarray(p.numpy()) for p in at))
        ref_loss, ref = jinv.loss_and_grad(params, jax_scene, jcfg,
                                           jnp.asarray(target))
        assert loss.item() == pytest.approx(float(ref_loss), rel=1e-4)
        for name, got, want in zip(SceneParams._fields, grads, ref):
            want = np.asarray(want)
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4,
                atol=1e-6 + 1e-4 * np.abs(want).max(), err_msg=name)
    # The parameters moved between the steps: three different points.
    assert not torch.equal(log[0][0][2], log[2][0][2])


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def test_inverse_rendering_fast_loop_converges():
    """The kernel path's loop recovers a light-emission scale from a target
    image (the JAX package's fast-loop test, same size and thresholds)."""
    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, integrator="path", spp=1,
                       bounces=2, pixel_chunk=512)
    true = extract_params(scene)
    target = render_hdr(scene, cfg, device="cpu")
    init = true._replace(light_emission=true.light_emission * 0.4)
    res = inverse_render(scene, target, init, cfg, steps=60,
                         learning_rate=1e-2, fast=True, device="cpu")
    losses = res.losses.numpy()
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.2
    np.testing.assert_allclose(res.params.light_emission.numpy(),
                               true.light_emission.numpy(), rtol=0.15)
    assert not any(p.requires_grad for p in res.params)


def test_inverse_rendering_recovers_emission_and_albedo(scene):
    """The oracle's loop (``fast=False``): perturb light emission and sphere
    albedo, recover both by Adam on the pixel loss (the JAX package's test,
    same size and thresholds)."""
    cfg = _direct_cfg(spp=1)
    true = extract_params(scene)
    target = render_hdr(apply_params(scene, true), cfg, device="cpu")
    init = SceneParams(
        sphere_centers=true.sphere_centers,
        sphere_diffuse=torch.clamp(true.sphere_diffuse * 0.5, 0.05, 1.0),
        light_emission=true.light_emission * 1.8)
    res = inverse_render(scene, target, init, cfg, steps=150,
                         learning_rate=3e-2, device="cpu")
    losses = res.losses.numpy()
    assert losses[-1] < losses[0] * 0.05
    np.testing.assert_allclose(res.params.light_emission.numpy(),
                               true.light_emission.numpy(), atol=0.08)


def test_hoisting_changes_no_loss():
    """Draws and occluder mask made once outside the loop, or anew inside
    every step: the same losses, bit for bit."""
    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = RenderConfig(width=32, height=16, integrator="path", spp=2,
                       bounces=2, pixel_chunk=512)
    true = extract_params(scene)
    target = render_hdr(scene, cfg, device="cpu")
    init = true._replace(light_emission=true.light_emission * 0.7,
                         sphere_centers=true.sphere_centers + 0.02)
    runs = [inverse_render(scene, target, init, cfg, steps=3, fast=True,
                           learning_rate=1e-2, hoist=hoist, device="cpu")
            for hoist in (True, False)]
    assert torch.equal(runs[0].losses, runs[1].losses)
    assert all(torch.equal(a, b)
               for a, b in zip(runs[0].params, runs[1].params))


def test_optimizer_argument_and_zero_steps(scene):
    cfg = _direct_cfg(spp=1)
    true = extract_params(scene)
    target = render_hdr(scene, cfg, device="cpu")
    init = true._replace(light_emission=true.light_emission * 0.5)
    made = []

    def sgd(params):
        made.append(torch.optim.SGD(params, lr=5.0, momentum=0.9))
        return made[-1]

    res = inverse_render(scene, target, init, cfg, steps=4, optimizer=sgd,
                         device="cpu")
    assert len(made) == 1 and res.losses[-1] < res.losses[0]
    none = inverse_render(scene, target, init, cfg, steps=0, device="cpu")
    assert none.losses.shape == (0,)
    assert all(torch.equal(a, b) for a, b in zip(none.params, init))


# ---------------------------------------------------------------------------
# The edge-aware loss
# ---------------------------------------------------------------------------

SOFT_SHIFTS = [[0.15, 0.0, -0.1], [-0.1, 0.05, 0.1]]
SOFT_LR = 3.5e2  # the JAX package's center-recovery rate (test_soft_fused.py)


@pytest.fixture(scope="module")
def jax_soft_run():
    """The JAX package's ``inverse_render(soft=True)`` (its default: the
    edge-aware oracle, SGD with momentum 0.9) for 3 steps from shifted
    sphere centers: (scene, target, init, losses, final parameters)."""
    jax_scene = jscene.cornell_box_with_spheres(resolution=(24, 24))
    jcfg = jtypes.RenderConfig(width=24, height=24, integrator="direct",
                               spp=2, bounces=1, pixel_chunk=576)
    true = jinv.extract_params(jax_scene)
    init = true._replace(
        sphere_centers=true.sphere_centers + jnp.array(SOFT_SHIFTS))
    target = jinv.render_hdr(jax_scene, jcfg)
    res = jinv.inverse_render(jax_scene, target, init, jcfg, steps=3,
                              learning_rate=SOFT_LR, soft=True, kappa=0.1)
    return (convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene)),
            torch.from_numpy(np.array(target)),
            SceneParams(*(torch.from_numpy(np.array(p)) for p in init)),
            np.asarray(res.losses), [np.asarray(p) for p in res.params])


@pytest.mark.parametrize("fast", [False, True])
def test_soft_first_steps_match_jax(jax_soft_run, fast):
    """``inverse_render(soft=True)`` with its default optimizer (SGD with
    momentum 0.9, as optax's ``sgd(momentum=0.9)``: both start from the
    gradient) takes the JAX package's first three steps: equal losses at
    every step (rtol 1e-4, a pixel loss of two images that agree to 2e-5)
    and equal parameters after the third: within 1e-4 of the distance the
    steps moved them (the gradients agree to rtol 1e-4) plus 1e-6."""
    scene, target, init, ref_losses, ref_params = jax_soft_run
    res = inverse_render(scene, target, init, _direct_cfg(), steps=3,
                         learning_rate=SOFT_LR, soft=True, fast=fast,
                         kappa=0.1, device="cpu")
    np.testing.assert_allclose(res.losses.numpy(), ref_losses, rtol=1e-4)
    for name, got, ref, start in zip(SceneParams._fields, res.params,
                                     ref_params, init):
        moved = np.abs(ref - start.numpy()).max()
        assert moved > 1e-3, name  # the three steps did move them
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * moved + 1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# What must raise
# ---------------------------------------------------------------------------

def test_default_device_raises_without_a_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = _direct_cfg()
    params = extract_params(scene)
    target = torch.zeros((24, 24, 3))
    with pytest.raises(RuntimeError, match="cuda"):
        inverse_render(scene, target, params, cfg, steps=1, fast=True)
    with pytest.raises(RuntimeError, match="cuda"):
        inverse.pixel_loss(params, scene, cfg, target)
