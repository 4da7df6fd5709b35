"""PyTorch port: the ``Renderer`` class (RTrace/renderer.swift:29-146
analog) — the cases of tests/test_renderer.py on the CPU, a frame against
the JAX package's ``Renderer``, the three routes against each other, the
one-time work, and the two choices of the JAX class the port does not
keep."""
import os

import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.renderer import Renderer as JaxRenderer
from gpuraytracer_tpu_torch import image, ops
from gpuraytracer_tpu_torch import renderer as trenderer
from gpuraytracer_tpu_torch.render import render
from gpuraytracer_tpu_torch.renderer import Renderer
from gpuraytracer_tpu_torch.scene import cornell_box, legacy_cornell
from gpuraytracer_tpu_torch.types import RenderConfig

_KW = dict(width=32, height=24, integrator="path", spp=2, bounces=2,
           pixel_chunk=768)
_CFG = RenderConfig(**_KW)
HDR_TOL = dict(atol=2e-5, rtol=1e-4)
MIS_TOL = dict(atol=5e-4, rtol=1e-3)


def test_renderer_draw_writes_png(tmp_path):
    r = Renderer(cornell_box(resolution=(32, 24)), _CFG, device="cpu")
    out = str(tmp_path / "frame.png")
    elapsed = r.draw(out, verbose=False)
    assert elapsed > 0.0
    assert image.read_png(out).shape == (24, 32, 3)
    assert torch.isfinite(r.last_hdr).all()


def test_renderer_repeated_draw(tmp_path):
    r = Renderer(cornell_box(resolution=(32, 24)), _CFG, device="cpu")
    r.draw(str(tmp_path / "a.png"), verbose=False)
    first = r.last_hdr
    assert r.draw(str(tmp_path / "b.png"), verbose=False) < 2.0
    assert torch.equal(r.last_hdr, first)


def test_renderer_progressive_accumulation():
    """Two batches of spp each: the seeds advance, so the mean is not the
    first batch repeated, but it stays finite and close to it."""
    r = Renderer(cornell_box(resolution=(32, 24)), _CFG, device="cpu")
    acc, img1 = r.draw_accumulate()
    acc, img2 = r.draw_accumulate(acc)
    assert int(acc.spp_done) == 2 * _CFG.spp and int(acc.seed_cursor) == 2
    assert torch.isfinite(img2).all() and not torch.equal(img1, img2)
    m1, m2 = float(img1.mean()), float(img2.mean())
    assert abs(m1 - m2) < 0.5 * max(m1, 1e-6)


def test_renderer_default_scene():
    r = Renderer(config=_CFG, device="cpu")
    assert r.render_hdr().shape == (24, 32, 3)
    assert r.scene.camera.resolution.tolist() == [32, 24]
    assert Renderer(device="cpu").config == RenderConfig(
        width=800, height=600, integrator="path", spp=400, bounces=3)


def test_renderer_frame_matches_jax_renderer():
    ours = Renderer(config=_CFG, device="cpu").render_hdr().numpy()
    theirs = JaxRenderer(config=jtypes.RenderConfig(**_KW),
                         kernel="jnp").render_hdr()
    np.testing.assert_allclose(ours, np.asarray(jax.device_get(theirs)),
                               **HDR_TOL)


@pytest.mark.parametrize("integrator", ["path", "direct"])
def test_renderer_routes_agree(integrator):
    """The kernel routes (their plain versions on the CPU) against the
    oracle on the same config."""
    cfg = _CFG.replace(integrator=integrator)
    scene = cornell_box(resolution=(32, 24))
    eager = Renderer(scene, cfg, kernel="eager", device="cpu").render_hdr()
    for kernel in ("cuda", "decoupled"):
        hdr = Renderer(scene, cfg, kernel=kernel, device="cpu").render_hdr()
        np.testing.assert_allclose(hdr.numpy(), eager.numpy(), **HDR_TOL)


def test_renderer_one_time_work_runs_once(monkeypatch):
    """The decoupled route makes the occluder cull and the draws in
    __init__, once, whatever the number of frames."""
    calls = {"occluders": 0, "draws": 0}
    real_occ, real_draws = trenderer.potential_occluders, ops.pregen_draws

    def occ(*a, **k):
        calls["occluders"] += 1
        return real_occ(*a, **k)

    def draws(*a, **k):
        calls["draws"] += 1
        return real_draws(*a, **k)

    monkeypatch.setattr(trenderer, "potential_occluders", occ)
    monkeypatch.setattr(ops, "pregen_draws", draws)
    r = Renderer(cornell_box(resolution=(32, 24)), _CFG, kernel="decoupled",
                 device="cpu")
    first = r.render_hdr()
    second = r.render_hdr()
    assert calls == {"occluders": 1, "draws": 1}
    assert torch.equal(first, second)
    assert r.draws is not None and len(r.occluders) == 36


def test_renderer_decoupled_mis_renders_mis(tmp_path):
    """The JAX class renders the path tracer for decoupled + MIS and
    tonemaps that frame as MIS; the port renders the MIS integrator, as
    both command lines do."""
    cfg = RenderConfig(width=16, height=12, integrator="mis", camera_rays=1,
                       mis_samples=3, pixel_chunk=192)
    scene = cornell_box(resolution=(16, 12))
    r = Renderer(scene, cfg, kernel="decoupled", device="cpu")
    hdr = r.render_hdr()
    np.testing.assert_allclose(
        hdr.numpy(), render(scene, cfg, device="cpu").hdr.numpy(), **MIS_TOL)
    out = str(tmp_path / "mis.png")
    r.draw(out, verbose=False)
    assert image.read_png(out).shape == (12, 16, 3)


@pytest.mark.parametrize("kernel", ["cuda", "decoupled"])
def test_renderer_legacy_takes_eager_only(kernel):
    """The JAX class renders the path tracer for legacy + its kernel; the
    port refuses, as the JAX command line does."""
    cfg = RenderConfig(width=16, height=16, integrator="legacy")
    with pytest.raises(ValueError, match="legacy"):
        Renderer(legacy_cornell("sphere", resolution=(16, 16)), cfg,
                 kernel=kernel, device="cpu")


def test_renderer_draw_legacy(tmp_path):
    cfg = RenderConfig(width=16, height=16, integrator="legacy",
                       legacy_samples=3, legacy_bounce_samples=3,
                       legacy_bounces=1, pixel_chunk=256)
    r = Renderer(legacy_cornell("box", resolution=(16, 16)), cfg,
                 device="cpu")
    out = str(tmp_path / "legacy.png")
    r.draw(out, verbose=False)
    assert os.path.getsize(out) > 0 and torch.isfinite(r.last_hdr).all()
