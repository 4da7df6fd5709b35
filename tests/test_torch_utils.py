"""PyTorch port: progressive accumulation and checkpoints (against the JAX
package's, and the .npz files both ways), debug checks, metrics, profiler
traces and the H100 roofline bound."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.utils import checkpoint as jckpt
from gpuraytracer_tpu_torch.render import render
from gpuraytracer_tpu_torch.scene import cornell_box
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils import checkpoint as ckpt
from gpuraytracer_tpu_torch.utils import debug
from gpuraytracer_tpu_torch.utils.metrics import (
    mrays_per_s, nominal_rays, profiler_trace, roofline)

HDR_TOL = dict(atol=2e-5, rtol=1e-4)
_KW = dict(width=16, height=16, integrator="path", spp=4, bounces=2,
           pixel_chunk=256)


@pytest.fixture(scope="module")
def scene():
    return cornell_box(resolution=(16, 16))


def _cfg(**kw):
    return RenderConfig(**dict(_KW, **kw))


def _acc(scene, cfg, batches, kernel="eager"):
    acc = ckpt.init_accumulator(cfg, "cpu")
    for _ in range(batches):
        acc = ckpt.accumulate(scene, cfg, acc, cfg.spp, kernel=kernel,
                              device="cpu")
    return acc


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Accumulation and checkpoints
# ---------------------------------------------------------------------------

def test_progressive_accumulation_matches_mc_statistics(scene):
    """Two batches of 4 spp give the mean of the union of two sample sets
    (the seed advances), not the first batch again."""
    cfg = _cfg()
    acc = _acc(scene, cfg, 2)
    assert int(acc.spp_done) == 8 and int(acc.seed_cursor) == 2
    img = ckpt.resolve(acc)
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    first = render(scene, cfg, device="cpu").hdr
    second = render(scene, cfg.replace(seed=1), device="cpu").hdr
    assert not torch.equal(img, first)
    torch.testing.assert_close(img, (first * 4 + second * 4) / 8.0,
                               atol=1e-6, rtol=1e-6)


def test_accumulate_matches_jax(scene):
    cfg = _cfg()
    jcfg = jtypes.RenderConfig(**_KW)
    jscn = jscene.cornell_box(resolution=(16, 16))
    jacc = jckpt.init_accumulator(jcfg)
    for _ in range(2):
        jacc = jckpt.accumulate(jscn, jcfg, jacc, 4, kernel="jnp")
    acc = _acc(scene, cfg, 2)
    assert int(acc.spp_done) == int(jacc.spp_done) == 8
    assert int(acc.seed_cursor) == int(jacc.seed_cursor) == 2
    np.testing.assert_allclose(ckpt.resolve(acc).numpy(),
                               np.asarray(jckpt.resolve(jacc)), **HDR_TOL)


@pytest.mark.parametrize("kernel", ["decoupled", "cuda"])
def test_kernel_accumulation_matches_oracle_and_resumes(scene, tmp_path,
                                                        kernel):
    """Accumulating two batches through a kernel route (plain versions on
    the CPU) equals the oracle's accumulation of the same seeded batches,
    and a save / load between the batches changes nothing."""
    cfg = _cfg(spp=2)
    acc_o = _acc(scene, cfg, 2)
    acc_k = ckpt.accumulate(scene, cfg, ckpt.init_accumulator(cfg, "cpu"), 2,
                            kernel=kernel, device="cpu")
    path = str(tmp_path / "acc_fused.npz")
    ckpt.save_accumulator(path, acc_k, cfg)
    acc_k = ckpt.load_accumulator(path, cfg, device="cpu")
    acc_k = ckpt.accumulate(scene, cfg, acc_k, 2, kernel=kernel,
                            device="cpu")
    assert int(acc_k.spp_done) == int(acc_o.spp_done) == 4
    np.testing.assert_allclose(ckpt.resolve(acc_k).numpy(),
                               ckpt.resolve(acc_o).numpy(), **HDR_TOL)


def test_direct_accumulation_clamps_bounces(scene):
    """integrator="direct" is one bounce through every route: the kernel
    routes clamp the config's bounces as the oracle does."""
    cfg = _cfg(integrator="direct", bounces=3, spp=2)
    eager = _acc(scene, cfg, 1)
    for kernel in ("decoupled", "cuda"):
        got = _acc(scene, cfg, 1, kernel=kernel)
        np.testing.assert_allclose(got.radiance_sum.numpy(),
                                   eager.radiance_sum.numpy(), **HDR_TOL)
    three = _acc(scene, cfg.replace(integrator="path"), 1, kernel="cuda")
    assert not np.allclose(three.radiance_sum.numpy(),
                           eager.radiance_sum.numpy(), **HDR_TOL)


@pytest.mark.parametrize("kernel", ["decoupled", "cuda"])
def test_kernel_accumulation_takes_the_path_tracer_only(scene, kernel):
    cfg = _cfg(integrator="mis", camera_rays=1, mis_samples=3)
    with pytest.raises(ValueError, match="path tracer"):
        ckpt.accumulate(scene, cfg, ckpt.init_accumulator(cfg, "cpu"), 1,
                        kernel=kernel, device="cpu")


def test_checkpoint_roundtrip(scene, tmp_path):
    cfg = _cfg()
    acc = _acc(scene, cfg, 1)
    path = str(tmp_path / "acc.npz")
    ckpt.save_accumulator(path, acc, cfg)
    assert sorted(os.listdir(tmp_path)) == ["acc.npz"]
    back = ckpt.load_accumulator(path, cfg, device="cpu")
    for a, b in zip(back, acc):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = ckpt.accumulate(scene, cfg, back, 4, device="cpu")
    assert int(resumed.spp_done) == 8


def test_checkpoint_config_mismatch(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "acc.npz")
    ckpt.save_accumulator(path, ckpt.init_accumulator(cfg, "cpu"), cfg)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_accumulator(path, _cfg(width=32), device="cpu")


@pytest.mark.parametrize("name", ["acc.npz", "acc.ckpt"])
def test_accumulator_interchange_with_jax(scene, tmp_path, name):
    """An accumulator saved by either package loads in the other with equal
    bits, file names ending in .npz or not."""
    cfg = _cfg()
    jcfg = jtypes.RenderConfig(**_KW)
    ours = _acc(scene, cfg, 1)
    path = str(tmp_path / ("port-" + name))
    ckpt.save_accumulator(path, ours, cfg)
    theirs = jckpt.load_accumulator(path, jcfg)
    for a, b in zip(theirs, ours):
        assert _bits_equal(jax.device_get(a), b.numpy())

    jacc = jckpt.accumulate(jscene.cornell_box(resolution=(16, 16)), jcfg,
                            jckpt.init_accumulator(jcfg), 4)
    path = str(tmp_path / ("jax-" + name))
    jckpt.save_accumulator(path, jacc, jcfg)
    back = ckpt.load_accumulator(path, cfg, device="cpu")
    for a, b in zip(back, jacc):
        assert _bits_equal(a.numpy(), jax.device_get(b))
    assert sorted(os.listdir(tmp_path)) == sorted(["port-" + name,
                                                   "jax-" + name])


def test_pytree_of_dicts_and_tuples_roundtrip(tmp_path):
    """Leaves in the JAX package's order (dict keys sorted), any nesting,
    None an empty subtree."""
    tree = {"b": (torch.arange(3), None), "a": [torch.ones(2, 2)],
            "c": torch.tensor(2.5)}
    path = str(tmp_path / "tree.npz")
    ckpt.save_pytree(path, tree, meta={"step": 7})
    with np.load(path) as data:
        assert data["leaf_0"].shape == (2, 2)  # "a" first
    back, meta = ckpt.load_pytree(path, tree)
    assert meta == {"step": 7} and list(back) == ["b", "a", "c"]
    assert torch.equal(back["b"][0], tree["b"][0]) and back["b"][1] is None
    assert torch.equal(back["a"][0], tree["a"][0])
    assert torch.equal(back["c"], tree["c"])


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_nominal_rays():
    assert nominal_rays(_cfg()) == 16 * 16 * 4 * 2 * 2
    assert nominal_rays(_cfg(integrator="direct")) == 16 * 16 * 4 * 2
    mis = _cfg(integrator="mis", camera_rays=2, mis_samples=30)
    assert nominal_rays(mis) == 16 * 16 * 2 * (1 + 10 * 5)
    assert mrays_per_s(_cfg(), 1.0) == pytest.approx(
        nominal_rays(_cfg()) / 1e6)
    with pytest.raises(ValueError, match="legacy"):
        nominal_rays(_cfg(integrator="legacy"))


def test_profiler_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiler_trace(str(log_dir)):
        torch.ones(64).mul(3.0).sum()
    (trace,) = list(log_dir.iterdir())
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "aten::mul" in names


def test_roofline_bound():
    # The H100's peaks: 3.35 TB/s, 67 TFLOP/s of float32.
    assert roofline(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert roofline(0, 67e9) == (pytest.approx(1.0), "operations")


# ---------------------------------------------------------------------------
# Debug checks
# ---------------------------------------------------------------------------

def test_debug_checks_catch_a_nan_and_restore_state():
    assert not torch.is_anomaly_enabled()
    with debug.debug_checks(nans=True):
        assert torch.is_anomaly_enabled()
        assert float(torch.ones(4).sum()) == 4.0  # a clean op passes
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.zeros(2) - 1.0)
        # An Inf is not a NaN.
        assert torch.isinf(torch.ones(1) / 0.0).all()
        # Uninitialized memory and views are not checked.
        torch.empty(1024).view(32, 32)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.zeros(2) - 1.0)).all()


def test_debug_checks_infs_and_the_backward():
    with debug.debug_checks(nans=False, infs=True):
        with pytest.raises(FloatingPointError, match="Inf"):
            torch.ones(1) / 0.0
    x = torch.zeros(3, requires_grad=True)
    with debug.debug_checks(nans=True):
        y = torch.sqrt(x).sum()  # finite forward, 0 * inf backward
        with pytest.raises((FloatingPointError, RuntimeError)):
            (y * 0.0).backward()
    assert not torch.is_anomaly_enabled()


def test_debug_enable_disable():
    try:
        debug.enable(nans=True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(1) - 1.0)
    finally:
        debug.disable()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.zeros(1) - 1.0)).all()


def test_debug_checks_pass_the_oracles(scene):
    """The oracles' masked arithmetic makes no NaN, dead lanes included."""
    with debug.debug_checks(nans=True):
        for cfg in (_cfg(spp=1), _cfg(integrator="mis", camera_rays=1,
                                      mis_samples=3)):
            assert torch.isfinite(render(scene, cfg, device="cpu").hdr).all()
