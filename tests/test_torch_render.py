"""PyTorch port vs the JAX package: the slice as a whole — the eager
renderer, the kernel path (plain versions on the CPU) and the command line."""
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render as jax_render
from gpuraytracer_tpu_torch import cli, convert, image
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch.ops import (render_mis_cuda, render_path_cuda,
                                        render_path_decoupled)
from gpuraytracer_tpu_torch.render import render, tonemap_mis
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils.metrics import mrays_per_s, nominal_rays

# The JAX package's own kernel-vs-oracle tolerance: f32 sums over a few
# bounces, with an ulp of rsqrt, sin, cos and of fused or unfused dot
# products between the two compilers.
HDR_TOL = dict(atol=2e-5, rtol=1e-4)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfgs(**kw):
    base = dict(width=32, height=16, spp=2, bounces=3, pixel_chunk=512)
    base.update(kw)
    return jtypes.RenderConfig(**base), RenderConfig(**base)


def _scenes(name):
    ctor = (jscene.cornell_box if name == "cornell"
            else jscene.cornell_box_with_spheres)
    jax_scene = ctor(resolution=(32, 16))
    return jax_scene, convert.scene_from_numpy(
        jax.tree.map(np.asarray, jax_scene))


CASES = {
    "cornell": ("cornell", {}),
    "cornell-one-bounce": ("cornell", dict(bounces=1)),
    "spheres": ("cornell-spheres", {}),
    "stratified": ("cornell", dict(spp=4, sampler="stratified")),
    "seed-3": ("cornell", dict(seed=3, spp=1)),
    "true-aspect": ("cornell", dict(integer_aspect=False, spp=1)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One JAX oracle render per case, shared by the tests below."""
    scene_name, kw = CASES[request.param]
    jax_scene, scene = _scenes(scene_name)
    jcfg, cfg = _cfgs(**kw)
    return scene, cfg, np.asarray(jax_render(jax_scene, jcfg).hdr)


def test_eager_render_matches_jax(case):
    scene, cfg, ref = case
    out = render(scene, cfg, device="cpu")
    assert out.ldr is None and out.hdr.shape == (16, 32, 3)
    np.testing.assert_allclose(out.hdr.numpy(), ref, **HDR_TOL)


def test_kernel_path_matches_jax(case):
    scene, cfg, ref = case
    hdr = render_path_cuda(scene, cfg, device="cpu")
    np.testing.assert_allclose(hdr.numpy(), ref, **HDR_TOL)


def test_decoupled_path_matches_jax(case):
    scene, cfg, ref = case
    hdr = render_path_decoupled(scene, cfg, device="cpu")
    np.testing.assert_allclose(hdr.numpy(), ref, **HDR_TOL)


def test_direct_integrator_is_one_bounce():
    _, scene = _scenes("cornell")
    _, cfg = _cfgs()
    direct = render(scene, cfg.replace(integrator="direct"), device="cpu").hdr
    one = render(scene, cfg.replace(bounces=1), device="cpu").hdr
    assert torch.equal(direct, one)


def test_seed_changes_the_image():
    _, scene = _scenes("cornell")
    _, cfg = _cfgs(spp=1, bounces=1)
    a = render_path_cuda(scene, cfg, device="cpu")
    b = render_path_cuda(scene, cfg.replace(seed=3), device="cpu")
    assert not torch.equal(a, b)


@pytest.mark.parametrize("integrator,slice_name", [("legacy", "legacy")])
def test_unported_integrators_raise(integrator, slice_name):
    """Every integrator of the JAX package is ported. What still raises:
    the legacy tier through a kernel route (it has no kernel; the JAX
    command line refuses it too) and an integrator neither package has."""
    _, scene = _scenes("cornell")
    _, cfg = _cfgs(integrator=integrator)
    for kernel in ("cuda", "decoupled"):
        with pytest.raises(SystemExit, match="--kernel eager only"):
            cli.main(["x.png", "--integrator", integrator, "--kernel",
                      kernel, "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown integrator"):
        render(scene, cfg.replace(integrator="bidirectional"), device="cpu")


@pytest.mark.parametrize("kind", ["sphere", "box", "square"])
def test_cli_legacy_integrator(tmp_path, capsys, kind):
    """``--integrator legacy`` at the defaults (30 / 2 / 30) on the legacy
    scenes: the CLI's PNG is the tonemapped oracle frame."""
    out = tmp_path / "l.png"
    assert cli.main([str(out), "--device", "cpu", "--integrator", "legacy",
                     "--scene", f"legacy-{kind}", "--width", "12",
                     "--height", "8"]) == 0
    assert f"Image saved to {out}" in capsys.readouterr().out
    cfg = RenderConfig(width=12, height=8, integrator="legacy")
    with torch.no_grad():
        hdr = render(tscene.legacy_cornell(kind, resolution=(12, 8)), cfg,
                     device="cpu").hdr.numpy()
    assert np.isfinite(hdr).all() and hdr.max() > 0.0
    got = image.read_png(str(out)).astype(int)
    assert np.abs(got - image.tonemap(hdr).astype(int)).max() <= 1


def test_cli_debug_nans(tmp_path):
    from gpuraytracer_tpu_torch.utils import debug
    out = tmp_path / "n.png"
    try:
        assert cli.main([str(out), "--device", "cpu", "--debug-nans",
                         "--width", "8", "--height", "8", "--spp", "1"]) == 0
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(1) - 1.0)
    finally:
        debug.disable()
    assert image.read_png(str(out)).shape == (8, 8, 3)


def test_render_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, scene = _scenes("cornell")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        render(scene, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["x.png", "--width", "8", "--height", "8", "--spp", "1"])


def test_ray_accounting():
    cfg = RenderConfig(width=800, height=600, spp=400, bounces=3)
    assert nominal_rays(cfg) == 800 * 600 * 400 * 3 * 2
    assert nominal_rays(cfg.replace(integrator="direct")) == (
        800 * 600 * 400 * 2)
    assert mrays_per_s(cfg, 2.0) == pytest.approx(800 * 600 * 400 * 3 / 1e6)
    # Variant A by the executed count: a primary ray and five traversals
    # per sample of each strategy, per camera ray.
    mis = RenderConfig(width=800, height=600, integrator="mis",
                       camera_rays=6, mis_samples=300)
    assert nominal_rays(mis) == 800 * 600 * 6 * (1 + 100 * 5)
    assert nominal_rays(mis.replace(mis_samples=302)) == nominal_rays(mis)
    assert mrays_per_s(mis, 1.0) == pytest.approx(1442.88)
    with pytest.raises(ValueError, match="no ray accounting"):
        nominal_rays(cfg.replace(integrator="legacy"))


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["eager", "cuda", "decoupled"])
@pytest.mark.parametrize("scene_name", ["cornell", "cornell-spheres"])
def test_cli_renders_a_png(kernel, scene_name, tmp_path, capsys):
    out = tmp_path / "frame.png"
    dbg = tmp_path / "debug.txt"
    rc = cli.main([str(out), "--device", "cpu", "--kernel", kernel,
                   "--scene", scene_name, "--width", "32", "--height", "16",
                   "--spp", "1", "--debug-output", str(dbg)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert re.search(r"Render completed in \d+\.\d\d seconds", printed)
    assert f"Image saved to {out}" in printed
    rgb = image.read_png(str(out))
    assert rgb.shape == (16, 32, 3) and rgb.dtype == np.uint8
    assert rgb.max() > 0
    rows = np.loadtxt(dbg)
    assert rows.shape == (16, 3) and np.isfinite(rows).all()

    # The PNG is the tonemapped image of the library call.
    ctor = (tscene.cornell_box if scene_name == "cornell"
            else tscene.cornell_box_with_spheres)
    cfg = RenderConfig(width=32, height=16, spp=1)
    hdr = render_path_cuda(ctor(resolution=(32, 16)), cfg, device="cpu")
    expect = image.tonemap(hdr.numpy())
    # Eager and kernel paths may differ by one grey level where a value
    # sits on a rounding boundary.
    assert np.abs(rgb.astype(int) - expect.astype(int)).max() <= 1


@pytest.mark.parametrize("kernel", ["eager", "cuda", "decoupled"])
@pytest.mark.parametrize("scene_name", ["cornell", "cornell-spheres"])
def test_cli_renders_a_mis_png(kernel, scene_name, tmp_path, capsys):
    """``--integrator mis`` through the three routes: the two lines of the
    reference, a PNG tonemapped by ``tonemap_mis`` and the raw hdr's rows."""
    out = tmp_path / "mis.png"
    dbg = tmp_path / "debug.txt"
    rc = cli.main([str(out), "--device", "cpu", "--integrator", "mis",
                   "--kernel", kernel, "--scene", scene_name,
                   "--width", "24", "--height", "12", "--camera-rays", "2",
                   "--mis-samples", "6", "--debug-output", str(dbg)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert re.search(r"Render completed in \d+\.\d\d seconds", printed)
    assert f"Image saved to {out}" in printed
    rgb = image.read_png(str(out))
    assert rgb.shape == (12, 24, 3) and rgb.dtype == np.uint8
    assert rgb.max() > 0
    rows = np.loadtxt(dbg)
    assert rows.shape == (12, 3) and np.isfinite(rows).all()

    ctor = (tscene.cornell_box if scene_name == "cornell"
            else tscene.cornell_box_with_spheres)
    cfg = RenderConfig(width=24, height=12, integrator="mis", camera_rays=2,
                       mis_samples=6)
    scene = ctor(resolution=(24, 12))
    hdr = render_mis_cuda(scene, cfg, device="cpu")
    expect = image.to_uint8(tonemap_mis(hdr, 2, scene.camera.ev100).numpy())
    # Eager and kernel paths may differ by a grey level or two where a
    # value sits on a rounding boundary.
    assert np.abs(rgb.astype(int) - expect.astype(int)).max() <= 2
    np.testing.assert_allclose(rows, hdr.numpy().mean(axis=1), rtol=2e-3,
                               atol=1e-3)


def test_cli_direct_integrator_and_devices_flag(tmp_path):
    out = tmp_path / "d.png"
    assert cli.main([str(out), "--device", "cpu", "--integrator", "direct",
                     "--kernel", "cuda", "--width", "16", "--height", "8",
                     "--spp", "1"]) == 0
    assert image.read_png(str(out)).shape == (8, 16, 3)
    # --devices N>1 shards the fused paths only (test_torch_multihost.py
    # renders with it).
    with pytest.raises(SystemExit, match="requires --kernel decoupled"):
        cli.main([str(out), "--device", "cpu", "--devices", "2"])
    with pytest.raises(SystemExit, match="requires --kernel decoupled"):
        cli.main([str(out), "--device", "cpu", "--devices", "2",
                  "--kernel", "decoupled", "--integrator", "legacy"])


def test_png_round_trip(tmp_path):
    rgb = image.gradient_pixels(24, 18)
    path = tmp_path / "gradient.png"
    image.write_png(str(path), rgb)
    np.testing.assert_array_equal(image.read_png(str(path)), rgb)
    assert image.to_uint8(np.array([[[0.0, 0.5, 2.0]]])).tolist() == [
        [[0, 127, 255]]]


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted((REPO / "gpuraytracer_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "gpuraytracer_tpu_torch").rglob("*.cu"))
    files += sorted((REPO / "gpuraytracer_tpu_torch").rglob("*.cuh"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+optax\b|from\s+optax\b"
        r"|import\s+gpuraytracer_tpu\b(?!_torch)"
        r"|from\s+gpuraytracer_tpu\b(?!_torch))", re.MULTILINE)
    files = _port_sources()
    assert len(files) > 15 and files[-1].exists()
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"gpuraytracer_tpu_torch/brdf.py",
            "gpuraytracer_tpu_torch/ops/cuda_mis.py",
            "gpuraytracer_tpu_torch/ops/csrc/mis_kernels.cu",
            "gpuraytracer_tpu_torch/grad/__init__.py",
            "gpuraytracer_tpu_torch/grad/inverse.py",
            "gpuraytracer_tpu_torch/ops/cuda_shade.py",
            "gpuraytracer_tpu_torch/ops/csrc/shade_kernels.cu",
            "gpuraytracer_tpu_torch/ops/csrc/halton.cuh",
            "gpuraytracer_tpu_torch/ops/cuda_mis_bwd.py",
            "gpuraytracer_tpu_torch/ops/csrc/mis_bwd_kernels.cu",
            "gpuraytracer_tpu_torch/ops/csrc/reduce.cuh",
            "gpuraytracer_tpu_torch/grad/diff_render.py",
            "gpuraytracer_tpu_torch/ops/cuda_soft.py",
            "gpuraytracer_tpu_torch/ops/csrc/soft_kernels.cu",
            "gpuraytracer_tpu_torch/ops/csrc/trace.cuh",
            "gpuraytracer_tpu_torch/render_legacy.py",
            "gpuraytracer_tpu_torch/renderer.py",
            "gpuraytracer_tpu_torch/native.py",
            "gpuraytracer_tpu_torch/utils/checkpoint.py",
            "gpuraytracer_tpu_torch/utils/debug.py",
            "gpuraytracer_tpu_torch/utils/metrics.py",
            "gpuraytracer_tpu_torch/parallel/__init__.py",
            "gpuraytracer_tpu_torch/parallel/multihost.py",
            "gpuraytracer_tpu_torch/parallel/mesh.py",
            "gpuraytracer_tpu_torch/parallel/fast.py",
            "gpuraytracer_tpu_torch/parallel/train.py"} <= names
    for path in files:
        found = pattern.findall(path.read_text())
        assert not found, f"{path}: {found}"


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports the whole port and the smoke script's
    module without jax, a compiler or a card."""
    import subprocess
    import sys
    code = (
        "import sys, importlib, pkgutil\n"
        "import gpuraytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gpuraytracer_tpu' or m.startswith('gpuraytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'gpuraytracer_tpu_torch.ops.cuda_mis_bwd' in sys.modules\n"
        "assert 'gpuraytracer_tpu_torch.ops.cuda_soft' in sys.modules\n"
        "assert 'gpuraytracer_tpu_torch.parallel.fast' in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
