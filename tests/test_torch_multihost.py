"""PyTorch port: sharding across processes over gloo (``parallel/``).

Real process groups on the CPU: the ranks run this file as a script (the
``__main__`` block at the end), join a gloo group on a free localhost port,
render and train through the sharded entry points, and write their results
to a ``.npz`` each; the tests, in the parent, compare them against the port
in one process and against the JAX package. The module imports JAX only
inside the tests, so a rank imports only the port. Every rank runs one
thread.

  * a pair of ranks: the fused path and MIS renders (images bit-equal to one
    process, gradients within the JAX package's sharded tolerances, atol
    1e-8 / rtol 1e-5 and 1e-5 of the largest magnitude / rtol 1e-4); three
    SGD steps of ``make_train_step`` against the JAX package's on a
    2-device mesh (losses rtol 1e-4, parameters atol 1e-6 / rtol 1e-4; SGD
    keeps the update linear in the gradient); a default-Adam step of
    ``make_train_step_fused`` against the same step on one rank;
    ``make_overlapped_grad_fn`` against the plain fused gradient (atol 1e-6
    / rtol 1e-4, ``tests/test_fast_sharded.py``). The parameters are equal
    by bits on both ranks.
  * four ranks on a 2 x 2 ``rays`` x ``spp`` mesh (atol 2e-5 / rtol 1e-5).
  * the command line with ``--devices 2``, its PNG and debug rows equal to
    ``--devices 1``'s.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds a group of ranks may take

PATH = dict(width=32, height=16, spp=2, bounces=2, pixel_chunk=512)
MIS = dict(width=32, height=16, integrator="mis", camera_rays=2,
           mis_samples=6, pixel_chunk=512)
TRAIN = dict(width=32, height=16, spp=1, bounces=1, pixel_chunk=512)
TRAIN_LR, TRAIN_STEPS, TRAIN_TARGET = 10.0, 3, 0.5
ADAM_STEPS = 2
SPP = dict(width=16, height=16, spp=8, bounces=2, pixel_chunk=256)
CLI_ARGS = ["--device", "cpu", "--kernel", "decoupled", "--width", "32",
            "--height", "16", "--spp", "2"]


# ---------------------------------------------------------------------------
# What the ranks run (and the parent, at one rank, for its references)
# ---------------------------------------------------------------------------

def _with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _named(scene):
    import dataclasses
    return {f"{part.name}.{f.name}": getattr(getattr(scene, part.name),
                                             f.name)
            for part in dataclasses.fields(scene)
            for f in dataclasses.fields(getattr(scene, part.name))}


def _grads(scene, prefix):
    return {f"{prefix}/{name}": t.grad.numpy()
            for name, t in _named(scene).items() if t.grad is not None}


def _fused_renders(m):
    """Images and gradients of the frame's mean through the sharded fused
    path (sphere scene) and MIS (box scene) entries."""
    from gpuraytracer_tpu_torch.parallel import fast
    from gpuraytracer_tpu_torch.scene import (cornell_box,
                                              cornell_box_with_spheres)
    from gpuraytracer_tpu_torch.types import RenderConfig
    out = {}
    cfg = RenderConfig(**PATH)
    scene = _with_grad(cornell_box_with_spheres(resolution=cfg.resolution))
    img = fast.render_path_fused_sharded(scene, cfg, m)
    img.mean().backward()
    out["path_hdr"] = img.detach().numpy()
    out.update(_grads(scene, "path"))
    cfg = RenderConfig(**MIS)
    scene = _with_grad(cornell_box(resolution=cfg.resolution))
    img = fast.render_mis_fused_sharded(scene, cfg, m)
    img.mean().backward()
    out["mis_hdr"] = img.detach().numpy()
    out.update(_grads(scene, "mis"))
    return out


def _trainings(m):
    """Three SGD steps of the oracle step (sphere scene) and two default-Adam
    steps of the fused step (box scene): losses and parameters."""
    from gpuraytracer_tpu_torch.grad.inverse import extract_params
    from gpuraytracer_tpu_torch.parallel import train
    from gpuraytracer_tpu_torch.scene import (cornell_box,
                                              cornell_box_with_spheres)
    from gpuraytracer_tpu_torch.types import RenderConfig
    out = {}
    cfg = RenderConfig(**TRAIN)
    target = torch.full((cfg.height, cfg.width, 3), TRAIN_TARGET)
    for key, ctor, make, kw, steps in (
            ("sgd", cornell_box_with_spheres, train.make_train_step,
             dict(optimizer=lambda p: torch.optim.SGD(p, lr=TRAIN_LR)),
             TRAIN_STEPS),
            ("adam", cornell_box, train.make_train_step_fused, {},
             ADAM_STEPS)):
        scene = ctor(resolution=cfg.resolution)
        init_fn, step_fn = make(scene, cfg, m, **kw)
        state = init_fn(extract_params(scene))
        losses = []
        for _ in range(steps):
            state, loss = step_fn(state, target)
            losses.append(loss.item())
        out[f"{key}_losses"] = np.array(losses)
        for name, p in state.params._asdict().items():
            out[f"{key}/{name}"] = p.detach().numpy()
    return out


def _overlapped(m):
    """``make_overlapped_grad_fn`` (two tiles a rank) and the plain fused
    sharded loss's gradients on the sphere scene."""
    from gpuraytracer_tpu_torch.parallel import fast
    from gpuraytracer_tpu_torch.scene import cornell_box_with_spheres
    from gpuraytracer_tpu_torch.types import RenderConfig
    cfg = RenderConfig(**PATH)
    scene = cornell_box_with_spheres(resolution=cfg.resolution)
    target = torch.full((cfg.height, cfg.width, 3), 0.25)
    loss, grads = fast.make_overlapped_grad_fn(scene, cfg, m, 2)(scene,
                                                                  target)
    out = {"over_loss": np.array(loss.item())}
    out.update({f"over/{k}": v.numpy() for k, v in _named(grads).items()
                if v.is_floating_point()})
    leaves = _with_grad(scene)
    plain = torch.mean((fast.render_path_fused_sharded(leaves, cfg, m)
                        - target) ** 2)
    plain.backward()
    out["plain_loss"] = np.array(plain.item())
    out.update(_grads(leaves, "plain"))
    return out


def _rank_main(job, rank, world, port, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from gpuraytracer_tpu_torch.parallel import mesh, multihost
    from gpuraytracer_tpu_torch.types import RenderConfig
    assert multihost.init_distributed(f"localhost:{port}", world, rank,
                                      device="cpu")
    assert multihost.is_primary() == (rank == 0)
    if job == "pair":
        m = mesh.make_ray_mesh("cpu")
        assert m.shape == {"rays": 2} and m.axes["rays"].index == rank
        out = _fused_renders(m)
        out.update(_trainings(m))
        out.update(_overlapped(m))
    else:  # "mesh": 2 x 2, rays x spp
        from gpuraytracer_tpu_torch.scene import cornell_box
        m = mesh.make_ray_spp_mesh(2, 2, device="cpu")
        assert (m.axes["rays"].index, m.axes["spp"].index) == divmod(rank, 2)
        cfg = RenderConfig(**SPP)
        img = mesh.render_path_spp_sharded(
            cornell_box(resolution=cfg.resolution), cfg, m)
        out = {"spp_hdr": multihost.gather_image(img)}
    multihost.sync_hosts("written")
    np.savez(Path(out_dir) / f"{job}{rank}.npz", **out)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------

def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every group of processes, started at once so that they run while
    the parent computes its references: the rank pair, the 2 x 2 mesh, and
    the command line with ``--devices 2``."""
    from gpuraytracer_tpu_torch.parallel.multihost import free_port
    out = tmp_path_factory.mktemp("ranks")
    groups = {}
    for job, world in (("pair", 2), ("mesh", 4)):
        port = free_port()
        groups[job] = [subprocess.Popen(
            [sys.executable, __file__, job, str(r), str(world), str(port),
             str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env(), cwd=REPO) for r in range(world)]
    groups["cli"] = [subprocess.Popen(
        [sys.executable, "-m", "gpuraytracer_tpu_torch.cli",
         str(out / "sharded.png"), "--devices", "2", "--debug-output",
         str(out / "sharded.txt")] + CLI_ARGS, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(), cwd=REPO)]
    yield out, groups, {}
    for procs in groups.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _wait(launched, job):
    """The results of a group of processes (waited for once): every rank's
    ``.npz``, or for the command line its directory and output."""
    out, groups, done = launched
    if job in done:
        return done[job]
    procs = groups[job]
    logs = []
    for i, p in enumerate(procs):
        try:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{job}: process {i} timed out")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job}: process {i} failed:\n{log}"
    if job == "cli":
        done[job] = (out, logs[0])
    else:
        done[job] = [dict(np.load(out / f"{job}{r}.npz"))
                     for r in range(len(procs))]
    return done[job]


def _assert_same_on_ranks(ranks, prefixes):
    for key in ranks[0]:
        if key.split("/")[0].split("_")[0] in prefixes:
            assert np.array_equal(ranks[0][key], ranks[1][key]), key


def _grad_tol(ref, mis):
    if mis:
        return dict(atol=1e-5 * max(np.abs(ref).max(), 1e-6), rtol=1e-4)
    return dict(atol=1e-8, rtol=1e-5)


def test_fused_renders_match_one_process(launched):
    from gpuraytracer_tpu_torch.parallel import mesh
    ranks = _wait(launched, "pair")
    torch.set_num_threads(1)
    ref = _fused_renders(mesh.make_ray_mesh("cpu"))
    _assert_same_on_ranks(ranks, ("path", "mis"))
    got = ranks[0]
    assert {k for k in got if k.split("/")[0] in ("path", "mis")} == {
        k for k in ref if k.split("/")[0] in ("path", "mis")}
    for key in ("path_hdr", "mis_hdr"):
        assert np.array_equal(got[key], ref[key]), key
    n = 0
    for key, r in ref.items():
        if "/" in key and r.size:
            np.testing.assert_allclose(got[key], r, err_msg=key,
                                       **_grad_tol(r, key.startswith("mis")))
            n += 1
    assert n >= 20


def test_sgd_trajectory_matches_jax(launched):
    import jax.numpy as jnp
    import optax

    import gpuraytracer_tpu.scene as jscene
    import gpuraytracer_tpu.types as jtypes
    import jax
    from gpuraytracer_tpu.grad.inverse import extract_params
    from gpuraytracer_tpu.parallel.mesh import make_ray_mesh
    from gpuraytracer_tpu.parallel.train import make_train_step

    cfg = jtypes.RenderConfig(integrator="path", **TRAIN)
    scene = jscene.cornell_box_with_spheres(resolution=(cfg.width,
                                                        cfg.height))
    mesh = make_ray_mesh(jax.devices()[:2])
    losses = []
    with jax.set_mesh(mesh):
        init_fn, step_fn = make_train_step(scene, cfg, mesh,
                                           optimizer=optax.sgd(TRAIN_LR))
        state = init_fn(extract_params(scene))
        target = jnp.full((cfg.height, cfg.width, 3), TRAIN_TARGET)
        for _ in range(TRAIN_STEPS):
            state, loss = step_fn(state, target)
            losses.append(float(loss))
    ranks = _wait(launched, "pair")
    _assert_same_on_ranks(ranks, ("sgd",))
    np.testing.assert_allclose(ranks[0]["sgd_losses"], losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for name, ref in state.params._asdict().items():
        np.testing.assert_allclose(ranks[0][f"sgd/{name}"], np.asarray(ref),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_adam_step_matches_one_rank(launched):
    from gpuraytracer_tpu_torch.parallel import mesh
    from gpuraytracer_tpu_torch.scene import cornell_box
    ranks = _wait(launched, "pair")
    torch.set_num_threads(1)
    ref = _trainings(mesh.make_ray_mesh("cpu"))
    _assert_same_on_ranks(ranks, ("adam",))
    for key, r in ref.items():
        if key.startswith("adam"):
            np.testing.assert_allclose(ranks[0][key], r, atol=1e-6,
                                       rtol=1e-4, err_msg=key)
    start = cornell_box(resolution=(TRAIN["width"], TRAIN["height"]))
    assert not np.allclose(ranks[0]["adam/light_emission"],
                           start.light.color.numpy())


def test_overlapped_grad_matches_plain_fused(launched):
    ranks = _wait(launched, "pair")
    _assert_same_on_ranks(ranks, ("over", "plain"))
    got = ranks[0]
    np.testing.assert_allclose(got["over_loss"], got["plain_loss"],
                               rtol=1e-6)
    n = 0
    for key in got:
        if key.startswith("over/"):
            name = key.split("/", 1)[1]
            ref = got.get(f"plain/{name}", np.zeros_like(got[key]))
            np.testing.assert_allclose(got[key], ref, atol=1e-6, rtol=1e-4,
                                       err_msg=name)
            n += 1
    assert n >= 12


def test_ray_spp_mesh_2x2(launched):
    from gpuraytracer_tpu_torch.render import render
    from gpuraytracer_tpu_torch.scene import cornell_box
    from gpuraytracer_tpu_torch.types import RenderConfig
    ranks = _wait(launched, "mesh")
    cfg = RenderConfig(**SPP)
    ref = render(cornell_box(resolution=cfg.resolution), cfg,
                 device="cpu").hdr.numpy()
    for r in ranks[1:]:
        assert np.array_equal(r["spp_hdr"], ranks[0]["spp_hdr"])
    np.testing.assert_allclose(ranks[0]["spp_hdr"], ref, atol=2e-5,
                               rtol=1e-5)


def test_cli_devices_2_equals_devices_1(launched, capsys):
    from gpuraytracer_tpu_torch import cli
    out, log = _wait(launched, "cli")
    assert "Render completed in" in log and "Image saved to" in log
    assert cli.main([str(out / "single.png"), "--debug-output",
                     str(out / "single.txt")] + CLI_ARGS) == 0
    assert (out / "sharded.png").read_bytes() == \
        (out / "single.png").read_bytes()
    assert (out / "sharded.txt").read_text() == \
        (out / "single.txt").read_text()


if __name__ == "__main__":
    _job, _rank, _world, _port, _out = sys.argv[1:6]
    _rank_main(_job, int(_rank), int(_world), int(_port), _out)
