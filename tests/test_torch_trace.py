"""The port's spans and counters on the CPU, at 8x8 pixels: a span records
only while torch's profiler records and changes no number; a fit step of
each integrator opens its spans in the layers' order, its backward the
attached body's; ``PACKS`` counts a pack whose geometry tables were kept
ones; every kernel
launch goes through the one helper that counts it and spans it."""
import contextlib
import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpuraytracer_tpu_torch import ops
from gpuraytracer_tpu_torch.intersect import potential_occluders
from gpuraytracer_tpu_torch.ops import (cuda_mis, cuda_mis_bwd, cuda_path,
                                        cuda_shade, cuda_soft)
from gpuraytracer_tpu_torch.scene import cornell_box
from gpuraytracer_tpu_torch.types import RenderConfig
from gpuraytracer_tpu_torch.utils import host, metrics

PATH = RenderConfig(width=8, height=8, spp=1, bounces=1)
MIS = RenderConfig(width=8, height=8, integrator="mis", camera_rays=1,
                   mis_samples=3)
LAUNCH_MODULES = (cuda_path, cuda_shade, cuda_mis, cuda_mis_bwd, cuda_soft)


def _fit_step(integrator):
    """One loss and its gradient through the fused kernel route (its plain
    versions on the CPU), the light's emission as the parameter."""
    scene = cornell_box(resolution=(8, 8))
    light = scene.light
    if integrator == "path":
        cfg, field = PATH, "color"
        render = ops.render_path_decoupled
    else:
        cfg, field = MIS, "emitted_radiance"
        render = ops.render_mis_decoupled
    param = getattr(light, field).clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, light=dataclasses.replace(light, **{field: param}))
    img = render(scene, cfg, occluders=potential_occluders(scene, cfg),
                 device="cpu")
    loss = torch.mean((img - 0.5) ** 2)
    loss.backward()
    return loss.detach(), param.grad


def _program_spans(prof, tmp_path):
    """(name, start, end) of the program's spans in the profiler's Chrome
    trace, in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("grt.")), key=lambda e: e[1])


def test_spans_are_off_without_the_profiler_and_move_no_number(tmp_path):
    assert not torch.autograd._profiler_enabled()
    off = metrics.span("render")
    assert isinstance(off, contextlib.nullcontext)
    assert off is metrics.span("pack")
    loss, grad = _fit_step("path")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss_on, grad_on = _fit_step("path")
    assert _program_spans(prof, tmp_path)
    assert torch.equal(loss, loss_on) and torch.equal(grad, grad_on)


@pytest.mark.parametrize("integrator", ["path", "mis"])
def test_a_fit_step_opens_the_layers_spans_in_order(integrator, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit_step(integrator)
    spans = _program_spans(prof, tmp_path)
    (render,) = [e for e in spans if e[0] == "grt.render"]
    lo, hi = render[1:]
    inner = [next(e for e in spans if e[0] == f"grt.{n}")
             for n in ("plan", "pack", "pack_diff")]
    assert lo <= inner[0][1] < inner[1][1] < inner[2][1]
    for name, start, end in spans:
        if name in ("grt.plan", "grt.pack", "grt.pack_diff"):
            assert lo <= start and end <= hi
    (attach,) = [e for e in spans if e[0] == "grt.attach"]
    assert attach[1] >= hi


@pytest.mark.parametrize("integrator", ["path", "mis"])
def test_packs_count_a_pack_of_the_same_geometry(integrator):
    """A pack of unchanged geometry takes its tables from the memo
    ("reused") instead of making them again ("same_geometry"); an in-place
    edit of the vertices makes them again once."""
    mod, render, cfg = ((cuda_path, ops.render_path_cuda, PATH)
                        if integrator == "path"
                        else (cuda_mis, ops.render_mis_cuda, MIS))
    scene = cornell_box(resolution=(8, 8))
    before = dict(mod.PACKS)

    def counted():
        render(scene, cfg, device="cpu")
        return tuple(mod.PACKS[k] - before[k]
                     for k in ("scene", "same_geometry", "reused"))

    assert counted() == (1, 0, 0)
    assert counted() == (2, 0, 1)
    with torch.no_grad():
        scene.triangles.verts[0, 0, 0] += 1e-3
    assert counted() == (3, 0, 1)
    assert counted() == (4, 0, 2)


def test_the_launch_helper_counts_and_spans_each_launch(tmp_path):
    counts = {"k": 0}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cuda_path.launch(counts, "k", lambda a, b: a - b, 3, 3)
    assert counts == {"k": 1}
    assert [e[0] for e in _program_spans(prof, tmp_path)] == [
        "grt.launch.k"]
    with pytest.raises(RuntimeError, match="k: launch failed"):
        cuda_path.launch(counts, "k", lambda: 700)
    assert counts == {"k": 1}


def test_every_launch_is_counted_by_the_helper_alone():
    """No module counts a launch itself, and a render through the plain
    versions launches nothing."""
    for mod in LAUNCH_MODULES:
        assert "LAUNCHES[" not in Path(mod.__file__).read_text(), mod
    before = [dict(mod.LAUNCHES) for mod in LAUNCH_MODULES]
    ops.render_path_cuda(cornell_box(resolution=(8, 8)), PATH, device="cpu")
    assert [mod.LAUNCHES for mod in LAUNCH_MODULES] == before


def test_uploads_and_fetches_are_wait_spans(tmp_path):
    x = torch.arange(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert host.upload(x, "cpu") is x          # no copy, no span
        assert host.upload([1, 2], "meta").device.type == "meta"
        assert host.fetch(x).tolist() == [0, 1, 2, 3]
    assert [e[0] for e in _program_spans(prof, tmp_path)] == [
        "grt.upload", "grt.fetch"]
