"""The reduction of a traced run's Chrome trace, on a trace built by hand:
two iterations of a fit, the program's nested ``grt.`` spans on two threads
inside the benchmark's spans. The program's spans change none of the
benchmark's readings; ``program_spans`` and ``repack_pct`` give the values
counted by hand; ``idle_glue_pct`` never passes ``device_idle_pct``."""
from __future__ import annotations

import json
import random
from types import SimpleNamespace

import pytest

from gpuraytracer_tpu_torch.ops import cuda_mis, cuda_path
from portbench import program_spans, spec, tracing
from portbench.metrics import device_idle_pct, repack_pct

MAIN, AUTOGRAD = 1, 2
PERIOD = 1000  # microseconds an iteration

# (name, thread, start, end) of one iteration, microseconds from its start.
BENCH = [("forward", 0, 400), ("backward", 400, 700),
         ("optimizer", 700, 800), ("readback", 800, 900)]
PROGRAM = [
    ("render", MAIN, 10, 390),
    ("plan", MAIN, 20, 40),
    ("pack", MAIN, 50, 150),
    ("upload", MAIN, 100, 130),
    ("launch.path_kernel_grouped", MAIN, 200, 220),
    ("pack_diff", MAIN, 250, 300),
    ("attach", AUTOGRAD, 450, 650),
    ("launch.shade_bwd_grouped_kernel", AUTOGRAD, 500, 510),
]
# (name, category, launched at, device start, device end).
DEVICE = [("Memcpy HtoD", "gpu_memcpy", 110, 120, 125),
          ("path_grouped_kernel", "kernel", 205, 220, 480),
          ("shade_bwd_grouped_kernel", "kernel", 505, 520, 600)]

# Counted by hand, per iteration (microseconds): each span's self time and
# the card-idle time under it. The card is busy 120-125, 220-480, 520-600.
SELF = {"render": (190, 70), "plan": (20, 20), "pack": (70, 70),
        "upload": (30, 25), "launch.path_kernel_grouped": (20, 20),
        "pack_diff": (50, 0), "attach": (190, 80),
        "launch.shade_bwd_grouped_kernel": (10, 10)}
WINDOW_US = 1900  # the first forward's start to the last readback's end
IDLE_US = WINDOW_US - 2 * (5 + 260 + 80)


def _events(iterations=2, program=True):
    events, corr = [], 0
    for k in range(iterations):
        o = k * PERIOD
        for name, s, e in BENCH:
            events.append(dict(ph="X", cat="user_annotation",
                               name="portbench." + name, pid=1, tid=MAIN,
                               ts=o + s, dur=e - s))
        if program:
            for name, tid, s, e in PROGRAM:
                events.append(dict(ph="X", cat="user_annotation",
                                   name="grt." + name, pid=1, tid=tid,
                                   ts=o + s, dur=e - s))
        for name, cat, at, s, e in DEVICE:
            corr += 1
            events.append(dict(ph="X", cat="cuda_runtime",
                               name="cudaLaunchKernel", pid=1, tid=MAIN,
                               ts=o + at, dur=2, args={"correlation": corr}))
            events.append(dict(ph="X", cat=cat, name=name, pid=0, tid=7,
                               ts=o + s, dur=e - s,
                               args={"correlation": corr}))
    return events


def _summary(tmp_path, **kw):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events(**kw)}))
    return tracing.summarize(path)


def test_the_programs_spans_change_no_reading_of_the_benchmarks(tmp_path):
    with_program = _summary(tmp_path)
    assert len(program_spans.read_spans(tmp_path / "trace.json")) == (
        2 * len(PROGRAM))
    without = _summary(tmp_path, program=False)
    assert program_spans.read_spans(tmp_path / "trace.json") == []
    for field in ("spans", "activities", "window", "iterations",
                  "unattributed"):
        assert getattr(with_program, field) == getattr(without, field)
    assert with_program.breakdown() == without.breakdown()
    assert with_program.iterations == 2 and with_program.unattributed == 0
    assert [a.span for a in with_program.activities] == [
        "forward", "forward", "backward"] * 2
    for name in ("tess1002.path_fit", "cornell.mis_fit"):
        cell = spec.load_cell(name)
        ctx = SimpleNamespace(traffic=cell.traffic, config=cell.config,
                              num_triangles=cell.config["triangles"])
        for m in cell.per_layer:
            read = spec.metric_reader(m.name)
            assert read(with_program, ctx) == read(without, ctx), m.name


def test_each_spans_self_time_and_the_idle_under_it(tmp_path):
    summary = _summary(tmp_path)
    table = program_spans.table(
        summary, program_spans.read_spans(tmp_path / "trace.json"))
    assert set(table) == set(SELF)
    for name, (self_us, idle_us) in SELF.items():
        assert table[name][0] == pytest.approx(2 * self_us * 1e-6), name
        assert table[name][1] == pytest.approx(2 * idle_us * 1e-6), name


def _packs(monkeypatch, path_counts, mis_counts):
    monkeypatch.setattr(cuda_path, "PACKS", path_counts)
    monkeypatch.setattr(cuda_mis, "PACKS", mis_counts)


def test_the_host_glue_readings_give_the_values_counted_by_hand(
        tmp_path, monkeypatch):
    summary = _summary(tmp_path)
    spans = program_spans.read_spans(tmp_path / "trace.json")
    work = [name for name in SELF if name in program_spans.WORK]
    assert work == ["render", "plan", "pack", "pack_diff", "attach"]
    assert program_spans.host_glue_ms(summary, spans) == pytest.approx(
        sum(SELF[n][0] for n in work) * 1e-3)
    assert program_spans.idle_glue_pct(summary, spans) == pytest.approx(
        100.0 * 2 * sum(SELF[n][1] for n in work) / WINDOW_US)
    assert device_idle_pct.read(summary, None) == pytest.approx(
        100.0 * IDLE_US / WINDOW_US)
    _packs(monkeypatch, {"scene": 3, "same_geometry": 2},
           {"scene": 1, "same_geometry": 1})
    assert repack_pct.read(summary, None) == 75.0


def test_without_the_programs_spans_and_counters_the_readers_read_nothing(
        tmp_path, monkeypatch):
    """A program that has neither, as one before them: no value, no
    error."""
    summary = _summary(tmp_path, program=False)
    spans = program_spans.read_spans(tmp_path / "trace.json")
    assert program_spans.host_glue_ms(summary, spans) is None
    assert program_spans.idle_glue_pct(summary, spans) is None
    zero = {"scene": 0, "same_geometry": 0}
    _packs(monkeypatch, dict(zero), dict(zero))
    assert repack_pct.read(summary, None) is None
    monkeypatch.delattr(cuda_path, "PACKS")
    monkeypatch.delattr(cuda_mis, "PACKS")
    assert program_spans.packs() == {}
    assert repack_pct.read(summary, None) is None


@pytest.mark.parametrize("seed", range(8))
def test_idle_glue_never_passes_device_idle(tmp_path, seed):
    """Seeded traces: nested work spans on two threads, kernels launched
    from some of them at random times."""
    rng = random.Random(seed)
    events = [dict(ph="X", cat="user_annotation", name="portbench.forward",
                   pid=1, tid=MAIN, ts=0, dur=10_000)]
    corr = 0
    for tid in (MAIN, AUTOGRAD):
        t = rng.uniform(0, 50)
        while t < 9_500:
            outer = rng.uniform(50, 400)
            events.append(dict(ph="X", cat="user_annotation",
                               name="grt." + rng.choice(
                                   program_spans.WORK),
                               pid=1, tid=tid, ts=t, dur=outer))
            inner = rng.uniform(0, outer / 2)
            events.append(dict(ph="X", cat="user_annotation",
                               name="grt." + rng.choice(
                                   ("pack", "launch.k", "upload")),
                               pid=1, tid=tid, ts=t + inner / 2, dur=inner))
            corr += 1
            start = t + rng.uniform(0, outer)
            events.append(dict(ph="X", cat="cuda_runtime", name="launch",
                               pid=1, tid=tid, ts=start, dur=1,
                               args={"correlation": corr}))
            events.append(dict(ph="X", cat="kernel", name="k", pid=0, tid=7,
                               ts=start + 5, dur=rng.uniform(10, 600),
                               args={"correlation": corr}))
            t += outer + rng.uniform(1, 300)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = tracing.summarize(path)
    glue = program_spans.idle_glue_pct(summary,
                                       program_spans.read_spans(path))
    assert 0.0 < glue <= device_idle_pct.read(summary, None)
