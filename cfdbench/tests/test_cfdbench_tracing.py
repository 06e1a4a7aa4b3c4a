"""The four span metrics on the accepted trace reduction: the program's
``yofc:`` spans named as targets in their readers' ``WRAPS``, kept beside
the wrapped entries' ranges, read on synthetic traces, naming idle gaps,
leaving the eight older readers as they were, and recorded by the
program in a tiny traced run on the CPU."""

import importlib
import json

import numpy as np
import pytest
import torch

from cfdbench import case, harness, tracing

PKG = "yade_openfoam_coupling_tpu_torch"
EXCHANGE = f"{PKG}.models.coupled:exchange"
DEM = f"{PKG}.ops.dem:dem_substeps"
REBUILD = f"{PKG}.models.coupled:_rebuild"
TURB = f"{PKG}.models.turbulence:correct"
PIMPLE = f"{PKG}.models.coupled:pimple_step"
OLD = ("launches_per_step", "device_idle_share", "exchange_ms", "exchange_roofline",
       "dem_ms", "list_build_ms", "fluid_ms", "p_iters")
NEW = ("host_syncs_per_step", "pressure_setup_ms", "pressure_device_ms",
       "pressure_launches_per_step")
STEPS = 2


def _reader(name):
    return importlib.import_module(f"cfdbench.metrics.{name}")


def _targets():
    """Every target of the twelve readers, as `harness.run_cell` gathers them."""
    return [t for name in OLD + NEW for t in _reader(name).WRAPS]


def _ev(name, ts, dur, cat=tracing.RANGE_CAT, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(with_spans: bool, on_card: bool = True):
    """Two steps of 1000 us. Host: each step's exchange (wrapped) at
    [1, 100), DEM [100, 300), the fluid (turbulence [300, 350), pimple
    [350, 900)); with the program's spans, the step [0, 990) around them,
    and inside pimple a pressure solve [400, 800) with its set-up
    [401, 500) holding one h2d copy [450, 460), and two CG exit reads
    [650, 655) and [750, 755); one list rebuild [2000, 2050). Device (when
    ``on_card``): a kernel launched at each of 10, 120, 420, 470, 600, 700
    us of a step, 5 us after its launch, 20 us long."""
    evs = [_ev(tracing.WINDOW, 0.0, 2100.0)]
    corr = 0
    for k in range(STEPS):
        t = 1000.0 * k
        evs += [_ev(EXCHANGE, t + 1, 99.0), _ev(DEM, t + 100, 200.0),
                _ev(TURB, t + 300, 50.0), _ev(PIMPLE, t + 350, 550.0)]
        if with_spans:
            evs += [_ev("yofc:step", t, 990.0), _ev("yofc:exchange", t + 2, 97.0),
                    _ev("yofc:fluid.pimple", t + 351, 548.0),
                    _ev("yofc:pressure", t + 400, 400.0),
                    _ev("yofc:pressure.setup", t + 401, 99.0),
                    _ev("yofc:sync.h2d", t + 450, 10.0),
                    _ev("yofc:sync.cg_exit", t + 650, 5.0),
                    _ev("yofc:sync.cg_exit", t + 750, 5.0)]
        for launch in (10, 120, 420, 470, 600, 700) if on_card else ():
            corr += 1
            evs.append(_ev("cudaLaunchKernel", t + launch, 2.0, cat="cuda_runtime",
                           corr=corr))
            evs.append(_ev(f"k{launch}", t + launch + 5, 20.0, cat="kernel", corr=corr))
    evs.append(_ev(REBUILD, 2000.0, 50.0))
    if with_spans:
        evs.append(_ev("yofc:dem.list_build", 2001.0, 48.0))
    return evs


def _trace(tmp_path, with_spans: bool, on_card: bool = True):
    path = tmp_path / f"trace_{with_spans}_{on_card}.json"
    path.write_text(json.dumps({"traceEvents": _events(with_spans, on_card)}))
    window, ranges, ops = tracing.parse_chrome_trace(str(path), _targets())
    config = case.load(harness.ROOT / "cfdbench/configs/channel_100k_128.json")
    return tracing.Trace(window=window, steps=STEPS, ranges=ranges, device_ops=ops,
                         untraced_step_us=800.0,
                         diags={"p_iters": np.array([2.0, 3.0])}, config=config,
                         n_particles=10_000)


def test_span_targets_wrap_nothing():
    """A span target has the ``module:attribute`` form, and no module
    behind it: `tracing.wrapped` skips it and changes nothing."""
    spans = [t for name in NEW for t in _reader(name).WRAPS]
    assert spans and all(t.startswith("yofc:") for t in spans)
    assert all(len(t.split(":")) == 2 for t in _targets())
    with tracing.wrapped(spans):
        pass
    assert [tracing.label(t) for t in sorted(set(spans))] == [
        "yofc.pressure", "yofc.pressure.setup", "yofc.step", "yofc.sync.cg_exit",
        "yofc.sync.h2d"]


def test_program_spans_are_kept_and_read(tmp_path):
    tr = _trace(tmp_path, True)
    assert tr.calls("yofc:pressure") == STEPS and tr.calls("yofc:sync.cg_exit") == 2 * STEPS
    assert tr.ranges["yofc:pressure.setup"][0] == (401.0, 500.0)
    # a span no reader names is not kept
    assert "yofc:exchange" not in tr.ranges and "yofc:fluid.pimple" not in tr.ranges
    launches_in = _reader("pressure_launches_per_step").launches_in
    # launched at 420, 470, 600, 700 of each step: inside the solve
    assert launches_in(tr, "yofc:pressure") == 4 * STEPS
    assert launches_in(tr, "yofc:pressure.setup") == 2 * STEPS
    assert launches_in(tr, "yofc:sync.h2d") == 0
    assert launches_in(tr, "yofc:nothing") is None
    assert tr.device_us_launched_in("yofc:pressure") == 4 * STEPS * 20.0
    values = {name: _reader(name).read(tr) for name in NEW}
    assert values["host_syncs_per_step"] == 3.0          # 2 exits + 1 copy a step
    assert values["pressure_setup_ms"] == pytest.approx(0.099)
    assert values["pressure_device_ms"] == pytest.approx(0.08)
    assert values["pressure_launches_per_step"] == 4.0


@pytest.mark.parametrize("with_spans, on_card", [(False, True), (True, False)],
                         ids=["no_spans", "no_card"])
def test_span_readers_report_nothing(tmp_path, with_spans, on_card):
    """A program without spans (the parent of the change that added them),
    or a run without a card, gives no reading, and no error."""
    tr = _trace(tmp_path, with_spans, on_card)
    assert bool(tr.ranges["yofc:pressure"]) == with_spans
    assert all(_reader(name).read(tr) is None for name in NEW)


def test_idle_gaps_are_named_by_the_innermost_span(tmp_path):
    with_spans = dict(_trace(tmp_path, True).breakdown(top=20)["idle_gaps"])
    without = dict(_trace(tmp_path, False).breakdown(top=20)["idle_gaps"])
    # gaps of a step: [35, 125) in the exchange, [145, 425) in the DEM,
    # [445, 475) in the h2d copy of the solve's set-up, [495, 605) and
    # [625, 705) in the solve, [725, 1015) in pimple_step after the solve
    assert {"coupled.exchange", "dem.dem_substeps", "yofc.sync.h2d", "yofc.pressure",
            "coupled.pimple_step"} <= set(with_spans)
    assert not any(n.startswith("yofc.") for n in without)
    assert "yofc.pressure" in with_spans and "yofc.pressure" not in without


def test_older_readers_read_the_same_with_program_spans(tmp_path):
    a, b = _trace(tmp_path, False), _trace(tmp_path, True)
    assert a.device_ops == b.device_ops
    for name in OLD:
        va, vb = _reader(name).read(a), _reader(name).read(b)
        assert va is not None and va == vb, name


@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_traced_run_keeps_the_programs_spans(workload, monkeypatch):
    """A tiny traced run on the CPU: the harness keeps the spans the
    readers name, one ``yofc:pressure`` span a solve and one CG exit read
    a solve and an iteration; without a card the span readers report
    nothing."""
    kept, real = [], tracing.Trace

    def keep(**kw):
        kept.append(real(**kw))
        return kept[-1]

    monkeypatch.setattr(tracing, "Trace", keep)
    res, _ = harness.run_cell(workload, 2 ** 31 + 777, 0.5, 1, 0.0,
                              device=torch.device("cpu"), shrink=(16, 300))
    tr, = kept
    cfg = case.build(case.shrink(harness.load_cell(workload)[2], 16, 300))
    solves = tr.steps * cfg.pimple.n_outer * cfg.pimple.n_correctors
    assert tr.calls("yofc:step") == tr.steps
    assert tr.calls("yofc:pressure") == solves
    assert tr.calls("yofc:sync.cg_exit") == int(tr.diags["p_iters"].sum()) + solves
    assert tr.calls("yofc:pressure.setup") == solves
    assert not set(NEW) & set(res["metrics"])
