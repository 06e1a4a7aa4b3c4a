"""The port's profiling hooks (`utils/profiling.py`) against the JAX
package's: `PhaseTimer.report()` prints the same lines for the same
phases and clock readings; `trace` writes a Chrome trace in which the
`annotate` region appears; `annotate` records nothing without a profiler.
And the coupled step's ``yofc:`` spans in one traced chunk of a window +
fftpcg case and of a planes-in-slabs + mgpcg case: every span the case
reaches, their nesting, one CG exit read per solve and per iteration,
every op inside a span, and the same state with the profiler on and off."""

import dataclasses
import itertools
import json
import time

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.utils import profiling as jprof
from yade_openfoam_coupling_tpu_torch import bench
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.scripts import bench_1m
from yade_openfoam_coupling_tpu_torch.utils import profiling as tprof

PHASES = [("exchange", 0.004), ("DEM", 0.0105), ("exchange", 0.0035), ("fluid", 0.125),
          ("halo pads", 0.00025), ("DEM", 0.011)]


def _report(module, monkeypatch, block_on):
    """Drive module's PhaseTimer through PHASES on a fake clock."""
    ticks = itertools.accumulate(itertools.chain.from_iterable((0.0, dt) for _, dt in PHASES))
    clock = iter([100.0 + t for t in ticks])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = module.PhaseTimer()
    for name, _ in PHASES:
        with timer.phase(name, block_on=block_on):
            pass
    monkeypatch.undo()
    return timer


def test_phase_timer_report_matches_jax(monkeypatch):
    ref = _report(jprof, monkeypatch, None)
    got = _report(tprof, monkeypatch, torch.zeros(3))
    assert got.report().splitlines() == ref.report().splitlines()
    assert got.counts == ref.counts
    np.testing.assert_allclose([got.totals[k] for k in ref.totals],
                               list(ref.totals.values()), rtol=0, atol=1e-12)
    assert got.report().splitlines()[0].startswith("fluid")


def test_trace_records_the_annotated_region(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.annotate("yofc_region"):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "yofc_region" for e in events)


def test_annotate_records_nothing_without_a_profiler(monkeypatch):
    """No profiler: one shared null context, and no `record_function`."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = tprof.annotate("yofc:step"), tprof.annotate("yofc:pressure")
    assert a is b
    with a:
        torch.ones(4).sum()
    assert tprof.host_tensor((1.0, 2.0)).tolist() == [1.0, 2.0]


# ---------------------------------------------------------------------------
# The coupled step's spans
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")
N_PART, K = 300, 2
COMMON = {"yofc:step", "yofc:dt", "yofc:exchange", "yofc:exchange.inputs",
          "yofc:exchange.bin", "yofc:exchange.kernel", "yofc:dem.list_build",
          "yofc:dem.substeps", "yofc:fluid.turbulence", "yofc:fluid.pimple",
          "yofc:pressure", "yofc:pressure.setup", "yofc:pressure.precond",
          "yofc:sync.cg_exit", "yofc:sync.h2d", "yofc:diagnostics"}


def _window_fftpcg():
    return bench.bench_config(16)


def _planes_mgpcg():
    return bench_1m.case_config(bench_1m.build_parser().parse_args([]), 16)


CASES = {
    # bench.py's configuration at 16^3: window exchange, 2 fftpcg solves a step
    "window_fftpcg": (_window_fftpcg, COMMON),
    # bench_1m's: planes exchange in 8 x-slabs, one mgpcg solve a step (16^3
    # admits three V-cycle levels)
    "planes_mgpcg": (_planes_mgpcg, COMMON | {"yofc:mg.L0", "yofc:mg.L1", "yofc:mg.L2"}),
}


def _leaves(state):
    return [t for t in torch.utils._pytree.tree_leaves(state) if t is not None]


@pytest.fixture(scope="module", params=list(CASES))
def chunk(request, tmp_path_factory):
    """One `make_scan_fn` chunk (a rebuild, K steps) from the same state,
    untraced and under `profiling.trace`. -> (config, the untraced final
    state and diagnostics, the traced ones, the trace's complete events,
    the expected span names)."""
    build, expected = CASES[request.param]
    cfg = build()
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, list_rebuild_steps=K))
    s0 = bench.initial_state(cfg, N_PART, CPU)
    run = tcd.make_scan_fn(cfg, K)
    plain = run(s0)
    logdir = tmp_path_factory.mktemp(request.param)
    with tprof.trace(str(logdir)):
        traced = run(s0)
    events = [e for e in json.loads((logdir / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return cfg, plain, traced, events, expected


def _spans(events, name=None):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["cat"] == "user_annotation" and e["name"].startswith("yofc:")
            and (name is None or e["name"] == name)]


def _inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= e for s, e in outers)


def test_chunk_holds_every_span_of_its_case(chunk):
    _, _, _, events, expected = chunk
    names = {e["name"] for e in events if e["name"].startswith("yofc:")}
    assert names == expected


def test_spans_nest(chunk):
    """The pressure solve inside PIMPLE inside the step; its set-up and the
    CG exit reads inside the solve; every step's stage inside a step."""
    _, _, _, events, _ = chunk
    steps, pimple, solves = (_spans(events, n) for n in (
        "yofc:step", "yofc:fluid.pimple", "yofc:pressure"))
    assert len(steps) == K and len(pimple) == K and solves
    assert all(_inside(p, steps) for p in pimple)
    assert all(_inside(p, pimple) for p in solves)
    for name in ("yofc:pressure.setup", "yofc:pressure.precond", "yofc:sync.cg_exit"):
        assert all(_inside(x, solves) for x in _spans(events, name)), name
    for name in ("yofc:dt", "yofc:exchange", "yofc:dem.substeps", "yofc:fluid.turbulence"):
        assert len(_spans(events, name)) == K, name
        assert all(_inside(x, steps) for x in _spans(events, name)), name
    for name in ("yofc:exchange.inputs", "yofc:exchange.bin", "yofc:exchange.kernel"):
        assert all(_inside(x, _spans(events, "yofc:exchange")) for x in _spans(events, name))


def test_one_exit_read_per_solve_and_iteration(chunk):
    cfg, _, (_, diags), events, _ = chunk
    solves = K * cfg.pimple.n_outer * cfg.pimple.n_correctors
    assert len(_spans(events, "yofc:pressure")) == solves
    assert len(_spans(events, "yofc:sync.cg_exit")) == int(diags.p_iters.sum()) + solves


def test_every_op_lies_in_a_span(chunk):
    _, _, _, events, _ = chunk
    spans = _spans(events)
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e["cat"] == "cpu_op" and e["name"].startswith("aten::")]
    assert ops
    assert [op for op in ops if not _inside(op, spans)] == []


def test_profiler_changes_no_number(chunk):
    _, plain, traced, _, _ = chunk
    a, b = _leaves(plain), _leaves(traced)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
