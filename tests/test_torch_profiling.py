"""The port's profiling hooks (`utils/profiling.py`) against the JAX
package's: `PhaseTimer.report()` prints the same lines for the same
phases and clock readings; `trace` writes a Chrome trace in which the
`annotate` region appears."""

import itertools
import json
import time

import numpy as np
import torch

from yade_openfoam_coupling_tpu.utils import profiling as jprof
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
