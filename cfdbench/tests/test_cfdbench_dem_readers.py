"""The two DEM readers, `dem_device_ms` and `dem_launches_per_step`, on
synthetic traces built as test_cfdbench_tracing.py builds them: they name
the program's ``yofc:dem.substeps`` span, read nothing without device
operations or without the span, count the launches and device time inside
it, and leave the twelve older readers' readings as they were."""

import importlib
import json

import numpy as np
import pytest

from cfdbench import case, harness, tracing
from test_cfdbench_tracing import NEW, OLD, STEPS, _ev, _events

DEM = ("dem_device_ms", "dem_launches_per_step")


def _reader(name):
    return importlib.import_module(f"cfdbench.metrics.{name}")


def _dem_events(with_spans: bool, on_card: bool):
    """`_events` with, in each step, the DEM span [101, 299) inside the
    wrapped DEM range [100, 300), and two more kernels launched in it (at
    150 and 250 us, 30 us long): 3 launches and their device time in the
    span a step (the 120-us kernel's 20 us and these two: 80 us)."""
    evs = _events(with_spans, on_card)
    corr = 1000
    for k in range(STEPS):
        t = 1000.0 * k
        if with_spans:
            evs.append(_ev("yofc:dem.substeps", t + 101, 198.0))
        for launch in (150, 250) if on_card else ():
            corr += 1
            evs.append(_ev("cudaLaunchKernel", t + launch, 2.0, cat="cuda_runtime", corr=corr))
            evs.append(_ev(f"dem{launch}", t + launch + 5, 30.0, cat="kernel", corr=corr))
    return evs


def _trace(tmp_path, names, with_spans=True, on_card=True):
    targets = [t for name in names for t in _reader(name).WRAPS]
    path = tmp_path / f"trace_{with_spans}_{on_card}_{len(names)}.json"
    path.write_text(json.dumps({"traceEvents": _dem_events(with_spans, on_card)}))
    window, ranges, ops = tracing.parse_chrome_trace(str(path), targets)
    config = case.load(harness.ROOT / "cfdbench/configs/channel_100k_128.json")
    return tracing.Trace(window=window, steps=STEPS, ranges=ranges, device_ops=ops,
                         untraced_step_us=800.0,
                         diags={"p_iters": np.array([2.0, 3.0])}, config=config,
                         n_particles=10_000)


def test_dem_readers_name_the_programs_span():
    for name in DEM:
        assert _reader(name).WRAPS == ("yofc:dem.substeps",)
    with tracing.wrapped([t for name in DEM for t in _reader(name).WRAPS]):
        pass
    assert tracing.label("yofc:dem.substeps") == "yofc.dem.substeps"


def test_dem_readers_read_the_span(tmp_path):
    tr = _trace(tmp_path, OLD + NEW + DEM)
    assert tr.calls("yofc:dem.substeps") == STEPS
    assert _reader("dem_launches_per_step").read(tr) == 3.0
    assert _reader("dem_device_ms").read(tr) == pytest.approx(0.08)


@pytest.mark.parametrize("with_spans, on_card", [(False, True), (True, False)],
                         ids=["no_span", "no_card"])
def test_dem_readers_report_nothing(tmp_path, with_spans, on_card):
    """A program without the span, or a run without a card, gives no
    reading, and no error."""
    tr = _trace(tmp_path, OLD + NEW + DEM, with_spans, on_card)
    assert all(_reader(name).read(tr) is None for name in DEM)


def test_older_readers_read_the_same_beside_the_dem_readers(tmp_path):
    """The twelve accepted readers read the same on a trace whose kept
    spans include the DEM readers' as on one without them."""
    a, b = _trace(tmp_path, OLD + NEW), _trace(tmp_path, OLD + NEW + DEM)
    assert "yofc:dem.substeps" not in a.ranges and b.ranges["yofc:dem.substeps"]
    assert a.device_ops == b.device_ops
    for name in OLD + NEW:
        va, vb = _reader(name).read(a), _reader(name).read(b)
        assert va is not None and va == vb, name
