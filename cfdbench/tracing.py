"""The traced run: each layer's entry wrapped in a profiler range from the
benchmark's own files, a bounded run of whole chunks under
`torch.profiler`, and the trace reduced to what the per-layer readers read.

A target is ``"module:attribute"``; `wrapped` replaces the module's
attribute by a function that runs the original inside
``record_function(target)``, and puts it back on exit. A target that no
longer exists is skipped, so its range stays empty and the metrics that
read it report nothing.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

WINDOW = "cfdbench.window"
RANGE_CAT = "user_annotation"          # a record_function range on the host
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def label(target: str) -> str:
    """``pkg.models.coupled:exchange`` -> ``coupled.exchange``."""
    module, attr = target.split(":")
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


@contextlib.contextmanager
def wrapped(targets):
    undo = []
    try:
        for target in sorted(set(targets)):
            module_name, attr = target.split(":")
            try:
                module = importlib.import_module(module_name)
                fn = getattr(module, attr)
            except (ImportError, AttributeError):
                continue

            def ranged(*a, _fn=fn, _name=target, **kw):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **kw)

            setattr(module, attr, ranged)
            undo.append((module, attr, fn))
        yield
    finally:
        for module, attr, fn in reversed(undo):
            setattr(module, attr, fn)


@dataclass
class Trace:
    """What the readers read. Times in microseconds on the trace's clock."""

    window: tuple                       # (start, end) of the traced chunks
    steps: int                          # coupled steps in them
    ranges: dict                        # target -> [(start, end)] host intervals
    device_ops: list                    # (name, start, duration, host launch time)
    untraced_step_us: float = 0.0       # wall time a step of as many chunks run untraced
    diags: dict = field(default_factory=dict)    # per-step counters, numpy
    config: dict = field(default_factory=dict)   # the configuration's file
    n_particles: int = 0

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        """The union of device activity inside the window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d, _ in self.device_ops
                       if s + d > lo and s < hi)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def range_us(self, target: str):
        """Summed host duration of a target's ranges; None without any."""
        spans = self.ranges.get(target)
        return None if not spans else sum(e - s for s, e in spans)

    def calls(self, target: str) -> int:
        return len(self.ranges.get(target, ()))

    def device_us_launched_in(self, target: str):
        """Device time of every operation launched inside a target's
        ranges; None without any range."""
        spans = sorted(self.ranges.get(target, ()))
        if not spans:
            return None
        total, j = 0.0, 0
        for _, s, d, launch in sorted(self.device_ops, key=lambda o: o[3]):
            while j < len(spans) and spans[j][1] < launch:
                j += 1
            if j < len(spans) and spans[j][0] <= launch:
                total += d
        return total

    def innermost(self, t: float) -> str:
        best, start = "harness", -1.0
        for target, spans in self.ranges.items():
            for s, e in spans:
                if s <= t <= e and s > start:
                    best, start = label(target), s
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the device, each named by the innermost range
        the host was in at the gap's middle; seconds."""
        by_name = {}
        for name, _, d, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for s, e in busy for x in (s, e)] + [self.window[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return {"device_ops": [[n, d / 1e6] for n, d in ops],
                "idle_gaps": [[self.innermost(s + g / 2), g / 1e6] for g, s in gaps]}


def parse_chrome_trace(path: str, targets) -> tuple:
    """(window, ranges, device_ops) of an exported `torch.profiler` trace.
    A device operation's launch time is that of the runtime or driver call
    with its correlation id; one without a matched call takes the launch
    time of the last matched operation before it on the device."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    targets = set(targets)
    window, ranges, launches, ops = None, {t: [] for t in targets}, {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == RANGE_CAT and name == WINDOW:
            window = (ts, ts + dur)
        elif cat == RANGE_CAT and name in targets:
            ranges[name].append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            ops.append((name, ts, dur, ev.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    ops.sort(key=lambda o: o[1])
    device_ops, last = [], window[0]
    for name, ts, dur, corr in ops:
        last = launches.get(corr, last)
        device_ops.append((name, ts, dur, last))
    return window, ranges, device_ops


def traced_chunks(run, state, n_chunks: int, targets, device):
    """``n_chunks`` calls of ``run`` with every target wrapped, under the
    profiler. -> (state before the last chunk, final state, per-chunk
    diagnostics, window, ranges, device_ops)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    diags = []
    with wrapped(targets):
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(n_chunks):
                    prev = state
                    state, d = run(state)
                    diags.append(d)
                if on_card:
                    torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        window, ranges, device_ops = parse_chrome_trace(path, targets)
    finally:
        os.unlink(path)
    return prev, state, diags, window, ranges, device_ops
