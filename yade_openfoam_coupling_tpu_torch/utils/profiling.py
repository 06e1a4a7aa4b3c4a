"""Profiling hooks: `torch.profiler` traces and phase timers (port of
`yade_openfoam_coupling_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace of a block (CPU and, when a card
is present, CUDA activity) and exports it as a Chrome trace; `annotate`
names a region in that timeline, `spanned` a whole function, and
`host_tensor` the copy of host data to a device; `PhaseTimer` accumulates
host-clock phase times, synchronising the device of a given tensor before
it reads the clock, and prints them in the JAX package's format.

The coupled step names its stages with `annotate` (every name is
``yofc:<stage>``; README lists them). A span is a `record_function` range
in the profiler's session, so it shares the device trace's clock; with no
profiler running `annotate` returns one shared null context and records
nothing, so the spans cost the step nothing outside a trace. The names
have the ``module:attribute`` form of `cfdbench`'s traced targets with no
module behind them (``yofc`` imports nothing), so a benchmark metric names
a span in its ``WRAPS``: the harness wraps nothing for it and keeps the
span's ranges, labelled ``yofc.<stage>``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed block and write it
    to ``logdir/trace.json`` (Chrome trace format):

        with profiling.trace('/tmp/yofc-trace'):
            state, _ = step(state)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NULL = contextlib.nullcontext()


def annotate(name: str):
    """A named region in the profiler's timeline (`record_function`) while
    a profiler runs; otherwise one shared null context, which records
    nothing and costs a check."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: the whole call of the function inside ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_tensor(data, dtype=None, device=None) -> torch.Tensor:
    """`torch.as_tensor(data, dtype, device)` of host data (a Python number
    or sequence, a numpy array) inside a ``yofc:sync.h2d`` span: PyTorch
    copies host data to a card with a blocking copy, which waits for the
    card's stream. A tensor passes through `as_tensor` with no span."""
    if isinstance(data, torch.Tensor):
        return torch.as_tensor(data, dtype=dtype, device=device)
    with annotate("yofc:sync.h2d"):
        return torch.as_tensor(data, dtype=dtype, device=device)


def _sync(block_on) -> None:
    """Wait for the work queued on the device of every tensor in
    ``block_on`` (a tensor or a nested tuple/list/NamedTuple of them)."""
    if isinstance(block_on, torch.Tensor):
        if block_on.device.type == "cuda":
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, (tuple, list)):
        for b in block_on:
            _sync(b)


class PhaseTimer:
    """Host-side accumulating timer for coarse phase breakdowns."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the enclosed block; with ``block_on`` (tensors, or a
        callable returning them) the device they lie on is synchronised
        first, so queued kernels count in the phase."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _sync(block_on() if callable(block_on) else block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[k]
            tot = self.totals[k]
            lines.append(f"{k:30s} {tot:9.3f}s total  {tot / n * 1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)
