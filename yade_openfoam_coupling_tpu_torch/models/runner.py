"""Host-side run loop, the equivalent of the two solver `main`s (port of
`yade_openfoam_coupling_tpu/models/runner.py`).

Chunks of `chunk` coupled steps run back to back (`make_scan_fn`); between
chunks the host logs, checks that the state is finite, writes time
directories (`runTime.write()` parity) and full-state checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import checkpoint as ckpt
from ..utils.config import RunControls
from ..utils.logging import RunLogger
from .coupled import CaseConfig, make_scan_fn
from .fields import SimState, StepDiagnostics


@dataclasses.dataclass
class RunResult:
    state: SimState
    steps: int
    wrote: list


class DivergenceError(RuntimeError):
    """Raised when the solution blows up: a non-finite state aborts with
    diagnostics, and checkpoints allow resuming from the last good
    snapshot."""


def check_finite(state: SimState, diag) -> None:
    bad = [name for name, t in (("U", state.fluid.u), ("p", state.fluid.p),
                                ("particles.pos", state.particles.pos))
           if not bool(torch.isfinite(t).all())]
    if bad:
        raise DivergenceError(
            f"non-finite fields {bad} at t={float(state.t):.6g} "
            f"(step {int(state.step)}); last Courant max "
            f"{float(diag.co_max):.3g}, p residual "
            f"{float(diag.p_final_residual):.3g}"
        )


def run(cfg: CaseConfig, state: SimState, controls: RunControls, *, chunk: int = 10,
        case_dir: Optional[str] = None, checkpoint_dir: Optional[str] = None,
        logger: Optional[RunLogger] = None, max_steps: Optional[int] = None,
        check_health: bool = True) -> RunResult:
    """Advance until `controls.end_time` (or max_steps)."""
    logger = logger or RunLogger(every=chunk)
    scan = make_scan_fn(cfg, chunk)
    wrote = []
    # time-dir output and checkpoints each track their own next-due time
    next_write = float(state.t) + controls.write_interval
    next_checkpoint = float(state.t) + controls.write_interval
    steps = 0

    while float(state.t) < controls.end_time:
        if max_steps is not None and steps >= max_steps:
            break
        state, diags = scan(state)
        steps += chunk
        last = StepDiagnostics(*[x[-1] for x in diags])
        logger.log_step(state, last)
        if check_health:
            check_finite(state, last)

        if case_dir is not None and float(state.t) >= next_write:
            wrote.append(ckpt.write_time_dir(case_dir, state, grid=cfg.grid))
            next_write += controls.write_interval
        if checkpoint_dir is not None and float(state.t) >= next_checkpoint:
            ckpt.save(checkpoint_dir, state)
            next_checkpoint += controls.write_interval

    if checkpoint_dir is not None:
        ckpt.save(checkpoint_dir, state)
    return RunResult(state=state, steps=steps, wrote=wrote)
