"""Run logging: the reference's per-step console banner, structured (port
of `yade_openfoam_coupling_tpu/utils/logging.py`).

Replicates the observability surface of the reference loops
(`icoFoamYade.C:67-68,144-146`, `CourantNo.H:48-49`,
`continuityErrs.H:42-45`): time banner, Courant mean/max, pressure solver
iterations/residuals, continuity errors, execution/clock time — plus the
particle-side counters the reference only prints on failure
(`FoamYade.C:229-231`)."""

from __future__ import annotations

import sys
import time


class RunLogger:
    def __init__(self, every: int = 1, stream=None):
        self.every = every
        self.stream = stream or sys.stdout
        self.t0 = time.perf_counter()
        self._cpu0 = time.process_time()

    def log_step(self, state, diag) -> None:
        step = int(state.step)
        if step % self.every:
            return
        wall = time.perf_counter() - self.t0
        cpu = time.process_time() - self._cpu0
        w = self.stream.write
        w(f"Time = {float(state.t):.6g}  (step {step}, dt {float(state.dt):.3e})\n")
        w(
            f"Courant Number mean: {float(diag.co_mean):.4g}"
            f" max: {float(diag.co_max):.4g}\n"
        )
        w(
            f"p: iters {int(diag.p_iters)}, initial residual"
            f" {float(diag.p_initial_residual):.3e}, final residual"
            f" {float(diag.p_final_residual):.3e}\n"
        )
        w(
            f"time step continuity errors : sum local = "
            f"{float(diag.cont_err_local):.3e}, global = "
            f"{float(diag.cont_err_global):.3e}\n"
        )
        w(
            f"particles found: {int(diag.n_found)}, max |v| = "
            f"{float(diag.max_particle_speed):.4g}\n"
        )
        overflow = int(getattr(diag, "n_contact_overflow", 0))
        if overflow:
            w(
                f"WARNING: {overflow} DEM neighbor-list overflows — raise "
                f"cell_capacity/max_neighbors (contacts are being dropped)\n"
            )
        cpl_overflow = int(getattr(diag, "n_coupling_overflow", 0))
        if cpl_overflow:
            w(
                f"WARNING: {cpl_overflow} coupling slot overflows — raise "
                f"slot_capacity (particles uncoupled this step)\n"
            )
        w(f"ExecutionTime = {cpu:.2f} s  ClockTime = {wall:.2f} s\n\n")
        self.stream.flush()
