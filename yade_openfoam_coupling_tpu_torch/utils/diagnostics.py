"""Step diagnostics: Courant number, continuity errors, adaptive dt (port
of `yade_openfoam_coupling_tpu/utils/diagnostics.py`)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import stencil as st
from ..ops.grid import FieldBC, Grid


@dataclasses.dataclass(frozen=True)
class TimeControls:
    """The controlDict time controls (`readTimeControls.H`)."""

    adjust_time_step: bool = False
    max_co: float = 0.5
    max_dt: float = 1.0
    min_dt: float = 1e-12


def courant(phi, grid: Grid, dt, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, max) Courant number: Co = 0.5 * sum_f |phi_f| A / V * dt."""
    co = 0.5 * st.surface_sum_abs_over_V(phi, grid) * dt
    if ctx is None:
        return torch.mean(co), torch.amax(co)
    return ctx.mean_of_sum(torch.sum(co), co.numel()), ctx.max(torch.amax(co))


def new_dt(co_max, dt, tc: TimeControls, dt_diff=None):
    """`setDeltaT.H`: grow at most 1.2x toward maxCo, shrink as needed,
    clamp to [min_dt, max_dt] and to the explicit-diffusion bound."""
    if not tc.adjust_time_step:
        return dt
    factor = tc.max_co / torch.clamp(co_max, min=1e-12)
    factor = torch.clamp(torch.minimum(factor, 1.0 + 0.1 * factor), max=1.2)
    out = dt * factor
    if dt_diff is not None:
        out = torch.minimum(out, torch.as_tensor(dt_diff, dtype=out.dtype,
                                                 device=out.device))
    return torch.clamp(out, tc.min_dt, tc.max_dt)


def diffusive_dt_bound(grid: Grid, nu: float, nut_max, safety: float = 0.9):
    """Explicit-diffusion stable dt: safety * h_min^2 / (6 nu_eff_max)."""
    h2 = min(grid.spacing) ** 2
    nut_max = torch.as_tensor(nut_max)
    return safety * h2 / (6.0 * (nu + torch.clamp(nut_max, min=0.0)))


def continuity_errors(phi, alpha, alpha_old, grid: Grid, dt, ctx=None):
    """(local, global) continuity error: contErr = ddt(alpha) + div(alpha_f phi)."""
    if ctx is None:
        from ..parallel.ctx import LOCAL
        ctx = LOCAL
    alpha_f = st.face_interp_all_padded(ctx.pad_s(alpha, FieldBC.uniform("neumann")))
    cont = (alpha - alpha_old) / dt + st.div_flux(
        tuple(alpha_f[a] * phi[a] for a in range(3)), grid)
    local = ctx.mean_of_sum(torch.sum(torch.abs(cont)), cont.numel()) * dt
    glob = ctx.mean_of_sum(torch.sum(cont), cont.numel()) * dt
    return local, glob
