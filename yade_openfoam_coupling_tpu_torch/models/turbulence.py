"""Turbulence closures for the phase-weighted PIMPLE solver (port of the
`laminar` and `kEqn` parts of `yade_openfoam_coupling_tpu/models/turbulence.py`).

kEqn: ddt(alpha k) + div(alphaPhi k) = alpha (P - Ce k^1.5/Delta)
+ div(alpha (nu + nut) grad k), explicit in time with the sink linearized
semi-implicitly (Patankar). `Smagorinsky` and `kEpsilon` (with its wall
functions) are not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import stencil as st
from ..ops.grid import FieldBC, Grid
from .fields import FluidState, TurbulenceState
from .piso import FluidBCs

_NEU = FieldBC.uniform("neumann")


@dataclasses.dataclass(frozen=True)
class TurbulenceConfig:
    """The `turbulenceProperties` dictionary; same fields and defaults as
    the JAX package."""

    model: str = "laminar"      # 'laminar' | 'kEpsilon' | 'Smagorinsky' | 'kEqn'
    c_mu: float = 0.09
    c1: float = 1.44
    c2: float = 1.92
    sigma_k: float = 1.0
    sigma_eps: float = 1.3
    ck: float = 0.094
    ce: float = 1.048
    k_min: float = 1e-10
    eps_min: float = 1e-12
    nut_max: float = 1e2
    wall_functions: bool = True
    kappa: float = 0.41
    e_wall: float = 9.8


def strain_rate_sq(u: torch.Tensor, bcs: FluidBCs, grid: Grid, ctx=None) -> torch.Tensor:
    """2 S:S where S = 0.5 (grad U + grad U^T) — the production kernel."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    G = st.grad_vector_padded(ctx.pad_v(u, bcs.u), grid)
    S = 0.5 * (G + G.transpose(0, 1))
    return 2.0 * torch.sum(S * S, dim=(0, 1))


def les_delta(grid: Grid) -> float:
    """Cube-root-volume filter width (OpenFOAM `cubeRootVol`)."""
    return float(np.cbrt(grid.cell_volume))


def correct(turb: TurbulenceState, fs: FluidState, grid: Grid, bcs: FluidBCs,
            nu: float, dt, cfg: TurbulenceConfig, ctx=None) -> TurbulenceState:
    """One `continuousPhaseTurbulence->correct()` equivalent."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    if cfg.model == "laminar":
        return turb._replace(nut=fs.alpha * 0.0)
    if cfg.model in ("Smagorinsky", "kEpsilon"):
        raise NotImplementedError(
            f"turbulence model {cfg.model!r}: not ported yet (ROADMAP A13)")
    if cfg.model != "kEqn":
        raise ValueError(f"unknown turbulence model {cfg.model!r}")

    S2 = strain_rate_sq(fs.u, bcs, grid, ctx)
    alpha = fs.alpha
    alpha_old = fs.alpha_old
    alpha_f = st.face_interp_all_padded(ctx.pad_s(alpha, _NEU))
    phi_alpha = tuple(alpha_f[a] * fs.phi[a] for a in range(3))
    a_new = torch.clamp(alpha, min=1e-3)

    d = les_delta(grid)
    k = torch.clamp(turb.k, min=cfg.k_min)
    nut = turb.nut
    prod = alpha * nut * S2
    kp = ctx.pad_s(k, _NEU)
    conv = st.div_phi_scalar_padded(phi_alpha, kp, grid, "upwind")
    gamma = st.face_interp_all_padded(ctx.pad_s(alpha * (nu + nut), _NEU))
    diff = st.laplacian_facegamma_padded(gamma, kp, grid)
    sink_coeff = cfg.ce * torch.sqrt(k) / d
    k_new = (alpha_old * k + dt * (prod - conv + diff)) / (
        a_new * (1.0 + dt * sink_coeff))
    k_new = torch.clamp(k_new, min=cfg.k_min)
    nut_new = cfg.ck * d * torch.sqrt(k_new)
    return turb._replace(k=k_new, nut=torch.clamp(nut_new, 0.0, cfg.nut_max))
