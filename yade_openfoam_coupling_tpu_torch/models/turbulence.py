"""Turbulence closures for the phase-weighted PIMPLE solver (port of
`yade_openfoam_coupling_tpu/models/turbulence.py`): laminar, the LES
`Smagorinsky` and `kEqn` models and the RAS `kEpsilon` model with its
standard wall functions, the closures OpenFOAM's DPM solver family
registers.

Transport equations (kEqn; k and epsilon of kEpsilon) are phase-weighted,
ddt(alpha k) + div(alphaPhi k) - div(alpha (nu + nut/sigma) grad k) =
alpha (G - eps), explicit in time with the sinks linearized
semi-implicitly (Patankar). Smagorinsky is algebraic: k_sgs = (Ck/Ce)
Delta^2 S2, nut = Ck Delta sqrt(k_sgs). kEpsilon's wall functions
(epsilonWallFunction, nutkWallFunction) act on the wall-adjacent cells,
whose mask and wall distance (`wall_layers`) `CaseConfig.wall_layers`
builds once per device and the coupled step passes in.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops import stencil as st
from ..ops.grid import DIRICHLET, SLIP, FieldBC, Grid
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


def wall_layers(grid: Grid, bcs: FluidBCs, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, y) of the wall-adjacent cells: mask (nx,ny,nz) bool, and the
    wall distance (half the cell size on the wall axis, the least where a
    cell touches several walls; 1 elsewhere) as float32. Walls are the
    non-periodic faces whose u BC is DIRICHLET or SLIP (OpenFOAM's wall
    patches). Built with numpy and copied to ``device``."""
    mask = np.zeros(grid.shape, bool)
    y = np.full(grid.shape, np.inf)
    for a in range(3):
        if bcs.u.is_periodic(a):
            continue
        lo, hi = bcs.u.faces[a]
        half = 0.5 * grid.spacing[a]
        for side, face in ((0, lo), (-1, hi)):
            if face.kind in (DIRICHLET, SLIP):
                idx = [slice(None)] * 3
                idx[a] = side
                mask[tuple(idx)] = True
                y[tuple(idx)] = np.minimum(y[tuple(idx)], half)
    y = np.where(mask, y, 1.0)
    return (torch.as_tensor(mask, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device))


def _apply_wall_functions(k, eps, nut, nu, walls, cfg: TurbulenceConfig):
    """The standard high-Re wall treatment at the wall-adjacent cells:
    epsilonWallFunction eps_w = C_mu^{3/4} k^{3/2} / (kappa y), and
    nutkWallFunction nut_w = nu (y+ kappa / ln(E y+) - 1) with u_tau =
    C_mu^{1/4} sqrt(k), y+ = u_tau y / nu, for y+ above the laminar
    sublayer (11), else 0."""
    mask, y = walls
    cmu34 = cfg.c_mu ** 0.75
    cmu14 = cfg.c_mu ** 0.25
    k_w = torch.clamp(k, min=cfg.k_min)
    eps_wall = cmu34 * k_w ** 1.5 / (cfg.kappa * y)
    u_tau = cmu14 * torch.sqrt(k_w)
    y_plus = u_tau * y / nu
    y_lam = 11.0   # OpenFOAM yPlusLam(kappa=0.41, E=9.8) ~ 11.53
    nut_wall = nu * torch.clamp(
        y_plus * cfg.kappa / torch.log(torch.clamp(cfg.e_wall * y_plus, min=1.001)) - 1.0,
        min=0.0)
    nut_wall = torch.where(y_plus > y_lam, nut_wall, 0.0)
    return torch.where(mask, eps_wall, eps), torch.where(mask, nut_wall, nut)


def correct(turb: TurbulenceState, fs: FluidState, grid: Grid, bcs: FluidBCs,
            nu: float, dt, cfg: TurbulenceConfig, ctx=None, walls=None) -> TurbulenceState:
    """One `continuousPhaseTurbulence->correct()` equivalent. ``walls`` is
    the `wall_layers` of (grid, bcs) on the fields' device, which kEpsilon's
    wall functions read; built here when None."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    if cfg.model == "laminar":
        return turb._replace(nut=fs.alpha * 0.0)
    if cfg.model not in ("kEqn", "Smagorinsky", "kEpsilon"):
        raise ValueError(f"unknown turbulence model {cfg.model!r}")

    S2 = strain_rate_sq(fs.u, bcs, grid, ctx)
    if cfg.model == "Smagorinsky":
        d = les_delta(grid)
        k_sgs = (cfg.ck / cfg.ce) * d * d * S2
        nut = cfg.ck * d * torch.sqrt(k_sgs)
        return turb._replace(nut=torch.clamp(nut, 0.0, cfg.nut_max), k=k_sgs)

    alpha = fs.alpha
    alpha_old = fs.alpha_old
    alpha_f = st.face_interp_all_padded(ctx.pad_s(alpha, _NEU))
    phi_alpha = tuple(alpha_f[a] * fs.phi[a] for a in range(3))
    a_new = torch.clamp(alpha, min=1e-3)

    if cfg.model == "kEpsilon":
        k = torch.clamp(turb.k, min=cfg.k_min)
        eps = torch.clamp(turb.epsilon, min=cfg.eps_min)
        prod = alpha * turb.nut * S2
        kp = ctx.pad_s(k, _NEU)
        ep = ctx.pad_s(eps, _NEU)
        conv_k = st.div_phi_scalar_padded(phi_alpha, kp, grid, "upwind")
        conv_e = st.div_phi_scalar_padded(phi_alpha, ep, grid, "upwind")
        gam_k = st.face_interp_all_padded(ctx.pad_s(alpha * (nu + turb.nut / cfg.sigma_k), _NEU))
        gam_e = st.face_interp_all_padded(
            ctx.pad_s(alpha * (nu + turb.nut / cfg.sigma_eps), _NEU))
        diff_k = st.laplacian_facegamma_padded(gam_k, kp, grid)
        diff_e = st.laplacian_facegamma_padded(gam_e, ep, grid)
        # semi-implicit sinks: eps in the k equation, C2 eps^2/k in eps's
        k_new = (alpha_old * k + dt * (prod - conv_k + diff_k)) / (
            a_new * (1.0 + dt * eps / k))
        e_new = (alpha_old * eps + dt * (cfg.c1 * prod * eps / k - conv_e + diff_e)) / (
            a_new * (1.0 + dt * cfg.c2 * eps / k))
        k_new = torch.clamp(k_new, min=cfg.k_min)
        e_new = torch.clamp(e_new, min=cfg.eps_min)
        nut_new = cfg.c_mu * k_new * k_new / e_new
        if cfg.wall_functions:
            if walls is None:
                walls = wall_layers(grid, bcs, k_new.device)
            e_new, nut_new = _apply_wall_functions(k_new, e_new, nut_new, nu, walls, cfg)
            e_new = torch.clamp(e_new, min=cfg.eps_min)
        return turb._replace(k=k_new, epsilon=e_new,
                             nut=torch.clamp(nut_new, 0.0, cfg.nut_max))

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
