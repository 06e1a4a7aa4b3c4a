"""PIMPLE 4-way pressure-velocity solver (port of
`yade_openfoam_coupling_tpu/models/pimple.py`).

Phase momentum with the continuity and drag Sp terms in the implicit
diagonal, convection and the alpha-weighted viscous stress (plus the
dev2-transpose term) explicit; body forces enter through the face flux;
the pressure equation laplacian(alphacf*rAUcf, p) == ddt(alphac) +
div(alphacf*phiHbyA) is solved matrix-free. Masked-cell obstacles
(``masks``) as in `piso.piso_step`. Under ``implicit_diffusion`` the
viscous Laplacian moves into the matrix: the predictor solves three
Helmholtz systems (`pressure.solve_helmholtz`, one per component) with
the reconstructed force at the current p on the right-hand side, and
HbyA = u* - rAU F_old.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import obstacle as ob
from ..ops import pressure as pr
from ..ops import stencil as st
from ..ops.grid import FieldBC, Grid
from .fields import FluidState
from .piso import FluidBCs, PressureSolveInfo, _needs_adjust_phi, _precond_bc_for


@dataclasses.dataclass(frozen=True)
class PIMPLEConfig:
    """The fvSolution `PIMPLE` controls; same fields and defaults as the
    JAX package."""

    n_outer: int = 2
    n_correctors: int = 1
    momentum_predictor: bool = False
    convection_scheme: str = "linear"
    pressure: pr.PressureSolverConfig = pr.PressureSolverConfig()
    full_stress: bool = True
    relax_u: float = 1.0
    relax_p: float = 1.0
    p_extrapolate: float = 0.0
    implicit_diffusion: bool = False
    momentum: pr.PressureSolverConfig = pr.PressureSolverConfig(
        solver="pcg", tol=1e-6, maxiter=100)


_NEU = FieldBC.uniform("neumann")


def pimple_step(fs: FluidState, grid: Grid, bcs: FluidBCs, nu: float,
                nut: torch.Tensor, g: torch.Tensor, dt,
                cfg: PIMPLEConfig = PIMPLEConfig(), ctx=None,
                masks=None) -> Tuple[FluidState, PressureSolveInfo]:
    """One PIMPLE step; `fs.alpha/u_source/u_source_drag/u_particle` hold
    this step's coupling output."""
    from ..parallel.ctx import LOCAL, LocalCtx
    ctx = ctx if ctx is not None else LOCAL
    if cfg.implicit_diffusion and cfg.full_stress:
        raise ValueError("implicit_diffusion requires full_stress=False: the explicit "
                         "dev2-transpose term re-imposes the diffusion dt cap")
    if masks is not None and cfg.implicit_diffusion:
        raise ValueError("masked-cell obstacles: the Helmholtz momentum solves do not carry "
                         "the solid rows; use explicit diffusion")
    if masks is not None and not isinstance(ctx, LocalCtx):
        raise NotImplementedError(
            "masked-cell obstacles on a sharded ctx: the masks are not sliced per slab "
            "(the JAX package asserts one device too, pimple.py:127-133)")
    alpha = fs.alpha
    alpha_old = fs.alpha_old
    alpha_f = st.face_interp_all_padded(ctx.pad_s(alpha, _NEU))   # alphacf
    phi_alpha = tuple(alpha_f[a] * fs.phi[a] for a in range(3))   # alphaPhic

    ddt_alpha = (alpha - alpha_old) / dt
    sp_cont = ddt_alpha + st.div_flux(phi_alpha, grid)

    nu_eff = nu + nut
    gamma_visc = st.face_interp_all_padded(ctx.pad_s(alpha * nu_eff, _NEU))

    u = fs.u
    p = fs.p
    phi = fs.phi
    info = None
    pcfg = cfg.pressure
    precond_bc = None if isinstance(ctx, LocalCtx) else _precond_bc_for(bcs.p, ctx)

    for _outer in range(cfg.n_outer):
        final = _outer == cfg.n_outer - 1
        up = ctx.pad_v(u, bcs.u)
        conv = st.div_phi_vector_padded(phi_alpha, up, grid, cfg.convection_scheme)
        if cfg.implicit_diffusion:
            visc = torch.zeros_like(u)    # the Laplacian moves into the matrix
        else:
            visc = st.laplacian_gamma_vector_padded(gamma_visc, up, grid)
        if cfg.full_stress:
            G = st.grad_vector_padded(up, grid)
            C = st.dev2_transpose_stress(G, alpha * nu_eff)
            visc = visc + st.div_tensor(C, grid, lambda f: ctx.pad_s(f, _NEU))

        # fvm::ddt(alphac, Uc): diagonal alpha^{n+1}/dt, source alpha^n u^n/dt
        A = alpha / dt - sp_cont - fs.u_source_drag
        H = alpha_old * fs.u / dt - conv + visc
        if cfg.implicit_diffusion:
            # the full diagonal, the (interior-stencil) Laplacian rows included
            D = A - pr.poisson_diag(gamma_visc, Grid(tuple(alpha.shape), grid.spacing,
                                                     grid.origin), None)
            if cfg.relax_u < 1.0 and not final:
                lam = cfg.relax_u
                H = H + ((1.0 - lam) / lam) * D[None] * u
                A = A + ((1.0 - lam) / lam) * D
                D = D / lam
            rAU = 1.0 / D
        else:
            if cfg.relax_u < 1.0 and not final:
                lam = cfg.relax_u
                H = H + ((1.0 - lam) / lam) * A[None] * u
                A = A / lam
            rAU = 1.0 / A
        rAU_f = st.face_interp_all_padded(ctx.pad_s(rAU, _NEU))   # rAUcf

        # phicForces: body-force face flux
        force_flux = st.flux_padded(ctx.pad_v(rAU[None] * fs.u_source, _NEU), grid)
        phic_forces = tuple(force_flux[a] + rAU_f[a] * g[a] for a in range(3))
        if masks is not None:
            # body forces push no flux through blocked faces
            phic_forces = ob.mask_flux(phic_forces, masks)
        if cfg.implicit_diffusion:
            # the predictor sees the reconstructed force at the current p
            # (`UcEqn == fvc::reconstruct(...)`); its rAU image leaves HbyA,
            # and the corrector adds it back at the new p
            snp0 = st.face_grad_padded(ctx.pad_s(p, bcs.p), grid)
            rec_F = st.reconstruct(tuple(phic_forces[a] / rAU_f[a] - snp0[a]
                                         for a in range(3)))
            comps = []
            for c in range(3):
                bc_c = bcs.u.component(c)
                res_c = pr.solve_helmholtz(
                    A, gamma_visc, H[c] + rec_F[c], u[c], grid, bc_c, cfg.momentum,
                    pad=lambda f, _bc=bc_c: ctx.pad_s(f, _bc), reduce_sum=ctx.sum,
                    precond_bc=None if isinstance(ctx, LocalCtx) else _precond_bc_for(bc_c, ctx))
                comps.append(res_c.x)
            u = torch.stack(comps)                  # the momentum predictor
            HbyA = u - rAU[None] * rec_F
        else:
            HbyA = rAU[None] * H

        if cfg.momentum_predictor:
            snp = st.face_grad_padded(ctx.pad_s(p, bcs.p), grid)
            u = HbyA + rAU[None] * st.reconstruct(
                tuple(phic_forces[a] / rAU_f[a] - snp[a] for a in range(3)))
            if masks is not None:
                u = ob.mask_u(u, masks)

        p_outer = p
        if _outer == 0 and cfg.p_extrapolate != 0.0 and fs.p_prev is not None:
            p = p + cfg.p_extrapolate * (p - fs.p_prev)
        for _corr in range(cfg.n_correctors):
            phiHbyA = st.flux_padded(ctx.pad_v(HbyA, bcs.u), grid)
            phiHbyA = tuple(phiHbyA[a] + phic_forces[a] for a in range(3))
            phiHbyA = st.constrain_flux(phiHbyA, bcs.u, ctx)
            if masks is not None:
                phiHbyA = ob.mask_flux(phiHbyA, masks)
            if _needs_adjust_phi(bcs):
                phiHbyA = st.adjust_phi(phiHbyA, bcs.u, grid, ctx, ctx.sum)

            gamma_p = tuple(alpha_f[a] * rAU_f[a] for a in range(3))
            rhs = ddt_alpha + st.div_flux(
                tuple(alpha_f[a] * phiHbyA[a] for a in range(3)), grid)
            if masks is not None:
                # solid cells carry no continuity equation
                gamma_p = ob.mask_flux(gamma_p, masks)
                rhs = rhs * masks.fluid
            res = pr.solve_pressure(
                gamma_p, rhs, p, grid, bcs.p, pcfg,
                pad=lambda f: ctx.pad_s(f, bcs.p), reduce_sum=ctx.sum,
                precond_bc=precond_bc, solid=masks)
            p = res.x
            # step-level info: first solve's initial residual, last solve's
            # final residual, total iterations
            info = PressureSolveInfo(
                res.iters if info is None else info.iters + res.iters,
                res.initial_residual if info is None else info.initial_residual,
                res.residual)

            snp = st.face_grad_padded(ctx.pad_s(p, bcs.p), grid)
            if masks is not None:
                # the pressure flux rides the masked coefficient: snGrad(p)
                # across a solid face is nonzero by construction
                snp = ob.mask_flux(snp, masks)
            pflux_over_alpha = tuple(rAU_f[a] * snp[a] for a in range(3))
            phi = tuple(phiHbyA[a] - pflux_over_alpha[a] for a in range(3))
            u = HbyA + rAU[None] * st.reconstruct(tuple(
                (phic_forces[a] - pflux_over_alpha[a]) / rAU_f[a] for a in range(3)))
            if masks is not None:
                u = ob.mask_u(u, masks)
        if cfg.relax_p < 1.0 and not final:
            p = p_outer + cfg.relax_p * (p - p_outer)
        phi_alpha = tuple(alpha_f[a] * phi[a] for a in range(3))
        sp_cont = ddt_alpha + st.div_flux(phi_alpha, grid)

    return fs._replace(u=u, p=p, phi=phi), info
