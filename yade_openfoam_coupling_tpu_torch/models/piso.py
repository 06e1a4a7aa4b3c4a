"""PISO pressure-velocity solver, the icoFoamYade fluid step (port of
`yade_openfoam_coupling_tpu/models/piso.py`), with the fluid BCs, the
PISO configuration and the pressure-solve record that PIMPLE shares.

Momentum is implicit Euler with the coupling drag in the diagonal and
convection and diffusion explicit, so A = 1/dt - uSourceDrag and
H = U_n/dt - div(phi,U) + nu lap(U) + uSource; each corrector recomputes H
from the latest U (Picard) and solves div(rAU_f grad p) = div(phiHbyA)
matrix-free. On a sharded ctx the halos and reductions go through the ring.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import obstacle as ob
from ..ops import pressure as pr
from ..ops import stencil as st
from ..ops.grid import DIRICHLET, NEUMANN, PERIODIC, FaceBC, FieldBC, Grid
from .fields import FluidState


@dataclasses.dataclass(frozen=True)
class FluidBCs:
    """BCs for the primary fields (the 0/ directory of an OpenFOAM case)."""

    u: FieldBC
    p: FieldBC

    @staticmethod
    def periodic() -> "FluidBCs":
        return FluidBCs(FieldBC.periodic(), FieldBC.periodic())

    @staticmethod
    def box_noslip() -> "FluidBCs":
        return FluidBCs(FieldBC.box(DIRICHLET, 0.0), FieldBC.box(NEUMANN))

    @staticmethod
    def channel_z() -> "FluidBCs":
        p = FaceBC(PERIODIC)
        return FluidBCs(
            FieldBC(((p, p), (p, p), (FaceBC(DIRICHLET, 0.0), FaceBC(DIRICHLET, 0.0)))),
            FieldBC(((p, p), (p, p), (FaceBC(NEUMANN), FaceBC(NEUMANN)))),
        )

    def periodic_axes(self) -> Tuple[bool, bool, bool]:
        return tuple(self.u.is_periodic(a) for a in range(3))


@dataclasses.dataclass(frozen=True)
class PISOConfig:
    """The fvSolution `PISO` controls; same fields and defaults as the JAX
    package (``ddt_corr``: the fvc::ddtCorr flux history, off by default
    there too)."""

    n_correctors: int = 2
    momentum_predictor: bool = True
    convection_scheme: str = "linear"
    pressure: pr.PressureSolverConfig = pr.PressureSolverConfig()
    ddt_corr: bool = False


class PressureSolveInfo(NamedTuple):
    iters: torch.Tensor
    initial_residual: torch.Tensor
    final_residual: torch.Tensor


_NEU = FieldBC.uniform("neumann")


def momentum_AH(fs: FluidState, grid: Grid, bcs: FluidBCs, nu_eff, dt, cfg: PISOConfig,
                u_latest: Optional[torch.Tensor] = None, g: Optional[torch.Tensor] = None,
                ctx=None):
    """A (diagonal, a scalar field) and H (explicit operator value) of
    ddt(U) + div(phi,U) - lap(nu,U) == uSource, the drag implicit in A.
    A scalar ``nu_eff`` takes the constant-coefficient Laplacian, a field
    the face-interpolated one."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    up = ctx.pad_v(fs.u if u_latest is None else u_latest, bcs.u)
    conv = st.div_phi_vector_padded(fs.phi, up, grid, cfg.convection_scheme)
    if not isinstance(nu_eff, torch.Tensor) or nu_eff.dim() == 0:
        diff = nu_eff * st.laplacian_vector_padded(up, grid)
    else:
        diff = st.laplacian_gamma_vector_padded(
            st.face_interp_all_padded(ctx.pad_s(nu_eff, _NEU)), up, grid)
    A = 1.0 / dt - fs.u_source_drag
    H = fs.u / dt - conv + diff + fs.u_source
    if g is not None:
        H = H + g[:, None, None, None]
    return A, H


def piso_step(fs: FluidState, grid: Grid, bcs: FluidBCs, nu, dt,
              cfg: PISOConfig = PISOConfig(), ctx=None,
              masks: Optional[ob.ObstacleMasks] = None) -> Tuple[FluidState, PressureSolveInfo]:
    """One PISO step (the fluid half of the icoFoamYade loop); the coupling
    fields in `fs` are inputs. `masks` pins velocity in solid cells, blocks
    fluxes at solid faces and hands the solid rows to
    `solve_pressure(solid=...)`."""
    from ..parallel.ctx import LOCAL, LocalCtx
    ctx = ctx if ctx is not None else LOCAL
    if masks is not None and not isinstance(ctx, LocalCtx):
        # the JAX package asserts one device here too (piso.py:161-164)
        raise NotImplementedError(
            "masked-cell obstacles on a sharded ctx: the masks are not sliced per slab")
    # block-local (additive-Schwarz) preconditioning under sharding:
    # homogeneous BCs with Dirichlet-0 on the sharded axis' faces
    precond_bc = None if isinstance(ctx, LocalCtx) else _precond_bc_for(bcs.p, ctx)
    A, H = momentum_AH(fs, grid, bcs, nu, dt, cfg, ctx=ctx)
    rAU = 1.0 / A
    HbyA = rAU[None] * H

    u = fs.u
    if cfg.momentum_predictor:
        u = HbyA - rAU[None] * st.grad_scalar_padded(ctx.pad_s(fs.p, bcs.p), grid)
        if masks is not None:
            u = ob.mask_u(u, masks)

    if cfg.ddt_corr:
        # the old-time face/cell flux mismatch with OpenFOAM's Euler limiter,
        # fixed across correctors
        flux_uo = st.flux_padded(ctx.pad_v(fs.u, bcs.u), grid)
        dphi = tuple(fs.phi[a] - flux_uo[a] for a in range(3))
        ddtc = tuple((1.0 - torch.clamp(torch.abs(dphi[a]) / (torch.abs(fs.phi[a]) + 1e-30),
                                        max=1.0)) * dphi[a] / dt for a in range(3))
    p, phi, info = fs.p, fs.phi, None
    for _ in range(cfg.n_correctors):
        A, H = momentum_AH(fs, grid, bcs, nu, dt, cfg, u_latest=u, ctx=ctx)
        rAU = 1.0 / A
        HbyA = rAU[None] * H

        phiHbyA = st.flux_padded(ctx.pad_v(HbyA, bcs.u), grid)
        gamma_f = st.face_interp_all_padded(ctx.pad_s(rAU, _NEU))
        if cfg.ddt_corr:
            phiHbyA = tuple(phiHbyA[a] + gamma_f[a] * ddtc[a] for a in range(3))
        phiHbyA = st.constrain_flux(phiHbyA, bcs.u, ctx)
        if masks is not None:
            phiHbyA = ob.mask_flux(phiHbyA, masks)
        if _needs_adjust_phi(bcs):
            phiHbyA = st.adjust_phi(phiHbyA, bcs.u, grid, ctx, ctx.sum)
        if masks is not None:
            gamma_f = ob.mask_flux(gamma_f, masks)
        res = pr.solve_pressure(gamma_f, st.div_flux(phiHbyA, grid), p, grid, bcs.p,
                                cfg.pressure, pad=lambda f: ctx.pad_s(f, bcs.p),
                                reduce_sum=ctx.sum, precond_bc=precond_bc, solid=masks)
        p = res.x
        # step-level info: first solve's initial residual, last solve's
        # final residual, total iterations
        info = PressureSolveInfo(
            res.iters if info is None else info.iters + res.iters,
            res.initial_residual if info is None else info.initial_residual,
            res.residual)

        pp = ctx.pad_s(p, bcs.p)
        snp = st.face_grad_padded(pp, grid)
        phi = tuple(phiHbyA[a] - gamma_f[a] * snp[a] for a in range(3))
        u = HbyA - rAU[None] * st.grad_scalar_padded(pp, grid)
        if masks is not None:
            u = ob.mask_u(u, masks)

    return fs._replace(u=u, p=p, phi=phi), info


def _needs_adjust_phi(bcs: FluidBCs) -> bool:
    """adjustPhi applies when the pressure equation is singular (no fixed
    pressure) and adjustable (Neumann-u) outflow faces exist."""
    p_fixed = any(f.kind == DIRICHLET for pair in bcs.p.faces for f in pair)
    u_adjustable = any(f.kind == NEUMANN for pair in bcs.u.faces for f in pair)
    return (not p_fixed) and u_adjustable


def _precond_bc_for(p_bc: FieldBC, ctx) -> FieldBC:
    """Homogenized pressure BC for block-local preconditioning under
    sharding: sharded-axis faces become Dirichlet-0 (shard-internal edges),
    which keeps each local block non-singular (additive Schwarz). A
    one-rank mesh follows the same rule, as in the JAX package."""
    faces = []
    h = p_bc.homogeneous()
    for a in range(3):
        if ctx.mesh_axes[a] is not None:
            faces.append((FaceBC(DIRICHLET, 0.0), FaceBC(DIRICHLET, 0.0)))
        else:
            faces.append(h.faces[a])
    return FieldBC(tuple(faces))
