"""Finite-volume stencil operators on the uniform Cartesian grid (port of
the main-path part of `yade_openfoam_coupling_tpu/ops/stencil.py`).

``*_padded`` operators consume arrays that already carry a one-cell ghost
shell and contain no BC logic; the unpadded forms (`grad_scalar`, `flux`,
`laplacian`, ...) pad with the field's BCs first. Shapes: scalars ``(nx,ny,nz)``; vectors
``(3,nx,ny,nz)``; tensors ``(3,3,nx,ny,nz)`` with ``T[i,j] = dU_i/dx_j``;
face fluxes are 3-tuples on x/y/z faces.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .grid import DIRICHLET, NEUMANN, SLIP, FieldBC, Grid, pad_scalar, pad_vector

Flux = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _slice(f: torch.Tensor, start: int, stop: int, axis: int) -> torch.Tensor:
    return f.narrow(axis, start, stop - start)


def _diff(fp: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward difference along `axis` of a padded-along-axis array."""
    n = fp.shape[axis]
    return _slice(fp, 1, n, axis) - _slice(fp, 0, n - 1, axis)


def _mean(fp: torch.Tensor, axis: int) -> torch.Tensor:
    n = fp.shape[axis]
    return 0.5 * (_slice(fp, 1, n, axis) + _slice(fp, 0, n - 1, axis))


def _strip_other_axes(fp: torch.Tensor, axis: int, offset: int = 0) -> torch.Tensor:
    """Remove ghost shells on all axes except `axis`."""
    idx = [slice(None)] * fp.dim()
    for a in range(3):
        if a != axis:
            idx[offset + a] = slice(1, -1)
    return fp[tuple(idx)]


# ---------------------------------------------------------------------------
# Gradient
# ---------------------------------------------------------------------------

def grad_scalar_padded(fp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Central-difference cell gradient from a padded scalar: (3,nx,ny,nz)."""
    comps = []
    for axis in range(3):
        f = _strip_other_axes(fp, axis)
        n = f.shape[axis]
        comps.append((_slice(f, 2, n, axis) - _slice(f, 0, n - 2, axis))
                     / (2.0 * grid.spacing[axis]))
    return torch.stack(comps)


def grad_scalar(f: torch.Tensor, bc: FieldBC, grid: Grid) -> torch.Tensor:
    return grad_scalar_padded(pad_scalar(f, bc), grid)


def grad_vector_padded(up: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Velocity-gradient tensor G[i,j] = dU_i/dx_j: (3,3,nx,ny,nz)."""
    return torch.stack([grad_scalar_padded(up[c], grid) for c in range(3)])


def grad_vector(u: torch.Tensor, bc: FieldBC, grid: Grid) -> torch.Tensor:
    return grad_vector_padded(pad_vector(u, bc), grid)


def curl_from_grad(G: torch.Tensor) -> torch.Tensor:
    """curl(U) from the gradient tensor G[i,j]=dU_i/dx_j."""
    return torch.stack([G[2, 1] - G[1, 2], G[0, 2] - G[2, 0], G[1, 0] - G[0, 1]])


# ---------------------------------------------------------------------------
# Face interpolation and fluxes
# ---------------------------------------------------------------------------

def face_interp_padded(fp: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear face values along `axis` from a padded scalar."""
    return _mean(_strip_other_axes(fp, axis), axis)


def face_interp_all_padded(fp: torch.Tensor) -> Flux:
    return tuple(face_interp_padded(fp, a) for a in range(3))


def face_interp(f: torch.Tensor, bc: FieldBC, grid: Grid) -> Flux:
    """``fvc::interpolate`` to all faces."""
    return face_interp_all_padded(pad_scalar(f, bc))


def flux_padded(up: torch.Tensor, grid: Grid) -> Flux:
    """``fvc::flux(U)`` — face-normal velocity from a padded vector field."""
    return tuple(face_interp_padded(up[a], a) for a in range(3))


def flux(u: torch.Tensor, bc: FieldBC, grid: Grid) -> Flux:
    return flux_padded(pad_vector(u, bc), grid)


def face_grad_padded(fp: torch.Tensor, grid: Grid) -> Flux:
    """``fvc::snGrad`` — normal gradient (f_hi - f_lo)/h at every face."""
    return tuple(_diff(_strip_other_axes(fp, axis), axis) / grid.spacing[axis]
                 for axis in range(3))


def face_grad(f: torch.Tensor, bc: FieldBC, grid: Grid) -> Flux:
    return face_grad_padded(pad_scalar(f, bc), grid)


# ---------------------------------------------------------------------------
# Divergence
# ---------------------------------------------------------------------------

def div_flux(phi: Flux, grid: Grid) -> torch.Tensor:
    """``fvc::div(phi)`` of face-normal velocities -> cell scalar (1/s)."""
    out = 0.0
    for axis in range(3):
        out = out + _diff(phi[axis], axis) / grid.spacing[axis]
    return out


def div_vector(u: torch.Tensor, bc: FieldBC, grid: Grid) -> torch.Tensor:
    return div_flux(flux(u, bc, grid), grid)


def _face_value(fp_c: torch.Tensor, axis: int, phi_ax: torch.Tensor, scheme: str) -> torch.Tensor:
    """Face value for convection: 'linear', 'upwind' or 'linearUpwind'."""
    n = fp_c.shape[axis]
    hi = _slice(fp_c, 1, n, axis)
    lo = _slice(fp_c, 0, n - 1, axis)
    if scheme == "linear":
        return 0.5 * (hi + lo)
    if scheme == "upwind":
        return torch.where(phi_ax >= 0.0, lo, hi)
    if scheme == "linearUpwind":
        return 0.75 * 0.5 * (hi + lo) + 0.25 * torch.where(phi_ax >= 0.0, lo, hi)
    raise ValueError(f"unknown convection scheme {scheme!r}")


def div_phi_scalar_padded(phi: Flux, fp: torch.Tensor, grid: Grid,
                          scheme: str = "linear") -> torch.Tensor:
    """``fvc::div(phi, f)`` — conservative convection of a padded scalar."""
    out = 0.0
    for axis in range(3):
        face = _face_value(_strip_other_axes(fp, axis), axis, phi[axis], scheme)
        out = out + _diff(phi[axis] * face, axis) / grid.spacing[axis]
    return out


def div_phi_vector_padded(phi: Flux, up: torch.Tensor, grid: Grid,
                          scheme: str = "linear") -> torch.Tensor:
    """``fvc::div(phi, U)`` per component: (3,nx,ny,nz)."""
    return torch.stack([div_phi_scalar_padded(phi, up[c], grid, scheme) for c in range(3)])


# ---------------------------------------------------------------------------
# Laplacian
# ---------------------------------------------------------------------------

def laplacian_padded(fp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Constant-coefficient 7-point Laplacian of a padded scalar."""
    out = 0.0
    for axis in range(3):
        f = _strip_other_axes(fp, axis)
        n = f.shape[axis]
        hi, mid, lo = _slice(f, 2, n, axis), _slice(f, 1, n - 1, axis), _slice(f, 0, n - 2, axis)
        out = out + (hi - 2.0 * mid + lo) / (grid.spacing[axis] ** 2)
    return out


def laplacian(f: torch.Tensor, bc: FieldBC, grid: Grid) -> torch.Tensor:
    return laplacian_padded(pad_scalar(f, bc), grid)


def laplacian_vector_padded(up: torch.Tensor, grid: Grid) -> torch.Tensor:
    return torch.stack([laplacian_padded(up[c], grid) for c in range(3)])


def laplacian_vector(u: torch.Tensor, bc: FieldBC, grid: Grid) -> torch.Tensor:
    return laplacian_vector_padded(pad_vector(u, bc), grid)


def laplacian_facegamma_padded(gamma_f: Flux, fp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Variable-coefficient ``fvm::laplacian(gamma, p)`` applied matrix-free:
    div(gamma_f * snGrad(p)) — the pressure-equation operator."""
    out = 0.0
    for axis in range(3):
        g = _diff(_strip_other_axes(fp, axis), axis) / grid.spacing[axis]
        out = out + _diff(gamma_f[axis] * g, axis) / grid.spacing[axis]
    return out


def laplacian_facegamma_scalar_padded(gamma_f: Flux, fp: torch.Tensor,
                                      grid: Grid) -> torch.Tensor:
    return laplacian_facegamma_padded(gamma_f, fp, grid)


def laplacian_gamma(gamma: torch.Tensor, f: torch.Tensor, gamma_bc: FieldBC, f_bc: FieldBC,
                    grid: Grid) -> torch.Tensor:
    """div(interpolate(gamma) grad f), each field padded with its own BCs."""
    return laplacian_facegamma_padded(face_interp(gamma, gamma_bc, grid),
                                      pad_scalar(f, f_bc), grid)


def laplacian_gamma_vector_padded(gamma_f: Flux, up: torch.Tensor, grid: Grid) -> torch.Tensor:
    """div(gamma_f grad U) per component."""
    return torch.stack([laplacian_facegamma_padded(gamma_f, up[c], grid) for c in range(3)])


def dev2_transpose_stress(G: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """C[i,j] = coeff * (dU_j/dx_i - (2/3) div(U) delta_ij), the explicit
    half of OpenFOAM's `divDevRhoReff` integrand."""
    div_u = G[0, 0] + G[1, 1] + G[2, 2]
    eye = torch.eye(3, dtype=G.dtype, device=G.device)[:, :, None, None, None]
    C = G.transpose(0, 1) - (2.0 / 3.0) * div_u * eye
    return coeff * C


def div_tensor(C: torch.Tensor, grid: Grid, pad_s) -> torch.Tensor:
    """out[i] = sum_j d C[i,j] / dx_j (central differences, ghosts from
    `pad_s`)."""
    out = []
    for i in range(3):
        s = 0.0
        for j in range(3):
            fp = _strip_other_axes(pad_s(C[i, j]), j)
            n = fp.shape[j]
            s = s + (_slice(fp, 2, n, j) - _slice(fp, 0, n - 2, j)) / (2.0 * grid.spacing[j])
        out.append(s)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Reconstruction and boundary fluxes
# ---------------------------------------------------------------------------

def reconstruct(face_vals: Flux) -> torch.Tensor:
    """``fvc::reconstruct`` — average of the two faces on each axis."""
    return torch.stack([_mean(face_vals[axis], axis) for axis in range(3)])


def _global_edges(ctx, axis: int):
    """(holds the low global face, holds the high one) of ``axis`` on this
    rank: both unless the axis is sharded."""
    if ctx is None or ctx.mesh_axes[axis] is None:
        return True, True
    i = ctx.shard_index(axis)
    return i == 0, i == ctx.shard_count(axis) - 1


def constrain_flux(phi: Flux, u_bc: FieldBC, ctx=None) -> Flux:
    """Pin boundary-face fluxes to the BC normal velocity at Dirichlet/slip
    faces (`constrainHbyA` + `fixedFluxPressure`). Under sharding only the
    ranks holding a global edge pin it."""
    def pin_value(face, a):
        return 0.0 if face.kind == SLIP else face.component(a)
    out = list(phi)
    for a in range(3):
        lo, hi = u_bc.faces[a]
        f = out[a]
        n = f.shape[a]
        at_lo, at_hi = _global_edges(ctx, a)
        if lo.kind in (DIRICHLET, SLIP) and at_lo:
            plane = torch.full_like(_slice(f, 0, 1, a), pin_value(lo, a))
            f = torch.cat([plane, _slice(f, 1, n, a)], dim=a)
        if hi.kind in (DIRICHLET, SLIP) and at_hi:
            plane = torch.full_like(_slice(f, n - 1, n, a), pin_value(hi, a))
            f = torch.cat([_slice(f, 0, n - 1, a), plane], dim=a)
        out[a] = f
    return tuple(out)


def adjust_phi(phi: Flux, u_bc: FieldBC, grid: Grid, ctx=None, reduce_sum=None) -> Flux:
    """Global mass-balance correction for inlet/outflow cases (`adjustPhi`):
    an additive uniform outward velocity on the Neumann-u faces makes the
    net boundary flux vanish. No-op without Neumann-u faces."""
    reduce_sum = reduce_sum or (lambda x: x)
    if not any(f.kind == NEUMANN for pair in u_bc.faces for f in pair):
        return phi

    fixed_net = 0.0     # outward flux through non-adjustable faces
    adj_out = 0.0       # outward flux through adjustable faces
    planes = []
    for a in range(3):
        lo, hi = u_bc.faces[a]
        if u_bc.is_periodic(a):
            continue
        hs = [grid.spacing[x] for x in range(3) if x != a]
        A = hs[0] * hs[1]
        f = phi[a]
        n = f.shape[a]
        lo_out = -torch.sum(_slice(f, 0, 1, a)) * A
        hi_out = torch.sum(_slice(f, n - 1, n, a)) * A
        at_lo, at_hi = _global_edges(ctx, a)
        if not at_lo:
            lo_out = torch.zeros_like(lo_out)
        if not at_hi:
            hi_out = torch.zeros_like(hi_out)
        for side, out in ((0, lo_out), (1, hi_out)):
            if (lo if side == 0 else hi).kind == NEUMANN:
                adj_out = adj_out + out
                planes.append((a, side))
            else:
                fixed_net = fixed_net + out
    fixed_net = reduce_sum(fixed_net)
    adj_out = reduce_sum(adj_out)

    adj_area = 0.0
    for a, side in planes:
        hs = [grid.spacing[x] for x in range(3) if x != a]
        nfaces = 1
        for x in range(3):
            if x != a:
                nfaces *= grid.shape[x]
        adj_area = adj_area + hs[0] * hs[1] * nfaces
    scale = 1.0
    additive = -(fixed_net + adj_out) / adj_area
    out = list(phi)
    for a, side in planes:
        f = out[a]
        n = f.shape[a]
        at_lo, at_hi = _global_edges(ctx, a)
        if side == 0 and at_lo:
            plane = _slice(f, 0, 1, a) * scale - additive
            f = torch.cat([plane, _slice(f, 1, n, a)], dim=a)
        elif side == 1 and at_hi:
            plane = _slice(f, n - 1, n, a) * scale + additive
            f = torch.cat([_slice(f, 0, n - 1, a), plane], dim=a)
        out[a] = f
    return tuple(out)


def surface_sum_abs_over_V(phi: Flux, grid: Grid) -> torch.Tensor:
    """``fvc::surfaceSum(mag(phi))/V`` per cell — the Courant-number kernel."""
    out = 0.0
    for axis in range(3):
        p = torch.abs(phi[axis])
        n = p.shape[axis]
        out = out + (_slice(p, 1, n, axis) + _slice(p, 0, n - 1, axis)) / grid.spacing[axis]
    return out
