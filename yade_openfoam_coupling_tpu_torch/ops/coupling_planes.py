"""Channel-major slot-plane helpers shared by the window exchange (port of
the parts of `yade_openfoam_coupling_tpu/ops/coupling_planes.py` that
`coupling_window.py` imports).

The planes exchange itself (binning, its Pallas kernels, the chunked
variant) is not ported yet (ROADMAP A12, B4-B6).
"""

from __future__ import annotations

import math

import torch

from . import coupling as cp


def pad_wrap_zero(F: torch.Tensor, periodic) -> torch.Tensor:
    """Single-device ghost ring: wrap on periodic axes, zero on wall axes
    (never read — wall-offset weights are masked)."""
    Fp = F
    for a in range(3):
        dim = a + 1
        n = Fp.shape[dim]
        if periodic[a]:
            lo = Fp.narrow(dim, n - 1, 1)
            hi = Fp.narrow(dim, 0, 1)
        else:
            lo = torch.zeros_like(Fp.narrow(dim, 0, 1))
            hi = lo
        Fp = torch.cat([lo, Fp, hi], dim=dim)
    return Fp


def _combo_of(o, dy_in_kernel):
    """Output-stack key of one offset: (dx, dy), or (dx, 0) when the dy
    shift is applied in the kernel (CouplingConfig.dy_in_kernel)."""
    return (int(o[0]), 0 if dy_in_kernel else int(o[1]))


def _roll_contrib(contrib, o, dy_in_kernel):
    """Shift one (..., ny, nz) deposit contribution by dz, and by dy too
    under dy_in_kernel."""
    dy = int(o[1]) if dy_in_kernel else 0
    dz = int(o[2])
    if dy or dz:
        return torch.roll(contrib, (dy, dz), dims=(-2, -1))
    return contrib


def _stack_epilogue(stks: torch.Tensor, combos) -> torch.Tensor:
    """Land the per-(dx,dy) output stacks (n_combo, C, nx, ny, nz): roll
    each by its (dx, dy) and sum."""
    out = None
    for ci, (dx, dy) in enumerate(combos):
        v = stks[ci]
        if dx or dy:
            v = torch.roll(v, (dx, dy), dims=(1, 2))
        out = v if out is None else out + v
    return out


def _physics_planes(D, G, norm, cell_volume, nu, rho_f, cfg: cp.CouplingConfig):
    """Channel-major force laws on slot planes: D (7|10, cap, ...) staged
    particle data, G (C_in, cap, ...) normalised interpolants, norm the
    weight norms. -> V (8, cap, ...) deposit values, force (3, cap, ...),
    torque (3, cap, ...), found (cap, ...)."""
    vel = D[3:6]
    radius = D[6]
    act = D[6] > 0.0
    found = (norm > 0.0) & act

    uf = G[0:3]
    pg = G[3:6]
    dtau = G[6:9]
    c = 9
    if cfg.use_torque:
        curl = G[c:c + 3]
        c += 3
    if cfg.use_added_mass:
        ddtu = G[c:c + 3]
        c += 3
    alpha_f = G[c]

    dia = 2.0 * radius
    vol = cp.particle_volume(radius)

    alpha_p = torch.clamp(1.0 - alpha_f, 1e-6, 1.0)
    ur = uf - vel
    mag_ur = torch.sqrt(ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2])
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    coeff = cp.drag_coefficient(alpha_f, alpha_p, mag_ur, dia, nu, rho_f)
    coeff = torch.where(found, coeff, zero)
    f_drag = (vol * coeff / alpha_p)[None] * ur

    f_arch = vol[None] * rho_f * (-pg + dtau)
    f_arch = torch.where(found[None], f_arch, zero)
    force = f_drag + f_arch

    if cfg.use_added_mass:
        f_am = cfg.added_mass_coeff * rho_f * vol[None] * ddtu
        f_am = torch.where(found[None], f_am, zero)
        force = force + f_am
        src_part = -(f_arch + f_am)
    else:
        src_part = -f_arch

    ooVrho = 1.0 / (cell_volume * rho_f)
    V = torch.cat([
        vol[None],
        vol[None] * vel,
        (-(coeff / rho_f))[None],
        src_part * ooVrho,
    ])

    if cfg.use_torque:
        angvel = D[7:10]
        torque = math.pi * (dia ** 3)[None] * (0.5 * curl - angvel) * nu * rho_f
        torque = torch.where(found[None], torque, zero)
    else:
        torque = torch.zeros_like(force)
    force = torch.where(found[None], force, zero)
    return V, force, torque, found


def _unbin_rows(per, cell_sorted, rank, keep, ncells, cfg: cp.CouplingConfig):
    """Fetch each (sorted) particle's slot-result row from the per-slot
    table `per` (n_res, cap, ncells): one flat per-channel gather at
    rank * ncells + cell. The flat index is int64, so cap * ncells may
    exceed 2^31. ``cfg.packed_unbin`` and ``cfg.unbin_gather`` select
    layouts of the same values in the JAX package and change nothing here."""
    n_res, cap = per.shape[0], per.shape[1]
    cell_c = torch.clamp(cell_sorted.to(torch.int64), max=ncells - 1)
    flat = torch.clamp(rank.to(torch.int64), max=cap - 1) * ncells + cell_c
    keep_f = keep.to(per.dtype)
    cols = [per[c].reshape(cap * ncells)[flat] * keep_f for c in range(n_res)]
    return torch.stack(cols, dim=-1)
