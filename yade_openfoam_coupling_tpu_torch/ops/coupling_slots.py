"""The slot-table Gaussian exchange (port of
`yade_openfoam_coupling_tpu/ops/coupling_slots.py`).

Particles are binned into a fixed-capacity table of ``slot_capacity``
slots per fluid cell (one N-row indexed store); the normalised Gaussian
weights W (ncells, cap, S) are built densely from the slot positions and
the stencil cell centres; fluid inputs reach the slots as a batched
product with the S stencil-rolled field stacks; the unchanged force
physics (`coupling.gaussian_physics`) runs on the slot layout; deposits
are per-cell products D = W^T V followed by the roll sum
out[c] = sum_o roll(D[o, c], offsets[o]); per-particle results come back
with one N-row gather. Overflowed particles (past `slot_capacity` in
their cell) are counted, reported found=False and get no hydro force.

The roll sum is kernel B3's function exactly, so it runs through
`rolls.distribute_rolls` (B3 for CUDA tensors, the plain roll loop for
CPU tensors, which it matches bit for bit) on grids whose sides are all
at least 8, the sparse exchange's rule; smaller grids take the roll loop.
The per-slot products stay PyTorch ops in float32: the JAX package leaves
them to XLA too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import coupling as cp
from . import rolls
from .dem import rank_in_sorted_segments
from .grid import Grid


class SlotTable(NamedTuple):
    data: torch.Tensor        # (ncells*cap + 1, 11): pos3 vel3 angvel3 radius act
    slot_of: torch.Tensor     # (N,) int32 slot id; ncells*cap = overflow/invalid
    n_overflow: torch.Tensor  # int32 scalar
    cap: int


def bin_particles(pf: cp.ParticleFields, grid: Grid, cap: int) -> SlotTable:
    """One N-row store of the particle data into (ncells, cap) slots, in
    order of cell and, within a cell, of particle index (a stable sort).
    Particles past `cap` in their cell, and inactive or outside ones, go
    to the scrap row ncells*cap, which is zeroed."""
    N = pf.pos.shape[0]
    ncells = grid.ncells
    nslots = ncells * cap
    dev = pf.pos.device

    base, inside = cp.locate(pf.pos, grid)
    valid = pf.active & inside
    nx, ny, nz = grid.shape
    cell = base[:, 0] * (ny * nz) + base[:, 1] * nz + base[:, 2]
    cell = torch.where(valid, cell, ncells)

    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    rank = rank_in_sorted_segments(cell_sorted)
    keep = (rank < cap) & (cell_sorted < ncells)
    slot_sorted = torch.where(
        keep, torch.clamp(cell_sorted, 0, ncells - 1) * cap + torch.clamp(rank, max=cap - 1),
        nslots).to(torch.int32)
    slot_of = torch.zeros(N, dtype=torch.int32, device=dev)
    slot_of[order] = slot_sorted

    dat = torch.cat([pf.pos, pf.vel, pf.angvel, pf.radius[:, None],
                     valid.to(pf.pos.dtype)[:, None]], dim=-1)
    table = torch.zeros((nslots + 1, 11), dtype=pf.pos.dtype, device=dev)
    table[slot_of.long()] = dat
    table[nslots] = 0.0     # the scrap row may hold an overflowed particle
    n_overflow = torch.sum((~keep & (cell_sorted < ncells)).to(torch.int32))
    return SlotTable(table, slot_of, n_overflow, cap)


def _domain_mask(grid: Grid, off, periodic, dtype, device) -> Optional[torch.Tensor]:
    """(nx,ny,nz) 0/1 mask of the cells whose stencil cell c + off lies in
    the domain on every non-periodic axis; None when all do."""
    m = None
    for a in range(3):
        if periodic[a] or off[a] == 0:
            continue
        n = grid.shape[a]
        idx = torch.arange(n, device=device)
        ok = ((idx + int(off[a]) >= 0) & (idx + int(off[a]) < n)).reshape(
            [n if i == a else 1 for i in range(3)])
        m = ok if m is None else m & ok
    if m is None:
        return None
    return torch.broadcast_to(m, grid.shape).to(dtype)


def build_slot_weights(tbl: SlotTable, grid: Grid, periodic,
                       cfg: cp.CouplingConfig) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """W (ncells, cap, S) normalised Gaussian weights per slot, the found
    mask (ncells*cap,) and the stencil offsets (S, 3): the sparse path's
    `gaussian_cells_raw_weights` + `normalize_weights` on the slot layout."""
    offsets = cp.stencil_offsets(cfg)
    S = len(offsets)
    ncells = grid.ncells
    cap = tbl.cap
    dtype = tbl.data.dtype
    dev = tbl.data.device

    pos_t = tbl.data[:-1, 0:3].reshape(grid.shape + (cap, 3))
    act_t = tbl.data[:-1, 10].reshape(grid.shape + (cap,)) > 0.5

    h_mean = float(np.cbrt(grid.cell_volume))
    sigma = cp.SIGMA_OVER_RANGE * cp.INTERP_RANGE_CELLS * h_mean
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    # cell-centre coordinates along each axis, as broadcast iotas
    ax = [(grid.origin[a] + (torch.arange(grid.shape[a], dtype=dtype, device=dev) + 0.5)
           * grid.spacing[a]).reshape([-1 if i == a else 1 for i in range(3)])
          for a in range(3)]

    W = torch.empty(grid.shape + (cap, S), dtype=dtype, device=dev)
    for s, o in enumerate(offsets):
        d2 = 0.0
        for a in range(3):
            ca = ax[a] + float(o[a]) * grid.spacing[a]          # centre of c + o
            d2 = d2 + (pos_t[..., a] - ca[..., None]) ** 2
        w = torch.exp(-d2 * inv2s2)
        m = _domain_mask(grid, o, periodic, dtype, dev)
        if m is not None:
            w = w * m[..., None]
        W[..., s] = torch.where(act_t, w, 0.0)
    W = W.reshape(ncells, cap, S)
    wsum = torch.sum(W, dim=-1, keepdim=True)
    W = W / torch.where(wsum > 0.0, wsum, 1.0)
    found = (wsum[..., 0] > 0.0).reshape(ncells * cap)
    return W, found, offsets


def _roll_sum(D: torch.Tensor, offsets: np.ndarray, shape) -> torch.Tensor:
    """(S, C, ncells) contiguous per-offset anchor deposits -> (C, grid):
    out[c] = sum_o roll(D[o, c], offsets[o]), kernel B3 on grids whose
    sides are all at least 8."""
    S, C, _ = D.shape
    bufT = D.view((S, C) + tuple(shape))
    if min(shape) >= 8:
        return rolls.distribute_rolls(bufT, offsets)
    return rolls.distribute_rolls_reference(bufT, offsets)


def slot_support_ops(W: torch.Tensor, offsets: np.ndarray, grid: Grid) -> cp.SupportOps:
    """SupportOps over the slot layout: per-cell products with W for the
    gathers and deposits, and the roll sum for the deposits."""
    ncells = grid.ncells
    cap, S = W.shape[1], W.shape[2]
    shape = grid.shape
    # (cap, S, ncells): slot k's weights in the deposit's (S, C, ncells) order
    Wt = W.permute(1, 2, 0).contiguous()

    def gather_stack(fields) -> torch.Tensor:
        F = cp._stack_channels(fields)                         # (C, grid)
        C = F.shape[0]
        # F at cell + o for each offset: (S, C, ncells)
        FoS = torch.stack([torch.roll(F, (-int(o[0]), -int(o[1]), -int(o[2])),
                                      dims=(1, 2, 3)).reshape(C, ncells) for o in offsets])
        G = torch.einsum("nks,scn->nkc", W, FoS)
        return G.reshape(ncells * cap, C)

    def deposit_outer(vals: torch.Tensor) -> torch.Tensor:
        # D[s, c, n] = sum_k W[n, k, s] V[n, k, c], written straight into
        # the (S, C, ncells) layout the roll sum reads
        Vt = vals.reshape(ncells, cap, -1).permute(1, 2, 0)    # (cap, C, ncells)
        D = torch.empty((S, Vt.shape[1], ncells), dtype=vals.dtype, device=vals.device)
        torch.mul(Wt[0][:, None, :], Vt[0][None, :, :], out=D)
        for k in range(1, cap):
            D.addcmul_(Wt[k][:, None, :], Vt[k][None, :, :])
        return _roll_sum(D, offsets, shape)

    def deposit_stack(values: torch.Tensor) -> torch.Tensor:
        # values already weighted: (ncells*cap, S, C) -> sum the slots of a cell
        C = values.shape[-1]
        D = values.reshape(ncells, cap, S, C).sum(dim=1)          # (ncells, S, C)
        return _roll_sum(D.permute(1, 2, 0).contiguous(), offsets, shape)

    return cp.SupportOps(
        deposit=lambda v: deposit_stack(v[..., None])[0],
        deposit_vec=deposit_stack,
        gather=lambda f: gather_stack([f])[:, 0],
        gather_vec=lambda f: gather_stack([f]),
        deposit_stack=deposit_stack,
        gather_stack=gather_stack,
        deposit_outer=deposit_outer,
    )


def gaussian_coupling_slots(pf: cp.ParticleFields, fluid_u, grad_p, div_tau, ddt_u, curl_u,
                            grid: Grid, periodic, nu: float, rho_f: float, dt,
                            cfg: cp.CouplingConfig, prev_alpha=None) -> cp.CouplingResult:
    """The 4-way Gaussian exchange through the slot table: the physics of
    `coupling.gaussian_coupling` on the (ncells*cap) slot layout, then one
    N-row gather of the per-particle results (the scrap row gives zeros
    and found=False)."""
    tbl = bin_particles(pf, grid, cfg.slot_capacity)
    W, found_v, offsets = build_slot_weights(tbl, grid, periodic, cfg)
    ops = slot_support_ops(W, offsets, grid)

    d = tbl.data[:-1]
    pf_v = cp.ParticleFields(pos=d[:, 0:3], vel=d[:, 3:6], angvel=d[:, 6:9],
                             radius=d[:, 9], active=d[:, 10] > 0.5)
    res_v = cp.gaussian_physics(pf_v, fluid_u, grad_p, div_tau, ddt_u, curl_u,
                                W.reshape(-1, W.shape[-1]), found_v, ops,
                                grid.cell_volume, nu, rho_f, cfg, prev_alpha=prev_alpha)
    per = torch.cat([res_v.force, res_v.torque, res_v.found.to(res_v.force.dtype)[:, None]],
                    dim=-1)
    per = torch.cat([per, per.new_zeros((1, 7))])
    out = per[tbl.slot_of.long()]
    return cp.CouplingResult(force=out[:, 0:3], torque=out[:, 3:6], alpha=res_v.alpha,
                             u_particle=res_v.u_particle, u_source=res_v.u_source,
                             u_source_drag=res_v.u_source_drag, found=out[:, 6] > 0.5,
                             n_overflow=tbl.n_overflow)
