"""Window-staged Gaussian coupling exchange (port of
`yade_openfoam_coupling_tpu/ops/coupling_window.py`).

Particles are sorted by flat cell id, so each x-plane's population is a
contiguous window of the sorted arrays; `window_bins` gathers a fixed-size
(nx, C_w, W) window tensor, and `window_exchange_padded` interpolates the
fluid inputs at each live window row's slot, evaluates the force laws and
deposits the coupling fields. Same
overflow contract as the JAX package: a particle at rank >= slot_capacity
in its cell, or beyond the window W of its plane, is counted in
n_overflow and uncoupled for the step.

`window_exchange_padded` runs the hand-written CUDA kernel
(`csrc/window_exchange.cu`) for CUDA tensors and its plain PyTorch version
`window_exchange_padded_reference` for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate, host_tensor
from . import coupling as cp
from .coupling_planes import (
    DX_COMBOS,
    _channel_counts,
    _check_cuda,
    _coupling_result,
    _input_stack,
    _inv2s2,
    _kernel_params,
    _launch,
    _on_cpu,
    _padded_shape,
    _scratch_words,
    _slot_exchange,
    _stack_epilogue,
    _unbin_rows,
    pad_wrap_zero,
)
from .dem import rank_in_sorted_segments
from .grid import Grid


def window_size(n_particles: int, nx: int, requested: int = 0) -> int:
    """Static per-plane window capacity. Auto (=0): 2.5x the uniform mean,
    rounded up to 512 rows."""
    if requested > 0:
        if requested > 2048:
            return int(np.ceil(requested / 512.0)) * 512
        return int(requested)
    mean = max(1.0, n_particles / max(1, nx))
    return max(512, int(np.ceil(2.5 * mean / 512.0)) * 512)


def _hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split f32 into a bf16-exact head (round to nearest even) and the f32
    remainder: x == hi + lo exactly."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, x - hi


def _factors(D, act, grid: Grid, periodic, offsets, x_off, dtype):
    """Separable Gaussian factors exp(-(rel - d*h)^2 / 2 sigma^2) of the
    staged anchor-relative positions, per axis and delta, with the wall
    masks of non-periodic axes and the activity gate. Shapes (cap, nx, ny, nz)."""
    cap, nxl, ny, nz = D.shape[1:]
    dev = D.device
    inv2s2 = _inv2s2(grid)
    hx, hy, hz = (float(s) for s in grid.spacing)
    nx = grid.shape[0]
    ix = torch.arange(nxl, device=dev)[None, :, None, None] + x_off
    iy = torch.arange(ny, device=dev)[None, None, :, None]
    iz = torch.arange(nz, device=dev)[None, None, None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)

    deltas = sorted({int(v) for o in offsets for v in o})
    fx, fy, fz = {}, {}, {}
    for d in deltas:
        e = torch.exp(-((D[0] - d * hx) ** 2) * inv2s2)
        if not periodic[0] and d != 0:
            e = e * ((ix + d >= 0) & (ix + d < nx)).to(dtype)
        fx[d] = torch.where(act, e, zero)
    for d in deltas:
        e = torch.exp(-((D[1] - d * hy) ** 2) * inv2s2)
        if not periodic[1] and d != 0:
            e = torch.where((iy + d >= 0) & (iy + d < ny), e, zero)
        fy[d] = e
    for d in deltas:
        e = torch.exp(-((D[2] - d * hz) ** 2) * inv2s2)
        if not periodic[2] and d != 0:
            e = torch.where((iz + d >= 0) & (iz + d < nz), e, zero)
        fz[d] = e
    return fx, fy, fz


def window_exchange_padded_reference(
    Fp: torch.Tensor,          # (C_in, nxl+2, ny+2, nz+2) ghost-padded stack
    dat_win: torch.Tensor,     # (nxl, C_w, W) plane-major window channels
    grid: Grid,
    periodic: Tuple[bool, bool, bool],
    cfg: cp.CouplingConfig,
    x_off,
    nu: float,
    rho_f: float,
    *,
    counts: Optional[torch.Tensor] = None,   # (nxl,) per-plane populations
):
    """Plain PyTorch version of the window kernel: stage the windows into a
    slot table with one indexed store, interpolate by slicing Fp, deposit
    with rolls. -> (stks (3, 8, nxl, ny, nz), combos, pres (4|7, cap,
    nxl*ny*nz)): one stack per dx with the dy and dz shifts applied, for
    every ``cfg.dy_in_kernel`` (which only chooses stack layouts in the JAX
    package)."""
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    offsets = cp.stencil_offsets(cfg)
    C_d = _channel_counts(cfg)[0]
    W = dat_win.shape[2]
    dev, dtype = Fp.device, Fp.dtype

    # staging: every kept row owns one (rank, plane, y, z) slot
    rows = dat_win.permute(1, 0, 2)                       # (C_w, nxl, W)
    y, z, rank = rows[2 * C_d], rows[2 * C_d + 1], rows[2 * C_d + 2]
    live = (y >= 0) & (rank < cap)
    if counts is not None:
        n_live = torch.clamp(counts.to(torch.int64), 0, W)
        live = live & (torch.arange(W, device=dev)[None, :] < n_live[:, None])
    plane = torch.arange(nxl, device=dev)[:, None].expand(nxl, W)
    D = torch.zeros((C_d, cap, nxl, ny, nz), dtype=dtype, device=dev)
    D[:, rank[live].long(), plane[live], y[live].long(), z[live].long()] = (
        rows[:C_d][:, live] + rows[C_d:2 * C_d][:, live])

    act = D[6] > 0.0
    fx, fy, fz = _factors(D, act, grid, periodic, offsets, x_off, dtype)
    return _slot_exchange(Fp, D, fx, fy, fz, offsets, grid.cell_volume, nu, rho_f, cfg)


def window_exchange_padded(
    Fp: torch.Tensor,
    dat_win: torch.Tensor,
    grid: Grid,
    periodic: Tuple[bool, bool, bool],
    cfg: cp.CouplingConfig,
    x_off,
    nu: float,
    rho_f: float,
    *,
    counts: Optional[torch.Tensor] = None,
):
    """-> (stks, combos, pres), the contract of the JAX launcher. CPU
    tensors run the plain version; CUDA tensors launch the kernel of
    csrc/window_exchange.cu or raise. The kernel stages no slot table: it
    keeps one 96-byte record per window row in its scratch.
    ``window_exchange_padded.launches`` counts kernel launches."""
    kernel = "window kernel"
    if _on_cpu(kernel, Fp, cfg):
        return window_exchange_padded_reference(
            Fp, dat_win, grid, periodic, cfg, x_off, nu, rho_f, counts=counts)
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    C_d, C_in, n_pres = _channel_counts(cfg)
    C_w = 2 * C_d + 3
    W = dat_win.shape[-1]
    dev = Fp.device
    _check_cuda(kernel, "Fp", Fp, _padded_shape(C_in, nxl, grid), dev)
    _check_cuda(kernel, "dat_win", dat_win, (nxl, C_w, W), dev)
    if counts is not None:
        _check_cuda(kernel, "counts", counts, (nxl,), dev, dtype=torch.int32)

    ip, fp = _kernel_params(grid, periodic, cfg, nxl, C_d, C_in, int(x_off),
                            absolute=False, nu=nu, rho_f=rho_f, W=W, C_w=C_w, n_rec=nxl * W)
    ncell = nxl * ny * nz
    scratch = torch.empty(_scratch_words(ncell, nxl * W), dtype=torch.int32, device=dev)
    stks = torch.empty((3, 8, nxl, ny, nz), dtype=torch.float32, device=dev)
    pres = torch.empty((n_pres, cap, ncell), dtype=torch.float32, device=dev)
    _launch("window_exchange", "yofc_window_exchange", kernel, ip, fp, Fp, dat_win,
            counts, scratch, stks, pres, device=dev)
    window_exchange_padded.launches += 1
    return stks, list(DX_COMBOS), pres


window_exchange_padded.launches = 0


class WindowBins(NamedTuple):
    """Sorted per-plane window staging data."""
    dat_win: torch.Tensor        # (nx, C_w, W) plane-major window channels
    order: torch.Tensor
    inv_order: torch.Tensor
    cell_sorted: torch.Tensor    # flat cell ids (ncells = invalid)
    rank: torch.Tensor
    keep: torch.Tensor           # slot-kept AND inside the window
    n_overflow: torch.Tensor     # slot overflow + window overflow
    counts: torch.Tensor         # (nx,) per-plane populations (pre-clip)


def window_bins(pf: cp.ParticleFields, grid: Grid, cap: int, W: int,
                with_angvel: bool = False, x_start=None, n_loc: Optional[int] = None,
                wrap_x: bool = False) -> WindowBins:
    """Build the per-plane window staging tensor: on the full grid, or,
    given ``x_start`` (the window's first global plane) and ``n_loc``, on
    that x-window of n_loc planes (``wrap_x`` reads the window modulo the
    global nx: the extended slab of the chunked sharded scan); particles
    outside the window are invalid. Each row carries the hi/lo split of
    the anchor-relative position (frame-free: a wrapped particle needs no
    shift), the velocity and radius [and angular velocity], then y, z and
    rank; rows past a plane's population or not kept carry y = -1."""
    pos = pf.pos
    dev, dtype = pos.device, pos.dtype
    N = pos.shape[0]
    nx, ny, nz = grid.shape
    nx_global = nx
    if n_loc is not None:
        nx = n_loc
    ncells = nx * ny * nz
    C_d = 10 if with_angvel else 7

    base, inside = cp.locate(pos, grid)
    valid = pf.active & inside
    bx = base[:, 0]
    if x_start is not None:
        bx = bx - x_start
        if wrap_x:
            bx = torch.remainder(bx, nx_global)
        valid = valid & (bx >= 0) & (bx < nx)
    cell = bx * (ny * nz) + base[:, 1] * nz + base[:, 2]
    cell = torch.where(valid, cell, ncells)
    order = torch.argsort(cell, stable=True)
    inv_order = torch.argsort(order, stable=True)
    cell_s = cell[order]
    rank_s = rank_in_sorted_segments(cell_s)
    keep = (rank_s < cap) & (cell_s < ncells)

    # per-plane windows: starts by a left-side binary search
    bounds = torch.arange(nx + 1, device=dev, dtype=torch.int64) * (ny * nz)
    starts = torch.searchsorted(cell_s.to(torch.int64), bounds, side="left")
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    window_over = torch.sum(torch.clamp(counts - W, min=0))
    slot_over = torch.sum(((rank_s >= cap) & (cell_s < ncells)).to(torch.int32))

    # one row gather for all per-particle channels
    src_cols = [pos, pf.vel, pf.radius[:, None]]
    if with_angvel:
        src_cols.append(pf.angvel)
    src_cols.append(base.to(dtype))
    gath = torch.cat(src_cols, dim=-1)[order]
    base_s = gath[:, -3:].to(torch.int32)
    centre = host_tensor(grid.origin, dtype=dtype, device=dev) + (
        gath[:, -3:] + 0.5) * host_tensor(grid.spacing, dtype=dtype, device=dev)
    rel_s = gath[:, 0:3] - centre
    dat = torch.cat([rel_s, gath[:, 3:-3]], dim=-1)
    hi, lo = _hi_lo(dat)
    yv = torch.where(keep, base_s[:, 1], -1).to(dtype)
    zv = base_s[:, 2].to(dtype)
    rv = rank_s.to(dtype)
    dat_all = torch.cat([hi, lo, yv[:, None], zv[:, None], rv[:, None]], dim=-1).T

    ar = torch.arange(W, device=dev, dtype=torch.int64)
    idx = torch.clamp(starts[:-1, None] + ar[None, :], max=N - 1)
    in_w = ar[None, :] < torch.clamp(counts, max=W)[:, None]
    dat_win = dat_all[:, idx]                           # (C_w, nx, W)
    ych = 2 * C_d
    dat_win[ych] = torch.where(in_w, dat_win[ych], -1.0)
    dat_win = dat_win.permute(1, 0, 2).contiguous()     # (nx, C_w, W)

    # window-dropped rows read found=False downstream
    w_pos = torch.arange(N, device=dev, dtype=torch.int64) - starts[
        torch.clamp(cell_s.to(torch.int64) // (ny * nz), max=nx - 1)]
    keep_u = keep & (w_pos < W)
    return WindowBins(dat_win, order, inv_order, cell_s, rank_s, keep_u,
                      (slot_over + window_over).to(torch.int32), counts)


def gaussian_coupling_window(
    pf: cp.ParticleFields,
    fluid_u: torch.Tensor,
    grad_p: torch.Tensor,
    div_tau: torch.Tensor,
    ddt_u: torch.Tensor,
    curl_u: torch.Tensor,
    grid: Grid,
    periodic: Tuple[bool, bool, bool],
    nu: float,
    rho_f: float,
    dt,
    cfg: cp.CouplingConfig,
    prev_alpha=None,
) -> cp.CouplingResult:
    """The window exchange: bin (``yofc:exchange.bin``), run the window
    kernel, land the stacks, unbin the per-slot results back to particle
    order (``yofc:exchange.kernel``)."""
    if not cfg.lag_alpha:
        raise ValueError("exchange='window' requires lag_alpha=True")
    N = pf.pos.shape[0]
    nx = grid.shape[0]
    cap = cfg.slot_capacity
    ncells = grid.ncells
    W = window_size(N, nx, cfg.planes_window)
    with annotate("yofc:exchange.bin"):
        bins = window_bins(pf, grid, cap, W, with_angvel=cfg.use_torque)

    F = _input_stack(fluid_u, grad_p, div_tau, ddt_u, curl_u, prev_alpha, cfg)

    with annotate("yofc:exchange.kernel"):
        # every window is read up to its plane's count, for every
        # cfg.window_dynamic (rows past the count carry y = -1 either way)
        stks, combos, pres = window_exchange_padded(
            pad_wrap_zero(F, periodic), bins.dat_win, grid, periodic, cfg, 0,
            nu, rho_f, counts=bins.counts)
        fields = _stack_epilogue(stks, combos).reshape(8, ncells)
        res = _unbin_rows(pres, bins.cell_sorted, bins.rank, bins.keep, ncells,
                          cfg)[bins.inv_order]
        return _coupling_result(fields, res, bins.n_overflow, grid, cfg)
