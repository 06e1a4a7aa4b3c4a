"""Window-staged Gaussian coupling exchange (port of
`yade_openfoam_coupling_tpu/ops/coupling_window.py`).

Particles are sorted by flat cell id, so each x-plane's population is a
contiguous window of the sorted arrays; `window_bins` gathers a fixed-size
(nx, C_w, W) window tensor, and `window_exchange_padded` stages each
plane's window into (C_d, cap, ny, nz) slot planes, interpolates the fluid
inputs, evaluates the force laws and deposits the coupling fields. Same
overflow contract as the JAX package: a particle at rank >= slot_capacity
in its cell, or beyond the window W of its plane, is counted in
n_overflow and uncoupled for the step.

`window_exchange_padded` runs the hand-written CUDA kernel
(`csrc/window_exchange.cu`) for CUDA tensors and its plain PyTorch version
`window_exchange_padded_reference` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import coupling as cp
from .coupling_planes import (
    _combo_of,
    _physics_planes,
    _roll_contrib,
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
    h_mean = float(np.cbrt(grid.cell_volume))
    sigma = cp.SIGMA_OVER_RANGE * cp.INTERP_RANGE_CELLS * h_mean
    inv2s2 = float(1.0 / (2.0 * sigma * sigma))
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
    C_in = Fp.shape[0]
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    offsets = cp.stencil_offsets(cfg)
    combos = sorted({_combo_of(o, True) for o in offsets})
    C_d = 10 if cfg.use_torque else 7
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

    # interp: all input channels per offset, normalised at the end
    acc = None
    norm = None
    for o in offsets:
        dx, dy, dz = (int(v) for v in o)
        w = fx[dx] * fy[dy] * fz[dz]
        norm = w if norm is None else norm + w
        F = Fp[:, 1 + dx: 1 + dx + nxl, 1 + dy: 1 + dy + ny, 1 + dz: 1 + dz + nz]
        t = w[None] * F[:, None]
        acc = t if acc is None else acc + t
    zero = torch.zeros((), dtype=dtype, device=dev)
    inv_norm = torch.where(norm > 0.0, 1.0 / torch.where(norm > 0.0, norm, 1.0), zero)
    G = acc * inv_norm[None]

    V, force, torque, found = _physics_planes(
        D, G, norm, grid.cell_volume, nu, rho_f, cfg)
    Vn = V * inv_norm[None]

    # deposit: per-offset slot sums, shifted by (dy,) dz, one stack per combo
    accd = {}
    for o in offsets:
        dx, dy, dz = (int(v) for v in o)
        w = fx[dx] * fy[dy] * fz[dz]
        contrib = _roll_contrib(torch.sum(w[None] * Vn, dim=1), o, True)
        key = _combo_of(o, True)
        accd[key] = contrib if key not in accd else accd[key] + contrib
    stks = torch.stack([accd[c] for c in combos])

    parts = [force] + ([torque] if cfg.use_torque else []) + [found.to(dtype)[None]]
    pres = torch.cat(parts)
    return stks, combos, pres.reshape(pres.shape[0], cap, nxl * ny * nz)


def _kernel_params(grid: Grid, periodic, cfg: cp.CouplingConfig, offsets,
                   nxl: int, W: int, C_w: int, C_in: int, x_off: int,
                   nu: float, rho_f: float):
    """Host parameter arrays of `yofc_window_exchange`, in the layout of the
    IParam/FParam enums of csrc/window_exchange.cu. Every float is rounded
    from the same double-precision expression as the plain version uses."""
    ny, nz = grid.shape[1], grid.shape[2]
    max_off = 27
    ip = np.zeros(13 + 3 * max_off, np.int32)
    ip[:13] = (nxl, ny, nz, W, C_w, C_in, cfg.slot_capacity, grid.shape[0], x_off,
               int(periodic[0]), int(periodic[1]), int(periodic[2]), len(offsets))
    ip[13:13 + 3 * len(offsets)] = np.asarray(offsets).reshape(-1)
    h_mean = float(np.cbrt(grid.cell_volume))
    sigma = cp.SIGMA_OVER_RANGE * cp.INTERP_RANGE_CELLS * h_mean
    fp = np.zeros(15, np.float32)
    fp[:9] = [d * float(h) for h in grid.spacing for d in (-1, 0, 1)]
    fp[9:] = (1.0 / (2.0 * sigma * sigma), nu, rho_f, nu * rho_f,
              1.0 / (grid.cell_volume * rho_f), (4.0 / 3.0) * math.pi)
    return ip, fp


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"window kernel: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


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
    csrc/window_exchange.cu or raise. ``window_exchange_padded.launches``
    counts kernel launches."""
    if Fp.device.type == "cpu":
        return window_exchange_padded_reference(
            Fp, dat_win, grid, periodic, cfg, x_off, nu, rho_f, counts=counts)
    if Fp.device.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {Fp.device}")
    if cfg.use_torque or cfg.use_added_mass:
        raise NotImplementedError(
            "window kernel with use_torque/use_added_mass: not ported yet "
            "(ROADMAP B1 follow-up)")
    if cfg.stencil_width != 3:
        raise NotImplementedError("window kernel: stencil_width must be 3")
    from ..kernels import library

    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    C_d = 7
    C_in = 10
    C_w = 2 * C_d + 3
    W = dat_win.shape[-1]
    dev = Fp.device
    _check_cuda("Fp", Fp, torch.float32, (C_in, nxl + 2, ny + 2, nz + 2), dev)
    if (ny, nz) != tuple(grid.shape[1:]):
        raise ValueError(f"window kernel: Fp planes {(ny, nz)} != grid {grid.shape[1:]}")
    _check_cuda("dat_win", dat_win, torch.float32, (nxl, C_w, W), dev)
    if counts is not None:
        _check_cuda("counts", counts, torch.int32, (nxl,), dev)

    offsets = cp.stencil_offsets(cfg)
    combos = sorted({_combo_of(o, True) for o in offsets})
    ip, fp = _kernel_params(grid, periodic, cfg, offsets, nxl, W, C_w, C_in,
                            int(x_off), nu, rho_f)
    lib = library()
    n_int, n_float = ctypes.c_int(), ctypes.c_int()
    lib.yofc_window_param_counts(ctypes.byref(n_int), ctypes.byref(n_float))
    if (n_int.value, n_float.value) != (ip.size, fp.size):
        raise RuntimeError("window kernel: parameter layout of the library "
                           f"{(n_int.value, n_float.value)} != {(ip.size, fp.size)}")
    ncell = nxl * ny * nz
    D = torch.zeros((C_d, cap, nxl, ny, nz), dtype=torch.float32, device=dev)
    V = torch.empty((8, cap, ncell), dtype=torch.float32, device=dev)
    stks = torch.empty((len(combos), 8, nxl, ny, nz), dtype=torch.float32, device=dev)
    pres = torch.empty((4, cap, ncell), dtype=torch.float32, device=dev)
    err = lib.yofc_window_exchange(
        ip.ctypes.data, fp.ctypes.data, Fp.data_ptr(), dat_win.data_ptr(),
        None if counts is None else counts.data_ptr(),
        D.data_ptr(), V.data_ptr(), stks.data_ptr(), pres.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {err}")
    window_exchange_padded.launches += 1
    return stks, combos, pres


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
                with_angvel: bool = False) -> WindowBins:
    """Build the per-plane window staging tensor on the full grid. Each row
    carries the hi/lo split of the anchor-relative position, the velocity
    and radius [and angular velocity], then y, z and rank; rows past a
    plane's population or not kept carry y = -1."""
    pos = pf.pos
    dev, dtype = pos.device, pos.dtype
    N = pos.shape[0]
    nx, ny, nz = grid.shape
    ncells = nx * ny * nz
    C_d = 10 if with_angvel else 7

    base, inside = cp.locate(pos, grid)
    valid = pf.active & inside
    cell = base[:, 0] * (ny * nz) + base[:, 1] * nz + base[:, 2]
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
    centre = torch.tensor(grid.origin, dtype=dtype, device=dev) + (
        gath[:, -3:] + 0.5) * torch.tensor(grid.spacing, dtype=dtype, device=dev)
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
    """The window exchange: bin, run the window kernel, land the stacks,
    unbin the per-slot results back to particle order."""
    if not cfg.lag_alpha:
        raise ValueError("exchange='window' requires lag_alpha=True")
    N = pf.pos.shape[0]
    nx = grid.shape[0]
    cap = cfg.slot_capacity
    ncells = grid.ncells
    Vc = grid.cell_volume
    W = window_size(N, nx, cfg.planes_window)
    bins = window_bins(pf, grid, cap, W, with_angvel=cfg.use_torque)

    in_fields = [fluid_u, grad_p, div_tau]
    if cfg.use_torque:
        in_fields.append(curl_u)
    if cfg.use_added_mass:
        in_fields.append(ddt_u)
    in_fields.append(prev_alpha)
    F = cp._stack_channels(in_fields)

    # every window is read up to its plane's count, for every
    # cfg.window_dynamic (rows past the count carry y = -1 either way)
    stks, combos, pres = window_exchange_padded(
        pad_wrap_zero(F, periodic), bins.dat_win, grid, periodic, cfg, 0,
        nu, rho_f, counts=bins.counts)
    fields = _stack_epilogue(stks, combos).reshape(8, ncells)

    pvol, up = fields[0], fields[1:4]
    alpha = torch.clamp(1.0 - pvol / Vc, min=cfg.alpha_min)
    u_particle = up / Vc
    u_source_drag = fields[4]
    u_source = u_source_drag[None] * u_particle + fields[5:8]

    res = _unbin_rows(pres, bins.cell_sorted, bins.rank, bins.keep, ncells,
                      cfg)[bins.inv_order]
    if pres.shape[0] == 4:
        res_force, res_torque, res_found = (
            res[:, 0:3], torch.zeros_like(res[:, 0:3]), res[:, 3])
    else:
        res_force, res_torque, res_found = res[:, 0:3], res[:, 3:6], res[:, 6]

    return cp.CouplingResult(
        force=res_force,
        torque=res_torque,
        alpha=alpha.reshape(grid.shape),
        u_particle=u_particle.reshape((3,) + grid.shape),
        u_source=u_source.reshape((3,) + grid.shape),
        u_source_drag=u_source_drag.reshape(grid.shape),
        found=res_found > 0.5,
        n_overflow=bins.n_overflow,
    )
