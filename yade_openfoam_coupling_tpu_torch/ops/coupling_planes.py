"""Plane-dense Gaussian coupling exchange (port of
`yade_openfoam_coupling_tpu/ops/coupling_planes.py`).

Pipeline, as in the JAX package:
  1. bin: sort particles by flat cell id (stable), rank them within their
     cell and store each kept particle's 7 data channels (position,
     velocity, radius [+ angular velocity]) into the channel-major slot
     table D (7[+3], cap, ncells); an empty slot has radius 0.
  2. the exchange kernels over D and the ghost-padded fluid stack: the
     fused kernel (interpolation, force laws, deposit; `fused_planes`), or
     the interpolation kernel, the force laws in torch ops and the deposit
     kernel.
  3. land the per-dx deposit stacks, unbin the per-slot results back to
     particle order.
`gaussian_coupling_planes_chunked` runs the same fused kernel on
`planes_chunks` x-slabs of one global sort.

Each kernel wrapper (`fused_exchange_padded`, `interp_planes_padded`,
`deposit_stacks`) runs its plain PyTorch version (`*_reference`) for CPU
tensors and the hand-written CUDA kernel of `csrc/planes_exchange.cu` for
CUDA tensors, or raises (`kernels.on_cpu`). The port's
stacks are always one per dx with the dy and dz shifts applied, whatever
``cfg.dy_in_kernel`` says (the JAX launchers then return one per (dx, dy));
the returned combos say which, and `_stack_epilogue` lands either.

This module also holds what the window exchange (`coupling_window.py`)
shares with the planes exchange: the force laws, the plain interpolation
and deposit over slot factors, the unbin, and the kernels' argument
layout.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.profiling import annotate
from . import coupling as cp
from .dem import rank_in_sorted_segments
from .grid import Grid


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


# ---------------------------------------------------------------------------
# Binning: particles -> channel-major slot planes
# ---------------------------------------------------------------------------

class PlaneBins(NamedTuple):
    D: torch.Tensor            # (7[+3], cap, ncells): px py pz vx vy vz rad [+ angvel]
    order: torch.Tensor        # (N,) sorted-by-cell particle order
    inv_order: torch.Tensor    # (N,) inverse permutation
    cell_sorted: torch.Tensor  # (N,) flat cell per sorted particle (ncells = invalid)
    rank: torch.Tensor         # (N,) rank within cell (sorted order)
    keep: torch.Tensor         # (N,) bool: binned (valid & rank < cap)
    n_overflow: torch.Tensor   # int32


def _staging_store(dat, cell, rank, keep, C: int, cap: int, ncells: int):
    """Store the kept rows of dat (N, C) into the slot table D (C, cap,
    ncells) at (rank, cell). Non-kept rows go to one dump element past the
    table, so they never overwrite a kept slot, and D is a prefix view of
    the buffer. The JAX package's three staging layouts (`packed_bin`)
    accumulate into a zero table, which turns -0.0 into +0.0; so does the
    `+ 0.0` here, and D is the same bit for bit."""
    n_tab = cap * ncells
    slot = rank.to(torch.int64) * ncells + cell.to(torch.int64)
    chan = torch.arange(C, device=dat.device, dtype=torch.int64)[:, None] * n_tab
    idx = torch.where(keep[None], chan + slot[None], C * n_tab)
    buf = torch.zeros(C * n_tab + 1, dtype=dat.dtype, device=dat.device)
    buf[idx.reshape(-1)] = (dat.T + 0.0).reshape(-1)
    return buf[:C * n_tab].view(C, cap, ncells)


def bin_particles_planes(pf: cp.ParticleFields, grid: Grid, cap: int,
                         x_start=None, n_loc: Optional[int] = None,
                         with_angvel: bool = False, packed_bin=False,
                         wrap_x: bool = False) -> PlaneBins:
    """Bin into the full grid, or, given ``x_start`` (slab origin plane)
    and ``n_loc``, into that x-slab; particles outside it are invalid.
    ``wrap_x`` reads the slab window modulo the global nx, and a wrapped
    particle's x is shifted into the window frame. ``with_angvel`` appends
    the 3 angular-velocity channels (torque mode). ``packed_bin`` selects a
    staging layout of the same D in the JAX package; the port has one
    path, an indexed store (`_staging_store`)."""
    pos = pf.pos
    dtype = pos.dtype
    nx, ny, nz = grid.shape
    nx_global = nx
    if n_loc is not None:
        nx = n_loc
    ncells = nx * ny * nz
    C = 10 if with_angvel else 7

    base, inside = cp.locate(pos, grid)
    valid = pf.active & inside
    bx = base[:, 0]
    pos_staged = pos
    if x_start is not None:
        bx = bx - x_start
        if wrap_x:
            bx_raw = bx
            bx = torch.remainder(bx, nx_global)
            px_shift = torch.div(bx_raw - bx, nx_global, rounding_mode="floor").to(
                dtype) * grid.lengths[0]
            pos_staged = torch.cat([(pos[:, 0] - px_shift)[:, None], pos[:, 1:]], dim=1)
        valid = valid & (bx >= 0) & (bx < nx)
    cell = bx * (ny * nz) + base[:, 1] * nz + base[:, 2]
    cell = torch.where(valid, cell, ncells)

    order = torch.argsort(cell, stable=True)
    inv_order = torch.argsort(order, stable=True)
    cell_sorted = cell[order]
    rank = rank_in_sorted_segments(cell_sorted)
    keep = (rank < cap) & (cell_sorted < ncells)

    cols = [pos_staged, pf.vel, pf.radius[:, None]]
    if with_angvel:
        cols.append(pf.angvel)
    dat = torch.cat(cols, dim=-1)[order]
    D = _staging_store(dat, cell_sorted, rank, keep, C, cap, ncells)
    n_overflow = torch.sum(((rank >= cap) & (cell_sorted < ncells)).to(torch.int32))
    return PlaneBins(D, order, inv_order, cell_sorted, rank, keep, n_overflow)


# ---------------------------------------------------------------------------
# Plain versions of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _inv2s2(grid: Grid) -> float:
    """1 / (2 sigma^2) of the Gaussian kernel, sigma from the mean cell size."""
    h_mean = float(np.cbrt(grid.cell_volume))
    sigma = cp.SIGMA_OVER_RANGE * cp.INTERP_RANGE_CELLS * h_mean
    return float(1.0 / (2.0 * sigma * sigma))


def _plane_factors(D5, grid: Grid, periodic, offsets, x_off: int):
    """Separable Gaussian factors of the absolute slot positions of D5
    (C_d, cap, nxl, ny, nz) per axis and delta, with the wall masks and the
    activity gate (`_axis_factors_plane` of the JAX package, in its
    operation order). x_off is the slab's first global plane."""
    cap, nxl, ny, nz = D5.shape[1:]
    dev, dtype = D5.device, D5.dtype
    inv2s2 = _inv2s2(grid)
    hx, hy, hz = (float(s) for s in grid.spacing)
    ox, oy, oz = (float(o) for o in grid.origin)
    nx = grid.shape[0]
    i = torch.arange(nxl, device=dev)[:, None, None] + x_off
    iy = torch.arange(ny, device=dev)[:, None]
    iz = torch.arange(nz, device=dev)
    xi = i.to(dtype)
    act = D5[6] > 0.0
    zero = torch.zeros((), dtype=dtype, device=dev)

    deltas = sorted({int(v) for o in offsets for v in o})
    fx, fy, fz = {}, {}, {}
    for d in deltas:
        cx = ox + (xi + (d + 0.5)) * hx
        e = torch.exp(-((D5[0] - cx) ** 2) * inv2s2)
        if not periodic[0] and d != 0:
            e = e * ((i + d >= 0) & (i + d < nx)).to(dtype)
        fx[d] = torch.where(act, e, zero)
    for d in deltas:
        cy = oy + ((iy + d).to(dtype) + 0.5) * hy
        e = torch.exp(-((D5[1] - cy) ** 2) * inv2s2)
        if not periodic[1] and d != 0:
            e = torch.where((iy + d >= 0) & (iy + d < ny), e, zero)
        fy[d] = e
    for d in deltas:
        cz = oz + ((iz + d).to(dtype) + 0.5) * hz
        e = torch.exp(-((D5[2] - cz) ** 2) * inv2s2)
        if not periodic[2] and d != 0:
            e = torch.where((iz + d >= 0) & (iz + d < nz), e, zero)
        fz[d] = e
    return fx, fy, fz


def _slot_interp(Fp, fx, fy, fz, offsets):
    """Interpolate every input channel of Fp (C_in, nxl+2, ny+2, nz+2) to
    the slots over the stencil, normalised at the end. -> G (C_in, cap,
    nxl, ny, nz), norm and inv_norm (cap, nxl, ny, nz)."""
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    acc = None
    norm = None
    for o in offsets:
        dx, dy, dz = (int(v) for v in o)
        w = fx[dx] * fy[dy] * fz[dz]
        norm = w if norm is None else norm + w
        F = Fp[:, 1 + dx: 1 + dx + nxl, 1 + dy: 1 + dy + ny, 1 + dz: 1 + dz + nz]
        t = w[None] * F[:, None]
        acc = t if acc is None else acc + t
    zero = torch.zeros((), dtype=Fp.dtype, device=Fp.device)
    inv_norm = torch.where(norm > 0.0, 1.0 / torch.where(norm > 0.0, norm, 1.0), zero)
    return acc * inv_norm[None], norm, inv_norm


def _slot_deposit(Vn, fx, fy, fz, offsets):
    """Deposit the pre-normalised slot values Vn (C, cap, nxl, ny, nz) with
    the raw weights: per-offset slot sums, shifted by dy and dz, one stack
    per dx. -> (stks (3, C, nxl, ny, nz), combos [(dx, 0)])."""
    accd = {}
    for o in offsets:
        dx, dy, dz = (int(v) for v in o)
        w = fx[dx] * fy[dy] * fz[dz]
        contrib = _roll_contrib(torch.sum(w[None] * Vn, dim=1), o, True)
        key = _combo_of(o, True)
        accd[key] = contrib if key not in accd else accd[key] + contrib
    combos = sorted(accd)
    return torch.stack([accd[c] for c in combos]), combos


def _slot_exchange(Fp, D5, fx, fy, fz, offsets, cell_volume, nu, rho_f,
                   cfg: cp.CouplingConfig):
    """Interpolation, force laws and deposit over slot factors: the body
    the fused and the window kernels share. -> (stks, combos, pres (4|7,
    cap, nxl*ny*nz))."""
    cap = D5.shape[1]
    G, norm, inv_norm = _slot_interp(Fp, fx, fy, fz, offsets)
    V, force, torque, found = _physics_planes(D5, G, norm, cell_volume, nu, rho_f, cfg)
    stks, combos = _slot_deposit(V * inv_norm[None], fx, fy, fz, offsets)
    parts = [force] + ([torque] if cfg.use_torque else []) + [found.to(Fp.dtype)[None]]
    pres = torch.cat(parts)
    return stks, combos, pres.reshape(pres.shape[0], cap, -1)


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


# ---------------------------------------------------------------------------
# Kernel arguments (layout of csrc/exchange_common.cuh)
# ---------------------------------------------------------------------------

# the kernels' stacks: one per dx, with the dy and dz shifts applied
DX_COMBOS = ((-1, 0), (0, 0), (1, 0))

_IPARAMS = ("nx", "ny", "nz", "cap", "nx_global", "x_off", "C_d", "C_in", "n_pres",
            "torque", "added_mass", "absolute", "per_x", "per_y", "per_z", "W", "C_w",
            "n_rec", "n_off")
_MAX_OFF = 27
_N_FPARAMS = 23
_REC_FLOATS = 24     # floats of one slot record of the fused exchanges (kRec)


def _channel_counts(cfg: cp.CouplingConfig):
    """(C_d, C_in, n_pres): staged particle channels, input channels and
    per-slot result channels under cfg's torque and added-mass switches."""
    return (10 if cfg.use_torque else 7, 10 + 3 * cfg.use_torque + 3 * cfg.use_added_mass,
            7 if cfg.use_torque else 4)


def _padded_shape(C: int, nxl: int, grid: Grid):
    """Shape of a ghost-padded stack of C channels over nxl x-planes."""
    return (C, nxl + 2, grid.shape[1] + 2, grid.shape[2] + 2)


def _kernel_params(grid: Grid, periodic, cfg: cp.CouplingConfig, nxl: int, C_d: int,
                   C_in: int, x_off: int, *, absolute: bool, nu: float = 1.0,
                   rho_f: float = 1.0, W: int = 0, C_w: int = 0, n_rec: int = 0):
    """Host parameter arrays (int32, float32) of the exchange kernels, in
    the layout of the IParam/FParam enums of csrc/exchange_common.cuh.
    Every float is rounded from the same double-precision expression as
    the plain version uses. nu and rho_f matter only to the kernels that
    run the force laws, n_rec (records of scratch) only to the fused
    exchanges. The arrays are built once per distinct argument set and
    are read-only."""
    return _kernel_params_cached(grid, tuple(bool(p) for p in periodic), cfg, int(nxl),
                                 int(C_d), int(C_in), int(x_off), bool(absolute), float(nu),
                                 float(rho_f), int(W), int(C_w), int(n_rec))


@functools.lru_cache(maxsize=256)
def _kernel_params_cached(grid, periodic, cfg, nxl, C_d, C_in, x_off, absolute, nu, rho_f,
                          W, C_w, n_rec):
    offsets = cp.stencil_offsets(cfg)
    vals = dict(nx=nxl, ny=grid.shape[1], nz=grid.shape[2], cap=cfg.slot_capacity,
                nx_global=grid.shape[0], x_off=x_off, C_d=C_d, C_in=C_in,
                n_pres=_channel_counts(cfg)[2], torque=int(cfg.use_torque),
                added_mass=int(cfg.use_added_mass), absolute=int(absolute),
                per_x=int(periodic[0]), per_y=int(periodic[1]), per_z=int(periodic[2]),
                W=W, C_w=C_w, n_rec=n_rec, n_off=len(offsets))
    ip = np.zeros(len(_IPARAMS) + 3 * _MAX_OFF, np.int32)
    ip[:len(_IPARAMS)] = [vals[k] for k in _IPARAMS]
    ip[len(_IPARAMS):len(_IPARAMS) + 3 * len(offsets)] = np.asarray(offsets).reshape(-1)
    fp = np.zeros(_N_FPARAMS, np.float32)
    fp[:9] = [d * float(h) for h in grid.spacing for d in (-1, 0, 1)]
    fp[9:12] = [float(o) for o in grid.origin]
    fp[12:15] = [float(h) for h in grid.spacing]
    fp[15:] = (_inv2s2(grid), nu, rho_f, nu * rho_f, 1.0 / (grid.cell_volume * rho_f),
               (4.0 / 3.0) * math.pi, cfg.added_mass_coeff * rho_f, math.pi)
    ip.flags.writeable = False
    fp.flags.writeable = False
    return ip, fp


def _scratch_layout(ncl: int, n_rec: int) -> Tuple[int, int, int, int, int]:
    """Word offsets of the fused exchanges' scratch segments (`carve` in
    csrc/exchange_common.cuh): per-cell record counts, per-cell record
    bases, the list of slots, n_rec records; then the total words. Each
    segment is rounded up to 4 words, so the records start on 16 bytes.
    No segment depends on the slot capacity."""
    def r4(n):
        return -(-n // 4) * 4
    cnt = 0
    base = cnt + r4(ncl)
    lst = base + r4(ncl)
    rec = lst + r4(1 + n_rec)
    return cnt, base, lst, rec, rec + _REC_FLOATS * n_rec


def _scratch_words(ncl: int, n_rec: int) -> int:
    """4-byte words of the fused exchanges' scratch."""
    return _scratch_layout(ncl, n_rec)[-1]


def _record_count(cap: int, ncl: int, max_occupied: Optional[int]) -> int:
    """Records the planes kernels' scratch holds: ``max_occupied`` (a bound
    on the occupied slots of the slot table, e.g. the particles binned
    into it), at most every slot; every slot when None."""
    return cap * ncl if max_occupied is None else min(int(max_occupied), cap * ncl)


def _on_cpu(kernel: str, t: torch.Tensor, cfg: cp.CouplingConfig) -> bool:
    """`kernels.on_cpu` of t's device, after raising for a stencil wider
    than the kernels' dx, dy, dz in {-1, 0, 1}."""
    if cfg.stencil_width != 3:
        raise NotImplementedError(f"{kernel}: stencil_width must be 3")
    return kernels.on_cpu(kernel, t.device)


_LAYOUT_CHECKED = set()
# (ncell, n_rec) pairs at which the libraries' scratch layout is checked
_LAYOUT_PROBES = ((5, 0), (7, 3), (210, 61), (128 ** 3, 100_000))


def library_scratch_layout(lib_name: str, ncl: int, n_rec: int):
    """The scratch layout that `carve` of library ``lib_name`` uses: word
    offsets of its segments and the total, as `_scratch_layout` gives them."""
    sizes = np.array([ncl, n_rec], np.int64)
    out = np.zeros(5, np.int64)
    kernels.library(lib_name).yofc_scratch_layout(sizes.ctypes.data, out.ctypes.data)
    return tuple(int(v) for v in out)


def _launch(lib_name: str, fn: str, kernel: str, ip, fp, *tensors, device):
    """Call one entry point of a kernel library on the current stream;
    raise if a launch fails, or, at the first call into each library, if
    its parameter, record or scratch layout differs from this module's."""
    if lib_name not in _LAYOUT_CHECKED:
        counts = [ctypes.c_int() for _ in range(3)]
        kernels.library(lib_name).yofc_param_counts(*(ctypes.byref(c) for c in counts))
        got = tuple(c.value for c in counts)
        if got != (ip.size, fp.size, _REC_FLOATS):
            raise RuntimeError(f"{kernel}: parameter layout of the library {got} != "
                               f"{(ip.size, fp.size, _REC_FLOATS)}")
        for probe in _LAYOUT_PROBES:
            if library_scratch_layout(lib_name, *probe) != _scratch_layout(*probe):
                raise RuntimeError(f"{kernel}: scratch layout of the library differs from "
                                   f"_scratch_layout at (ncell, n_rec) = {probe}")
        _LAYOUT_CHECKED.add(lib_name)
    kernels.call(lib_name, fn, kernel, ip, fp, *tensors, device=device)


# ---------------------------------------------------------------------------
# B5: slot interpolation
# ---------------------------------------------------------------------------

def interp_planes_padded_reference(Fp, D, grid: Grid, periodic,
                                   cfg: cp.CouplingConfig, x_off):
    """Plain PyTorch version of the interpolation kernel. -> G (C_in, cap,
    ncl) normalised slot interpolants, norm (cap, ncl)."""
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    offsets = cp.stencil_offsets(cfg)
    D5 = D.reshape(D.shape[0], cap, nxl, ny, nz)
    fx, fy, fz = _plane_factors(D5, grid, periodic, offsets, int(x_off))
    G, norm, _ = _slot_interp(Fp, fx, fy, fz, offsets)
    return G.reshape(G.shape[0], cap, -1), norm.reshape(cap, -1)


def interp_planes_padded(Fp: torch.Tensor, D: torch.Tensor, grid: Grid, periodic,
                         cfg: cp.CouplingConfig, x_off):
    """-> G (C_in, cap, ncl) normalised slot interpolants, norm (cap, ncl),
    for a (possibly slab-local) padded input stack Fp (C_in, nxl+2, ny+2,
    nz+2) and slot table D (7|10, cap, ncl). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    kernel = "planes interp kernel"
    if _on_cpu(kernel, Fp, cfg):
        return interp_planes_padded_reference(Fp, D, grid, periodic, cfg, x_off)
    C_in = Fp.shape[0]
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap, ncl, dev = cfg.slot_capacity, nxl * ny * nz, Fp.device
    if C_in not in (10, 13, 16) or D.shape[0] not in (7, 10):
        raise ValueError(f"{kernel}: C_in {C_in} / C_d {D.shape[0]} not taken")
    f32 = torch.float32
    kernels.require(kernel, dev, ("Fp", Fp, _padded_shape(C_in, nxl, grid), f32, False),
                    ("D", D, (D.shape[0], cap, ncl), f32, False))
    ip, fp = _kernel_params(grid, periodic, cfg, nxl, D.shape[0], C_in, int(x_off),
                            absolute=True)
    G = torch.empty((C_in, cap, ncl), dtype=torch.float32, device=dev)
    norm = torch.empty((cap, ncl), dtype=torch.float32, device=dev)
    _launch("planes_exchange", "yofc_planes_interp", kernel, ip, fp, Fp, D, G, norm,
            device=dev)
    return G, norm


def interp_planes(F, D, grid: Grid, periodic, cfg: cp.CouplingConfig):
    """-> G (C_in, cap, ncells) normalised slot interpolants, norm (cap, ncells)."""
    return interp_planes_padded(pad_wrap_zero(F, periodic), D, grid, periodic, cfg, 0)


# ---------------------------------------------------------------------------
# B6: slot deposit
# ---------------------------------------------------------------------------

def deposit_stacks_reference(V, D, nxl: int, grid: Grid, periodic,
                             cfg: cp.CouplingConfig, x_off):
    """Plain PyTorch version of the deposit kernel: V (8, cap, ncl) is
    pre-normalised, the weights are the raw Gaussian products. -> (stks
    (3, 8, nxl, ny, nz), combos)."""
    ny, nz = grid.shape[1], grid.shape[2]
    cap = cfg.slot_capacity
    offsets = cp.stencil_offsets(cfg)
    D5 = D.reshape(D.shape[0], cap, nxl, ny, nz)
    fx, fy, fz = _plane_factors(D5, grid, periodic, offsets, int(x_off))
    return _slot_deposit(V.reshape(V.shape[0], cap, nxl, ny, nz), fx, fy, fz, offsets)


def deposit_stacks(V: torch.Tensor, D: torch.Tensor, nxl: int, grid: Grid, periodic,
                   cfg: cp.CouplingConfig, x_off, *, max_occupied: Optional[int] = None):
    """-> (stks (3, 8, nxl, ny, nz), combos): one deposit stack per dx with
    the dy and dz shifts applied. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise. ``max_occupied`` bounds the
    occupied slots of D and sizes the kernel's compact per-slot records,
    as in `fused_exchange_padded`; the plain version ignores it."""
    kernel = "planes deposit kernel"
    if _on_cpu(kernel, V, cfg):
        return deposit_stacks_reference(V, D, nxl, grid, periodic, cfg, x_off)
    ny, nz = grid.shape[1], grid.shape[2]
    cap, ncl, dev = cfg.slot_capacity, nxl * ny * nz, V.device
    if D.shape[0] not in (7, 10):
        raise ValueError(f"{kernel}: C_d {D.shape[0]} not taken")
    f32 = torch.float32
    kernels.require(kernel, dev, ("V", V, (8, cap, ncl), f32, False),
                    ("D", D, (D.shape[0], cap, ncl), f32, False))
    n_rec = _record_count(cap, ncl, max_occupied)
    ip, fp = _kernel_params(grid, periodic, cfg, nxl, D.shape[0], 0, int(x_off),
                            absolute=True, n_rec=n_rec)
    scratch = torch.empty(_scratch_words(ncl, n_rec), dtype=torch.int32, device=dev)
    stks = torch.empty((3, 8, nxl, ny, nz), dtype=torch.float32, device=dev)
    _launch("planes_exchange", "yofc_planes_deposit", kernel, ip, fp, D, V, scratch, stks,
            device=dev)
    return stks, list(DX_COMBOS)


def deposit_planes(V, D, grid: Grid, periodic, cfg: cp.CouplingConfig, *,
                   max_occupied: Optional[int] = None):
    """-> (8, nx, ny, nz) deposited fields (weights applied inside)."""
    stks, combos = deposit_stacks(V, D, grid.shape[0], grid, periodic, cfg, 0,
                                  max_occupied=max_occupied)
    return _stack_epilogue(stks, combos)


# ---------------------------------------------------------------------------
# B4: fused interpolation + force laws + deposit
# ---------------------------------------------------------------------------

def fused_exchange_padded_reference(Fp, D, grid: Grid, periodic,
                                    cfg: cp.CouplingConfig, x_off, nu: float,
                                    rho_f: float):
    """Plain PyTorch version of the fused kernel. -> (stks (3, 8, nxl, ny,
    nz), combos, pres (4|7, cap, ncl))."""
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap = cfg.slot_capacity
    offsets = cp.stencil_offsets(cfg)
    D5 = D.reshape(D.shape[0], cap, nxl, ny, nz)
    fx, fy, fz = _plane_factors(D5, grid, periodic, offsets, int(x_off))
    return _slot_exchange(Fp, D5, fx, fy, fz, offsets, grid.cell_volume, nu, rho_f, cfg)


def fused_exchange_padded(Fp: torch.Tensor, D: torch.Tensor, grid: Grid, periodic,
                          cfg: cp.CouplingConfig, x_off, nu: float, rho_f: float, *,
                          max_occupied: Optional[int] = None):
    """-> (stks (3, 8, nxl, ny, nz), combos, pres) where pres is (4, cap,
    ncl) [fx fy fz found] or (7, ...) with the torque in channels 3:6, for a
    (possibly slab-local) padded input stack at global plane x_off. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise. ``max_occupied`` bounds the occupied slots of D (the particles
    binned into it) and sizes the kernel's compact per-slot records; None
    allows every slot (cap * ncl records of 96 bytes). The plain version
    ignores it."""
    kernel = "planes fused kernel"
    if _on_cpu(kernel, Fp, cfg):
        return fused_exchange_padded_reference(Fp, D, grid, periodic, cfg, x_off, nu, rho_f)
    nxl, ny, nz = Fp.shape[1] - 2, Fp.shape[2] - 2, Fp.shape[3] - 2
    cap, ncl, dev = cfg.slot_capacity, nxl * ny * nz, Fp.device
    C_d, C_in, n_pres = _channel_counts(cfg)
    f32 = torch.float32
    kernels.require(kernel, dev, ("Fp", Fp, _padded_shape(C_in, nxl, grid), f32, False),
                    ("D", D, (C_d, cap, ncl), f32, False))
    n_rec = _record_count(cap, ncl, max_occupied)
    ip, fp = _kernel_params(grid, periodic, cfg, nxl, C_d, C_in, int(x_off),
                            absolute=True, nu=nu, rho_f=rho_f, n_rec=n_rec)
    scratch = torch.empty(_scratch_words(ncl, n_rec), dtype=torch.int32, device=dev)
    stks = torch.empty((3, 8, nxl, ny, nz), dtype=torch.float32, device=dev)
    pres = torch.empty((n_pres, cap, ncl), dtype=torch.float32, device=dev)
    _launch("planes_exchange", "yofc_planes_fused", kernel, ip, fp, Fp, D, scratch, stks,
            pres, device=dev)
    return stks, list(DX_COMBOS), pres


# ---------------------------------------------------------------------------
# Unbin and the exchange result
# ---------------------------------------------------------------------------

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


def _coupling_result(fields, res, n_overflow, grid: Grid,
                     cfg: cp.CouplingConfig) -> cp.CouplingResult:
    """The grid fields from the landed deposit (8, ncells) and the
    per-particle results from the unbinned rows (N, 4|7)."""
    Vc = grid.cell_volume
    pvol, up = fields[0], fields[1:4]
    alpha = torch.clamp(1.0 - pvol / Vc, min=cfg.alpha_min)
    u_particle = up / Vc
    u_source_drag = fields[4]
    u_source = u_source_drag[None] * u_particle + fields[5:8]
    if res.shape[1] == 4:
        force, torque, found = res[:, 0:3], torch.zeros_like(res[:, 0:3]), res[:, 3]
    else:
        force, torque, found = res[:, 0:3], res[:, 3:6], res[:, 6]
    return cp.CouplingResult(
        force=force,
        torque=torque,
        alpha=alpha.reshape(grid.shape),
        u_particle=u_particle.reshape((3,) + grid.shape),
        u_source=u_source.reshape((3,) + grid.shape),
        u_source_drag=u_source_drag.reshape(grid.shape),
        found=found > 0.5,
        n_overflow=n_overflow,
    )


def _input_stack(fluid_u, grad_p, div_tau, ddt_u, curl_u, prev_alpha, cfg):
    """The exchange's input channels (C_in, grid): u, grad p, div tau,
    [curl u], [ddt u], the lagged alpha."""
    in_fields = [fluid_u, grad_p, div_tau]
    if cfg.use_torque:
        in_fields.append(curl_u)
    if cfg.use_added_mass:
        in_fields.append(ddt_u)
    in_fields.append(prev_alpha)
    return cp._stack_channels(in_fields)


# ---------------------------------------------------------------------------
# Full exchange
# ---------------------------------------------------------------------------

def gaussian_coupling_planes(
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
    """The planes exchange on the whole grid: bin (``yofc:exchange.bin``),
    run the fused kernel (or the interpolation kernel, the force laws and
    the deposit kernel under ``fused_planes=False``), land the stacks,
    unbin (``yofc:exchange.kernel``)."""
    if not cfg.lag_alpha:
        raise ValueError("exchange='planes' requires lag_alpha=True")
    cap = cfg.slot_capacity
    ncells = grid.ncells
    with annotate("yofc:exchange.bin"):
        bins = bin_particles_planes(pf, grid, cap, with_angvel=cfg.use_torque,
                                    packed_bin=cfg.packed_bin)
    F = _input_stack(fluid_u, grad_p, div_tau, ddt_u, curl_u, prev_alpha, cfg)

    with annotate("yofc:exchange.kernel"):
        if cfg.fused_planes:
            stks, combos, per = fused_exchange_padded(
                pad_wrap_zero(F, periodic), bins.D, grid, periodic, cfg, 0, nu, rho_f,
                max_occupied=pf.pos.shape[0])
            fields = _stack_epilogue(stks, combos)
        else:
            G, norm = interp_planes(F, bins.D, grid, periodic, cfg)
            V, force, torque, found = _physics_planes(
                bins.D, G, norm, grid.cell_volume, nu, rho_f, cfg)
            # the per-slot normalisation folds into V, so the deposit kernel
            # runs one raw-weight pass
            zero = torch.zeros((), dtype=norm.dtype, device=norm.device)
            inv_norm = torch.where(norm > 0.0, 1.0 / torch.where(norm > 0.0, norm, 1.0), zero)
            fields = deposit_planes(V * inv_norm[None], bins.D, grid, periodic, cfg,
                                    max_occupied=pf.pos.shape[0])
            per = torch.cat([force, torque, found.to(force.dtype)[None]])

        res = _unbin_rows(per, bins.cell_sorted, bins.rank, bins.keep, ncells,
                          cfg)[bins.inv_order]
        return _coupling_result(fields.reshape(8, ncells), res, bins.n_overflow, grid, cfg)


def gaussian_coupling_planes_chunked(
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
    """The planes exchange in ``cfg.planes_chunks`` x-slabs: one global
    stable sort orders particles by (x-major) flat cell id, so each slab's
    population is a contiguous run, fetched through a window of N_w rows
    at the clipped run start (fixed shapes, no host round trip). Per slab:
    store into the slab's slot table, the fused kernel at x_off = slab
    origin, the stacks landed into a halo-extended slab and added into the
    global fields with the two wrapped halo planes, and the windowed unbin
    written back under the slab's rows. A slab population beyond N_w adds
    to n_overflow, as do slot-capacity drops. Spans: the global sort and
    each slab's store in ``yofc:exchange.bin``; each slab's kernel,
    epilogue and unbin, and the result, in ``yofc:exchange.kernel``."""
    if not cfg.lag_alpha:
        raise ValueError("exchange='planes' requires lag_alpha=True")
    if not cfg.fused_planes:
        raise ValueError("chunked planes exchange: fused kernel only")
    n_chunks = cfg.planes_chunks
    nx, ny, nz = grid.shape
    if nx % n_chunks:
        raise ValueError(f"planes_chunks={n_chunks} must divide nx={nx}")
    nxc = nx // n_chunks
    ncl = nxc * ny * nz
    ncells = grid.ncells
    cap = cfg.slot_capacity
    C_d, _, n_res = _channel_counts(cfg)
    pos = pf.pos
    dev, dtype = pos.device, pos.dtype
    N = pos.shape[0]
    N_w = min(N, max(1024, int(2 * N / n_chunks + 1023) // 1024 * 1024))

    with annotate("yofc:exchange.bin"):
        # global locate + one sort
        base, inside = cp.locate(pos, grid)
        valid = pf.active & inside
        cell = base[:, 0] * (ny * nz) + base[:, 1] * nz + base[:, 2]
        cell = torch.where(valid, cell, ncells)
        order = torch.argsort(cell, stable=True)
        inv_order = torch.argsort(order, stable=True)
        cell_s = cell[order]
        rank_s = rank_in_sorted_segments(cell_s)
        cols = [pos, pf.vel, pf.radius[:, None]]
        if cfg.use_torque:
            cols.append(pf.angvel)
        dat_s = torch.cat(cols, dim=-1)[order]

        bounds = torch.searchsorted(
            cell_s.to(torch.int64),
            torch.arange(n_chunks + 1, device=dev, dtype=torch.int64) * ncl)
        counts = bounds[1:] - bounds[:-1]
        window_over = torch.sum(torch.clamp(counts - N_w, min=0))
        slot_over = torch.sum(((rank_s >= cap) & (cell_s < ncells)).to(torch.int32))

    Fpg = pad_wrap_zero(_input_stack(fluid_u, grad_p, div_tau, ddt_u, curl_u,
                                     prev_alpha, cfg), periodic)
    fields = torch.zeros((8,) + grid.shape, dtype=dtype, device=dev)
    res_s = torch.zeros((N, n_res), dtype=dtype, device=dev)
    ar = torch.arange(N_w, device=dev, dtype=torch.int64)
    for c in range(n_chunks):
        x0 = c * nxc
        s, e = bounds[c], bounds[c + 1]
        with annotate("yofc:exchange.bin"):
            start = torch.clamp(torch.clamp(s, max=N - N_w), min=0)
            idx_w = start + ar
            dat_w, cell_w, rank_w = dat_s[idx_w], cell_s[idx_w], rank_s[idx_w]
            in_chunk = (idx_w >= s) & (idx_w < e)
            cell_loc = cell_w - x0 * (ny * nz)
            keep = in_chunk & (rank_w < cap) & (cell_w < ncells)
            D = _staging_store(dat_w, cell_loc, rank_w, keep, C_d, cap, ncl)

        with annotate("yofc:exchange.kernel"):
            # slab fluid stack: padded-global plane x0 is global plane x0 - 1
            Fp_c = Fpg[:, x0:x0 + nxc + 2].contiguous()
            stks, combos, pres = fused_exchange_padded(Fp_c, D, grid, periodic, cfg, x0,
                                                       nu, rho_f, max_occupied=N_w)

            # epilogue: dy rolls slab-local, dx into a halo-extended slab
            ext = torch.zeros((8, nxc + 2, ny, nz), dtype=dtype, device=dev)
            for ci, (dx, dy) in enumerate(combos):
                v = stks[ci]
                if dy:
                    v = torch.roll(v, dy, dims=2)
                ext[:, 1 + dx:1 + dx + nxc] += v
            # the interior slab and the two wrapped halo planes (non-periodic x
            # edges receive zeros by the kernel's wall masks)
            fields[:, x0:x0 + nxc] += ext[:, 1:-1]
            fields[:, (x0 - 1) % nx] += ext[:, 0]
            fields[:, (x0 + nxc) % nx] += ext[:, -1]

            res_w = _unbin_rows(pres, torch.clamp(cell_loc, 0, ncl - 1), rank_w, keep, ncl,
                                cfg)
            res_s[idx_w] = torch.where(in_chunk[:, None], res_w, res_s[idx_w])

    with annotate("yofc:exchange.kernel"):
        return _coupling_result(fields.reshape(8, ncells), res_s[inv_order],
                                (slot_over + window_over).to(torch.int32), grid, cfg)
