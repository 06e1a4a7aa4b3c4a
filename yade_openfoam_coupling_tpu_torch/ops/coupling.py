"""Particle <-> grid coupling core (port of
`yade_openfoam_coupling_tpu/ops/coupling.py`): the config and result
tuples, the helpers the window and planes exchanges share, and the sparse
Gaussian exchange (`gaussian_coupling`, `gaussian_coupling_chunked`).

The sparse exchange gives every particle a fixed stencil of S cells
(27 for ``"cube"``, 19 for ``"sphere2"``) with normalised Gaussian weights,
gathers the fluid inputs over it with one row gather, and deposits with one
N-row scatter of all S*C channels onto each particle's anchor cell
(`index_add_`, as the JAX package leaves its `segment_sum` to XLA), which
kernel B3 (`rolls.distribute_rolls`) then spreads to the stencil cells.
The point-force (icoFoamYade) exchange, `point_force_coupling`, runs the
same deposit over the 8 trilinear corners {0,1}^3 of each particle. The
window and planes exchanges live in `coupling_window.py` and
`coupling_planes.py`, the slots exchange in `coupling_slots.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import host_tensor
from . import rolls
from .grid import Grid

# Gaussian support radius: interpRange = 4 * V^(1/3) and
# sigma = 0.4246 * interpRange, as in the reference engine.
INTERP_RANGE_CELLS = 4.0
SIGMA_OVER_RANGE = 0.42460
ALPHA_MIN = 0.10  # volume-fraction clamp

# deposit_stack's anchor-roll route needs an (S*C, ncells) buffer; above
# this many elements it takes the direct (N*S)-row scatter instead
ROLL_BUFFER_ELEM_LIMIT = 700_000_000


@dataclasses.dataclass(frozen=True)
class CouplingConfig:
    """Static switches of the coupling engine; same fields and defaults as
    the JAX package's `CouplingConfig` (see its field comments).

    ``exchange="sparse"``, ``"window"`` and ``"planes"`` run in the port
    with ``gaussian`` (window and planes with ``lag_alpha``). ``dy_in_kernel``, ``packed_bin``,
    ``packed_unbin``, ``unbin_gather`` and ``window_dynamic`` change no
    result in the JAX package; the port takes one path for each (dy shifts
    in the kernel, an indexed store into the slot table, flat unbin gather,
    windows read up to each plane's count)."""

    gaussian: bool = True
    stencil_width: int = 3
    stencil_shape: str = "cube"
    use_added_mass: bool = False
    use_torque: bool = False
    added_mass_coeff: float = 0.5
    alpha_min: float = ALPHA_MIN
    lag_alpha: bool = False
    particle_chunks: int = 1
    exchange: str = "sparse"
    fused_planes: bool = True
    packed_bin: object = False
    planes_chunks: int = 1
    dy_in_kernel: bool = False
    packed_unbin: bool = False
    unbin_gather: bool = False
    slot_capacity: int = 4
    planes_window: int = 0
    window_dynamic: bool = False


class ParticleFields(NamedTuple):
    """SoA particle state subset the coupling consumes."""

    pos: torch.Tensor       # (N, 3)
    vel: torch.Tensor       # (N, 3)
    angvel: torch.Tensor    # (N, 3)
    radius: torch.Tensor    # (N,)
    active: torch.Tensor    # (N,) bool


class CouplingResult(NamedTuple):
    """Grid fields and per-particle results of one exchange."""

    force: torch.Tensor          # (N, 3)
    torque: torch.Tensor         # (N, 3)
    alpha: torch.Tensor          # fluid volume fraction field
    u_particle: torch.Tensor     # (3, nx, ny, nz)
    u_source: torch.Tensor       # (3, nx, ny, nz)
    u_source_drag: torch.Tensor  # implicit drag coefficient field (<= 0)
    found: torch.Tensor          # (N,) bool
    n_overflow: object = 0       # slot + window overflow count


def locate(pos: torch.Tensor, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell index (N,3) int32 and in-domain mask: floor((x - x0)/h)."""
    origin = host_tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    h = host_tensor(grid.spacing, dtype=pos.dtype, device=pos.device)
    idx = torch.floor((pos - origin) / h).to(torch.int32)
    n = host_tensor(grid.shape, dtype=torch.int32, device=pos.device)
    inside = torch.all((idx >= 0) & (idx < n), dim=-1)
    return idx, inside


def _stencil_offsets(width: int, shape: str = "cube") -> np.ndarray:
    r = width // 2
    o = np.arange(-r, r + 1)
    offs = np.stack(np.meshgrid(o, o, o, indexing="ij"), -1).reshape(-1, 3)
    if shape == "sphere2":
        offs = offs[(offs ** 2).sum(1) <= 2]
    return offs


def stencil_offsets(cfg: CouplingConfig) -> np.ndarray:
    return _stencil_offsets(cfg.stencil_width, cfg.stencil_shape)


def particle_volume(radius: torch.Tensor) -> torch.Tensor:
    return (4.0 / 3.0) * math.pi * radius ** 3


def drag_coefficient(alpha_f, alpha_p, mag_ur, dia, nu, rho_f):
    """Wen-Yu / Ergun blended drag momentum-exchange coefficient."""
    small = 1e-12
    Re = small + mag_ur * dia / nu
    cd = torch.where(Re < 1000.0, (24.0 / Re) * (1.0 + 0.15 * Re ** 0.687),
                     torch.full_like(Re, 0.44))
    wen_yu = 0.75 * cd * alpha_f * alpha_p * rho_f * mag_ur * alpha_f ** (-2.65)
    ergun = (
        150.0 * (alpha_p * alpha_p / torch.clamp(alpha_f, min=1e-6))
        * (nu * rho_f) / (dia * dia)
        + 1.75 * alpha_p * rho_f * mag_ur / dia
    )
    return torch.where(alpha_f > 0.8, wen_yu, ergun)


def _stack_channels(fields) -> torch.Tensor:
    """List of scalar (grid,) / vector (3,grid) fields -> (C, grid)."""
    return torch.cat([f if f.dim() == 4 else f[None] for f in fields], dim=0)


# ---------------------------------------------------------------------------
# The sparse exchange's support: stencil cells and Gaussian weights
# ---------------------------------------------------------------------------

def _flat_cell_ids(cells, grid: Grid, bc_periodic, valid: torch.Tensor):
    """Flat ids of per-axis cell indices (3-tuple of (...) int tensors),
    wrapping periodic axes and masking cells outside non-periodic
    boundaries; invalid entries map to the scrap id ncells."""
    nx, ny, nz = grid.shape
    ok = valid
    wrapped = []
    for a, c in enumerate(cells):
        n_a = grid.shape[a]
        wrapped.append(torch.remainder(c, n_a))
        if not bc_periodic[a]:
            ok = ok & (c >= 0) & (c < n_a)
    flat = wrapped[0] * (ny * nz) + wrapped[1] * nz + wrapped[2]
    return torch.where(ok, flat, nx * ny * nz), ok


def _wrap_flat(cells3: torch.Tensor, valid: torch.Tensor, grid: Grid) -> torch.Tensor:
    """(N,3) int cell indices -> flat ids wrapped mod n on every axis (masked
    contributions are zero wherever they land), scrap when invalid."""
    nx, ny, nz = grid.shape
    n = host_tensor(grid.shape, dtype=torch.int32, device=cells3.device)
    w = torch.remainder(cells3, n)
    flat = w[..., 0] * (ny * nz) + w[..., 1] * nz + w[..., 2]
    return torch.where(valid, flat, nx * ny * nz)


def base_flat_ids(pos: torch.Tensor, valid: torch.Tensor, grid: Grid) -> torch.Tensor:
    base, _ = locate(pos, grid)
    return _wrap_flat(base, valid, grid)


class GaussianSupport(NamedTuple):
    """Per-particle interpolation support; deposits scatter onto the anchor
    cell `base_flat` with the whole stencil as payload channels."""

    flat_ids: torch.Tensor   # (N, S) int32 flat cell ids (scrap = ncells)
    weights: torch.Tensor    # (N, S) normalised Gaussian weights
    valid: torch.Tensor      # (N, S) bool
    base_flat: torch.Tensor  # (N,) int32 anchor cell id (scrap when invalid)


def gaussian_cells_raw_weights(pos: torch.Tensor, active: torch.Tensor, grid: Grid,
                               cfg: CouplingConfig):
    """Unwrapped stencil cell indices (3-tuple of (N,S)), raw weights
    exp(-|x_c - x_p|^2 / 2 sigma^2) (N,S) and the in-domain mask (N,)."""
    offsets = stencil_offsets(cfg)
    base, inside = locate(pos, grid)
    cells = []
    d2 = 0.0
    for a in range(3):
        off_a = host_tensor(offsets[:, a], dtype=torch.int32, device=pos.device)
        ca = base[:, a:a + 1] + off_a[None, :]
        cells.append(ca)
        centers_a = grid.origin[a] + (ca.to(pos.dtype) + 0.5) * grid.spacing[a]
        d2 = d2 + (centers_a - pos[:, a:a + 1]) ** 2
    h_mean = float(np.cbrt(grid.cell_volume))
    sigma = SIGMA_OVER_RANGE * INTERP_RANGE_CELLS * h_mean
    w = torch.exp(-d2 / (2.0 * sigma * sigma))
    return tuple(cells), w, active & inside


def normalize_weights(w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    w = torch.where(ok, w, 0.0)
    wsum = torch.sum(w, dim=1, keepdim=True)
    return w / torch.where(wsum > 0.0, wsum, 1.0)


def gaussian_support(pos: torch.Tensor, active: torch.Tensor, grid: Grid, periodic,
                     cfg: CouplingConfig) -> GaussianSupport:
    """Normalised Gaussian weights over the fixed stencil."""
    cells, w, valid_particle = gaussian_cells_raw_weights(pos, active, grid, cfg)
    flat, ok = _flat_cell_ids(cells, grid, periodic, valid_particle[:, None])
    base = base_flat_ids(pos, valid_particle, grid)
    return GaussianSupport(flat, normalize_weights(w, ok), ok, base)


# ---------------------------------------------------------------------------
# Deposits and gathers
# ---------------------------------------------------------------------------

def deposit(values: torch.Tensor, sup: GaussianSupport, grid: Grid) -> torch.Tensor:
    """Scatter-add per-(particle, stencil cell) values (N,S) onto the grid."""
    ncells = grid.ncells
    out = torch.zeros(ncells + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, sup.flat_ids.reshape(-1).long(), values.reshape(-1))
    return out[:ncells].reshape(grid.shape)


def deposit_vec(values: torch.Tensor, sup: GaussianSupport, grid: Grid) -> torch.Tensor:
    """(N,S,3) -> (3,nx,ny,nz)."""
    return torch.stack([deposit(values[..., c], sup, grid) for c in range(3)])


def gather(field: torch.Tensor, sup: GaussianSupport) -> torch.Tensor:
    """Weighted gather of a scalar grid field at each particle: (N,)."""
    flat = torch.cat([field.reshape(-1), field.new_zeros(1)])
    return torch.sum(flat[sup.flat_ids.long()] * sup.weights, dim=1)


def gather_vec(field: torch.Tensor, sup: GaussianSupport) -> torch.Tensor:
    """(3,grid) -> (N,3)."""
    return torch.stack([gather(field[c], sup) for c in range(3)], dim=-1)


def gather_stack(fields: torch.Tensor, sup: GaussianSupport) -> torch.Tensor:
    """(C, grid) -> (N, C) weighted gather with one row gather of an
    (ncells + 1, C) table (last row: the scrap cell)."""
    C = fields.shape[0]
    tbl = torch.cat([fields.reshape(C, -1).T, fields.new_zeros((1, C))])
    vals = tbl[sup.flat_ids.long()]                                # (N,S,C)
    return torch.sum(vals * sup.weights[..., None], dim=1)


def deposit_stack(values: torch.Tensor, sup: GaussianSupport, grid: Grid,
                  offsets: Optional[np.ndarray] = None) -> torch.Tensor:
    """(N,S,C) -> (C,) + grid.shape. With offsets, and an anchor buffer of
    at most ROLL_BUFFER_ELEM_LIMIT elements, the anchor-roll route
    (`_deposit_anchor_rolls`); otherwise one direct (N*S)-row scatter, as in
    the JAX package (`coupling.py:500-504`)."""
    ncells = grid.ncells
    N, S, C = values.shape
    if offsets is None or ncells * S * C > ROLL_BUFFER_ELEM_LIMIT:
        flat = torch.zeros((ncells + 1, C), dtype=values.dtype, device=values.device)
        flat.index_add_(0, sup.flat_ids.reshape(-1).long(), values.reshape(-1, C))
        return flat[:ncells].reshape(grid.shape + (C,)).movedim(-1, 0)
    return _deposit_anchor_rolls(values, sup, grid, offsets)


def anchor_row_length(ncells: int) -> int:
    """Row length of the anchor buffer: ncells + 1 (column ncells is the
    scrap bin) rounded up to 32 floats, so every (offset, channel) plane
    starts 128-byte aligned and kernel B3 reads it with vector loads."""
    return -(-(ncells + 1) // 32) * 32


def _deposit_anchor_rolls(values, sup: GaussianSupport, grid: Grid, offsets) -> torch.Tensor:
    """One N-row scatter of all S*C channels onto the anchor cells, straight
    into an offset-major (S*C, anchor_row_length) buffer (column ncells is
    the scrap bin), then the roll distribution over the (S, C, grid) view
    of its first ncells columns. The distribution is kernel B3 when every
    side of the grid is at least 8 (the JAX package's own rule,
    `coupling.py:532-536`); smaller grids take the plain roll loop."""
    ncells = grid.ncells
    N, S, C = values.shape
    buf = torch.zeros((S * C, anchor_row_length(ncells)), dtype=values.dtype,
                      device=values.device)
    buf.index_add_(1, sup.base_flat.long(), values.reshape(N, S * C).T)
    bufT = buf[:, :ncells].view((S, C) + grid.shape)
    if min(grid.shape) >= 8:
        return rolls.distribute_rolls(bufT, offsets)
    return rolls.distribute_rolls_reference(bufT, offsets)


class SupportOps(NamedTuple):
    """Scatter/gather plumbing over a particle support, so that the same
    force physics runs over any support."""

    deposit: Callable         # (N,S) values -> scalar grid field
    deposit_vec: Callable     # (N,S,3) values -> (3, grid) field
    gather: Callable          # scalar grid field -> (N,)
    gather_vec: Callable      # (3, grid) field -> (N,3)
    deposit_stack: Callable   # (N,S,C) values -> (C, grid) fields
    gather_stack: Callable    # list of (grid,) / (3, grid) fields -> (N,C)
    deposit_outer: Callable   # (N,C) per-particle values, weighted by the support


def local_support_ops(sup: GaussianSupport, grid: Grid,
                      offsets: Optional[np.ndarray] = None) -> SupportOps:
    return SupportOps(
        deposit=lambda v: deposit_stack(v[..., None], sup, grid, offsets)[0],
        deposit_vec=lambda v: deposit_stack(v, sup, grid, offsets),
        gather=lambda f: gather(f, sup),
        gather_vec=lambda f: gather_vec(f, sup),
        deposit_stack=lambda v: deposit_stack(v, sup, grid, offsets),
        gather_stack=lambda fs: gather_stack(_stack_channels(fs), sup),
        deposit_outer=lambda v: deposit_stack(sup.weights[..., None] * v[:, None, :],
                                              sup, grid, offsets),
    )


# ---------------------------------------------------------------------------
# Volume fraction and the Gaussian physics
# ---------------------------------------------------------------------------

def volume_fraction_fields(pf: ParticleFields, sup: GaussianSupport, grid: Grid,
                           cfg: CouplingConfig):
    """alpha = max(1 - sum_p w V_p / V_cell, alpha_min) and
    uParticle = sum_p w V_p v_p / V_cell."""
    wv = sup.weights * particle_volume(pf.radius)[:, None]
    pvol = deposit(wv, sup, grid)
    up = deposit_vec(wv[..., None] * pf.vel[:, None, :], sup, grid)
    Vc = grid.cell_volume
    return torch.clamp(1.0 - pvol / Vc, min=cfg.alpha_min), up / Vc


def volume_fraction_fields_ops(pf: ParticleFields, weights: torch.Tensor, ops: SupportOps,
                               cell_volume: float, cfg: CouplingConfig):
    """`volume_fraction_fields` through injected ops."""
    wv = weights * particle_volume(pf.radius)[:, None]
    pvol = ops.deposit(wv)
    up = ops.deposit_vec(wv[..., None] * pf.vel[:, None, :])
    return torch.clamp(1.0 - pvol / cell_volume, min=cfg.alpha_min), up / cell_volume


class FluidAtParticles(NamedTuple):
    """Fluid quantities gathered to particle positions."""

    u: torch.Tensor          # (N,3)
    alpha_f: torch.Tensor    # (N,)
    grad_p: torch.Tensor     # (N,3)
    div_tau: torch.Tensor    # (N,3)
    ddt_u: torch.Tensor      # (N,3)
    curl_u: torch.Tensor     # (N,3)


def gaussian_physics(pf: ParticleFields, fluid_u, grad_p, div_tau, ddt_u, curl_u,
                     weights: torch.Tensor, found: torch.Tensor, ops: SupportOps,
                     cell_volume: float, nu: float, rho_f: float, cfg: CouplingConfig,
                     prev_alpha=None) -> CouplingResult:
    """The Gaussian branch of `setParticleAction`: volume-fraction deposit,
    drag + Archimedes (+ added mass / torque), source-term deposits; one
    row gather of the inputs (plus one of alpha without ``lag_alpha``) and
    two deposits (one with ``lag_alpha``)."""
    vol = particle_volume(pf.radius)
    dia = 2.0 * pf.radius
    lag = cfg.lag_alpha and prev_alpha is not None
    zero = torch.zeros((), dtype=pf.vel.dtype, device=pf.vel.device)

    in_fields = [fluid_u, grad_p, div_tau]
    if cfg.use_torque:
        in_fields.append(curl_u)
    if cfg.use_added_mass:
        in_fields.append(ddt_u)
    if lag:
        in_fields.append(prev_alpha)
    g = ops.gather_stack(in_fields)                              # (N, C)
    uf, pg, dt_tau = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    c = 9
    if cfg.use_torque:
        curl_p = g[:, c:c + 3]
        c += 3
    if cfg.use_added_mass:
        ddtu = g[:, c:c + 3]
        c += 3

    val1 = torch.cat([vol[:, None], vol[:, None] * pf.vel], dim=-1)   # (N,4)
    if not lag:
        out1 = ops.deposit_outer(val1)
        alpha = torch.clamp(1.0 - out1[0] / cell_volume, min=cfg.alpha_min)
        u_particle = out1[1:4] / cell_volume
        alpha_f = ops.gather_stack([alpha])[:, 0]
    else:
        alpha_f = g[:, -1]

    # drag
    alpha_p = torch.clamp(1.0 - alpha_f, 1e-6, 1.0)
    ur = uf - pf.vel
    mag_ur = torch.linalg.vector_norm(ur, dim=-1)
    coeff = drag_coefficient(alpha_f, alpha_p, mag_ur, dia, nu, rho_f)
    coeff = torch.where(found, coeff, zero)
    f_drag = (vol * coeff / alpha_p)[:, None] * ur

    # Archimedes (with the rho_f dimensional fix)
    f_arch = vol[:, None] * rho_f * (-pg + dt_tau)
    f_arch = torch.where(found[:, None], f_arch, zero)
    ooVrho = 1.0 / (cell_volume * rho_f)
    force = f_drag + f_arch
    f_am = None
    if cfg.use_added_mass:
        f_am = cfg.added_mass_coeff * rho_f * vol[:, None] * ddtu
        f_am = torch.where(found[:, None], f_am, zero)
        force = force + f_am

    # implicit drag (1) + explicit source (3) deposits
    src_part = -f_arch if f_am is None else -(f_arch + f_am)
    val2 = torch.cat([(-(coeff / rho_f))[:, None], src_part * ooVrho], dim=-1)
    if lag:
        out = ops.deposit_outer(torch.cat([val1, val2], dim=-1))
        alpha = torch.clamp(1.0 - out[0] / cell_volume, min=cfg.alpha_min)
        u_particle = out[1:4] / cell_volume
        out2 = out[4:]
    else:
        out2 = ops.deposit_outer(val2)
    u_source_drag = out2[0]
    u_source = u_source_drag[None] * u_particle + out2[1:4]

    if cfg.use_torque:
        wf = 0.5 * curl_p
        torque = math.pi * (dia ** 3)[:, None] * (wf - pf.angvel) * nu * rho_f
        torque = torch.where(found[:, None], torque, zero)
    else:
        torque = torch.zeros_like(pf.vel)

    force = torch.where(found[:, None], force, zero)
    return CouplingResult(force=force, torque=torque, alpha=alpha, u_particle=u_particle,
                          u_source=u_source, u_source_drag=u_source_drag, found=found)


def gaussian_coupling(pf: ParticleFields, fluid_u, grad_p, div_tau, ddt_u, curl_u,
                      grid: Grid, periodic, nu: float, rho_f: float, dt,
                      cfg: CouplingConfig, prev_alpha=None) -> CouplingResult:
    """The sparse 4-way Gaussian exchange (pimpleFoamYade mode)."""
    sup = gaussian_support(pf.pos, pf.active, grid, periodic, cfg)
    found = torch.sum(sup.weights, dim=1) > 0.0
    return gaussian_physics(pf, fluid_u, grad_p, div_tau, ddt_u, curl_u, sup.weights, found,
                            local_support_ops(sup, grid, stencil_offsets(cfg)),
                            grid.cell_volume, nu, rho_f, cfg, prev_alpha=prev_alpha)


def gaussian_coupling_chunked(pf: ParticleFields, fluid_u, grad_p, div_tau, ddt_u, curl_u,
                              grid: Grid, periodic, nu: float, rho_f: float, dt,
                              cfg: CouplingConfig, prev_alpha) -> CouplingResult:
    """`gaussian_coupling` over ``particle_chunks`` particle chunks in turn
    (``lag_alpha`` makes them independent): the grid fields accumulate,
    the per-particle outputs concatenate. Each chunk's alpha is un-clamped
    back to its volume deposit, as in the JAX package."""
    if not cfg.lag_alpha:
        raise ValueError("particle_chunks > 1 requires lag_alpha=True")
    N = pf.pos.shape[0]
    k = cfg.particle_chunks
    if N % k:
        raise ValueError(f"capacity {N} not divisible by particle_chunks={k}")
    csz = N // k
    Vc = grid.cell_volume
    pvol = up = usd = src = 0.0
    forces, torques, founds = [], [], []
    for i in range(k):
        sl = ParticleFields(*(x[i * csz:(i + 1) * csz] for x in pf))
        res = gaussian_coupling(sl, fluid_u, grad_p, div_tau, ddt_u, curl_u, grid, periodic,
                                nu, rho_f, dt, cfg, prev_alpha=prev_alpha)
        pvol = pvol + (1.0 - torch.clamp(res.alpha, min=cfg.alpha_min)) * Vc
        up = up + res.u_particle * Vc
        usd = usd + res.u_source_drag
        src = src + (res.u_source - res.u_source_drag[None] * res.u_particle)
        forces.append(res.force)
        torques.append(res.torque)
        founds.append(res.found)
    alpha = torch.clamp(1.0 - pvol / Vc, min=cfg.alpha_min)
    u_particle = up / Vc
    return CouplingResult(force=torch.cat(forces), torque=torch.cat(torques), alpha=alpha,
                          u_particle=u_particle, u_source=src + usd[None] * u_particle,
                          u_source_drag=usd, found=torch.cat(founds))


# ---------------------------------------------------------------------------
# Point-force (icoFoamYade) mode
# ---------------------------------------------------------------------------

# the trilinear support's corner offsets {0,1}^3, in the order of its weights
TRILINEAR_CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                             -1).reshape(-1, 3)


def trilinear_cells_raw_weights(pos: torch.Tensor, active: torch.Tensor, grid: Grid):
    """Unwrapped corner cell indices (3-tuple of (N,8)), trilinear weights
    (N,8) and the in-domain mask (N,): in node space, where integer points
    are cell centres, the anchor is floor((x - x0)/h - 1/2)."""
    origin = host_tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    h = host_tensor(grid.spacing, dtype=pos.dtype, device=pos.device)
    s = (pos - origin) / h - 0.5
    base = torch.floor(s).to(torch.int32)
    frac = s - base.to(pos.dtype)
    cells = []
    w = 1.0
    for a in range(3):
        corn_a = host_tensor(TRILINEAR_CORNERS[:, a], dtype=torch.int32, device=pos.device)
        cells.append(base[:, a:a + 1] + corn_a[None, :])
        fa = frac[:, a:a + 1]
        w = w * torch.where(corn_a[None, :] == 1, fa, 1.0 - fa)
    _, inside = locate(pos, grid)
    return tuple(cells), w, active & inside


def trilinear_weights(pos: torch.Tensor, grid: Grid, periodic, active) -> GaussianSupport:
    """The trilinear support: corner flat ids, normalised weights, and the
    anchor floor((x - x0)/h - 1/2) wrapped on every axis."""
    cells, w, valid_particle = trilinear_cells_raw_weights(pos, active, grid)
    flat, ok = _flat_cell_ids(cells, grid, periodic, valid_particle[:, None])
    anchor = torch.stack([c[:, 0] for c in cells], 1)         # corner (0, 0, 0)
    return GaussianSupport(flat, normalize_weights(w, ok), ok,
                           _wrap_flat(anchor, valid_particle, grid))


def point_force_physics(pf: ParticleFields, fluid_u, curl_u, found: torch.Tensor,
                        ops: SupportOps, cell_volume: float, nu: float,
                        rho_f: float) -> CouplingResult:
    """Two-way Stokes point force (`stokesDragForce`): F = 3 pi d mu
    (u_f - v), its source deposited with weight -F/(V_cell rho_f), and the
    torque of the 1/2-curl rotation rate (`stokesDragTorque`), which the
    reference's point-force branch always computes."""
    g = ops.gather_stack([fluid_u, curl_u])                     # one row gather
    uf, curl_p = g[:, 0:3], g[:, 3:6]
    zero = torch.zeros((), dtype=pf.vel.dtype, device=pf.vel.device)
    dia = 2.0 * pf.radius
    coeff = 3.0 * math.pi * dia * nu * rho_f
    force = torch.where(found[:, None], coeff[:, None] * (uf - pf.vel), zero)
    u_source = ops.deposit_outer(-force * (1.0 / (cell_volume * rho_f)))

    torque = math.pi * (dia ** 3)[:, None] * (0.5 * curl_p - pf.angvel) * nu * rho_f
    torque = torch.where(found[:, None], torque, zero)

    shape = u_source.shape[1:]
    return CouplingResult(
        force=force, torque=torque,
        alpha=torch.ones(shape, dtype=fluid_u.dtype, device=fluid_u.device),
        u_particle=torch.zeros((3,) + shape, dtype=fluid_u.dtype, device=fluid_u.device),
        u_source=u_source,
        u_source_drag=torch.zeros(shape, dtype=fluid_u.dtype, device=fluid_u.device),
        found=found)


def point_force_coupling(pf: ParticleFields, fluid_u, curl_u, grid: Grid, periodic,
                         nu: float, rho_f: float) -> CouplingResult:
    """The point-force exchange: the deposit is kernel B3 over the 8
    corners (C = 3) on grids whose sides are all at least 8. Torque is
    always on (`CouplingConfig.use_torque` does not apply), as in the
    reference's point-force branch."""
    sup = trilinear_weights(pf.pos, grid, periodic, pf.active)
    found = torch.sum(sup.weights, dim=1) > 0.0
    return point_force_physics(pf, fluid_u, curl_u, found,
                               local_support_ops(sup, grid, TRILINEAR_CORNERS),
                               grid.cell_volume, nu, rho_f)
