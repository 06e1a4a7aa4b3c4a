"""Discrete-element engine (port of `yade_openfoam_coupling_tpu/ops/dem.py`):
linear spring-dashpot contacts with Coulomb-capped viscous friction, or
with the tangential spring history of Yade's
Law2_ScGeom_FrictPhys_CundallStrack (`ShearState`, carried across list
rebuilds by partner key); all pairs, a fixed-capacity cell list, or a
Verlet candidate list built from uniform hash bins (persistent, once per
`dem_substeps` call, or every ``list_rebuild_every`` substeps); wall
contacts against the box faces; and velocity-Verlet substeps with the
contact force evaluated every substep or held for the step
(``contact_mode``), optionally carried across calls, with a per-substep
dt sequence whose zero-dt tail changes nothing (dynamic substeps), and the
Rayleigh critical dt of the current radii (`critical_dt_dynamic`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate, host_tensor
from .grid import Grid


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Linear spring-dashpot contact model parameters (Yade FrictMat-style)."""

    kn: float = 1.0e4
    kt_over_kn: float = 0.5
    restitution: float = 0.5
    friction: float = 0.5
    rho_p: float = 2500.0


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    """Same fields and defaults as the JAX package's `DEMConfig` (see its
    field comments). ``dense_rolls``, ``sorted_fetch``, ``force_chunks``,
    ``substep_unroll``, ``gather_barrier`` and ``pair_layout`` schedule or
    lay out the same arithmetic in the JAX package; the port takes one
    path for every setting."""

    params: ContactParams = ContactParams()
    gravity: tuple[float, float, float] = (0.0, 0.0, -9.81)
    buoyancy: bool = False
    rho_f: float = 1000.0
    neighbor: str = "allpairs"
    cell_capacity: int = 8
    contact_mode: str = "substep"
    max_neighbors: int = 12
    skin: float = 0.5
    list_rebuild_every: int = 0
    list_reuse: bool = False
    list_margin_factor: float = 0.5
    list_rebuild_steps: int = 0
    max_bins: int = 2_000_000
    dense_rolls: bool = True
    force_chunks: int = 1
    carry_contact: bool = False
    sorted_fetch: bool = False
    refined_neighbors: int = 0
    wall_axes: tuple[bool, bool, bool] = (True, True, True)
    periodic: tuple[bool, bool, bool] = (False, False, False)
    shear_history: bool = False
    enforce_critical_dt: bool = False
    dynamic_substeps: bool = False
    cundall_damping: float = 0.0
    substep_unroll: bool = False
    gather_barrier: bool = False
    pair_layout: str = "rows"

    def __post_init__(self):
        if self.pair_layout not in ("rows", "channels"):
            raise ValueError(f"unknown pair_layout {self.pair_layout!r}: "
                             "expected 'rows' or 'channels'")


def rank_in_sorted_segments(keys_sorted: torch.Tensor) -> torch.Tensor:
    """rank[i] = i - (first index of keys_sorted[i]'s run), for an
    ascending key array: a cummax scan over segment-start indices."""
    n = keys_sorted.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys_sorted.device)
    is_new = torch.ones(n, dtype=torch.bool, device=keys_sorted.device)
    is_new[1:] = keys_sorted[1:] != keys_sorted[:-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    return idx - seg_start


def particle_mass(radius: torch.Tensor, rho_p: float) -> torch.Tensor:
    return rho_p * (4.0 / 3.0) * math.pi * radius ** 3


def particle_inertia(radius: torch.Tensor, rho_p: float) -> torch.Tensor:
    """Solid-sphere moment of inertia 2/5 m r^2."""
    return 0.4 * particle_mass(radius, rho_p) * radius ** 2


def _normal_damping(kn: float, m_eff: torch.Tensor, restitution: float) -> torch.Tensor:
    """Dashpot coefficient from restitution e: c = -2 ln e sqrt(kn m)/sqrt(pi^2+ln^2 e)."""
    e = max(min(restitution, 0.999), 1e-4)
    ln_e = np.log(e)
    beta = float(-ln_e / np.sqrt(np.pi ** 2 + ln_e ** 2))
    return 2.0 * beta * torch.sqrt(kn * m_eff)


def _cross_cm(a, b):
    """Cross product on component triples (each component any shape)."""
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) cross product, component formula of `jnp.cross`."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _pair_force_cm(dx, vi, vj, wi, wj, ri, rj, mi, mj,
                   p: ContactParams, valid):
    """Pair force and torque on particle i from j in channel-major form:
    every vector argument is an (x, y, z) tuple of (M, n) component
    arrays."""
    dist = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
    overlap = ri + rj - dist
    touching = valid & (overlap > 0.0) & (dist > 1e-12)
    dist_safe = torch.where(dist > 1e-12, dist, torch.ones_like(dist))
    n = tuple(c / dist_safe for c in dx)                # from j toward i

    ci = tuple(-ri * c for c in n)
    cj = tuple(rj * c for c in n)
    v_rel = tuple((vi[k] + wxci) - (vj[k] + wxcj)
                  for k, (wxci, wxcj) in enumerate(
                      zip(_cross_cm(wi, ci), _cross_cm(wj, cj))))
    v_n = v_rel[0] * n[0] + v_rel[1] * n[1] + v_rel[2] * n[2]
    v_t = tuple(v_rel[k] - v_n * n[k] for k in range(3))

    m_eff = (mi * mj) / torch.clamp(mi + mj, min=1e-30)
    cn = _normal_damping(p.kn, m_eff, p.restitution)

    f_n_mag = torch.clamp(p.kn * overlap - cn * v_n, min=0.0)
    f_n = tuple(f_n_mag * c for c in n)

    kt = p.kt_over_kn * p.kn
    ct = 2.0 * 0.5 * torch.sqrt(kt * m_eff)
    f_t = tuple(-ct * c for c in v_t)
    f_t_mag = torch.sqrt(f_t[0] * f_t[0] + f_t[1] * f_t[1] + f_t[2] * f_t[2])
    cap = p.friction * f_n_mag
    scale = torch.where(f_t_mag > 1e-30,
                        torch.clamp(cap / torch.clamp(f_t_mag, min=1e-30), max=1.0),
                        torch.zeros_like(f_t_mag))
    f_t = tuple(c * scale for c in f_t)

    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    f = tuple(torch.where(touching, f_n[k] + f_t[k], zero) for k in range(3))
    torque = tuple(torch.where(touching, c, zero) for c in _cross_cm(ci, f_t))
    return f, torque


class ShearState(NamedTuple):
    """Per-(particle, neighbour-slot) tangential spring history, keyed by
    partner (its pid when pids are given, else its index; -1 = empty
    slot), carried across list rebuilds by key match; one wall spring per
    axis."""

    xi: torch.Tensor        # (N, M, 3) tangential spring displacement
    ids: torch.Tensor       # (N, M) int32 partner keys (-1 = empty)
    xi_wall: torch.Tensor   # (N, 3, 3) wall-contact springs, one per axis


def make_shear_state(n: int, max_neighbors: int, dtype=torch.float32,
                     device=None) -> ShearState:
    return ShearState(
        xi=torch.zeros((n, max_neighbors, 3), dtype=dtype, device=device),
        ids=torch.full((n, max_neighbors), -1, dtype=torch.int32, device=device),
        xi_wall=torch.zeros((n, 3, 3), dtype=dtype, device=device))


def shear_keys(nbr: torch.Tensor, n_valid: int,
               pid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partner keys of a neighbour-id array: pid[nbr] when pids are given,
    else the index; -1 for empty slots (ids >= n_valid)."""
    empty = torch.full((), -1, dtype=torch.int32, device=nbr.device)
    if pid is None:
        return torch.where(nbr >= n_valid, empty, nbr)
    pid_ext = torch.cat([pid, empty[None]])
    keys = pid_ext[torch.clamp(nbr, max=pid.shape[0]).to(torch.int64)]
    return torch.where(nbr >= n_valid, empty, keys)


def carry_shear(old: ShearState, new_keys: torch.Tensor) -> torch.Tensor:
    """Each new slot's spring from the old slot with the same partner key,
    zero where none matches: the reference's dense (N, M_new, M_old)
    one-hot product (full f32, TF32 off at package entry, so a matched
    spring is carried exactly)."""
    match = ((new_keys[:, :, None] == old.ids[:, None, :]) & (old.ids[:, None, :] >= 0)
             & (new_keys[:, :, None] >= 0))
    return torch.einsum("nmo,noc->nmc", match.to(old.xi.dtype), old.xi)


def _pair_force_shear_cm(dx, vi, vj, wi, wj, ri, rj, mi, mj,
                         p: ContactParams, valid, xi, dt):
    """Spring-dashpot normal force and the Coulomb-capped tangential HISTORY
    spring with slip feedback (the reference's `_pair_force_shear`, op for
    op) in channel-major form: vectors, ``xi`` included, are (x, y, z)
    tuples of (M, n) component arrays. -> (force on i, torque on i,
    updated xi), each a triple."""
    dist = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
    overlap = ri + rj - dist
    touching = valid & (overlap > 0.0) & (dist > 1e-12)
    dist_safe = torch.where(dist > 1e-12, dist, torch.ones_like(dist))
    n = tuple(c / dist_safe for c in dx)

    ci = tuple(-ri * c for c in n)
    cj = tuple(rj * c for c in n)
    v_rel = tuple((vi[k] + wxci) - (vj[k] + wxcj)
                  for k, (wxci, wxcj) in enumerate(
                      zip(_cross_cm(wi, ci), _cross_cm(wj, cj))))
    v_n = v_rel[0] * n[0] + v_rel[1] * n[1] + v_rel[2] * n[2]
    v_t = tuple(v_rel[k] - v_n * n[k] for k in range(3))

    m_eff = (mi * mj) / torch.clamp(mi + mj, min=1e-30)
    cn = _normal_damping(p.kn, m_eff, p.restitution)
    f_n_mag = torch.clamp(p.kn * overlap - cn * v_n, min=0.0)
    f_n = tuple(f_n_mag * c for c in n)

    # the stored spring rotated into the current tangent plane, plus this
    # step's tangential sliding
    xi_n = xi[0] * n[0] + xi[1] * n[1] + xi[2] * n[2]
    xi_acc = tuple(xi[k] - xi_n * n[k] + v_t[k] * dt for k in range(3))
    kt = p.kt_over_kn * p.kn
    ct = _normal_damping(kt, m_eff, p.restitution)
    f_t_trial = tuple(-kt * xi_acc[k] - ct * v_t[k] for k in range(3))
    f_t_mag = torch.sqrt(f_t_trial[0] * f_t_trial[0] + f_t_trial[1] * f_t_trial[1]
                         + f_t_trial[2] * f_t_trial[2])
    cap = p.friction * f_n_mag
    over = f_t_mag > torch.clamp(cap, min=1e-30)
    scale = torch.where(over, cap / torch.clamp(f_t_mag, min=1e-30), torch.ones_like(cap))
    f_t = tuple(c * scale for c in f_t_trial)
    # slip: the spring relaxes to the Coulomb cone; sticking keeps it
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    xi_new = tuple(torch.where(touching, torch.where(over, -f_t[k] / kt, xi_acc[k]), zero)
                   for k in range(3))
    f = tuple(torch.where(touching, f_n[k] + f_t[k], zero) for k in range(3))
    torque = tuple(torch.where(touching, c, zero) for c in _cross_cm(ci, f_t))
    return f, torque, xi_new


def allpairs_contact_forces(pos, vel, angvel, radius, active, grid: Grid, cfg: DEMConfig):
    """Exact O(N^2) contact sums: every pair's force in (N, N) component
    arrays, summed over partners."""
    N = pos.shape[0]
    p = cfg.params
    m = particle_mass(radius, p.rho_p)
    dx = _min_image(pos[:, None, :] - pos[None, :, :], grid, cfg.periodic)
    valid = active[:, None] & active[None, :] & ~torch.eye(N, dtype=torch.bool,
                                                           device=pos.device)
    f, t = _pair_force_cm(
        tuple(dx[..., c] for c in range(3)),
        tuple(vel[:, None, c] for c in range(3)), tuple(vel[None, :, c] for c in range(3)),
        tuple(angvel[:, None, c] for c in range(3)),
        tuple(angvel[None, :, c] for c in range(3)),
        radius[:, None], radius[None, :], m[:, None], m[None, :], p, valid)
    return (torch.stack([torch.sum(c, dim=1) for c in f], dim=-1),
            torch.stack([torch.sum(c, dim=1) for c in t], dim=-1))


def _min_image(dx: torch.Tensor, grid: Grid, periodic) -> torch.Tensor:
    L = host_tensor(grid.lengths, dtype=dx.dtype, device=dx.device)
    per = host_tensor(periodic, device=dx.device)
    wrapped = dx - L * torch.round(dx / L)
    return torch.where(per, wrapped, dx)


def _float_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Floating modulo with the sign of the divisor, computed as
    `jnp.mod` does (truncated remainder, then shifted by y)."""
    r = torch.fmod(x, y)
    shift = ((r < 0) != (y < 0)) & (r != 0)
    return torch.where(shift, r + y, r)


def _check_periodic_bins(dims, cfg: DEMConfig) -> None:
    """Fewer than 3 bins on a periodic axis would alias neighbour bins and
    double-count contacts."""
    for a in range(3):
        if cfg.periodic[a] and dims[a] < 3:
            raise ValueError(
                f"periodic axis {a} has only {dims[a]} DEM hash bins "
                f"(domain < 6*r_max*(1+skin)): neighbor bins would alias and "
                f"double-count contacts. Use neighbor='allpairs' for this case.")


def _dem_cell_grid(grid: Grid, r_max: float):
    """Hash-cell counts and sizes: cells at least 2*r_max wide."""
    dims, sizes = [], []
    for a in range(3):
        L = grid.lengths[a]
        n = max(1, int(np.floor(L / max(2.0 * r_max, 1e-12))))
        dims.append(n)
        sizes.append(L / n)
    return tuple(dims), tuple(sizes)


def _list_forces(cand, self_idx, pos, vel, angvel, radius, active, grid: Grid,
                 cfg: DEMConfig, xi=None, dt=None):
    """Pair forces of every particle against its (N, K) candidate ids (N =
    empty): one 11-channel row gather of N * K rows, transposed once to
    (11, K, N) so that every pair formula runs on (K, N) component arrays;
    with ``xi`` (N, K, 3) the history spring, transposed the same way, and
    its update as a third output. ``self_idx`` (N, 1) masks a particle's own
    id where the candidates can hold it."""
    N = pos.shape[0]
    p = cfg.params
    data = torch.cat([pos, vel, angvel, radius[:, None],
                      active.to(pos.dtype)[:, None]], dim=-1)
    data = torch.cat([data, torch.zeros((1, 11), dtype=data.dtype, device=data.device)])
    djT = data[cand.to(torch.int64)].permute(2, 1, 0)   # (11, K, N)
    pos_j = (djT[0], djT[1], djT[2])
    vel_j = (djT[3], djT[4], djT[5])
    ang_j = (djT[6], djT[7], djT[8])
    rad_j, act_j = djT[9], djT[10] > 0.5
    m_j = particle_mass(torch.clamp(rad_j, min=1e-12), p.rho_p)
    m_b = particle_mass(radius, p.rho_p)
    valid = act_j & active[None, :] & (cand.T != N)
    if self_idx is not None:
        valid = valid & (cand.T != self_idx.T)
    L = grid.lengths
    dx = []
    for c in range(3):
        d = pos[:, c][None, :] - pos_j[c]
        if cfg.periodic[c]:
            d = d - L[c] * torch.round(d / L[c])
        dx.append(d)
    args = (tuple(dx),
            tuple(vel[:, c][None, :] for c in range(3)), vel_j,
            tuple(angvel[:, c][None, :] for c in range(3)), ang_j,
            radius[None, :], rad_j, m_b[None, :], m_j, p, valid)
    if xi is None:
        f, t = _pair_force_cm(*args)
    else:
        xiT = xi.permute(2, 1, 0)                       # (3, K, N)
        f, t, xi_n = _pair_force_shear_cm(*args, (xiT[0], xiT[1], xiT[2]), dt)
    fs = torch.stack([torch.sum(c, dim=0) for c in f], dim=-1)
    ts = torch.stack([torch.sum(c, dim=0) for c in t], dim=-1)
    if xi is None:
        return fs, ts
    return fs, ts, torch.stack(xi_n).permute(2, 1, 0).contiguous()


def cell_list_contact_forces(pos, vel, angvel, radius, active, grid: Grid,
                             cfg: DEMConfig, r_max: float):
    """O(N * 27 * capacity) contact forces through uniform hash cells at
    least 2 r_max wide: a stable sort by cell, a (ncell + 1, cap) table
    (particles past ``cell_capacity`` dropped; N = empty), and each
    particle's 27 neighbour cells' slots as its candidates."""
    N = pos.shape[0]
    cap = cfg.cell_capacity
    dev = pos.device
    dims, sizes = _dem_cell_grid(grid, r_max)
    _check_periodic_bins(dims, cfg)
    ncell = dims[0] * dims[1] * dims[2]

    origin = host_tensor(grid.origin, dtype=pos.dtype, device=dev)
    csz = host_tensor(sizes, dtype=pos.dtype, device=dev)
    nvec = host_tensor(dims, dtype=torch.int32, device=dev)
    ijk = torch.floor((pos - origin) / csz).to(torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), nvec - 1)
    cell = ijk[:, 0] * (dims[1] * dims[2]) + ijk[:, 1] * dims[2] + ijk[:, 2]
    cell = torch.where(active, cell, ncell)          # inactive: the scrap cell

    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    idx_in_cell = rank_in_sorted_segments(cell_sorted)
    keep = idx_in_cell < cap
    slot = cell_sorted.to(torch.int64) * cap + torch.clamp(idx_in_cell, max=cap - 1)
    table = torch.full(((ncell + 1) * cap,), N, dtype=torch.int32, device=dev)
    table[torch.where(keep, slot, (ncell + 1) * cap - 1)] = torch.where(
        keep, order.to(torch.int32), N)
    table = table.reshape(ncell + 1, cap)

    offs = host_tensor(np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                            indexing="ij"), -1).reshape(-1, 3),
                       dtype=torch.int32, device=dev)
    nb = ijk[:, None, :] + offs[None, :, :]          # (N, 27, 3)
    per = host_tensor(cfg.periodic, device=dev)
    nb_wrapped = torch.remainder(nb, nvec)
    in_rng = torch.all(((nb >= 0) & (nb < nvec)) | per, dim=-1)
    nb_cell = (nb_wrapped[..., 0] * (dims[1] * dims[2]) + nb_wrapped[..., 1] * dims[2]
               + nb_wrapped[..., 2])
    nb_cell = torch.where(in_rng, nb_cell, ncell)
    cand = table[nb_cell.to(torch.int64)].reshape(N, 27 * cap)
    self_idx = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    return _list_forces(cand, self_idx, pos, vel, angvel, radius, active, grid, cfg)


# ---------------------------------------------------------------------------
# Verlet neighbor lists
# ---------------------------------------------------------------------------

def drift_since(pos, ref_pos, active, grid: Grid, periodic) -> torch.Tensor:
    """(N,) max-norm per-particle displacement since ``ref_pos``, with the
    minimum-image distance on periodic axes."""
    d = torch.abs(pos - ref_pos)
    comps = []
    for a in range(3):
        da = d[:, a]
        if periodic[a]:
            da = torch.minimum(da, grid.lengths[a] - da)
        comps.append(da)
    d = torch.stack(comps, dim=-1)
    return torch.where(active, torch.amax(d, dim=-1), torch.zeros((), dtype=d.dtype, device=d.device))


def effective_bin_size(grid: Grid, cfg: DEMConfig, r_max: float) -> float:
    """The hash-bin size `build_neighbor_list` uses: 2*r_max*(1+skin),
    enlarged when the bin count would exceed `max_bins`."""
    bin_size = 2.0 * r_max * (1.0 + cfg.skin)
    vol = grid.lengths[0] * grid.lengths[1] * grid.lengths[2]
    if vol / bin_size ** 3 > cfg.max_bins:
        bin_size = float(np.cbrt(vol / cfg.max_bins))
    return bin_size


_HIGH = 1 << 21   # composite top_k key: validity bit above the particle id


def _compact(key: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """Keep the M largest composite keys (valid ids first, descending id)
    and decode them: the `lax.top_k` compaction of the JAX package."""
    top = torch.topk(key, M, dim=1, largest=True, sorted=True).values
    return torch.where(top >= _HIGH, top - _HIGH, torch.full_like(top, N))


def build_neighbor_list(pos, active, grid: Grid, cfg: DEMConfig, r_max: float,
                        return_overflow: bool = False):
    """(N, max_neighbors) int32 candidate indices (N = empty slot), and with
    ``return_overflow`` an int32 count of dropped candidates: particles
    beyond ``cell_capacity`` in their bin plus candidates truncated by the
    ``max_neighbors`` (and ``refined_neighbors``) compaction.

    One path: a (nbin, 27 * cap) candidate table built from 27 rolls of the
    bin table, walked in bin-sorted order, compacted by top_k on the key
    id + 2^21 so that the largest valid ids survive in descending order."""
    N = pos.shape[0]
    cap = cfg.cell_capacity
    M = cfg.max_neighbors
    if N >= _HIGH:
        raise ValueError("top_k composite key supports < 2M particles")
    dev = pos.device
    bin_size = effective_bin_size(grid, cfg, r_max)
    dims, sizes = [], []
    for a in range(3):
        L = grid.lengths[a]
        n = max(1, int(np.floor(L / max(bin_size, 1e-12))))
        dims.append(n)
        sizes.append(L / n)
    _check_periodic_bins(dims, cfg)
    bx, by, bz = dims
    nbin = bx * by * bz

    origin = host_tensor(grid.origin, dtype=pos.dtype, device=dev)
    csz = host_tensor(sizes, dtype=pos.dtype, device=dev)
    nvec = host_tensor(dims, dtype=torch.int32, device=dev)
    ijk = torch.floor((pos - origin) / csz).to(torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), nvec - 1)
    bin_of = ijk[:, 0] * (by * bz) + ijk[:, 1] * bz + ijk[:, 2]
    bin_of = torch.where(active, bin_of, nbin)

    order = torch.argsort(bin_of, stable=True)
    bin_sorted = bin_of[order]
    rank = rank_in_sorted_segments(bin_sorted)
    keep = rank < cap
    n_bin_drop = torch.sum(((rank >= cap) & (bin_sorted < nbin)).to(torch.int32))

    # bin-major flat slot table (bin*cap + rank), N = empty
    slot = torch.clamp(bin_sorted, 0, nbin).to(torch.int64) * cap \
        + torch.clamp(rank, max=cap - 1).to(torch.int64)
    table_flat = torch.full(((nbin + 1) * cap,), N, dtype=torch.int32, device=dev)
    table_flat[torch.where(keep, slot, (nbin + 1) * cap - 1)] = torch.where(
        keep, order.to(torch.int32), N)

    # 27 rolls of the bin table (cap fused into the z axis) -> one candidate
    # row of 27 * cap ids per bin
    offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                indexing="ij"), -1).reshape(-1, 3)
    tbl = table_flat[: nbin * cap].reshape(bx, by, bz * cap)
    cand_rows = torch.stack([
        torch.roll(tbl, (-int(o[0]), -int(o[1]), -int(o[2]) * cap),
                   dims=(0, 1, 2)).reshape(-1)
        for o in offs
    ]).T.reshape(nbin, cap * 27)

    act_s = active[order]
    self_s = order.to(torch.int32)[:, None]
    cand_s = cand_rows[torch.clamp(bin_sorted, max=nbin - 1).to(torch.int64)]
    valid = (cand_s != N) & (cand_s != self_s) & act_s[:, None]
    nbr_s = _compact(torch.where(valid, cand_s + _HIGH, 0), M, N)
    trunc = torch.sum(torch.clamp(torch.sum(valid.to(torch.int32), dim=1) - M, min=0))

    if 0 < cfg.refined_neighbors < M:
        if not cfg.list_margin_factor > 0:
            raise ValueError("refined_neighbors needs the Verlet-skin margin "
                             "(list_margin_factor > 0)")
        # keep only candidates reachable before the next rebuild
        margin = cfg.list_margin_factor * (bin_size - 2.0 * r_max)
        cutoff = 2.0 * r_max + 2.0 * margin
        Mr = cfg.refined_neighbors
        posx = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype, device=dev)])
        dxp = pos[order][:, None, :] - posx[nbr_s.to(torch.int64)]
        dxp = _min_image(dxp, grid, cfg.periodic)
        d2 = dxp[..., 0] * dxp[..., 0] + dxp[..., 1] * dxp[..., 1] + dxp[..., 2] * dxp[..., 2]
        within = (nbr_s != N) & (d2 <= cutoff * cutoff)
        nbr_s = _compact(torch.where(within, nbr_s + _HIGH, 0), Mr, N)
        trunc = trunc + torch.sum(torch.clamp(
            torch.sum(within.to(torch.int32), dim=1) - Mr, min=0))

    nbr = nbr_s[torch.argsort(order, stable=True)]
    if return_overflow:
        return nbr, (n_bin_drop + trunc).to(torch.int32)
    return nbr


def neighbor_contact_forces(nbr, pos, vel, angvel, radius, active, grid: Grid,
                            cfg: DEMConfig, xi=None, dt=None):
    """Pair forces against a fixed candidate list (`_list_forces`). With
    ``xi`` (N, M, 3) and ``dt`` the tangential force is the history spring
    and the updated springs are a third output."""
    return _list_forces(nbr, None, pos, vel, angvel, radius, active, grid, cfg, xi, dt)


def wall_contact_forces(pos, vel, angvel, radius, active, grid: Grid,
                        cfg: DEMConfig, xi_wall=None, dt=None):
    """Contacts with the domain box faces on non-periodic wall axes
    (spring-dashpot + Coulomb friction against infinite-mass planes). With
    ``xi_wall`` (N, 3, 3) and ``dt`` the tangential force is the history
    spring, one per axis, and the updated springs are a third output."""
    p = cfg.params
    dev, dt_ = pos.device, pos.dtype
    m = particle_mass(radius, p.rho_p)
    cn = _normal_damping(p.kn, m, p.restitution)            # m_eff = m (wall)
    kt = p.kt_over_kn * p.kn
    ct = torch.sqrt(kt * m)
    lo = host_tensor(grid.origin, dtype=dt_, device=dev)
    hi = host_tensor(grid.upper, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)

    f_total = torch.zeros_like(pos)
    t_total = torch.zeros_like(pos)
    xi_out = None if xi_wall is None else xi_wall.clone()   # updated per axis
    for axis in range(3):
        if not cfg.wall_axes[axis] or cfg.periodic[axis]:
            continue
        x = pos[:, axis]
        gap_lo = x - lo[axis]
        gap_hi = hi[axis] - x
        at_lo = gap_lo <= gap_hi
        gap = torch.where(at_lo, gap_lo, gap_hi)
        sgn = torch.where(at_lo, 1.0, -1.0).to(dt_)
        overlap = radius - gap
        touching = active & (overlap > 0.0)

        v_n = sgn * vel[:, axis]
        f_n_mag = torch.clamp(p.kn * overlap - cn * v_n, min=0.0)
        f_n_mag = torch.where(touching, f_n_mag, zero)

        e = torch.zeros((1, 3), dtype=dt_, device=dev)
        with annotate("yofc:sync.h2d"):
            e[0, axis] = 1.0        # one element from the host: a blocking copy
        n_vec = e * sgn[:, None]
        c_vec = -radius[:, None] * n_vec
        v_surf = vel + _cross(angvel, c_vec)
        v_t = v_surf - (torch.sum(v_surf * n_vec, -1))[:, None] * n_vec
        cap = p.friction * f_n_mag
        if xi_wall is None:
            f_t = -ct[:, None] * v_t
            f_t_mag = _norm3(f_t)
            scale = torch.where(
                f_t_mag > 1e-30,
                torch.clamp(cap / torch.clamp(f_t_mag, min=1e-30), max=1.0), zero)
            f_t = f_t * torch.where(touching, scale, zero)[:, None]
        else:
            # the wall normal is axis-aligned: drop the spring's normal part
            xi_t = xi_out[:, axis].clone()
            xi_t[:, axis] = 0.0
            xi_acc = xi_t + v_t * dt
            ct_t = _normal_damping(kt, m, p.restitution)     # m_eff = m
            f_t_trial = -kt * xi_acc - ct_t[:, None] * v_t
            f_t_mag = _norm3(f_t_trial)
            over = f_t_mag > torch.clamp(cap, min=1e-30)
            scale = torch.where(over, cap / torch.clamp(f_t_mag, min=1e-30),
                                torch.ones_like(cap))
            f_t = f_t_trial * torch.where(touching, scale, zero)[:, None]
            xi_upd = torch.where(over[:, None], -f_t / kt, xi_acc)
            xi_out[:, axis] = torch.where(touching[:, None], xi_upd, zero)

        f_total = f_total + (f_n_mag[:, None] * n_vec + f_t)
        t_total = t_total + _cross(c_vec, f_t)
    if xi_wall is None:
        return f_total, t_total
    return f_total, t_total, xi_out


# ---------------------------------------------------------------------------
# Integration
# ---------------------------------------------------------------------------

class DEMForces(NamedTuple):
    force: torch.Tensor    # (N,3) external (hydro) force, constant over substeps
    torque: torch.Tensor   # (N,3)


def contact_forces(pos, vel, angvel, radius, active, grid, cfg: DEMConfig,
                   r_max: float, nbr=None):
    if nbr is not None:
        fc, tc = neighbor_contact_forces(nbr, pos, vel, angvel, radius, active, grid, cfg)
    elif cfg.neighbor == "allpairs":
        fc, tc = allpairs_contact_forces(pos, vel, angvel, radius, active, grid, cfg)
    elif cfg.neighbor == "cells":
        fc, tc = cell_list_contact_forces(pos, vel, angvel, radius, active, grid, cfg, r_max)
    else:
        raise ValueError(f"unknown neighbor mode {cfg.neighbor!r}")
    fw, tw = wall_contact_forces(pos, vel, angvel, radius, active, grid, cfg)
    return fc + fw, tc + tw


def dem_substeps(pos, vel, angvel, radius, active, hydro: DEMForces,
                 grid: Grid, cfg: DEMConfig, dt_dem, n_sub: int, r_max: float,
                 shear: Optional[ShearState] = None, pid=None, nbr=None,
                 carried: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 dt_seq=None):
    """Advance the DEM state n_sub velocity-Verlet substeps under a constant
    hydro force. Returns (pos, vel, angvel, n_overflow); with
    ``cfg.shear_history`` (``shear`` the previous ShearState, ``pid`` the
    partner keys) also the updated ShearState; with ``cfg.carry_contact``
    (substep mode) also the contact force/torque of the last evaluation
    (the ``carried`` input of the next call).

    With a prebuilt Verlet list ``nbr`` it is used as it is and n_overflow
    is 0 (the build that produced the list counted its own drops); without
    one, ``neighbor="cells"`` builds a list at the start of every chunk of
    ``list_rebuild_every`` substeps (one chunk by default) and n_overflow is
    the largest build's drop count, and ``"allpairs"`` uses all pairs.
    ``contact_mode="step"`` holds each chunk's first contact force over the
    chunk. ``dt_seq`` (n_sub,) gives every substep its own dt in place of
    ``dt_dem``: a zero-dt substep leaves pos/vel/angvel bit-identical, and
    also keeps the shear springs and the carried force of the last live
    substep, as in the JAX package; no element is read on the host."""
    p = cfg.params
    dev = pos.device
    N = pos.shape[0]
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    m = particle_mass(radius, p.rho_p)
    inertia = particle_inertia(radius, p.rho_p)
    g = host_tensor(cfg.gravity, dtype=pos.dtype, device=dev)
    vol = (4.0 / 3.0) * math.pi * radius ** 3
    f_grav = m[:, None] * g[None, :]
    if cfg.buoyancy:
        f_grav = f_grav - cfg.rho_f * vol[:, None] * g[None, :]
    zero = torch.zeros((), dtype=pos.dtype, device=dev)
    inv_m = torch.where(active, 1.0 / m, zero)[:, None]
    inv_I = torch.where(active, 1.0 / inertia, zero)[:, None]
    lo = host_tensor(grid.origin, dtype=pos.dtype, device=dev)
    L = host_tensor(grid.lengths, dtype=pos.dtype, device=dev)
    per = host_tensor(cfg.periodic, device=dev)

    def damp(f, v):
        # Cundall non-viscous damping (Yade NewtonIntegrator::damping)
        d = cfg.cundall_damping
        if d == 0.0:
            return f
        return f * (1.0 - d * torch.sign(f * v))

    def accel(fc, tc, vel_, ang_):
        return (damp(fc + f_grav + hydro.force, vel_) * inv_m,
                damp(tc + hydro.torque, ang_) * inv_I)

    def drift(pos_, vel_, ang_, a, aw, dt_):
        """The first half of a substep: half-kick, drift, periodic wrap."""
        vel_h = vel_ + 0.5 * dt_ * a
        ang_h = ang_ + 0.5 * dt_ * aw
        pos_n = pos_ + dt_ * vel_h
        return torch.where(per, lo + _float_mod(pos_n - lo, L), pos_n), vel_h, ang_h

    use_list = cfg.neighbor == "cells"
    every = n_sub
    if nbr is None and use_list and cfg.list_rebuild_every > 0:
        every = min(cfg.list_rebuild_every, n_sub)
    n_chunks, rem = divmod(n_sub, every)
    if rem:
        raise ValueError(f"n_sub={n_sub} not divisible by list_rebuild_every={every}")
    masked = dt_seq is not None
    dts = list(dt_seq.unbind(0)) if masked else [dt_dem] * n_sub
    if len(dts) != n_sub:
        raise ValueError(f"dt_seq has {len(dts)} entries for {n_sub} substeps")

    def chunk_list(pos_):
        if nbr is not None:
            return nbr, izero
        if use_list:
            return build_neighbor_list(pos_, active, grid, cfg, r_max, return_overflow=True)
        return None, izero

    overflows = []
    if cfg.shear_history:
        if not (use_list and cfg.contact_mode == "substep"):
            raise ValueError("shear_history requires neighbor='cells', contact_mode='substep'")
        if shear is None:
            raise ValueError("shear_history: pass the previous ShearState")

        def eval_h(nbr_c, pos_, vel_, ang_, xi_, xw_, dt_):
            fc, tc, xi2 = neighbor_contact_forces(nbr_c, pos_, vel_, ang_, radius, active,
                                                  grid, cfg, xi_, dt_)
            fw, tw, xw2 = wall_contact_forces(pos_, vel_, ang_, radius, active, grid, cfg,
                                              xw_, dt_)
            return (*accel(fc + fw, tc + tw, vel_, ang_), xi2, xw2)

        for c in range(n_chunks):
            nbr_c, ov = chunk_list(pos)
            overflows.append(ov)
            keys = shear_keys(nbr_c, N, pid)
            # dt = 0: the force at the current state, springs projected only
            a, aw, xi, xw = eval_h(nbr_c, pos, vel, angvel, carry_shear(shear, keys),
                                   shear.xi_wall, 0.0)
            for dt_ in dts[c * every:(c + 1) * every]:
                pos, vel_h, ang_h = drift(pos, vel, angvel, a, aw, dt_)
                a, aw, xi2, xw2 = eval_h(nbr_c, pos, vel_h, ang_h, xi, xw, dt_)
                if masked:
                    # a zero-dt substep keeps the springs of the last live one
                    live = dt_ > 0
                    xi2, xw2 = torch.where(live, xi2, xi), torch.where(live, xw2, xw)
                xi, xw = xi2, xw2
                vel = vel_h + 0.5 * dt_ * a
                angvel = ang_h + 0.5 * dt_ * aw
            shear = ShearState(xi, keys, xw)
        return pos, vel, angvel, torch.stack(overflows).amax(), shear

    if cfg.carry_contact and cfg.contact_mode == "substep":
        if carried is not None:
            fc, tc = carried
        else:
            nbr0 = nbr if nbr is not None or not use_list else build_neighbor_list(
                pos, active, grid, cfg, r_max)
            fc, tc = contact_forces(pos, vel, angvel, radius, active, grid, cfg, r_max, nbr0)
        for c in range(n_chunks):
            nbr_c, ov = chunk_list(pos)
            overflows.append(ov)
            # a0 from the carried contact force: no evaluation
            a, aw = accel(fc, tc, vel, angvel)
            for dt_ in dts[c * every:(c + 1) * every]:
                pos, vel_h, ang_h = drift(pos, vel, angvel, a, aw, dt_)
                fc2, tc2 = contact_forces(pos, vel_h, ang_h, radius, active, grid, cfg,
                                          r_max, nbr_c)
                if masked:
                    # a zero-dt substep keeps the last live evaluation
                    live = dt_ > 0
                    fc2, tc2 = torch.where(live, fc2, fc), torch.where(live, tc2, tc)
                fc, tc = fc2, tc2
                a, aw = accel(fc, tc, vel_h, ang_h)
                vel = vel_h + 0.5 * dt_ * a
                angvel = ang_h + 0.5 * dt_ * aw
        return pos, vel, angvel, torch.stack(overflows).amax(), fc, tc

    for c in range(n_chunks):
        nbr_c, ov = chunk_list(pos)
        overflows.append(ov)
        held = (contact_forces(pos, vel, angvel, radius, active, grid, cfg, r_max, nbr_c)
                if cfg.contact_mode == "step" else None)

        def forces(pos_, vel_, ang_):
            return held if held is not None else contact_forces(
                pos_, vel_, ang_, radius, active, grid, cfg, r_max, nbr_c)

        a, aw = accel(*forces(pos, vel, angvel), vel, angvel)
        for dt_ in dts[c * every:(c + 1) * every]:
            pos, vel_h, ang_h = drift(pos, vel, angvel, a, aw, dt_)
            a, aw = accel(*forces(pos, vel_h, ang_h), vel_h, ang_h)
            vel = vel_h + 0.5 * dt_ * a
            angvel = ang_h + 0.5 * dt_ * aw
    return pos, vel, angvel, torch.stack(overflows).amax()


def critical_dt(radius_min: float, params: ContactParams) -> float:
    """Rayleigh-style critical DEM time step: dt_c ~ sqrt(m_min/kn) * safety."""
    m_min = float(params.rho_p * (4.0 / 3.0) * np.pi * radius_min ** 3)
    return 0.2 * float(np.sqrt(m_min / params.kn))


def critical_dt_dynamic(radius, active, params: ContactParams) -> torch.Tensor:
    """`critical_dt` of the smallest active radius, as a 0-d tensor on the
    radii's device (1.0 m when no particle is active): the bound the
    coupled step clamps the adaptive fluid dt to and divides it by for the
    dynamic substep count."""
    inf = torch.full((), math.inf, dtype=radius.dtype, device=radius.device)
    r_min = torch.amin(torch.where(active, radius, inf))
    r_min = torch.where(torch.isfinite(r_min), r_min, torch.ones_like(r_min))
    m_min = params.rho_p * (4.0 / 3.0) * math.pi * r_min ** 3
    return 0.2 * torch.sqrt(m_min / params.kn)
