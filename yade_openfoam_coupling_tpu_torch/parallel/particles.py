"""Sharded particle arrays: slab ownership, ring migration, DEM ghosts
(port of `yade_openfoam_coupling_tpu/parallel/particles.py`).

* Every rank owns the particles whose base cell lies in its x-slab and
  holds them in a fixed-capacity slot array (``cap_loc`` slots,
  active-masked).
* After the DEM substeps, particles that left their slab ride one ring
  hop per step toward their owner (`migrate`: fixed-size buffers, overflow
  counted; an unsent particle stays and retries next step).
* DEM contact partners within reach of the slab boundary are mirrored as
  ghosts every substep (`GhostPlan`: the ghost set is fixed per fluid step
  so Verlet-list slots stay valid; the ghost values refresh per substep,
  which makes the sharded trajectories equal the single-device ones).

Selections are `topk` compactions on the key ``index + 2^24`` (the JAX
package's `lax.top_k`: the selected rows in descending index order), and
transfers are `ctx.ring_exchange`s of small (K, C) float buffers; pids
travel as float32, exact below 2^24.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models.fields import ParticleState
from ..ops import dem as demod
from ..ops.grid import Grid
from .ctx import ring_exchange

_HIGH = 1 << 24   # selection key high bit; per-rank capacity < 16M


def _select_rows(mask: torch.Tensor, K: int):
    """Up to K set rows of ``mask``: (ids (K,), valid (K,), n_unselected).
    Valid entries come first, in descending row order (top-k of a
    high-bit key); invalid ids are N."""
    N = mask.shape[0]
    key = torch.where(mask, torch.arange(N, dtype=torch.int32, device=mask.device) + _HIGH,
                      torch.zeros((), dtype=torch.int32, device=mask.device))
    top = torch.topk(key, K, largest=True, sorted=True).values
    valid = top >= _HIGH
    ids = torch.where(valid, top - _HIGH, torch.full_like(top, N)).to(torch.int64)
    n_over = torch.sum(mask.to(torch.int32)) - torch.sum(valid.to(torch.int32))
    return ids, valid, n_over


def _rows(arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows with one scrap row appended (ids == len(arr) -> zeros)."""
    pad = torch.zeros((1,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])[ids]


def _put(dst: torch.Tensor, tgt: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with rows ``tgt`` set to ``src``; rows aimed at len(dst) drop."""
    N = dst.shape[0]
    pad = torch.zeros((1,) + tuple(dst.shape[1:]), dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, pad])
    out[tgt] = src.to(dst.dtype)
    return out[:N]


class SlabGeom(NamedTuple):
    """Static geometry of this rank's x-slab: its width in cells and the
    mesh (rank, size, group); ``timer``, a `utils.profiling.PhaseTimer`,
    takes the ghost refreshes' synchronised time."""

    n_loc: int
    mesh: Any
    timer: Any = None


def _slab_bounds(grid: Grid, geom: SlabGeom):
    """The slab's x extent [x_lo, x_hi) as float32, by the JAX package's
    float32 operations."""
    f32 = np.float32
    hx = grid.spacing[0]
    x_lo = f32(grid.origin[0]) + (f32(geom.mesh.rank) * f32(geom.n_loc)) * f32(hx)
    return x_lo, x_lo + f32(geom.n_loc * hx)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------

def migrate(ps: ParticleState, grid: Grid, geom: SlabGeom, K: int):
    """One ring-migration step: particles outside their owner slab hop one
    rank toward it (several steps for several hops; while in transit they
    are DEM-active but uncoupled). -> (ps_new, n_overflow): buffer-overflow
    particles stay behind to retry, arrivals that found no free slot are
    dropped, and both are counted (this rank's count; the caller reduces)."""
    mesh = geom.mesh
    n_sh, idx = mesh.size, mesh.rank
    n_loc = geom.n_loc
    hx = grid.spacing[0]
    nx_glob = n_loc * n_sh
    dev = ps.pos.device

    cellx = torch.floor((ps.pos[:, 0] - grid.origin[0]) / hx).to(torch.int32)
    cellx = torch.clamp(cellx, 0, nx_glob - 1)     # out-of-domain stays at edges
    slab = torch.div(cellx, n_loc, rounding_mode="floor")
    d = torch.remainder(slab - idx, n_sh)          # hops to the right to reach the owner
    act = ps.active
    go_right = act & (d >= 1) & (d <= n_sh // 2)
    go_left = act & (d > n_sh // 2)

    ids_r, val_r, over_r = _select_rows(go_right, K)
    ids_l, val_l, over_l = _select_rows(go_left, K)

    has_shear = ps.shear_xi is not None
    fparts = [ps.pos, ps.vel, ps.angvel, ps.radius[:, None]]
    if has_shear:
        Np, M = ps.shear_ids.shape
        fparts += [ps.shear_xi.reshape(Np, 3 * M), ps.shear_wall.reshape(Np, 9),
                   ps.shear_ids.to(ps.pos.dtype)]    # pid keys fit f32 ints
    # one float message a direction: payload, pid, valid
    payload = torch.cat(fparts + [ps.pid.to(ps.pos.dtype)[:, None]], dim=-1)
    N = payload.shape[0]
    C = payload.shape[1]

    def outgoing(ids, valid):
        return torch.cat([_rows(payload, ids), valid.to(payload.dtype)[:, None]], dim=-1)

    from_left, from_right = ring_exchange(mesh, [outgoing(ids_r, val_r)],
                                          [outgoing(ids_l, val_l)])

    # deactivate the rows actually sent
    sent = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    sent[torch.where(val_r, ids_r, N)] = True
    sent[torch.where(val_l, ids_l, N)] = True
    active = act & ~sent[:N]

    arr = torch.cat([from_left[0], from_right[0]])      # (2K, C + 1)
    arr_buf = arr[:, :C - 1]
    arr_pid = arr[:, C - 1].to(torch.int32)
    arr_val = arr[:, C] > 0.5

    # place arrivals into free slots (valid-first on both sides)
    free_ids, free_ok, _ = _select_rows(~active, 2 * K)
    order = torch.argsort((~arr_val).to(torch.int32), stable=True)
    arr_buf, arr_pid, arr_val = arr_buf[order], arr_pid[order], arr_val[order]
    place_ok = arr_val & free_ok
    tgt = torch.where(place_ok, free_ids, N)
    n_dropped = torch.sum((arr_val & ~free_ok).to(torch.int32))

    kw = {}
    if has_shear:
        kw = dict(
            shear_xi=_put(ps.shear_xi, tgt, arr_buf[:, 10:10 + 3 * M].reshape(-1, M, 3)),
            shear_wall=_put(ps.shear_wall, tgt, arr_buf[:, 10 + 3 * M:19 + 3 * M].reshape(-1, 3, 3)),
            shear_ids=_put(ps.shear_ids, tgt, arr_buf[:, 19 + 3 * M:].to(torch.int32)),
        )
    ps_new = ParticleState(
        pos=_put(ps.pos, tgt, arr_buf[:, 0:3]),
        vel=_put(ps.vel, tgt, arr_buf[:, 3:6]),
        angvel=_put(ps.angvel, tgt, arr_buf[:, 6:9]),
        radius=_put(ps.radius, tgt, arr_buf[:, 9]),
        active=_put(active, tgt, place_ok),
        pid=_put(ps.pid, tgt, arr_pid),
        **kw,
    )
    return ps_new, (over_r + over_l + n_dropped).to(torch.int32)


# ---------------------------------------------------------------------------
# DEM ghosts
# ---------------------------------------------------------------------------

class GhostPlan(NamedTuple):
    """Fixed ghost set for one fluid step: which local rows mirror to each
    neighbour (ids/valid), and the wrap shift applied to their x."""

    ids_lo: torch.Tensor    # (K,) rows sent to the LEFT neighbour
    val_lo: torch.Tensor
    ids_hi: torch.Tensor    # rows sent to the RIGHT neighbour
    val_hi: torch.Tensor
    shift_lo: float         # x shift applied when sending left
    shift_hi: float
    n_overflow: torch.Tensor


def plan_ghosts(pos, active, grid: Grid, geom: SlabGeom, gw: float,
                periodic_x: bool, K: int) -> GhostPlan:
    """Select the boundary-zone particles (width ``gw``) once per fluid step."""
    n_sh, idx = geom.mesh.size, geom.mesh.rank
    x_lo, x_hi = _slab_bounds(grid, geom)
    f32 = np.float32
    near_lo = active & (pos[:, 0] < float(x_lo + f32(gw)))
    near_hi = active & (pos[:, 0] >= float(x_hi - f32(gw)))
    if not periodic_x:
        near_lo = near_lo & (idx > 0)
        near_hi = near_hi & (idx < n_sh - 1)
    ids_lo, val_lo, over_lo = _select_rows(near_lo, K)
    ids_hi, val_hi, over_hi = _select_rows(near_hi, K)
    # crossing the periodic wrap: shift so the receiver sees contiguous x
    L = float(f32(grid.lengths[0]))
    shift_lo = L if periodic_x and idx == 0 else 0.0
    shift_hi = -L if periodic_x and idx == n_sh - 1 else 0.0
    return GhostPlan(ids_lo, val_lo, ids_hi, val_hi, shift_lo, shift_hi,
                     (over_lo + over_hi).to(torch.int32))


def fetch_ghosts(plan: GhostPlan, pos, vel, angvel, radius, geom: SlabGeom, pid=None):
    """Exchange the current values of the planned ghost set: (2K, ...)
    arrays, the left neighbour's rows first. Called every substep so the
    ghosts track their owners exactly. With ``pid`` also the ghosts'
    stable pids (shear-history keys; -1 where invalid)."""
    parts = [pos, vel, angvel, radius[:, None]]
    if pid is not None:
        parts.append(pid.to(pos.dtype)[:, None])    # pids < 2^24 carry exactly in f32
    buf = torch.cat(parts, dim=-1)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    def pack(ids, valid, shift):
        rows = _rows(buf, ids)
        x = rows[:, 0] + torch.where(valid, torch.full_like(zero, shift), zero)
        return torch.cat([x[:, None], rows[:, 1:], valid.to(pos.dtype)[:, None]], dim=-1)

    # to the left = backward; to the right = forward
    with (contextlib.nullcontext() if geom.timer is None
          else geom.timer.phase("ghosts", block_on=pos)):
        from_left, from_right = ring_exchange(
            geom.mesh, [pack(plan.ids_hi, plan.val_hi, plan.shift_hi)],
            [pack(plan.ids_lo, plan.val_lo, plan.shift_lo)])
    rows = torch.cat([from_left[0], from_right[0]])
    val = rows[:, -1] > 0.5
    out = (rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9], val)
    if pid is not None:
        gpid = torch.where(val, rows[:, 10].to(torch.int32),
                           torch.full((), -1, dtype=torch.int32, device=pos.device))
        return out + (gpid,)
    return out


# ---------------------------------------------------------------------------
# Prebuilt DEM plan (chunked sharded scan: one build per chunk)
# ---------------------------------------------------------------------------

class DEMPlan(NamedTuple):
    """Ghost plan and neighbour list built once per rebuild chunk and frozen
    over the chunk's fluid steps. Ghost values still refresh per substep;
    ``ref_pos`` anchors the drift-staleness diagnostic."""

    plan: GhostPlan
    nbr: Optional[torch.Tensor]
    n_list_overflow: torch.Tensor
    ref_pos: torch.Tensor


def ghost_width(grid: Grid, cfg, r_max: float) -> float:
    """The farthest a contact partner of a local particle can sit past the
    slab boundary: cell lists, 2 hash-bin widths (`effective_bin_size`);
    all pairs, the contact distance plus the Verlet-skin margin."""
    if cfg.neighbor == "cells":
        return 2.0 * demod.effective_bin_size(grid, cfg, r_max)
    return 2.0 * r_max * (1.0 + cfg.skin)


def ghost_capacity(n_loc_cap: int, grid: Grid, cfg, r_max: float, geom: SlabGeom) -> int:
    """Per-direction ghost-plan capacity: the slot capacity scaled by the
    fraction of the slab within `ghost_width` of an edge (all of it when
    the ghost width reaches the slab width), at least 16."""
    gw = ghost_width(grid, cfg, r_max)
    slab_w = geom.n_loc * grid.spacing[0]
    frac = min(1.0, gw / slab_w)
    return max(16, min(n_loc_cap, int(math.ceil(n_loc_cap * frac))))


def check_slab_geometry(grid: Grid, cfg, r_max: float, geom: SlabGeom, n_sh: int) -> float:
    """The ghost width, after refusing slabs narrower than it (contacts
    would reach past the adjacent rank) and, at 2 ranks with periodic x,
    narrower than twice it (one particle would ghost to both sides of the
    same neighbour)."""
    gw = ghost_width(grid, cfg, r_max)
    slab_w = geom.n_loc * grid.spacing[0]
    periodic_x = bool(cfg.periodic[0])
    if n_sh > 1 and slab_w < gw:
        raise ValueError(f"slab width {slab_w:.4g} < ghost width {gw:.4g}: contacts "
                         f"would reach past the adjacent shard — use fewer shards")
    if n_sh == 2 and periodic_x and slab_w < 2.0 * gw:
        raise ValueError(f"2 shards + periodic x needs slab width >= 2*ghost width "
                         f"({slab_w:.4g} < {2 * gw:.4g})")
    return gw


def build_dem_plan(ps: ParticleState, grid: Grid, cfg, r_max: float, geom: SlabGeom,
                   K_ghost: int) -> DEMPlan:
    """Build the frozen (ghost plan, neighbour list) of one rebuild chunk."""
    n_sh = geom.mesh.size
    gw = check_slab_geometry(grid, cfg, r_max, geom, n_sh)
    use_ghosts = n_sh > 1
    plan = plan_ghosts(ps.pos, ps.active, grid, geom, gw, bool(cfg.periodic[0]),
                       K_ghost if use_ghosts else 1)
    if use_ghosts:
        gpos, _, _, _, gact = fetch_ghosts(plan, ps.pos, ps.vel, ps.angvel, ps.radius, geom)
        apos = torch.cat([ps.pos, gpos])
        aact = torch.cat([ps.active, gact])
    else:
        apos, aact = ps.pos, ps.active
    if cfg.neighbor == "cells":
        nbr, n_over = demod.build_neighbor_list(apos, aact, grid, cfg, r_max,
                                                return_overflow=True)
    else:
        nbr, n_over = None, torch.zeros((), dtype=torch.int32, device=ps.pos.device)
    return DEMPlan(plan, nbr, n_over, ps.pos.clone())


# ---------------------------------------------------------------------------
# Sharded DEM substeps
# ---------------------------------------------------------------------------

def dem_substeps_sharded(ps: ParticleState, hydro: demod.DEMForces, grid: Grid,
                         cfg: demod.DEMConfig, dt_dem, n_sub: int, r_max: float,
                         geom: SlabGeom, K_ghost: int, shear=None, dt_seq=None,
                         dem_plan: Optional[DEMPlan] = None):
    """Velocity-Verlet substeps on the local slot array with a ghost refresh
    every substep: the sharded counterpart of `dem.dem_substeps` (equal
    trajectories). -> (pos, vel, angvel, n_list_overflow, n_ghost_overflow)
    [+ the ShearState with ``shear``].

    ``dt_seq`` (n_sub,) gives each substep its own dt (zero entries are
    exact no-ops, the dynamic-substep tail); it must be the same on every
    rank (it comes from a min-reduced critical dt). ``dem_plan`` is the
    chunk's frozen ghost set and candidate list (`build_dem_plan`); the
    ghost values still refresh every substep. With one rank there are no
    ghosts: the minimum image already sees every particle."""
    pos, vel, angvel = ps.pos, ps.vel, ps.angvel
    radius, active = ps.radius, ps.active
    N = pos.shape[0]
    dev, dtype = pos.device, pos.dtype
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    p = cfg.params
    m = demod.particle_mass(radius, p.rho_p)
    inertia = demod.particle_inertia(radius, p.rho_p)
    g = torch.tensor(cfg.gravity, dtype=dtype, device=dev)
    vol = (4.0 / 3.0) * math.pi * radius ** 3
    f_grav = m[:, None] * g[None, :]
    if cfg.buoyancy:
        f_grav = f_grav - cfg.rho_f * vol[:, None] * g[None, :]
    inv_m = torch.where(active, 1.0 / m, zero)[:, None]
    inv_I = torch.where(active, 1.0 / inertia, zero)[:, None]
    lo = torch.tensor(grid.origin, dtype=dtype, device=dev)
    L = torch.tensor(grid.lengths, dtype=dtype, device=dev)
    per = torch.tensor(cfg.periodic, device=dev)

    use_list = cfg.neighbor == "cells"
    use_ghosts = geom.mesh.size > 1
    if dem_plan is None:
        gw = check_slab_geometry(grid, cfg, r_max, geom, geom.mesh.size)
        plan = plan_ghosts(pos, active, grid, geom, gw, bool(cfg.periodic[0]),
                           K_ghost if use_ghosts else 1)
    else:
        plan = dem_plan.plan

    def all_state(pos_, vel_, ang_):
        if not use_ghosts:
            return pos_, vel_, ang_, radius, active
        gpos, gvel, gang, grad, gact = fetch_ghosts(plan, pos_, vel_, ang_, radius, geom)
        return (torch.cat([pos_, gpos]), torch.cat([vel_, gvel]), torch.cat([ang_, gang]),
                torch.cat([radius, grad]), torch.cat([active, gact]))

    if shear is not None:
        if not (use_list and cfg.contact_mode == "substep"):
            raise ValueError("sharded shear_history requires neighbor='cells', "
                             "contact_mode='substep'")
        if use_ghosts:
            *_, gpid = fetch_ghosts(plan, pos, vel, angvel, radius, geom, pid=ps.pid)
            apid = torch.cat([ps.pid, gpid])
        else:
            apid = ps.pid

    apos, avel, aang, arad, aact = all_state(pos, vel, angvel)
    if dem_plan is not None:
        nbr, n_list_over = dem_plan.nbr, izero
    elif use_list:
        nbr, n_list_over = demod.build_neighbor_list(apos, aact, grid, cfg, r_max,
                                                     return_overflow=True)
    else:
        nbr, n_list_over = None, izero
    n_ghost_over = plan.n_overflow if dem_plan is None and use_ghosts else izero

    def damp(f, v):
        d = cfg.cundall_damping
        if d == 0.0:
            return f
        return f * (1.0 - d * torch.sign(f * v))

    def drift(pos_, vel_, ang_, a, aw, dt_):
        vel_h = vel_ + 0.5 * dt_ * a
        ang_h = ang_ + 0.5 * dt_ * aw
        pos_n = pos_ + dt_ * vel_h
        return torch.where(per, lo + demod._float_mod(pos_n - lo, L), pos_n), vel_h, ang_h

    dts = list(dt_seq.unbind(0)) if dt_seq is not None else [dt_dem] * n_sub

    if shear is not None:
        Nc = apos.shape[0]
        keys = demod.shear_keys(nbr[:N], Nc, apid)
        xi = demod.carry_shear(shear, keys)
        xw = shear.xi_wall

        def eval_h(apos_, avel_, aang_, xi_, xw_, dt_):
            xi_full = torch.zeros((Nc,) + tuple(xi_.shape[1:]), dtype=xi_.dtype, device=dev)
            xi_full[:N] = xi_
            xw_full = torch.zeros((Nc, 3, 3), dtype=xw_.dtype, device=dev)
            xw_full[:N] = xw_
            fc, tc, xi2 = demod.neighbor_contact_forces(nbr, apos_, avel_, aang_, arad, aact,
                                                        grid, cfg, xi_full, dt_)
            fw, tw, xw2 = demod.wall_contact_forces(apos_, avel_, aang_, arad, aact, grid,
                                                    cfg, xw_full, dt_)
            f = damp((fc + fw)[:N] + f_grav + hydro.force, avel_[:N])
            t = damp((tc + tw)[:N] + hydro.torque, aang_[:N])
            return f * inv_m, t * inv_I, xi2[:N], xw2[:N]

        a, aw, xi, xw = eval_h(apos, avel, aang, xi, xw, 0.0)
        for dt_ in dts:
            pos, vel_h, ang_h = drift(pos, vel, angvel, a, aw, dt_)
            apos, avel, aang, _, _ = all_state(pos, vel_h, ang_h)
            a, aw, xi2, xw2 = eval_h(apos, avel, aang, xi, xw, dt_)
            if dt_seq is not None:
                # a zero-dt substep keeps the springs of the last live one
                live = dt_ > 0
                xi2, xw2 = torch.where(live, xi2, xi), torch.where(live, xw2, xw)
            xi, xw = xi2, xw2
            vel = vel_h + 0.5 * dt_ * a
            angvel = ang_h + 0.5 * dt_ * aw
        return (pos, vel, angvel, n_list_over, n_ghost_over,
                demod.ShearState(xi, keys, xw))

    def accel(apos_, avel_, aang_):
        if nbr is not None:
            fc, tc = demod.neighbor_contact_forces(nbr, apos_, avel_, aang_, arad, aact,
                                                   grid, cfg)
        else:
            fc, tc = demod.allpairs_contact_forces(apos_, avel_, aang_, arad, aact, grid, cfg)
        fw, tw = demod.wall_contact_forces(apos_, avel_, aang_, arad, aact, grid, cfg)
        f = damp((fc + fw)[:N] + f_grav + hydro.force, avel_[:N])
        t = damp((tc + tw)[:N] + hydro.torque, aang_[:N])
        return f * inv_m, t * inv_I

    a, aw = accel(apos, avel, aang)
    for dt_ in dts:
        pos, vel_h, ang_h = drift(pos, vel, angvel, a, aw, dt_)
        apos, avel, aang, _, _ = all_state(pos, vel_h, ang_h)
        a, aw = accel(apos, avel, aang)
        vel = vel_h + 0.5 * dt_ * a
        angvel = ang_h + 0.5 * dt_ * aw
    return pos, vel, angvel, n_list_over, n_ghost_over
