"""Slab-sharded coupled step: grid x-slabs over the ranks of a
`torch.distributed` ring (port of `yade_openfoam_coupling_tpu/parallel/sharded.py`).

Every rank runs the same program on its own block, SPMD, on its own
device:

* the grid is split in x-slabs; every stencil and CG halo is a ring
  exchange and every dot product an all-reduce (`parallel/ctx.ShardCtx`);
* face fluxes are carried between steps in cell-indexed form (`LoFaces`:
  each cell's low face per axis, plus the three global top planes), so the
  state splits evenly; the local (n+1)-face tuples are rebuilt per step
  with one ring exchange;
* particles live in fixed-capacity slot arrays per rank and belong to the
  rank holding their base cell (`parallel/particles.py`). The owner
  computes weights and forces on its halo-extended block; deposits that
  land in a neighbour's slab travel back by a ring halo reduction.

`make_sharded_step` and `make_sharded_scan` return per-rank callables; the
state goes in and out through `to_sharded_state` (this rank's block) and
`gather_state` (the whole state on rank 0). Everything decided on the host
(the CG's exit, branches on counts) reads all-reduced values, so every
rank takes the same branch and meets the same collectives.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import coupled as cd
from ..models.fields import FluidState, ParticleState, SimState, TurbulenceState
from ..ops import coupling as cp
from ..ops import coupling_planes as cpp
from ..ops import coupling_window as cpw
from ..ops import dem as demod
from ..ops import rolls
from ..ops.grid import NEUMANN, PERIODIC, FaceBC, FieldBC, Grid, pad_axis
from . import particles as pp
from .ctx import ShardCtx, all_gather, ring_exchange
from .mesh import AXIS, Mesh


def _phase(timer, name: str, device):
    """``timer.phase(name)``, synchronising ``device`` at its end, or
    nothing without a timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.phase(name, block_on=torch.empty(0, device=device))


# ---------------------------------------------------------------------------
# phi layout: (n+1)-face tuples <-> cell-indexed low faces
# ---------------------------------------------------------------------------

class LoFaces(NamedTuple):
    """Sharding-friendly face-flux layout. ``lo``: per axis, each cell's
    low face value (shape == grid.shape, so it splits evenly in x-slabs).
    ``hi``: the three global top planes ((1,ny,nz), (nx,1,nz), (nx,ny,1)),
    carried as they are so the (n+1)-face tuples rebuild exactly, slip
    walls and adjustPhi-corrected outlet fluxes included. The x plane is
    replicated on every rank; its owner is the last rank."""

    lo: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    hi: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def faces_to_lo(phi) -> LoFaces:
    """(n+1)-face tuples -> LoFaces (global)."""
    return LoFaces(lo=(phi[0][:-1], phi[1][:, :-1], phi[2][:, :, :-1]),
                   hi=(phi[0][-1:], phi[1][:, -1:], phi[2][:, :, -1:]))


def lo_to_faces_host(phi_lo: LoFaces, u_bc: FieldBC = None):
    """Global inverse of `faces_to_lo`: exact, the top planes are carried."""
    return tuple(torch.cat([phi_lo.lo[a], phi_lo.hi[a]], dim=a) for a in range(3))


def lo_to_faces_local(phi_lo: LoFaces, u_bc: FieldBC, ctx: ShardCtx):
    """Local (n_loc+1)-face tuples from this rank's LoFaces: along the
    sharded axis the missing top plane is the next rank's first low face
    (one ring exchange); the last rank, and every unsharded axis, uses the
    carried global top plane."""
    faces = []
    for a in range(3):
        f, top = phi_lo.lo[a], phi_lo.hi[a]
        if ctx.mesh_axes[a] is not None:
            first = f.narrow(a, 0, 1)
            _, from_right = ring_exchange(ctx.mesh, [first], [first])
            if ctx.mesh.rank != ctx.mesh.size - 1:
                top = from_right[0]
        faces.append(torch.cat([f, top], dim=a))
    return tuple(faces)


def faces_to_lo_local(phi, ctx: ShardCtx) -> LoFaces:
    """Per-rank inverse of `lo_to_faces_local`. Along the sharded axis the
    global top plane lives on the last rank; every rank gets it by an
    all-reduce sum of the masked local top plane, exact since one rank
    alone adds a nonzero value."""
    lo, hi = [], []
    for a in range(3):
        f = phi[a]
        n = f.shape[a]
        lo.append(f.narrow(a, 0, n - 1))
        top = f.narrow(a, n - 1, 1)
        if ctx.mesh_axes[a] is not None:
            if ctx.mesh.rank != ctx.mesh.size - 1:
                top = torch.zeros_like(top)
            top = ctx.sum(top)
        hi.append(top)
    return LoFaces(lo=tuple(lo), hi=tuple(hi))


# ---------------------------------------------------------------------------
# Sharded particle <-> grid plumbing
# ---------------------------------------------------------------------------

def _gather_bc(bcs) -> FieldBC:
    """Halo-pad BC for gathers: ring values where globally periodic,
    (unread) mirror ghosts at walls."""
    faces = []
    for a in range(3):
        if bcs.u.is_periodic(a):
            faces.append((FaceBC(PERIODIC), FaceBC(PERIODIC)))
        else:
            faces.append((FaceBC(NEUMANN), FaceBC(NEUMANN)))
    return FieldBC(tuple(faces))


def _pad_stack(ctx: ShardCtx, F: torch.Tensor, bc: FieldBC, depth: int) -> torch.Tensor:
    """A (C, n_loc, ny, nz) stack of scalar channels padded under ``bc``
    with a ``depth``-plane x halo (one ring exchange for every channel) and
    the one-cell y/z shell: each channel equals ``ctx.pad_s`` (depth 1) or
    ``ctx.pad_s_x2`` (depth 2) of it under a periodic or Neumann ``bc``."""
    F = ctx._pad(F, bc, depth, [None] * F.shape[0])
    for axis in (1, 2):
        lo, hi = bc.faces[axis]
        F = pad_axis(F, axis + 1, lo, hi)
    return F


def _halo_reduce(ctx: ShardCtx, ext: torch.Tensor, H: int) -> torch.Tensor:
    """(C, n_loc + 2H, ny, nz) halo-extended deposits -> (C, n_loc, ny, nz):
    the H planes past each slab edge travel to the neighbour that owns
    them and add into its edge planes."""
    from_left, from_right = ring_exchange(ctx.mesh, [ext[:, -H:]], [ext[:, :H]])
    out = ext[:, H:-H].clone()
    out[:, :H] += from_left[0]
    out[:, -H:] += from_right[0]
    return out


def _sharded_support_ops(cells, weights: torch.Tensor, owner: torch.Tensor,
                         base: torch.Tensor, offsets, grid: Grid, bcs, ctx: ShardCtx,
                         n_loc: int):
    """SupportOps of the owner-rank sparse coupling on a halo-extended
    slab: (cells (3-tuple of (N,S) unwrapped global indices), weights
    (N,S) normalised and owner-masked, owner (N,), base (N,3) anchor cells,
    offsets (S,3)) -> (ops, w).

    A deposit scatters every particle's S*C channels onto its anchor slot
    of an (n_loc+2)-plane buffer (plane j = global plane start - 1 + j; an
    owned Gaussian anchor lies in planes 1..n_loc, a trilinear anchor one
    cell left of the slab in plane 0, whose offsets have dx in {0, 1}),
    distributes offset o's channels to anchor + o with kernel B3
    (`rolls.distribute_rolls`, the JAX package's clipped roll loop: no
    offset leaves the buffer except a dx = -1 from plane 0, which is
    empty), and halo-reduces the two outer planes over the ring."""
    nx, ny, nz = grid.shape
    periodic = bcs.periodic_axes()
    start = ctx.shard_index(0) * n_loc
    dev = weights.device

    # per-axis validity on the global domain (walls mask, periodic wraps)
    ok = owner[:, None]
    for a in range(3):
        if not periodic[a]:
            ok = ok & (cells[a] >= 0) & (cells[a] < grid.shape[a])
    w = torch.where(ok, weights, torch.zeros((), dtype=weights.dtype, device=dev))

    # extended-slab x index in [0, n_loc+2); ownership keeps it in range
    lxe = torch.clamp(cells[0] - start + 1, 0, n_loc + 1)
    wy = torch.remainder(cells[1], ny)
    wz = torch.remainder(cells[2], nz)
    npadyz = (ny + 2) * (nz + 2)
    gat_ids = lxe * npadyz + (wy + 1) * (nz + 2) + (wz + 1)
    gat_ids = torch.where(ok, gat_ids, 0).to(torch.int64)
    gbc = _gather_bc(bcs)

    ncell_ext = (n_loc + 2) * ny * nz
    base_lx = torch.clamp(base[:, 0] - start + 1, 0, n_loc)
    base_loc = (base_lx * (ny * nz) + torch.remainder(base[:, 1], ny) * nz
                + torch.remainder(base[:, 2], nz))
    base_loc = torch.where(owner, base_loc, ncell_ext).to(torch.int64)   # scrap column

    def dep_stack(values: torch.Tensor) -> torch.Tensor:
        """(N,S,C) -> (C, n_loc, ny, nz): one N-row scatter of the S*C
        channels onto the anchor slots, B3, the ring halo reduction."""
        N, S, C = values.shape
        buf = torch.zeros((S * C, cp.anchor_row_length(ncell_ext)), dtype=values.dtype,
                          device=dev)
        buf.index_add_(1, base_loc, values.reshape(N, S * C).T)
        bufT = buf[:, :ncell_ext].view(S, C, n_loc + 2, ny, nz)
        return _halo_reduce(ctx, rolls.distribute_rolls(bufT, offsets), 1)

    def gat_stack(fields) -> torch.Tensor:
        """Local scalar/vector fields -> (N, C) through one row gather of the
        stacked, halo-padded slab."""
        F = cp._stack_channels(fields)                      # (C, n_loc, ny, nz)
        Fp = _pad_stack(ctx, F, gbc, 1)                     # (C, n_loc+2, ny+2, nz+2)
        tbl = Fp.reshape(Fp.shape[0], -1).T
        vals = tbl[gat_ids]                                 # (N, S, C)
        return torch.sum(vals * w[..., None], dim=1)

    return cp.SupportOps(
        deposit=lambda v: dep_stack(v[..., None])[0],
        deposit_vec=dep_stack,
        gather=lambda f: gat_stack([f])[:, 0],
        gather_vec=lambda f: gat_stack([f]),
        deposit_stack=dep_stack,
        gather_stack=gat_stack,
        deposit_outer=lambda v: dep_stack(w[..., None] * v[:, None, :]),
    ), w


def _slab_exchange_inputs(cfg: cd.CaseConfig, ctx: ShardCtx, n_loc: int, ext_slab: bool,
                          fs: FluidState, ps: ParticleState, dt):
    """The slab exchange's kernel inputs: (bins, Fp, x_off, nxl). The
    window (``n_loc`` planes, or ``n_loc + 2`` from ``start - 1``, wrapped
    under periodic x, with ``ext_slab``) holds the particles binned into
    slot planes (`bin_particles_planes`) or window rows (`window_bins`);
    Fp stacks the input channels with a depth-1 (depth-2) x halo."""
    grid, bcs, tp, ccfg = cfg.grid, cfg.bcs, cfg.transport, cfg.coupling
    periodic = bcs.periodic_axes()
    nxl = n_loc + (2 if ext_slab else 0)
    curl_u, grad_p, div_tau, ddt_u = cd._coupling_inputs(fs, grid, bcs, tp.nu, dt, ctx, ccfg)
    pf = cp.ParticleFields(ps.pos, ps.vel, ps.angvel, ps.radius, ps.active)
    start = ctx.shard_index(0) * n_loc
    x_off = start - 1 if ext_slab else start
    wrap = ext_slab and periodic[0]
    if ccfg.exchange == "window":
        W = cpw.window_size(pf.pos.shape[0], nxl, ccfg.planes_window)
        bins = cpw.window_bins(pf, grid, ccfg.slot_capacity, W, with_angvel=ccfg.use_torque,
                               x_start=x_off, n_loc=nxl, wrap_x=wrap)
    else:
        bins = cpp.bin_particles_planes(pf, grid, ccfg.slot_capacity, x_start=x_off,
                                        n_loc=nxl, with_angvel=ccfg.use_torque,
                                        packed_bin=ccfg.packed_bin, wrap_x=wrap)
    F = cpp._input_stack(fs.u, grad_p, div_tau, ddt_u, curl_u, fs.alpha, ccfg)
    Fp = _pad_stack(ctx, F, _gather_bc(bcs), 2 if ext_slab else 1)
    return bins, Fp, x_off, nxl


def _make_planes_exchange(cfg: cd.CaseConfig, ctx: ShardCtx, n_loc: int,
                          ext_slab: bool = False):
    """Sharded slot-plane exchange: each rank bins its slab population,
    runs the window kernel (B1, ``exchange="window"``), the fused planes
    kernel (B4) or the two-kernel path (B5, the force laws, B6) on its slab
    at the slab's global x offset, and completes cross-slab deposits with
    one ring halo addition.

    ``ext_slab``: bin into an extended window of n_loc+2 planes [start-1,
    start+n_loc+1), so particles that drifted <= 1 plane past their slab
    between the chunked scan's migrations stay coupled: a depth-2 x halo
    on the inputs, deposits halo-reduced 2 planes each way, and under
    periodic x the window wraps. Drift past the window uncouples the
    particle and shows in n_found. The epilogue's dy rolls and dx shifts
    are plain torch (not B3's function: they land whole stacks)."""
    grid, bcs, tp = cfg.grid, cfg.bcs, cfg.transport
    ccfg = cfg.coupling
    if not ccfg.lag_alpha:
        raise ValueError("planes exchange: lag_alpha required")
    periodic = bcs.periodic_axes()
    ny, nz = grid.shape[1], grid.shape[2]
    Vc = grid.cell_volume
    H = 2 if ext_slab else 1           # deposit halo depth
    use_window = ccfg.exchange == "window"

    def ex(fs, ps, dt) -> cp.CouplingResult:
        N = ps.pos.shape[0]
        bins, Fp, x_off, nxl = _slab_exchange_inputs(cfg, ctx, n_loc, ext_slab, fs, ps, dt)
        if use_window:
            stks, combos, pres = cpw.window_exchange_padded(
                Fp, bins.dat_win, grid, periodic, ccfg, x_off, tp.nu, tp.rho_f,
                counts=bins.counts)
        elif ccfg.fused_planes:
            stks, combos, pres = cpp.fused_exchange_padded(
                Fp, bins.D, grid, periodic, ccfg, x_off, tp.nu, tp.rho_f, max_occupied=N)
        else:
            G, norm = cpp.interp_planes_padded(Fp, bins.D, grid, periodic, ccfg, x_off)
            V, force, torque, found = cpp._physics_planes(bins.D, G, norm, Vc, tp.nu,
                                                          tp.rho_f, ccfg)
            zero = torch.zeros((), dtype=norm.dtype, device=norm.device)
            inv_norm = torch.where(norm > 0.0, 1.0 / torch.where(norm > 0.0, norm, 1.0), zero)
            stks, combos = cpp.deposit_stacks(V * inv_norm[None], bins.D, nxl, grid,
                                              periodic, ccfg, x_off, max_occupied=N)
            pres = torch.cat([force, torque, found.to(force.dtype)[None]])
        force, found = pres[0:3], pres[pres.shape[0] - 1]
        torque = pres[3:6] if pres.shape[0] == 7 else torch.zeros_like(force)

        # epilogue: dy rolls are slab-local; dx shifts land in a halo-
        # extended slab completed by one ring exchange
        ext = torch.zeros((stks.shape[1], nxl + 2, ny, nz), dtype=stks.dtype,
                          device=stks.device)
        for ci, (dx, dy) in enumerate(combos):
            v = stks[ci]
            if dy:
                v = torch.roll(v, dy, dims=2)
            ext[:, 1 + dx:1 + dx + nxl] += v
        out = _halo_reduce(ctx, ext, H)

        pvol, up = out[0], out[1:4]
        alpha = torch.clamp(1.0 - pvol / Vc, min=ccfg.alpha_min)
        u_particle = up / Vc
        u_source_drag = out[4]
        u_source = u_source_drag[None] * u_particle + out[5:8]

        ncl = nxl * ny * nz
        per = torch.cat([force, torque, found.to(force.dtype)[None]])
        res = cpp._unbin_rows(per, bins.cell_sorted, bins.rank, bins.keep, ncl,
                              ccfg)[bins.inv_order]
        return cp.CouplingResult(force=res[:, 0:3], torque=res[:, 3:6], alpha=alpha,
                                 u_particle=u_particle, u_source=u_source,
                                 u_source_drag=u_source_drag, found=res[:, 6] > 0.5,
                                 n_overflow=bins.n_overflow)

    return ex


def make_sharded_exchange(cfg: cd.CaseConfig, ctx: ShardCtx, n_loc: int,
                          ext_slab: bool = False):
    """Owner-rank coupling exchange closure for `coupled_step`: the slab
    window/planes exchange for ``exchange`` "window" or "planes", else (the
    other Gaussian exchanges too, as in the JAX package) the sparse
    Gaussian, or the point-force, exchange on the halo-extended slab."""
    grid, bcs, tp = cfg.grid, cfg.bcs, cfg.transport
    ccfg = cfg.coupling
    if ccfg.gaussian and ccfg.exchange in ("planes", "window"):
        return _make_planes_exchange(cfg, ctx, n_loc, ext_slab=ext_slab)
    if ext_slab:
        raise ValueError("the chunked sharded scan (list_rebuild_steps > 0) requires the "
                         "planes/window exchange: the sparse sharded exchange has no "
                         "extended-window binning")
    if ccfg.gaussian and ccfg.stencil_width != 3:
        # the JAX package's extended slab holds one plane a side: its
        # lxe = clip(cells[0] - start + 1, 0, n_loc + 1) folds dx = +-2 into
        # the halo planes (gathers) and its clipped roll loop drops them
        # (deposits), so its sharded result differs from its own
        # single-device one at width 5 (ROADMAP queue C)
        raise NotImplementedError(
            f"sharded sparse exchange with stencil_width={ccfg.stencil_width}: the slab "
            "halo is one plane a side, so only stencil_width=3 is exact")
    periodic = bcs.periodic_axes()
    if ccfg.gaussian:
        offsets = cp.stencil_offsets(ccfg)
    else:
        offsets = cp.TRILINEAR_CORNERS

    def ex(fs, ps, dt) -> cp.CouplingResult:
        curl_u, grad_p, div_tau, ddt_u = cd._coupling_inputs(fs, grid, bcs, tp.nu, dt, ctx,
                                                            ccfg)
        pf = cp.ParticleFields(ps.pos, ps.vel, ps.angvel, ps.radius, ps.active)
        if ccfg.gaussian:
            cells, w_raw, validp = cp.gaussian_cells_raw_weights(pf.pos, pf.active, grid, ccfg)
        else:
            cells, w_raw, validp = cp.trilinear_cells_raw_weights(pf.pos, pf.active, grid)
        # globally consistent normalisation (every rank computes the same)
        ok_glob = validp[:, None]
        for a in range(3):
            if not periodic[a]:
                ok_glob = ok_glob & (cells[a] >= 0) & (cells[a] < grid.shape[a])
        w_norm = cp.normalize_weights(w_raw, ok_glob)

        # owner test: the base cell lies in this rank's slab. It holds for
        # every settled local particle and masks particles in transit
        base, _ = cp.locate(pf.pos, grid)
        start = ctx.shard_index(0) * n_loc
        owner = validp & (base[:, 0] >= start) & (base[:, 0] < start + n_loc)
        w_owned = torch.where(owner[:, None], w_norm, torch.zeros((), dtype=w_norm.dtype,
                                                                  device=w_norm.device))
        if ccfg.gaussian:
            anchor = base
        else:
            anchor = torch.stack([c[:, 0] for c in cells], 1)     # corner (0, 0, 0)
        ops, w = _sharded_support_ops(cells, w_owned, owner, anchor, offsets, grid, bcs,
                                      ctx, n_loc)
        found_local = owner & (torch.sum(w, dim=1) > 0.0)
        if ccfg.gaussian:
            return cp.gaussian_physics(pf, fs.u, grad_p, div_tau, ddt_u, curl_u, w,
                                       found_local, ops, grid.cell_volume, tp.nu, tp.rho_f,
                                       ccfg, prev_alpha=fs.alpha)
        # per-particle results are complete locally: each local particle is
        # computed by exactly this rank
        return cp.point_force_physics(pf, fs.u, curl_u, found_local, ops, grid.cell_volume,
                                      tp.nu, tp.rho_f)

    return ex


# ---------------------------------------------------------------------------
# State layout
# ---------------------------------------------------------------------------

class Split(NamedTuple):
    """An array split over the ranks along ``axis`` (a slab, or a block of
    particle slots)."""

    axis: int


REPLICATED = "replicated"


def state_specs(cfg: cd.CaseConfig) -> SimState:
    """Which arrays of a sharded-layout SimState (lo-face phi, slab-binned
    particle slots) are split over the ranks, and along which axis, and
    which are replicated: the table `to_sharded_state` and `gather_state`
    read."""
    x0, x1 = Split(0), Split(1)
    fluid = dict(u=x1, u_old=x1, p=x0,
                 phi=LoFaces(lo=(x0, x0, x0),
                             # the x top plane (1,ny,nz) is replicated; the
                             # y/z top planes split over x like their fields
                             hi=(REPLICATED, x0, x0)),
                 alpha=x0, alpha_old=x0, u_source=x1, u_source_drag=x0, u_particle=x1,
                 p_prev=x0 if cfg.solver == "pimple" and cfg.pimple.p_extrapolate != 0.0
                 else None)
    shear_kw = {}
    if cfg.dem.shear_history:
        shear_kw = dict(shear_xi=x0, shear_ids=x0, shear_wall=x0)
    return SimState(
        fluid=FluidState(**fluid),
        particles=ParticleState(pos=x0, vel=x0, angvel=x0, radius=x0, active=x0, pid=x0,
                                **shear_kw),
        turb=TurbulenceState(k=x0, epsilon=x0, nut=x0),
        t=REPLICATED, dt=REPLICATED, step=REPLICATED)


def _map(fn, tree, spec):
    """Apply fn(leaf, spec) over a state tree and its spec table; leaves
    whose spec is None (absent fields) map to None."""
    if spec is None:
        return None
    if isinstance(spec, Split) or spec == REPLICATED:
        return fn(tree, spec)
    items = [_map(fn, t, s) for t, s in zip(tree, spec)]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def shard_particles_host(ps: ParticleState, cfg: cd.CaseConfig, n_sh: int,
                         cap_loc: int = 0) -> ParticleState:
    """Host-side slab binning of a ParticleState: a (n_sh * cap_loc)-row
    state whose block [s*cap_loc, (s+1)*cap_loc) holds slab s's population
    (active-masked padding after it), as CPU tensors. ``cap_loc`` 0 picks
    twice the largest slab population, at least 16."""
    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    pos = host(ps.pos)
    act = host(ps.active)
    nx = cfg.grid.shape[0]
    if nx % n_sh:
        raise ValueError(f"nx={nx} not divisible by {n_sh} shards")
    n_loc = nx // n_sh
    hx = cfg.grid.spacing[0]
    cellx = np.clip(np.floor((pos[:, 0] - cfg.grid.origin[0]) / hx).astype(int), 0, nx - 1)
    slab = cellx // n_loc
    counts = np.bincount(slab[act], minlength=n_sh)
    if cap_loc <= 0:
        cap_loc = max(16, int(2 * counts.max()) if counts.size else 16)

    src = {"pos": pos, "vel": host(ps.vel), "angvel": host(ps.angvel),
           "radius": host(ps.radius), "active": act, "pid": host(ps.pid)}
    fill = {"radius": 1e-6, "pid": -1}
    if ps.shear_xi is not None:
        src.update(shear_xi=host(ps.shear_xi), shear_wall=host(ps.shear_wall),
                   shear_ids=host(ps.shear_ids))
        fill["shear_ids"] = -1
    new = {k: np.full((n_sh, cap_loc) + v.shape[1:], fill.get(k, 0), v.dtype)
           for k, v in src.items()}
    for s in range(n_sh):
        ids = np.where(act & (slab == s))[0]
        if len(ids) > cap_loc:
            raise ValueError(f"shard {s} holds {len(ids)} particles > cap_loc={cap_loc}; "
                             f"raise shard capacity")
        for k in new:
            new[k][s, :len(ids)] = src[k][ids]
    return ParticleState(**{k: torch.as_tensor(v.reshape((n_sh * cap_loc,) + v.shape[2:]))
                            for k, v in new.items()})


def particles_by_pid(ps: ParticleState):
    """Host-side: the active particles sorted by pid, as numpy arrays (the
    layout-independent view for comparing sharded and single-device runs)."""
    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    act = host(ps.active).astype(bool)
    pid = host(ps.pid)[act]
    order = np.argsort(pid, kind="stable")
    return {"pid": pid[order], "pos": host(ps.pos)[act][order],
            "vel": host(ps.vel)[act][order], "angvel": host(ps.angvel)[act][order],
            "radius": host(ps.radius)[act][order]}


def sharded_layout(state: SimState, cfg: cd.CaseConfig, n_sh: int,
                   cap_loc: int = 0) -> SimState:
    """A single-device SimState (face-tuple phi) in the global sharded
    layout: lo-face phi and the particles binned into ``n_sh`` blocks of
    ``cap_loc`` slots (`shard_particles_host`)."""
    return state._replace(
        fluid=state.fluid._replace(phi=faces_to_lo(state.fluid.phi)),
        particles=shard_particles_host(state.particles, cfg, n_sh, cap_loc))


def scatter_state(glob: SimState, cfg: cd.CaseConfig, mesh: Mesh) -> SimState:
    """This rank's block of a global sharded-layout state, on the rank's
    device (the inverse of `gather_state`)."""
    def block(x, spec):
        if isinstance(spec, Split):
            n = x.shape[spec.axis] // mesh.size
            x = x.narrow(spec.axis, mesh.rank * n, n)
        return x.to(mesh.device).contiguous()

    return _map(block, glob, state_specs(cfg))


def to_sharded_state(state: SimState, cfg: cd.CaseConfig, mesh: Mesh,
                     cap_loc: int = 0) -> SimState:
    """This rank's block of a single-device SimState (face-tuple phi, any
    device) in the sharded layout, on the rank's device: its slab of every
    field, lo-face phi, its ``cap_loc`` particle slots. Every rank calls it
    with the same global state."""
    return scatter_state(sharded_layout(state, cfg, mesh.size, cap_loc), cfg, mesh)


def gather_state(state: SimState, cfg: cd.CaseConfig, mesh: Mesh) -> Optional[SimState]:
    """The whole sharded-layout state on rank 0 (as CPU tensors; None on the
    other ranks): split arrays are gathered over the ranks, replicated ones
    taken from rank 0. A collective: every rank calls it."""
    def gather(x, spec):
        if isinstance(spec, Split):
            parts = all_gather(mesh, x)
            x = torch.cat(parts, dim=spec.axis)
        return x.cpu()

    out = _map(gather, state, state_specs(cfg))
    return out if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def demod_shear(ps: ParticleState) -> demod.ShearState:
    return demod.ShearState(ps.shear_xi, ps.shear_ids, ps.shear_wall)


def _make_dem_fn(cfg: cd.CaseConfig, geom: pp.SlabGeom, dem_plan=None, timer=None):
    """Per-rank DEM closure for `coupled_step`: ghost-refreshing
    velocity-Verlet substeps on the local slot population, with the
    pid-keyed springs under ``shear_history``. ``dem_plan`` (chunked scan)
    is the chunk's frozen ghost plan and Verlet list; the per-step
    staleness (drift since its build past the skin margin) rides
    n_contact_overflow, as on the local frozen-list path."""
    if cfg.dem.carry_contact:
        raise AssertionError(
            "carry_contact is a single-device optimization: the sharded path migrates and "
            "permutes particle slots between steps and refreshes ghosts per substep, so "
            "the carried force would be misaligned")
    def staleness(ps):
        if dem_plan is None or cfg.dem.neighbor != "cells":
            return torch.zeros((), dtype=torch.int32, device=ps.pos.device)
        bin_size = demod.effective_bin_size(cfg.grid, cfg.dem, cfg.r_max)
        margin = cfg.dem.list_margin_factor * (bin_size - 2.0 * cfg.r_max)
        disp = demod.drift_since(ps.pos, dem_plan.ref_pos, ps.active, cfg.grid,
                                 cfg.dem.periodic)
        return torch.sum((disp >= margin).to(torch.int32))

    def dem_fn(ps, hydro, dt_dem, dt_seq=None):
        K_g = pp.ghost_capacity(ps.pos.shape[0], cfg.grid, cfg.dem, cfg.r_max, geom)
        with _phase(timer, "DEM", ps.pos.device):
            out = pp.dem_substeps_sharded(
                ps, hydro, cfg.grid, cfg.dem, dt_dem, cfg.n_dem_substeps, cfg.r_max, geom,
                K_g, shear=demod_shear(ps) if cfg.dem.shear_history else None,
                dt_seq=dt_seq, dem_plan=dem_plan)
        pos, vel, angvel, n_list, n_ghost = out[:5]
        n_over = n_list + n_ghost + staleness(ps)
        return (pos, vel, angvel, n_over) + tuple(out[5:])

    return dem_fn


def _timed_exchange(ex, timer):
    if timer is None:
        return ex

    def timed(fs, ps, dt):
        with _phase(timer, "exchange", ps.pos.device):
            return ex(fs, ps, dt)
    return timed


def _one_sharded_step(state: SimState, cfg: cd.CaseConfig, ctx: ShardCtx, n_loc: int, ex,
                      dem_fn, geom: pp.SlabGeom, migrate: bool = True, timer=None):
    faces = lo_to_faces_local(state.fluid.phi, cfg.bcs.u, ctx)
    st8 = state._replace(fluid=state.fluid._replace(phi=faces))
    new, diag = cd.coupled_step(st8, cfg, ctx=ctx, exchange_fn=ex, dem_fn=dem_fn)
    if migrate:
        # slab migration: one ring hop per step toward the owner rank
        with _phase(timer, "migration", ctx.device):
            K_m = max(8, new.particles.pos.shape[0] // 4)
            ps_new, n_mig = pp.migrate(new.particles, cfg.grid, geom, K_m)
        diag = diag._replace(n_shard_overflow=ctx.sum(n_mig))
        new = new._replace(particles=ps_new)
    new = new._replace(fluid=new.fluid._replace(phi=faces_to_lo_local(new.fluid.phi, ctx)))
    return new, diag


def _setup(cfg: cd.CaseConfig, mesh: Mesh, timer=None):
    n_sh = mesh.size
    nx = cfg.grid.shape[0]
    if nx % n_sh:
        raise ValueError(f"nx={nx} not divisible by {n_sh} shards")
    cd._check_supported(cfg)
    n_loc = nx // n_sh
    ctx = ShardCtx(mesh_axes=(AXIS, None, None), mesh=mesh, timer=timer)
    return n_loc, ctx, pp.SlabGeom(n_loc, mesh, timer)


def make_sharded_step(cfg: cd.CaseConfig, mesh: Mesh, timer=None):
    """This rank's coupled step: state -> (state, diags), for a state in the
    layout of `to_sharded_state` (cfg.grid.shape[0] divisible by the rank
    count). Diagnostics are reduced over the ranks: every rank holds the
    same. ``timer`` (a `utils.profiling.PhaseTimer`) adds a synchronised
    split: exchange, DEM, migration, halo pads, ghosts."""
    n_loc, ctx, geom = _setup(cfg, mesh, timer)
    ex = _timed_exchange(make_sharded_exchange(cfg, ctx, n_loc), timer)
    dem_fn = _make_dem_fn(cfg, geom, timer=timer)
    return lambda state: _one_sharded_step(state, cfg, ctx, n_loc, ex, dem_fn, geom,
                                           timer=timer)


def make_sharded_scan(cfg: cd.CaseConfig, mesh: Mesh, n_steps: int, timer=None):
    """n_steps sharded coupled steps: state -> (state, diags stacked along a
    leading step axis).

    With ``dem.list_reuse``, ``list_rebuild_steps = K > 0``, the cell list
    and a Gaussian window or planes exchange, the steps run in chunks of
    [one migration and one (ghost plan, Verlet list) build -> K steps with
    neither], the sharded form of the local statically scheduled rebuild.
    Between migrations particles may drift <= 1 plane past their slab, so
    the exchange runs on the extended slab; drift past it or past the
    Verlet margin shows per step in n_found and n_contact_overflow. (The
    JAX package unrolls this loop on its CPU backend to dodge a miscompile
    of the rolled scan; eager PyTorch runs the loop as it is.)"""
    n_loc, ctx, geom = _setup(cfg, mesh, timer)
    K = cfg.dem.list_rebuild_steps
    chunked = (cfg.dem.list_reuse and K > 0 and cfg.dem.neighbor == "cells"
               and cfg.coupling.gaussian and cfg.coupling.exchange in ("planes", "window"))

    if not chunked:
        ex = _timed_exchange(make_sharded_exchange(cfg, ctx, n_loc), timer)
        dem_fn = _make_dem_fn(cfg, geom, timer=timer)

        def run(state: SimState):
            diags = []
            for _ in range(n_steps):
                state, d = _one_sharded_step(state, cfg, ctx, n_loc, ex, dem_fn, geom,
                                             timer=timer)
                diags.append(d)
            return state, cd._stack_diags(diags)
        return run

    n_chunks, rem = divmod(n_steps, K)
    sizes = [K] * n_chunks + ([rem] if rem else [])
    ex = _timed_exchange(make_sharded_exchange(cfg, ctx, n_loc, ext_slab=True), timer)

    def run(state: SimState):
        cap = state.particles.pos.shape[0]
        K_m = max(8, cap // 4)
        K_g = pp.ghost_capacity(cap, cfg.grid, cfg.dem, cfg.r_max, geom)
        diags = []
        for sz in sizes:
            with _phase(timer, "migration", ctx.device):
                ps, n_mig = pp.migrate(state.particles, cfg.grid, geom, K_m)
            with _phase(timer, "DEM plan (ghost set, Verlet list)", ctx.device):
                plan = pp.build_dem_plan(ps, cfg.grid, cfg.dem, cfg.r_max, geom, K_g)
            state = state._replace(particles=ps)
            dem_fn = _make_dem_fn(cfg, geom, dem_plan=plan, timer=timer)
            chunk = []
            for _ in range(sz):
                state, d = _one_sharded_step(state, cfg, ctx, n_loc, ex, dem_fn, geom,
                                             migrate=False, timer=timer)
                chunk.append(d)
            # the chunk boundary's counts ride its first step
            chunk[0] = chunk[0]._replace(
                n_shard_overflow=chunk[0].n_shard_overflow
                + ctx.sum(n_mig + plan.plan.n_overflow).to(torch.int32),
                n_contact_overflow=chunk[0].n_contact_overflow
                + ctx.sum(plan.n_list_overflow).to(torch.int32))
            diags += chunk
        return state, cd._stack_diags(diags)

    return run
