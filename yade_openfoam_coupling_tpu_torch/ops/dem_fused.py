"""The substep loop of `dem.dem_substeps` with a frozen Verlet list and the
carried contact force of substep mode, as hand-written kernels
(`csrc/dem_substep.cu`; no Pallas original: the JAX package leaves
`dem_substeps` to XLA).

The state between launches is a record buffer (N + 1, RECORD) float32: per
particle its position, half-step velocity and angular velocity, radius,
active (1.0 or 0.0) and a pad, 48 bytes; record N is zero, the empty slot
of the list. Two wrappers, each with its plain PyTorch version of the same
signature beside it, the loop's own operations in its own order:

* `pack_drift(pos, vel, angvel, radius, active, carried, hydro, grid, cfg,
  dt)`: the first acceleration from the carried contact force, the
  half-kick, the drift and the periodic wrap, into a new record buffer;
* `substep(records, nbr, hydro, grid, cfg, dt, last=False)`: the contact
  force (pairs, then walls) at the records' state, the closing kick and
  the next half-kick and drift, into a new record buffer; with ``last``
  the closing kick only, -> (pos, vel, angvel, fc, tc).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises (`kernels.on_cpu`); `kernels.LAUNCHES` counts the launches.
`on_route` says which calls of `dem.dem_substeps` run the loop here, and
`substeps` runs it: 1 + n_sub launches, no host copy.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from . import dem
from .grid import Grid

_KERNEL = "dem_substep kernel"
RECORD = 12            # float32 a record: pos (3), vel_h (3), ang_h (3), radius, active, pad
MAX_NEIGHBORS = 32     # the kernels' longest list row


def on_route(pos, cfg: dem.DEMConfig, n_sub: int, nbr=None, dt_seq=None) -> bool:
    """Whether `dem.dem_substeps` runs the loop as the kernels: a float32
    state on a card, a list ``nbr`` of at most MAX_NEIGHBORS slots a row,
    the carried contact force of substep mode, no spring history, no dt
    sequence and at least one substep. Every other call stays plain."""
    return (pos.device.type == "cuda" and pos.dtype == torch.float32 and nbr is not None
            and nbr.shape[1] <= MAX_NEIGHBORS and cfg.carry_contact
            and cfg.contact_mode == "substep" and not cfg.shear_history and dt_seq is None
            and n_sub >= 1)


def substeps(pos, vel, angvel, radius, active, hydro: dem.DEMForces, grid: Grid,
             cfg: dem.DEMConfig, dt_dem, n_sub: int, r_max: float, nbr,
             carried: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """`dem.dem_substeps` on its kernel route: -> (pos, vel, angvel,
    n_overflow 0, fc, tc). Without ``carried`` the first contact force is
    the plain `dem.contact_forces`, as in the plain loop."""
    if carried is None:
        carried = dem.contact_forces(pos, vel, angvel, radius, active, grid, cfg, r_max, nbr)
    if not isinstance(dt_dem, torch.Tensor):
        dt_dem = torch.full((), dt_dem, dtype=pos.dtype, device=pos.device)
    rec = pack_drift(pos.contiguous(), vel.contiguous(), angvel.contiguous(),
                     radius.contiguous(), active.contiguous(),
                     tuple(c.contiguous() for c in carried), hydro, grid, cfg, dt_dem)
    for _ in range(n_sub - 1):
        rec = substep(rec, nbr, hydro, grid, cfg, dt_dem)
    pos, vel, angvel, fc, tc = substep(rec, nbr, hydro, grid, cfg, dt_dem, last=True)
    return pos, vel, angvel, torch.zeros((), dtype=torch.int32, device=pos.device), fc, tc


def _pack(pos, vel_h, ang_h, radius, active) -> torch.Tensor:
    n = pos.shape[0]
    rec = torch.zeros((n + 1, RECORD), dtype=pos.dtype, device=pos.device)
    rec[:n, 0:3] = pos
    rec[:n, 3:6] = vel_h
    rec[:n, 6:9] = ang_h
    rec[:n, 9] = radius
    rec[:n, 10] = active.to(pos.dtype)
    return rec


def _unpack(records):
    """(pos, vel_h, ang_h, radius, active) of a record buffer, as views
    (active as bool)."""
    r = records[:-1]
    return r[:, 0:3], r[:, 3:6], r[:, 6:9], r[:, 9], r[:, 10] > 0.5


def pack_drift_plain(pos, vel, angvel, radius, active, carried, hydro: dem.DEMForces,
                     grid: Grid, cfg: dem.DEMConfig, dt) -> torch.Tensor:
    """`pack_drift`'s plain version."""
    k = dem.integration(radius, active, grid, cfg)
    a, aw = dem.accel(k, cfg, *carried, hydro, vel, angvel)
    return _pack(*dem.drift(k, pos, vel, angvel, a, aw, dt), radius, active)


def substep_plain(records, nbr, hydro: dem.DEMForces, grid: Grid, cfg: dem.DEMConfig, dt,
                  last: bool = False):
    """`substep`'s plain version."""
    pos, vel_h, ang_h, radius, active = _unpack(records)
    # r_max: unused with a list
    fc, tc = dem.contact_forces(pos, vel_h, ang_h, radius, active, grid, cfg, None, nbr)
    k = dem.integration(radius, active, grid, cfg)
    a, aw = dem.accel(k, cfg, fc, tc, hydro, vel_h, ang_h)
    vel = vel_h + 0.5 * dt * a
    angvel = ang_h + 0.5 * dt * aw
    if last:
        return pos.contiguous(), vel, angvel, fc, tc
    return _pack(*dem.drift(k, pos, vel, angvel, a, aw, dt), radius, active)


@functools.lru_cache(maxsize=64)
def _params(grid: Grid, cfg: dem.DEMConfig, n: int, k: int, force_stride: int,
            torque_stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' read-only host parameters: int32 (N, K, periodic and
    wall flags per axis, buoyancy, damping, the hydro force's and torque's
    row strides) and float32 (gravity, the box's lower and upper corners
    and lengths, 1/length, the mass and volume factors of r^3, rho_f, kn,
    2 beta, kt, friction, the damping coefficient), each the float32 that
    PyTorch applies for the Python number: a constant product taken in
    double, 1/length the reciprocal PyTorch multiplies by when it divides a
    CUDA tensor by the length."""
    p = cfg.params
    walls = [bool(w) and not bool(per) for w, per in zip(cfg.wall_axes, cfg.periodic)]
    ip = np.asarray([n, k, *(int(bool(x)) for x in cfg.periodic), *(int(w) for w in walls),
                     int(cfg.buoyancy), int(cfg.cundall_damping != 0.0), force_stride,
                     torque_stride], np.int32)
    fp = np.asarray([*cfg.gravity, *grid.origin, *grid.upper, *grid.lengths,
                     *(1.0 / L for L in grid.lengths), p.rho_p * (4.0 / 3.0) * math.pi,
                     (4.0 / 3.0) * math.pi, cfg.rho_f, p.kn, dem.damping_factor(p.restitution),
                     p.kt_over_kn * p.kn, p.friction, cfg.cundall_damping], np.float32)
    ip.setflags(write=False)
    fp.setflags(write=False)
    return ip, fp


def _hydro(hydro: dem.DEMForces, n: int):
    """The hydro arrays' specs for `kernels.require`: rows of unit stride."""
    return (("hydro force", hydro.force, (n, 3), torch.float32, True),
            ("hydro torque", hydro.torque, (n, 3), torch.float32, True))


def _params_for(grid, cfg, n, k, hydro):
    return _params(grid, cfg, n, k, hydro.force.stride(0), hydro.torque.stride(0))


def pack_drift(pos, vel, angvel, radius, active, carried, hydro: dem.DEMForces, grid: Grid,
               cfg: dem.DEMConfig, dt) -> torch.Tensor:
    """The first half of the first substep from the carried contact force
    ``carried`` (fc, tc) under gravity and ``hydro``, into a new (N + 1,
    RECORD) record buffer. ``dt``: a 0-d tensor, read by the kernel on the
    card."""
    n, dev, f32 = pos.shape[0], pos.device, torch.float32
    cpu = kernels.on_cpu(_KERNEL, dev)
    vec = (n, 3)
    kernels.require(_KERNEL, dev, ("pos", pos, vec, f32, False), ("vel", vel, vec, f32, False),
                    ("angvel", angvel, vec, f32, False), ("radius", radius, (n,), f32, False),
                    ("active", active, (n,), torch.bool, False),
                    ("fc", carried[0], vec, f32, False), ("tc", carried[1], vec, f32, False),
                    *_hydro(hydro, n), ("dt", dt, (), f32, False))
    if cpu:
        return pack_drift_plain(pos, vel, angvel, radius, active, carried, hydro, grid, cfg,
                                dt)
    ip, fp = _params_for(grid, cfg, n, 1, hydro)
    rec = torch.empty((n + 1, RECORD), dtype=f32, device=dev)
    kernels.call("dem_substep", "yofc_dem_pack_drift", _KERNEL, ip, fp, dt, pos, vel, angvel,
                 radius, active, *carried, hydro.force, hydro.torque, rec, device=dev)
    return rec


def substep(records, nbr, hydro: dem.DEMForces, grid: Grid, cfg: dem.DEMConfig, dt,
            last: bool = False):
    """One substep from the record buffer of its drifted state: the contact
    force against the list ``nbr`` (N, K) int32 (N = empty) and the walls,
    the closing kick and, unless ``last``, the next half-kick and drift. ->
    a new record buffer, or with ``last`` (pos, vel, angvel, fc, tc)."""
    n = records.shape[0] - 1
    k = nbr.shape[1] if nbr.dim() == 2 else 0
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"{_KERNEL}: nbr must be (N, K) with 1 <= K <= {MAX_NEIGHBORS}; "
                         f"got {tuple(nbr.shape)}")
    dev = records.device
    cpu = kernels.on_cpu(_KERNEL, dev)
    kernels.require(_KERNEL, dev, ("records", records, (n + 1, RECORD), torch.float32, False),
                    ("nbr", nbr, (n, k), torch.int32, False), *_hydro(hydro, n),
                    ("dt", dt, (), torch.float32, False))
    if cpu:
        return substep_plain(records, nbr, hydro, grid, cfg, dt, last)
    ip, fp = _params_for(grid, cfg, n, k, hydro)
    if last:
        outs = tuple(torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(5))
        kernels.call("dem_substep", "yofc_dem_substep", _KERNEL, ip, fp, dt, records, nbr,
                     hydro.force, hydro.torque, None, *outs, device=dev)
    else:
        outs = torch.empty_like(records)
        kernels.call("dem_substep", "yofc_dem_substep", _KERNEL, ip, fp, dt, records, nbr,
                     hydro.force, hydro.torque, outs, None, None, None, None, None, device=dev)
    return outs
