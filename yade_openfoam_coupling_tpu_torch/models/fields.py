"""State tuples: fluid, particles, turbulence and the coupled sim state
(port of `yade_openfoam_coupling_tpu/models/fields.py`)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.grid import Grid

FaceFlux = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class FluidState(NamedTuple):
    """The grid half of the coupled state."""

    u: torch.Tensor              # (3, nx, ny, nz) velocity
    u_old: torch.Tensor          # previous-step velocity
    p: torch.Tensor              # (nx, ny, nz) kinematic pressure p/rho
    phi: FaceFlux                # face-normal velocities
    alpha: torch.Tensor          # fluid volume fraction
    alpha_old: torch.Tensor
    u_source: torch.Tensor       # (3, grid) explicit momentum source [m/s^2]
    u_source_drag: torch.Tensor  # implicit drag coefficient [1/s], <= 0
    u_particle: torch.Tensor     # (3, grid) cell-averaged particle velocity
    p_prev: Optional[torch.Tensor] = None


class TurbulenceState(NamedTuple):
    """Closure state for the DPM turbulence models."""

    k: torch.Tensor
    epsilon: torch.Tensor
    nut: torch.Tensor


class ParticleState(NamedTuple):
    """Fixed-capacity SoA particle arrays; ``active`` masks padding."""

    pos: torch.Tensor       # (N, 3)
    vel: torch.Tensor       # (N, 3)
    angvel: torch.Tensor    # (N, 3)
    radius: torch.Tensor    # (N,)
    active: torch.Tensor    # (N,) bool
    pid: torch.Tensor       # (N,) int32 stable identity (-1 = padding)
    shear_xi: Optional[torch.Tensor] = None
    shear_ids: Optional[torch.Tensor] = None
    shear_wall: Optional[torch.Tensor] = None
    # persistent Verlet list and the positions it was built at; the port
    # updates no tensor in place, and nbr_ref_pos is always its own copy
    nbr: Optional[torch.Tensor] = None          # (N, M) int32
    nbr_ref_pos: Optional[torch.Tensor] = None  # (N, 3)
    contact_f: Optional[torch.Tensor] = None    # (N, 3)
    contact_t: Optional[torch.Tensor] = None    # (N, 3)

    @property
    def n_capacity(self) -> int:
        return self.pos.shape[0]


class SimState(NamedTuple):
    """Everything one coupled step advances."""

    fluid: FluidState
    particles: ParticleState
    turb: TurbulenceState
    t: torch.Tensor          # simulation time
    dt: torch.Tensor         # current fluid time step
    step: torch.Tensor       # int32 step counter


class StepDiagnostics(NamedTuple):
    """Per-step observability (Courant, continuity, pressure solve,
    particle counters)."""

    co_mean: torch.Tensor
    co_max: torch.Tensor
    cont_err_local: torch.Tensor
    cont_err_global: torch.Tensor
    p_iters: torch.Tensor
    p_initial_residual: torch.Tensor
    p_final_residual: torch.Tensor
    n_found: torch.Tensor
    max_particle_speed: torch.Tensor
    n_contact_overflow: torch.Tensor
    n_coupling_overflow: torch.Tensor
    n_shard_overflow: torch.Tensor
    n_dem_sub: torch.Tensor


def make_fluid_state(grid: Grid, device, dtype=torch.float32) -> FluidState:
    ones = torch.ones(grid.shape, dtype=dtype, device=device)
    return FluidState(
        u=grid.zeros_vector(device, dtype),
        u_old=grid.zeros_vector(device, dtype),
        p=grid.zeros_scalar(device, dtype),
        phi=grid.zeros_flux(device, dtype),
        alpha=ones,
        alpha_old=ones.clone(),
        u_source=grid.zeros_vector(device, dtype),
        u_source_drag=grid.zeros_scalar(device, dtype),
        u_particle=grid.zeros_vector(device, dtype),
    )


def make_turbulence_state(grid: Grid, device, k0: float = 0.0, eps0: float = 0.0,
                          dtype=torch.float32) -> TurbulenceState:
    return TurbulenceState(
        k=torch.full(grid.shape, k0, dtype=dtype, device=device),
        epsilon=torch.full(grid.shape, eps0, dtype=dtype, device=device),
        nut=grid.zeros_scalar(device, dtype),
    )


def make_particle_state(pos, device, vel=None, angvel=None, radius=0.001,
                        capacity: Optional[int] = None,
                        dtype=torch.float32) -> ParticleState:
    """Build a padded particle state from (n,3) positions."""
    pos = torch.as_tensor(np.asarray(pos), dtype=dtype, device=device)
    n = pos.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} particles")

    def pad2(x, fill=0.0):
        return torch.cat([x, torch.full((cap - n,) + tuple(x.shape[1:]), fill,
                                        dtype=dtype, device=device)])

    def as_t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    vel = torch.zeros((n, 3), dtype=dtype, device=device) if vel is None else as_t(vel)
    angvel = torch.zeros((n, 3), dtype=dtype, device=device) if angvel is None else as_t(angvel)
    radius = (torch.full((n,), float(radius), dtype=dtype, device=device)
              if np.ndim(radius) == 0 else as_t(radius))
    active = torch.cat([torch.ones(n, dtype=torch.bool, device=device),
                        torch.zeros(cap - n, dtype=torch.bool, device=device)])
    pid = torch.cat([torch.arange(n, dtype=torch.int32, device=device),
                     torch.full((cap - n,), -1, dtype=torch.int32, device=device)])
    return ParticleState(
        pos=pad2(pos), vel=pad2(vel), angvel=pad2(angvel),
        radius=pad2(radius, 1e-6), active=active, pid=pid,
    )
