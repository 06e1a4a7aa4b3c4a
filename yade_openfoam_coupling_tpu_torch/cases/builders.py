"""Builders for the validation cases (port of
`yade_openfoam_coupling_tpu/cases/builders.py`): the PISO point-force
cases `settling_sphere` and `sedimentation_cloud`, and the PIMPLE cases.
Each returns (cfg, state, dt) with the state on ``device`` (default
``cuda``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..models import coupled as cd
from ..models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from ..models.pimple import PIMPLEConfig
from ..models.piso import FluidBCs, PISOConfig
from ..models.turbulence import TurbulenceConfig
from ..ops import coupling as cp
from ..ops import dem
from ..ops import pressure as pr
from ..ops.grid import DIRICHLET, NEUMANN, PERIODIC, FaceBC, FieldBC, Grid

WATER = cd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0)


def _init(cfg, pos, radius, dt, device, k0=0.0, capacity=None):
    state = cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(pos, device, radius=radius, capacity=capacity),
        make_turbulence_state(cfg.grid, device, k0=k0),
        cfg, dt=dt)
    return cfg, state, dt


def settling_sphere(n: int = 16, device="cuda") -> Tuple[cd.CaseConfig, SimState, float]:
    """Config #1: one sphere settling in a closed box, point-force PISO; its
    terminal velocity has the analytic Stokes value."""
    cfg = cd.CaseConfig(
        grid=Grid.cube(n, 8e-3), bcs=FluidBCs.box_noslip(), transport=WATER, solver="piso",
        coupling=cp.CouplingConfig(gaussian=False),
        dem=dem.DEMConfig(params=dem.ContactParams(rho_p=WATER.rho_p),
                          gravity=(0.0, 0.0, -9.81), buoyancy=True, rho_f=WATER.rho_f),
        piso=PISOConfig(n_correctors=1),
        n_dem_substeps=10,
        r_max=50e-6,
    )
    return _init(cfg, [[4e-3, 4e-3, 6e-3]], 50e-6, 2e-4, device, capacity=4)


def sedimentation_cloud(n_particles: int = 500, n: int = 32, seed: int = 0,
                        device="cuda") -> Tuple[cd.CaseConfig, SimState, float]:
    """Config #2: a sedimenting sphere cloud, point-force PISO with
    contacts."""
    radius = 150e-6
    cfg = cd.CaseConfig(
        grid=Grid.cube(n, 0.02), bcs=FluidBCs.box_noslip(), transport=WATER, solver="piso",
        coupling=cp.CouplingConfig(gaussian=False),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=50.0, restitution=0.5, rho_p=WATER.rho_p),
            gravity=(0.0, 0.0, -9.81), buoyancy=True, rho_f=WATER.rho_f,
            neighbor="allpairs"),
        piso=PISOConfig(n_correctors=1),
        n_dem_substeps=10,
        r_max=radius,
    )
    pos = np.random.RandomState(seed).uniform(0.004, 0.016, (n_particles, 3))
    return _init(cfg, pos, radius, 1e-4, device)


def fluidized_bed(n_particles: int = 10_000, n: int = 48, seed: int = 0,
                  turbulence: str = "kEqn", inlet_velocity: float = 0.0,
                  device="cuda") -> Tuple[cd.CaseConfig, SimState, float]:
    """Config #3: fluidized bed, PIMPLE 4-way. A bed at the bottom of a
    periodic-x/y column under gravity; `inlet_velocity > 0` drives a fixed
    upward inflow at z-lo with zero-gradient outflow at z-hi, 0 gives the
    closed settling column."""
    grid = Grid.box((n // 2, n // 2, n), (0.01, 0.01, 0.02))
    radius = 1.5e-4
    if inlet_velocity > 0.0:
        p = FaceBC(PERIODIC)
        bcs = FluidBCs(
            u=FieldBC(((p, p), (p, p), (FaceBC(DIRICHLET, (0.0, 0.0, inlet_velocity)),
                                        FaceBC(NEUMANN)))),
            p=FieldBC(((p, p), (p, p), (FaceBC(NEUMANN), FaceBC(NEUMANN)))),
        )
    else:
        bcs = FluidBCs.channel_z()
    cfg = cd.CaseConfig(
        grid=grid, bcs=bcs, transport=WATER, solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=50.0, restitution=0.5, rho_p=WATER.rho_p),
            gravity=(0.0, 0.0, -9.81), rho_f=WATER.rho_f,
            periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=8),
        pimple=PIMPLEConfig(n_outer=2, n_correctors=1),
        turbulence=TurbulenceConfig(model=turbulence),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=5,
        r_max=radius,
    )
    rng = np.random.RandomState(seed)
    pos = rng.uniform((5e-4, 5e-4, 5e-4), (9.5e-3, 9.5e-3, 8e-3), (n_particles, 3))
    return _init(cfg, pos, radius, 5e-5, device, k0=1e-6)


def dense_suspension(n_particles: int = 100_000, n: int = 128, seed: int = 0,
                     device="cuda") -> Tuple[cd.CaseConfig, SimState, float]:
    """Config #4: dense suspension in a periodic channel, 128^3."""
    grid = Grid.cube(n, 1e-3 * n)
    radius = 4e-4
    cfg = cd.CaseConfig(
        grid=grid, bcs=FluidBCs.channel_z(), transport=WATER, solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, restitution=0.5, rho_p=WATER.rho_p),
            gravity=(0.0, 0.0, -9.81), rho_f=WATER.rho_f,
            periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=8),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="mgpcg", tol=1e-5, maxiter=40)),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4,
        r_max=radius,
    )
    rng = np.random.RandomState(seed)
    L = grid.lengths
    pos = rng.uniform((0.05 * L[0], 0.05 * L[1], 0.05 * L[2]),
                      (0.95 * L[0], 0.95 * L[1], 0.95 * L[2]), (n_particles, 3))
    return _init(cfg, pos, radius, 5e-5, device, k0=1e-6)


def fluidized_bed_1m(n_particles: int = 1_000_000, n: int = 256, seed: int = 0,
                     device="cuda") -> Tuple[cd.CaseConfig, SimState, float]:
    """Config #5: 1M particles on 256^3 with lag_alpha and 8 particle
    chunks in the exchange (`gaussian_coupling_chunked`)."""
    cfg, state, dt = dense_suspension(n_particles=n_particles, n=n, seed=seed, device=device)
    cfg = dataclasses.replace(
        cfg,
        coupling=dataclasses.replace(cfg.coupling, lag_alpha=True, particle_chunks=8),
        dem=dataclasses.replace(cfg.dem, force_chunks=8),
    )
    return cfg, state, dt
