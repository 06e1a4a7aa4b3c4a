"""Each bench case's path at a small size, run by both packages from the
same numpy state for 4 coupled steps (`make_scan_fn`), at the slice
tolerances and step count of test_torch_coupled.py: counters equal step
by step, the state within 1e-4 of each field's scale, the float
diagnostics within 1e-3. (The fluid starts at rest: in the second step
its velocity is ~5e-4 m/s and the pressure equation's right-hand side a
cancellation, so its pressure agrees only to ~3e-4 of its scale, and the
third step's Archimedes source, built on that pressure gradient, as
well; from the third step on the flow has grown and the pressure agrees
to ~2e-5.) The configurations are the reference scripts' cut to 16^3 (the
ladder's builders at their own reduced sizes), with a few hundred
particles and seeded velocities of ~1 cm/s:

  * bench_1m's default case: the planes exchange in 2 x-slabs, mgpcg (304
    particles);
  * bench_1m --fast: the window exchange with 4 slots, fftpcg;
  * ladder #3: the fluidized bed's overlay, the window exchange with 6
    slots (a 16 x 16 x 32 bed, 300 particles);
  * ladder #2: the sedimentation cloud, PISO with the point-force
    exchange (16^3, 200 particles).

The JAX package's Pallas kernels run in interpret mode on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.cases import builders as jb
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.cases import builders as tb
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.scripts import bench_1m, bench_ladder

from test_torch_bench import ladder3_overlay, reference_bench_1m
from test_torch_coupled import _close, _np_tree, lattice

N_STEPS = 4
CPU = torch.device("cpu")


def _bench_1m_case(argv, planes_chunks):
    """The reference bench_1m configuration for argv on a 16^3 grid, its
    lattice of 304 particles; the port's own configuration at that size
    must be the same (304 particles: the JAX package needs a capacity
    divisible by force_chunks=8)."""
    with pytest.MonkeyPatch.context() as mp:
        cfg, _ = reference_bench_1m(argv, mp)
    coupling = (dataclasses.replace(cfg.coupling, planes_chunks=planes_chunks)
                if planes_chunks else cfg.coupling)
    cfg = dataclasses.replace(cfg, grid=Grid.cube(16, 0.016), coupling=coupling)
    port = bench_1m.case_config(bench_1m.build_parser().parse_args(argv), 16)
    if planes_chunks:
        port = dataclasses.replace(port, coupling=dataclasses.replace(
            port.coupling, planes_chunks=planes_chunks))
    assert port == case_config_from(cfg)
    return cfg, lattice(304, 0.016), 4e-4, 5e-5


def _ladder3_case():
    cfg, state, dt = jb.fluidized_bed(n_particles=300, n=32)
    cfg = ladder3_overlay(cfg)
    port, _, _ = tb.fluidized_bed(n_particles=300, n=32, device=CPU)
    assert bench_ladder.fluidized_bed_config(port) == case_config_from(cfg)
    return cfg, np.asarray(state.particles.pos), np.asarray(state.particles.radius), dt


def _ladder2_case():
    cfg, state, dt = jb.sedimentation_cloud(n_particles=200, n=16)
    port, _, _ = tb.sedimentation_cloud(n_particles=200, n=16, device=CPU)
    assert port == case_config_from(cfg)
    return cfg, np.asarray(state.particles.pos), np.asarray(state.particles.radius), dt


CASES = {
    "bench_1m_planes_2_slabs": lambda: _bench_1m_case([], 2),
    "bench_1m_fast_window": lambda: _bench_1m_case(["--fast"], 0),
    "ladder3_window_cap6": _ladder3_case,
    "ladder2_piso_point_force": _ladder2_case,
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """(name, JAX state and diagnostics, the port's) after N_STEPS steps
    from the same initial numpy state."""
    cfg, pos, radius, dt = CASES[request.param]()
    n = len(pos)
    vel = (1e-2 * np.random.RandomState(1).randn(n, 3)).astype(np.float32)
    parts = (make_fluid_state(cfg.grid),
             make_particle_state(pos=np.asarray(pos, np.float32), vel=vel, radius=radius),
             make_turbulence_state(cfg.grid, k0=1e-6))
    s0 = jcd.initialize_state(*parts, cfg, dt=dt)
    raw = _np_tree(SimState(*parts, t=np.float32(0), dt=np.float32(dt), step=np.int32(0)))
    t = state_from_numpy(raw, CPU)
    tcfg = case_config_from(cfg)
    t0 = tcd.initialize_state(t.fluid, t.particles, t.turb, tcfg, dt=dt)
    ref_s, ref_d = jcd.make_scan_fn(cfg, N_STEPS)(s0)
    out_s, out_d = tcd.make_scan_fn(tcfg, N_STEPS)(t0)
    return (request.param, _np_tree(ref_s), _np_tree(ref_d), state_to_numpy(out_s),
            {k: v.numpy() for k, v in out_d._asdict().items()})


def test_path_counters_match(runs):
    """Pressure iterations, DEM substeps, found particles and every
    overflow counter equal the JAX package's, step by step; every
    particle is found."""
    name, _, ref_d, _, out_d = runs
    for key in ("p_iters", "n_contact_overflow", "n_coupling_overflow", "n_found",
                "n_dem_sub"):
        np.testing.assert_array_equal(out_d[key], np.asarray(getattr(ref_d, key)),
                                      err_msg=f"{name}: {key}")
    assert np.all(out_d["n_found"] == out_d["n_found"][0]), name


def test_path_state_matches(runs):
    """The final fluid, particle and turbulence state within 1e-4 of each
    field's scale, the float diagnostics within 1e-3."""
    name, ref_s, ref_d, out_s, out_d = runs
    for key in ("u", "p", "alpha", "u_source", "u_particle"):
        _close(f"{name}: {key}", getattr(out_s.fluid, key), getattr(ref_s.fluid, key), 1e-4)
    for key in ("pos", "vel", "angvel"):
        _close(f"{name}: {key}", getattr(out_s.particles, key),
               getattr(ref_s.particles, key), 1e-4)
    for key in ("k", "nut"):
        _close(f"{name}: {key}", getattr(out_s.turb, key), getattr(ref_s.turb, key), 1e-4)
    for key in ("co_max", "p_initial_residual", "max_particle_speed"):
        _close(f"{name}: {key}", out_d[key], np.asarray(getattr(ref_d, key)), 1e-3)
