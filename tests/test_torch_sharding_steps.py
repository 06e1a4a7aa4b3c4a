"""The port's sharded coupled step on gloo CPU ranks against the JAX
package's single-device scan, from the same numpy state (the 1-vs-N
tests of tests/test_sharding.py and test_round2_fixes.py, at their
tolerances): the settling sphere with the point-force exchange (PISO),
the Gaussian sparse exchange (PIMPLE) at 4 ranks by `make_sharded_scan`
and at 2 ranks by `make_sharded_step`, the window exchange at 2 ranks by
`make_sharded_step` (the slab window without the extended window), and
an inlet/outflow case with slip walls whose outflow lies on the sharded
axis."""

import dataclasses as dc

import numpy as np
import pytest

from test_round2_fixes import _PCFG as _PCFG_R2
from test_round2_fixes import _inlet_bcs
from torch_sharding_ranks import run_cases
from torch_sharding_ref import _gaussian_cfg, _initial_state, _settling_cfg, \
    assert_same_particles, by_pid, port_case, run_single
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import make_fluid_state, make_particle_state, \
    make_turbulence_state
from yade_openfoam_coupling_tpu.models.piso import PISOConfig
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.parallel import launch


def _settling():
    cfg = _settling_cfg()
    return cfg, _initial_state(cfg, [[4e-3, 4e-3, 6e-3]], 50e-6), 5


def _gaussian():
    cfg = _gaussian_cfg()
    pos = np.random.RandomState(0).uniform(0.003, 0.013, (24, 3))
    return cfg, _initial_state(cfg, pos, 4e-4), 4


def _window():
    cfg = _gaussian_cfg()
    cfg = dc.replace(cfg, coupling=dc.replace(cfg.coupling, lag_alpha=True, exchange="window",
                                              slot_capacity=4, dy_in_kernel=True))
    pos = np.random.RandomState(2).uniform(0.003, 0.013, (24, 3))
    return cfg, _initial_state(cfg, pos, 4e-4), 4


def _inlet():
    grid = Grid.cube(16, 0.016)
    cfg = jcd.CaseConfig(
        grid=grid, bcs=_inlet_bcs(0.01),
        transport=jcd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="piso", coupling=cp.CouplingConfig(gaussian=False),
        dem=dem.DEMConfig(params=dem.ContactParams(rho_p=2500.0), gravity=(0.0, 0.0, 0.0),
                          rho_f=1000.0),
        piso=PISOConfig(n_correctors=1, pressure=_PCFG_R2), n_dem_substeps=2, r_max=50e-6)
    state = jcd.initialize_state(
        make_fluid_state(grid), make_particle_state(pos=[[8e-3, 8e-3, 8e-3]], radius=50e-6),
        make_turbulence_state(grid), cfg, dt=1e-4)
    return cfg, state, 5


CASES = {"settling": (_settling, 4, "scan"), "gaussian": (_gaussian, 4, "scan"),
         "gaussian_2_ranks_step": (_gaussian, 2, "step"),
         "window_2_ranks_step": (_window, 2, "step"), "inlet": (_inlet, 4, "scan")}


@pytest.fixture(scope="module")
def results():
    """Every case's JAX reference, and the port's runs: one launch per rank
    count, each running its cases in turn."""
    refs, by_ranks = {}, {}
    for name, (build, n_ranks, how) in CASES.items():
        cfg, state, n = build()
        refs[name] = run_single(cfg, state, n)
        by_ranks.setdefault(n_ranks, []).append(port_case(name, cfg, state, n, how))
    port = {}
    for n_ranks, cases in by_ranks.items():
        port.update(launch(run_cases, n_ranks, "gloo", "cpu", (cases,), timeout=120)[0])
    return refs, port


def test_point_force_sharded_matches_single(results):
    (s1, d1), (s8, d8) = results[0]["settling"], results[1]["settling"]
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), vel_tol=(1e-3, 1e-9))
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, atol=5e-7)
    assert int(d8["n_found"][-1]) == 1


@pytest.mark.parametrize("name", ["gaussian", "gaussian_2_ranks_step", "window_2_ranks_step"])
def test_gaussian_4way_sharded_matches_single(results, name):
    (s1, d1), (s8, d8) = results[0][name], results[1][name]
    np.testing.assert_allclose(s8.fluid.alpha, s1.fluid.alpha, rtol=1e-4, atol=1e-6)
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), pos_tol=(1e-4, 1e-8))
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, rtol=1e-2, atol=1e-5)
    assert int(d8["n_found"][-1]) == 24
    assert int(d8["n_shard_overflow"][-1]) == 0


def test_sharded_inlet_outflow_slip_matches_single(results):
    (s1, _), (s8, _) = results[0]["inlet"], results[1]["inlet"]
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, rtol=1e-4, atol=5e-8)
    # the x outflow plane (carried on the last rank) equals the single run's
    np.testing.assert_allclose(s8.fluid.phi[0][-1], s1.fluid.phi[0][-1], rtol=1e-5,
                               atol=1e-9)


def test_sharded_diagnostics_are_global(results):
    """Every reduced diagnostic of the sharded run is the global one: the
    particle counts match the single run's exactly, and the pressure
    solve converges on every step."""
    for name in CASES:
        (_, d1), (_, d8) = results[0][name], results[1][name]
        np.testing.assert_array_equal(d8["n_found"], d1.n_found)
        np.testing.assert_array_equal(d8["n_contact_overflow"], d1.n_contact_overflow)
        assert np.all(d8["p_final_residual"] <= np.maximum(1e-5 * d8["p_initial_residual"],
                                                           5e-6)), name
