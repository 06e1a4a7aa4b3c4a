"""The port's sharded solvers on gloo CPU ranks against the JAX package's
single-device scan, from the same numpy state (tests/test_sharding.py's
1-vs-N tests and tolerances): fftpcg with its block-local preconditioner,
and the pid-keyed shear springs carried through ghosts and migration."""

import dataclasses as dc

import numpy as np
import pytest

from torch_sharding_ranks import run_cases
from torch_sharding_ref import _gaussian_cfg, _initial_state, assert_same_particles, \
    by_pid, port_case, run_single
from yade_openfoam_coupling_tpu.ops import pressure as pr
from yade_openfoam_coupling_tpu_torch.parallel import launch


def _fftpcg():
    cfg = _gaussian_cfg()
    cfg = dc.replace(
        cfg, coupling=dc.replace(cfg.coupling, lag_alpha=True, exchange="planes",
                                 slot_capacity=4, packed_bin="col", dy_in_kernel=True),
        pimple=dc.replace(cfg.pimple, pressure=pr.PressureSolverConfig(
            solver="fftpcg", tol=1e-7, maxiter=600)))
    pos = np.random.RandomState(3).uniform(0.003, 0.013, (24, 3))
    return cfg, _initial_state(cfg, pos, 4e-4), 4


def _shear():
    cfg = _gaussian_cfg()
    cfg = dc.replace(cfg, dem=dc.replace(
        cfg.dem, neighbor="cells", cell_capacity=8, max_neighbors=8, shear_history=True,
        cundall_damping=0.2, skin=0.1,
        params=dc.replace(cfg.dem.params, kn=100.0, friction=0.4)))
    # a settling chain on the floor across the 4 mm slab edges: persistent
    # particle and wall contacts carry their springs through ghosts and
    # migration
    r = 4e-4
    xs = 0.002 + np.arange(16) * 1.9 * r
    pos = np.column_stack([xs, np.full(16, 8e-3), np.full(16, r * 0.98)])
    return cfg, _initial_state(cfg, pos, np.full(16, r)), 5


CASES = {"fftpcg": (_fftpcg, 4), "shear": (_shear, 4)}


@pytest.fixture(scope="module")
def results():
    refs, cases = {}, []
    for name, (build, _) in CASES.items():
        cfg, state, n = build()
        refs[name] = run_single(cfg, state, n)
        cases.append(port_case(name, cfg, state, n))
    return refs, launch(run_cases, 4, "gloo", "cpu", (cases,), timeout=120)[0]


def test_fftpcg_sharded_matches_single(results):
    """The block-local spectral preconditioner (Dirichlet-0 on the slab
    faces) differs from the single run's, so p agrees within the CG
    tolerance."""
    (s1, _), (s8, d8) = results[0]["fftpcg"], results[1]["fftpcg"]
    np.testing.assert_allclose(s8.fluid.p, s1.fluid.p, rtol=1e-3, atol=1e-7)
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), pos_tol=(1e-4, 1e-8))
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, rtol=1e-2, atol=1e-5)
    assert int(d8["n_found"][-1]) == 24
    assert int(d8["n_coupling_overflow"][-1]) == 0


def test_shear_history_sharded_matches_single(results):
    (s1, _), (s8, _) = results[0]["shear"], results[1]["shear"]
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), pos_tol=(1e-4, 1e-8),
                          vel_tol=(1e-3, 1e-7))
    # the boundary-straddling contacts persist: engaged springs
    assert float(np.abs(s1.particles.shear_xi).sum()) > 0.0
    assert float(np.abs(s8.particles.shear_xi).sum()) > 0.0
