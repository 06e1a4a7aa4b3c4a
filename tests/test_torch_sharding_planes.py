"""The port's sharded slot-plane exchanges and solvers on gloo CPU ranks
against the JAX package's single-device scan, from the same numpy state
(tests/test_sharding.py's 1-vs-N tests and tolerances): the planes
exchange with the fused kernel B4's plain version at 4 ranks and the
two-kernel path (B5, the force laws, B6) at 2."""

import dataclasses as dc

import numpy as np
import pytest

from torch_sharding_ranks import run_cases
from torch_sharding_ref import _gaussian_cfg, _initial_state, assert_same_particles, \
    by_pid, port_case, run_single
from yade_openfoam_coupling_tpu_torch.parallel import launch


def _planes(fused=True):
    cfg = _gaussian_cfg()
    cfg = dc.replace(cfg, coupling=dc.replace(
        cfg.coupling, lag_alpha=True, exchange="planes", slot_capacity=4, packed_bin="col",
        dy_in_kernel=True, packed_unbin=True, fused_planes=fused))
    pos = np.random.RandomState(1).uniform(0.003, 0.013, (24, 3))
    return cfg, _initial_state(cfg, pos, 4e-4), 4


CASES = {"planes": (_planes, 4), "planes_two_kernel": (lambda: _planes(False), 2)}


@pytest.fixture(scope="module")
def results():
    refs, by_ranks = {}, {}
    for name, (build, n_ranks) in CASES.items():
        cfg, state, n = build()
        refs[name] = run_single(cfg, state, n)
        by_ranks.setdefault(n_ranks, []).append(port_case(name, cfg, state, n))
    port = {}
    for n_ranks, cases in by_ranks.items():
        port.update(launch(run_cases, n_ranks, "gloo", "cpu", (cases,), timeout=120)[0])
    return refs, port


@pytest.mark.parametrize("name", ["planes", "planes_two_kernel"])
def test_gaussian_planes_sharded_matches_single(results, name):
    (s1, _), (s8, d8) = results[0][name], results[1][name]
    np.testing.assert_allclose(s8.fluid.alpha, s1.fluid.alpha, rtol=1e-4, atol=1e-6)
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), pos_tol=(1e-4, 1e-8))
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, rtol=1e-2, atol=1e-5)
    assert int(d8["n_found"][-1]) == 24
    assert int(d8["n_coupling_overflow"][-1]) == 0
