"""JAX-side helpers of the port's 1-vs-N sharding tests: build a case in
the JAX package (the configurations of tests/test_sharding.py), run its
single-device `make_scan_fn`, hand the same numpy state to the port's
ranks, and compare by pid at that file's tolerances."""

from __future__ import annotations

import jax
import numpy as np

from test_sharding import _gaussian_cfg, _initial_state, _settling_cfg  # noqa: F401
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.parallel import sharded as jsh
from yade_openfoam_coupling_tpu_torch.convert import case_config_from, state_from_numpy, \
    state_to_numpy


def port_case(name, jcfg, jstate, n, how="scan"):
    """The case as the port's ranks take it: (name, port CaseConfig, the
    initial state as a port SimState of numpy arrays, steps, how)."""
    tree = jax.tree.map(np.asarray, jstate)
    return (name, case_config_from(jcfg), state_to_numpy(state_from_numpy(tree, "cpu")), n,
            how)


def run_single(jcfg, jstate, n):
    """The JAX package's single-device scan, as numpy."""
    s, d = jcd.make_scan_fn(jcfg, n)(jstate)
    return jax.tree.map(np.asarray, s), jax.tree.map(np.asarray, d)


def by_pid(ps):
    return jsh.particles_by_pid(ps)


def assert_same_particles(p_ref, p_port, pos_tol=None, vel_tol=None):
    """pids equal; pos and vel at their (rtol, atol), where given."""
    np.testing.assert_array_equal(p_port["pid"], p_ref["pid"])
    for key, tol in (("pos", pos_tol), ("vel", vel_tol)):
        if tol is not None:
            np.testing.assert_allclose(p_port[key], p_ref[key], rtol=tol[0], atol=tol[1],
                                       err_msg=key)
