"""The port's chunked sharded scan (one migration and one frozen ghost
plan + Verlet list per chunk, the exchange on the extended slab with
depth-2 halos and the periodic wrap) on gloo CPU ranks against the JAX
package's single-device chunked scan, from the same numpy state
(tests/test_sharding.py's chunked test and tolerances), for the window
and planes exchanges at 4 ranks and the window exchange at 2."""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest

from torch_sharding_ranks import run_cases
from torch_sharding_ref import _gaussian_cfg, assert_same_particles, by_pid, port_case, \
    run_single
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import make_fluid_state, make_particle_state, \
    make_turbulence_state
from yade_openfoam_coupling_tpu_torch.parallel import launch

L, R, N_P, N_STEPS = 0.016, 4e-4, 96, 6      # 2 chunks of 3


def _chunked(exchange):
    cfg = _gaussian_cfg()
    cfg = dc.replace(
        cfg,
        coupling=dc.replace(cfg.coupling, lag_alpha=True, exchange=exchange, slot_capacity=6,
                            dy_in_kernel=True),
        dem=dc.replace(cfg.dem, neighbor="cells", cell_capacity=10, max_neighbors=24,
                       shear_history=True, list_reuse=True, list_rebuild_steps=3, skin=0.25,
                       cundall_damping=0.2,
                       params=dc.replace(cfg.dem.params, kn=10.0, friction=0.4)))
    rng = np.random.RandomState(7)
    side = np.linspace(0.2 * L, 0.8 * L, 8)
    lat = np.stack(np.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
    sites = lat[rng.choice(len(lat), N_P, replace=False)]
    pos = (sites + rng.uniform(-2e-4, 2e-4, (N_P, 3))).astype(np.float32)
    vel = np.zeros((N_P, 3), np.float32)
    vel[:, 0] = rng.choice([-0.15, 0.15], N_P)
    # global-edge wrap-crossers, coupled through the first/last rank's
    # wrapped window plane mid-chunk
    pos[:4, 0] = 1.1e-5
    vel[:4, 0] = -0.15
    pos[4:8, 0] = L - 1.1e-5
    vel[4:8, 0] = 0.15
    # an overlapping chain on the floor: engaged frozen shear springs
    pos[8:20, 0] = 0.004 + np.arange(12) * 1.9 * R
    pos[8:20, 1] = L / 2
    pos[8:20, 2] = R * 0.98
    vel[8:20] = 0.0
    state = jcd.initialize_state(
        make_fluid_state(cfg.grid),
        make_particle_state(pos=jnp.asarray(pos), vel=jnp.asarray(vel), radius=R),
        make_turbulence_state(cfg.grid), cfg, dt=5e-5)
    return cfg, state


CASES = {"window": ("window", 4), "planes": ("planes", 4), "window_2_ranks": ("window", 2)}


@pytest.fixture(scope="module")
def results():
    refs, by_ranks = {}, {}
    for name, (exchange, n_ranks) in CASES.items():
        cfg, state = _chunked(exchange)
        if exchange not in refs:
            refs[exchange] = run_single(cfg, state, N_STEPS)
        by_ranks.setdefault(n_ranks, []).append(port_case(name, cfg, state, N_STEPS))
    port = {}
    for n_ranks, cases in by_ranks.items():
        port.update(launch(run_cases, n_ranks, "gloo", "cpu", (cases,), timeout=120)[0])
    return refs, port


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_sharded_matches_single_chunked(results, name):
    (s1, d1), (s8, d8) = results[0][CASES[name][0]], results[1][name]
    # every particle stays coupled every step, also outside its owner slab
    # mid-chunk (the extended window)
    np.testing.assert_array_equal(d8["n_found"], np.full(N_STEPS, N_P))
    for d in (d1._asdict(), d8):
        assert int(np.max(d["n_contact_overflow"])) == 0
        assert int(np.max(d["n_coupling_overflow"])) == 0
    assert int(np.max(d8["n_shard_overflow"])) == 0
    p1, p8 = by_pid(s1.particles), by_pid(s8.particles)
    # vel atol: near-zero components wiggle by ~2e-5 with the reduction order
    assert_same_particles(p1, p8, pos_tol=(1e-4, 1e-8), vel_tol=(5e-3, 5e-5))
    np.testing.assert_allclose(s8.fluid.alpha, s1.fluid.alpha, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s8.fluid.u, s1.fluid.u, rtol=1e-2, atol=1e-5)
    assert float(np.abs(s8.particles.shear_xi).sum()) > 0.0
    # the wrap-crossers really wrapped across the global x edge
    w = np.isin(p1["pid"], np.arange(8))
    assert (p8["pos"][w][:4, 0] > 0.9 * L).all()
    assert (p8["pos"][w][4:, 0] < 0.1 * L).all()
