"""Ring migration in the port's sharded scan: particles driven across
slab boundaries (and the periodic x wrap) on 4 gloo CPU ranks match, by
pid, both the JAX package's single-device scan and its own
`make_sharded_scan` on 4 virtual devices (tests/test_sharding.py's
migration test and tolerances); and a checkpoint round trip of the
sharded layout (gathered, saved, restored, scattered) continues exactly
as the run that was never stopped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_sharding_ranks import checkpoint_round_trip, run_cases
from torch_sharding_ref import _gaussian_cfg, _initial_state, _settling_cfg, \
    assert_same_particles, by_pid, port_case, run_single
from yade_openfoam_coupling_tpu.parallel import make_mesh
from yade_openfoam_coupling_tpu.parallel import sharded as jsh
from yade_openfoam_coupling_tpu_torch.parallel import launch

N_RANKS = 4

pytestmark = pytest.mark.skipif(len(jax.devices()) < N_RANKS, reason="needs 4 virtual devices")


def _migration_case():
    cfg = _gaussian_cfg()
    # straddle the x slab boundaries (4 mm slabs at 4 ranks) with strong
    # +-x velocities so several particles hop slabs within 6 steps
    pos = np.array([
        [3.9e-3, 8e-3, 8e-3], [4.1e-3, 5e-3, 9e-3],
        [7.95e-3, 8e-3, 8e-3], [8.05e-3, 4e-3, 10e-3],
        [11.9e-3, 6e-3, 7e-3], [15.9e-3, 7e-3, 8e-3],   # wraps periodic x
        [0.1e-3, 9e-3, 9e-3],
        [5.0e-3, 5.0e-3, 8e-3],
    ])
    # y and z off the cell faces: the JAX package's jitted `locate` divides
    # by h as a product with 1/h, its eager one divides, and the two place
    # a particle lying exactly on a face (0.006 / 0.001) in different cells
    pos[:, 1:] += 0.37e-3
    vel = np.zeros((8, 3), np.float32)
    vel[:, 0] = [0.4, -0.4, 0.4, -0.4, 0.4, 0.4, -0.4, 0.0]
    state = _initial_state(cfg, pos, 4e-4)
    state = state._replace(particles=state.particles._replace(vel=jnp.asarray(vel)))
    return cfg, state, 6


@pytest.fixture(scope="module")
def migration():
    cfg, state, n = _migration_case()
    single = run_single(cfg, state, n)
    mesh = make_mesh(N_RANKS)
    out, d = jsh.make_sharded_scan(cfg, mesh, n)(jsh.to_sharded_state(state, cfg, mesh))
    jax_sharded = (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, d))
    port = launch(run_cases, N_RANKS, "gloo", "cpu",
                  ([port_case("migration", cfg, state, n)],), timeout=120)[0]["migration"]
    return state, single, jax_sharded, port


@pytest.mark.parametrize("ref", ["single", "jax_sharded"])
def test_migration_across_slabs_matches(migration, ref):
    state, single, jax_sharded, (s8, d8) = migration
    s1, _ = single if ref == "single" else jax_sharded
    # atol: f32 halo/deposit reordering noise accumulated over 6 steps
    assert_same_particles(by_pid(s1.particles), by_pid(s8.particles), pos_tol=(1e-4, 2e-6),
                          vel_tol=(1e-3, 1e-5))
    assert int(d8["n_shard_overflow"][-1]) == 0
    # everyone remains coupled at the end (settled in their owner slabs)
    assert int(d8["n_found"][-1]) == 8


def test_migration_really_moved_particles(migration):
    """The straddlers changed slab, and the slot layout of the port's
    gathered state holds every particle once, in its owner's block."""
    state, (s1, _), _, (s8, _) = migration
    slab0 = (np.asarray(state.particles.pos)[:, 0] // 4e-3).astype(int)
    p = by_pid(s8.particles)
    slab1 = (p["pos"][:, 0] // 4e-3).astype(int) % N_RANKS
    assert (slab0[np.argsort(np.asarray(state.particles.pid))] != slab1).sum() >= 4
    act = s8.particles.active
    cap = act.shape[0] // N_RANKS
    block = np.arange(act.shape[0]) // cap
    owner = (s8.particles.pos[:, 0] // 4e-3).astype(int) % N_RANKS
    assert np.all(block[act] == owner[act])


def test_sharded_checkpoint_round_trip(tmp_path):
    """Gather, save with the port's checkpoint module, restore, scatter and
    continue: bit for bit the run that was never stopped (the JAX
    package's test_sharded_checkpoint, on the settling sphere)."""
    cfg = _settling_cfg()
    state = _initial_state(cfg, [[4e-3, 4e-3, 6e-3]], 50e-6)
    _, pcfg, pstate, n, _ = port_case("ck", cfg, state, 3)
    direct, resumed, d = launch(checkpoint_round_trip, N_RANKS, "gloo", "cpu",
                                (pcfg, pstate, n, str(tmp_path / "ck")), timeout=120)[0]
    assert np.all(np.isfinite(resumed.fluid.u))
    assert int(d["n_found"][-1]) == 1
    for a, b in ((direct.fluid.u, resumed.fluid.u), (direct.fluid.p, resumed.fluid.p),
                 (direct.particles.pos, resumed.particles.pos),
                 (direct.particles.vel, resumed.particles.vel), (direct.t, resumed.t)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(direct.fluid.phi, resumed.fluid.phi):
        np.testing.assert_array_equal(a, b)
