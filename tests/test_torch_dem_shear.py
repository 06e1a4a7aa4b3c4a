"""The DEM's tangential spring history (Yade Law2_ScGeom_FrictPhys_CundallStrack)
in the PyTorch port against the JAX package: the partner keys and the
spring carry exactly, the history pair and wall forces, the three physics
tests of tests/test_dem_shear.py run in both packages, and bench.py's
`--yade-physics` slice (window exchange, shear history, dynamic substeps,
8 substeps, frozen Verlet list) over 4 coupled steps at 16^3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import closing_pairs
from test_torch_coupled import _close, _np_tree, bench_config, jax_equivalent
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem

GRID = Grid.cube(16, 1.0)


def _params(**kw):
    d = dict(kn=1e3, kt_over_kn=0.5, restitution=0.9, friction=0.3, rho_p=2500.0)
    d.update(kw)
    return dem.ContactParams(**d)


def _cfg(**kw):
    d = dict(params=_params(), neighbor="cells", cell_capacity=8, max_neighbors=8,
             gravity=(0.0, 0.0, 0.0), wall_axes=(False, False, False),
             shear_history=True, cundall_damping=0.2)
    d.update(kw)
    return dem.DEMConfig(**d)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(out, ref):
    """max |out - ref| over the reference's scale."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_shear_keys_and_carry_exact():
    """Partner keys with and without pids, and the spring carry across a
    reshuffled list, equal the JAX package's exactly."""
    rng = np.random.RandomState(0)
    N, M = 40, 6
    old_nbr = np.stack([rng.permutation(N + 8)[:M] for _ in range(N)]).astype(np.int32)
    old_nbr[old_nbr >= N] = N                                   # empty slots
    new_nbr = np.stack([rng.permutation(r) for r in old_nbr]).astype(np.int32)
    new_nbr[:, -1] = np.where(rng.rand(N) < 0.5, N, rng.randint(0, N, N))
    pid = rng.permutation(1000)[:N].astype(np.int32)
    xi = rng.randn(N, M, 3).astype(np.float32)
    xw = rng.randn(N, 3, 3).astype(np.float32)
    for p in (None, pid):
        jp, tp = (None, None) if p is None else (jnp.asarray(p), _t(p))
        old_j = dem.shear_keys(jnp.asarray(old_nbr), N, jp)
        old_t = tdem.shear_keys(_t(old_nbr), N, tp)
        new_j = dem.shear_keys(jnp.asarray(new_nbr), N, jp)
        new_t = tdem.shear_keys(_t(new_nbr), N, tp)
        assert old_t.dtype == new_t.dtype == torch.int32
        np.testing.assert_array_equal(old_t.numpy(), np.asarray(old_j))
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
        carried_j = dem.carry_shear(dem.ShearState(jnp.asarray(xi), old_j, jnp.asarray(xw)),
                                    new_j)
        carried_t = tdem.carry_shear(tdem.ShearState(_t(xi), old_t, _t(xw)), new_t)
        np.testing.assert_array_equal(carried_t.numpy(), np.asarray(carried_j))
        assert np.count_nonzero(carried_t.numpy()) > 0
    sh = tdem.make_shear_state(5, 4)
    assert sh.xi.shape == (5, 4, 3) and sh.xi_wall.shape == (5, 3, 3)
    assert int(sh.ids.min()) == int(sh.ids.max()) == -1


@pytest.mark.parametrize("pair_layout", ["rows", "channels"])
def test_history_pair_and_wall_forces_match(pair_layout):
    """One history evaluation on a pressed, sliding packing against walls:
    forces, torques and updated springs (pair and wall) within 1e-5 of
    their scale (f32 in another order), from seeded springs, some beyond the
    Coulomb cone."""
    rng = np.random.RandomState(4)
    n, r = 60, 0.05
    pos = (0.05 + 0.9 * rng.rand(n, 3)).astype(np.float32)
    pos[:8, 2] = 0.04                                           # on the floor
    vel = (0.1 * rng.randn(n, 3)).astype(np.float32)
    ang = (0.5 * rng.randn(n, 3)).astype(np.float32)
    rad = np.full(n, r, np.float32)
    act = np.arange(n) < n - 3
    cfg = _cfg(wall_axes=(True, True, True), pair_layout=pair_layout, max_neighbors=12,
               cell_capacity=12)
    nbr = np.asarray(dem.build_neighbor_list(jnp.asarray(pos), jnp.asarray(act), GRID, cfg, r))
    xi = (1e-2 * rng.randn(n, 12, 3)).astype(np.float32)
    xw = (1e-2 * rng.randn(n, 3, 3)).astype(np.float32)
    arrs = (pos, vel, ang, rad, act)
    ref = dem.neighbor_contact_forces(jnp.asarray(nbr), *map(jnp.asarray, arrs), GRID, cfg,
                                      jnp.asarray(xi), 2e-3)
    out = tdem.neighbor_contact_forces(_t(nbr), *map(_t, arrs), config_from(GRID),
                                       config_from(cfg), _t(xi), 2e-3)
    wref = dem.wall_contact_forces(*map(jnp.asarray, arrs), GRID, cfg, jnp.asarray(xw), 2e-3)
    wout = tdem.wall_contact_forces(*map(_t, arrs), config_from(GRID), config_from(cfg),
                                    _t(xw), 2e-3)
    for o, rf in zip((*out, *wout), (*ref, *wref)):
        assert np.abs(np.asarray(rf)).max() > 0
        assert _rel(o.numpy(), rf) <= 1e-5
    # the untouched slots' springs are zero in both
    np.testing.assert_array_equal(out[2].numpy() == 0, np.asarray(ref[2]) == 0)


def test_shear_spring_accumulates_and_slips():
    """tests/test_dem_shear.py's steady sliding pair in both packages: the
    spring force grows as kt * integral(v_t dt) until the Coulomb cone, then
    locks at friction * f_n; the port's history within 1e-5 of JAX's."""
    r = 0.05
    pos = np.asarray([[0.5, 0.5, 0.5], [0.5 + 1.9 * r, 0.5, 0.5]], np.float32)
    vel = np.asarray([[0.0, 1e-3, 0.0], [0.0, -1e-3, 0.0]], np.float32)
    ang = np.zeros((2, 3), np.float32)
    rad = np.full(2, r, np.float32)
    act = np.ones(2, bool)
    cfg = _cfg()
    p = cfg.params
    dt = 5e-3
    arrs = (pos, vel, ang, rad, act)
    nbr = dem.build_neighbor_list(jnp.asarray(pos), jnp.asarray(act), GRID, cfg, r)
    step = jax.jit(lambda xi: dem.neighbor_contact_forces(
        nbr, *map(jnp.asarray, arrs), GRID, cfg, xi, dt))
    tcfg, tgrid, tnbr, targs = config_from(cfg), config_from(GRID), _t(nbr), [_t(a) for a in arrs]
    xi_j = jnp.zeros((2, cfg.max_neighbors, 3), jnp.float32)
    xi_t = torch.zeros((2, cfg.max_neighbors, 3))
    hist_j, hist_t = [], []
    for _ in range(400):
        f, _, xi_j = step(xi_j)
        hist_j.append(float(f[0, 1]))
        f, _, xi_t = tdem.neighbor_contact_forces(tnbr, *targs, tgrid, tcfg, xi_t, dt)
        hist_t.append(float(f[0, 1]))
    assert _rel(hist_t, hist_j) <= 1e-5
    kt = p.kt_over_kn * p.kn
    m = 2500.0 * (4.0 / 3.0) * np.pi * r ** 3
    ln_e = np.log(p.restitution)
    beta = -ln_e / np.sqrt(np.pi ** 2 + ln_e ** 2)
    ct = 2.0 * beta * np.sqrt(kt * m / 2.0)
    np.testing.assert_allclose(hist_t[0], -(kt * 2e-3 * dt + ct * 2e-3), rtol=1e-3)
    np.testing.assert_allclose(abs(hist_t[-1]), p.friction * p.kn * 0.1 * r, rtol=1e-4)
    assert abs(hist_t[5]) > abs(hist_t[0])


def test_shear_history_persists_across_rebuilds():
    """Two dem_substeps calls (a list built at each entry) equal one call
    with an in-call rebuild at the same point (`list_rebuild_every`), in the
    port; each path equals the JAX package's to 1e-5 of scale, and the
    partner keys and the overflow count exactly."""
    r = 0.05
    rng = np.random.RandomState(3)
    n = 12
    arrs = ((0.3 + 0.4 * rng.rand(n, 3)).astype(np.float32),
            (rng.randn(n, 3) * 1e-2).astype(np.float32), np.zeros((n, 3), np.float32),
            np.full(n, r, np.float32), np.ones(n, bool))
    zeros = np.zeros((n, 3), np.float32)
    dt = 2e-4
    cfg, cfg8 = _cfg(), _cfg(list_rebuild_every=4)
    tgrid = config_from(GRID)

    def jax_run(c, calls, n_sub):
        st = [jnp.asarray(a) for a in arrs[:3]]
        sh = dem.make_shear_state(n, cfg.max_neighbors)
        for _ in range(calls):
            *st, ov, sh = dem.dem_substeps(*st, *map(jnp.asarray, arrs[3:]),
                                           dem.DEMForces(jnp.asarray(zeros), jnp.asarray(zeros)),
                                           GRID, c, dt, n_sub, r, shear=sh)
        return [np.asarray(x) for x in (*st, *sh, ov)]

    def port_run(c, calls, n_sub):
        st = [_t(a) for a in arrs[:3]]
        sh = tdem.make_shear_state(n, cfg.max_neighbors)
        for _ in range(calls):
            *st, ov, sh = tdem.dem_substeps(*st, *map(_t, arrs[3:]),
                                            tdem.DEMForces(_t(zeros), _t(zeros)),
                                            tgrid, config_from(c), dt, n_sub, r, shear=sh)
        return [x.numpy() for x in (*st, *sh, ov)]

    two, one = port_run(cfg, 2, 4), port_run(cfg8, 1, 8)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(two[1], one[1], rtol=1e-5, atol=1e-8)
    for out, ref in ((two, jax_run(cfg, 2, 4)), (one, jax_run(cfg8, 1, 8))):
        for k in (0, 1, 2, 3, 5):
            assert _rel(out[k], ref[k]) <= 1e-5, k
        np.testing.assert_array_equal(out[4], ref[4])      # keys
        assert int(out[6]) == int(ref[6])                 # the truncated candidates
    assert np.count_nonzero(two[3]) > 0


def test_rolling_without_slip_on_floor():
    """A ball pushed along the floor inside the friction cone: with the
    history spring the contact slip speed falls to < 0.25 of the viscous
    model's (static friction); the port's final state within 1e-5 of JAX's
    in both models."""
    r, kn, g = 0.05, 1e5, 9.81
    m = 2500.0 * (4.0 / 3.0) * np.pi * r ** 3
    dt = 2e-4
    rad, act = np.full(1, r, np.float32), np.ones(1, bool)

    def run(shear_history, n_outer=120):
        cfg = _cfg(shear_history=shear_history, params=_params(kn=kn),
                   gravity=(0.0, 0.0, -g), wall_axes=(False, False, True))
        hf = np.asarray([[cfg.params.friction * m * g * 0.5, 0.0, 0.0]], np.float32)
        pos0 = np.asarray([[0.5, 0.5, r - m * g / kn]], np.float32)
        zeros = np.zeros((1, 3), np.float32)
        jh = dem.DEMForces(jnp.asarray(hf), jnp.asarray(zeros))
        jstep = jax.jit(lambda pos, vel, ang, sh: dem.dem_substeps(
            pos, vel, ang, jnp.asarray(rad), jnp.asarray(act), jh, GRID, cfg, dt, 4, r,
            shear=sh if shear_history else None))
        tcfg, tgrid = config_from(cfg), config_from(GRID)
        th = tdem.DEMForces(_t(hf), _t(zeros))
        js = [jnp.asarray(pos0), jnp.zeros((1, 3)), jnp.zeros((1, 3))]
        ts = [_t(pos0), torch.zeros((1, 3)), torch.zeros((1, 3))]
        jsh, tsh = dem.make_shear_state(1, 8), tdem.make_shear_state(1, 8)
        tail = []
        for it in range(n_outer):
            out = jstep(*js, jsh)
            js, jsh = list(out[:3]), (out[4] if shear_history else jsh)
            out = tdem.dem_substeps(*ts, _t(rad), _t(act), th, tgrid, tcfg, dt, 4, r,
                                    shear=tsh if shear_history else None)
            ts, tsh = list(out[:3]), (out[4] if shear_history else tsh)
            if it >= n_outer - 30:
                tail.append(abs(float(ts[1][0, 0]) - r * float(ts[2][0, 1])))
        for o, rf in zip(ts, js):
            assert _rel(o.numpy(), rf) <= 1e-5
        assert abs(float(ts[1][0, 0])) > 0.05
        return float(np.mean(tail))

    assert run(True) < 0.25 * run(False)


YADE_N, YADE_NX = 500, 16


def yade_physics_config(nx=YADE_NX):
    """bench.py's `--yade-physics` configuration (bench.py:59-179) on an
    nx^3 grid: shear history, dynamic substeps up to 8, rows pair layout, no
    carried contact, frozen Verlet list rebuilt every 2 steps."""
    cfg = bench_config(nx, rebuild_steps=2, carry_contact=False, shear_history=True,
                       dynamic_substeps=True, pair_layout="rows")
    return dataclasses.replace(cfg, n_dem_substeps=8)


def run_both(cfg, n_steps=4):
    """Both packages' initialize_state and n_steps of make_scan_fn from one
    numpy state: `chip_smoke.closing_pairs`, bench.py's lattice with 16
    pairs closing at 0.2 m/s and sliding, each in contact from the second
    step past the fourth at overlaps of a few um (at grazing overlaps
    r_i + r_j - |dx| keeps few significant bits in f32). -> (JAX state, JAX diagnostics, port
    state, port diagnostics), as numpy."""
    pos, vel = closing_pairs(YADE_N, cfg.grid.lengths[0])
    parts = (make_fluid_state(cfg.grid), make_particle_state(pos=pos, vel=vel, radius=4e-4),
             make_turbulence_state(cfg.grid, k0=1e-6))
    ref = jcd.initialize_state(*parts, jax_equivalent(cfg), dt=5e-5)
    raw = _np_tree(SimState(*parts, t=np.float32(0), dt=np.float32(5e-5), step=np.int32(0)))
    t = state_from_numpy(raw, torch.device("cpu"))
    out = tcd.initialize_state(t.fluid, t.particles, t.turb, case_config_from(cfg), dt=5e-5)
    ref_s, ref_d = jcd.make_scan_fn(jax_equivalent(cfg), n_steps)(ref)
    out_s, out_d = tcd.make_scan_fn(case_config_from(cfg), n_steps)(out)
    return (_np_tree(ref_s), _np_tree(ref_d), state_to_numpy(out_s),
            {k: v.numpy() for k, v in out_d._asdict().items()})


@pytest.fixture(scope="module")
def yade_runs():
    return run_both(yade_physics_config())


def test_yade_physics_slice_counters(yade_runs):
    """Per step: the dynamic substep count ceil(5e-5 / 1.64e-5) = 4 of 8,
    the pressure iterations and every overflow counter equal JAX's;
    bench.py's health conditions hold; springs are loaded."""
    ref_s, ref_d, out_s, out_d = yade_runs
    for name in ("n_dem_sub", "p_iters", "n_contact_overflow", "n_coupling_overflow",
                 "n_found"):
        np.testing.assert_array_equal(out_d[name], np.asarray(getattr(ref_d, name)),
                                      err_msg=name)
    assert out_d["n_dem_sub"].tolist() == [4] * 4
    assert not out_d["n_contact_overflow"].any() and not out_d["n_coupling_overflow"].any()
    assert out_d["cont_err_local"].max() < 1e-5
    assert np.count_nonzero(np.abs(out_s.particles.shear_xi).sum(-1)) >= 20
    np.testing.assert_array_equal(out_s.particles.shear_ids, ref_s.particles.shear_ids)
    np.testing.assert_array_equal(out_s.particles.nbr, ref_s.particles.nbr)


def test_yade_physics_slice_state(yade_runs):
    """The state after 4 steps: the particle positions and velocities, alpha,
    u_particle, the drag coefficient and the kEqn fields within 1e-5 of
    their scale; u, p and u_source, and through them the contact springs
    and angular velocities, within 5e-5. Those take in the window exchange,
    whose plain version meets the JAX package's Pallas kernel (hi + bf16 lo
    staging) to ~1e-5-3e-4 of scale (test_torch_coupled.py); they read
    1.3e-5-3.0e-5 here, and no less with the pressure tolerance at 1e-7,
    while the DEM alone meets JAX to 9e-6 on the same particles."""
    ref_s, _, out_s, _ = yade_runs
    for name, rel in (("alpha", 1e-5), ("u_particle", 1e-5), ("u_source_drag", 1e-5),
                      ("u", 5e-5), ("p", 5e-5), ("u_source", 5e-5)):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), rel)
    for name, rel in (("pos", 1e-5), ("vel", 1e-5), ("angvel", 5e-5), ("shear_xi", 5e-5),
                      ("shear_wall", 1e-5)):
        _close(name, getattr(out_s.particles, name), getattr(ref_s.particles, name), rel)
    for name in ("k", "nut"):
        _close(name, getattr(out_s.turb, name), getattr(ref_s.turb, name), 1e-5)
    _close("t", out_s.t, ref_s.t, 1e-7)
