"""The DEM's neighbour lists in the PyTorch port against the JAX package:
the cell list against all pairs (tests/test_dem.py's two tests), and the
persistent Verlet list rebuilt on the drift criterion, by hand and inside
the coupled step (test_dem_verlet.py's two persistent-list tests), in both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_coupled import _close
from test_torch_dem_substeps import _case, _params, _rel, _steps, _t
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem

GRID = Grid.cube(16, 1.0)


@pytest.mark.parametrize("periodic", [(False,) * 3, (True,) * 3])
def test_cell_list_matches_allpairs(periodic):
    """tests/test_dem.py's two cell-list tests in the port (cell list against
    all pairs to atol 1e-4), and the port's cell list against JAX's to 1e-5
    of scale."""
    rng = np.random.RandomState(42 if not any(periodic) else 3)
    N, r = (64, 0.02) if not any(periodic) else (32, 0.03)
    lo, hi = (0.1, 0.9) if not any(periodic) else (0.0, 1.0)
    pos = rng.uniform(lo, hi, (N, 3))
    # one sure contact, across the x seam where it is periodic
    pos[0] = (0.99, 0.5, 0.5) if any(periodic) else (0.5, 0.5, 0.5)
    pos[1] = np.mod(pos[0] + (1.8 * r, 0.01, 0.0), 1.0)
    arrs = (pos.astype(np.float32), rng.normal(0, 0.1, (N, 3)).astype(np.float32),
            rng.normal(0, 0.1, (N, 3)).astype(np.float32),
            np.full(N, r, np.float32), np.ones(N, bool))
    walls = tuple(not p for p in periodic)
    cfg_a = dem.DEMConfig(params=_params(), neighbor="allpairs", periodic=periodic,
                          wall_axes=walls)
    cfg_c = dem.DEMConfig(params=_params(), neighbor="cells", cell_capacity=16,
                          periodic=periodic, wall_axes=walls)
    ta = tdem.allpairs_contact_forces(*map(_t, arrs), config_from(GRID), config_from(cfg_a))
    tc = tdem.cell_list_contact_forces(*map(_t, arrs), config_from(GRID), config_from(cfg_c), r)
    jc = dem.cell_list_contact_forces(*map(jnp.asarray, arrs), GRID, cfg_c, r)
    assert np.abs(ta[0].numpy()).max() > 0
    for a, c, j in zip(ta, tc, jc):
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-4)
        assert _rel(c.numpy(), j) <= 1e-5
    # and through contact_forces, walls included
    out = tdem.contact_forces(*map(_t, arrs), config_from(GRID), config_from(cfg_c), r)
    ref = dem.contact_forces(*map(jnp.asarray, arrs), GRID, cfg_c, r)
    for o, rf in zip(out, ref):
        assert _rel(o.numpy(), rf) <= 1e-5


def test_persistent_list_rebuild_triggers():
    """test_dem_verlet.py's fast particle that eats the skin margin: the
    conditional rebuild (drift >= margin) finds the contact a stale list
    would miss, in the port as in JAX (same rebuild steps)."""
    cfg = dem.DEMConfig(params=_params(), neighbor="cells", cell_capacity=8, max_neighbors=8,
                        gravity=(0, 0, 0), wall_axes=(False,) * 3, list_reuse=True)
    grid = Grid.cube(8, 1.0)
    r = 0.02
    pos = np.array([[0.2, 0.5, 0.5], [0.6, 0.5, 0.5]], np.float32)
    vel = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    dt = dem.critical_dt(r, cfg.params)
    margin = cfg.list_margin_factor * (dem.effective_bin_size(grid, cfg, r) - 2.0 * r)
    rad, act = np.full(2, r, np.float32), np.ones(2, bool)
    tcfg, tgrid = config_from(cfg), config_from(grid)
    rebuilds = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            P = lambda a: jnp.asarray(a)  # noqa: E731
            mod, g, c = dem, grid, cfg
            substeps = jax.jit(lambda p_, v_, w_, nbr: dem.dem_substeps(
                p_, v_, w_, P(rad), P(act), dem.DEMForces(z, z), g, c, dt, 10, r, nbr=nbr))
        else:
            P, mod, g, c = _t, tdem, tgrid, tcfg
            substeps = lambda p_, v_, w_, nbr: tdem.dem_substeps(  # noqa: E731
                p_, v_, w_, P(rad), P(act), tdem.DEMForces(z, z), g, c, dt, 10, r, nbr=nbr)
        z = P(np.zeros((2, 3), np.float32))
        p_, v_, w_ = P(pos), P(vel), P(np.zeros((2, 3), np.float32))
        ref = p_
        nbr = mod.build_neighbor_list(p_, P(act), g, c, r)
        steps = []
        for it in range(60):
            if float(np.abs(np.asarray(p_) - np.asarray(ref)).max()) >= margin:
                nbr = mod.build_neighbor_list(p_, P(act), g, c, r)
                ref = p_
                steps.append(it)
            p_, v_, w_, _ = substeps(p_, v_, w_, nbr)
        rebuilds[pkg] = (steps, np.asarray(v_))
    assert rebuilds["torch"][0] == rebuilds["jax"][0] and rebuilds["torch"][0]
    assert float(rebuilds["torch"][1][1, 0]) > 0.3
    assert _rel(rebuilds["torch"][1], rebuilds["jax"][1]) <= 1e-5


def test_persistent_list_matches_per_step_rebuild():
    """test_dem_verlet.py's coupled case: the carried Verlet list, rebuilt
    inside coupled_step on the drift criterion, gives the per-step rebuild's
    trajectory (the JAX test's tolerances), and the port's carried-list run
    meets JAX's (the list and counters exactly); with a vanishing margin
    the step rebuilds every time, as JAX's does."""
    rng = np.random.RandomState(3)
    grid = Grid.cube(16, 16e-3)
    r = 4e-4
    pos0 = rng.uniform(0.2 * 16e-3, 0.8 * 16e-3, (120, 3))
    params = dem.ContactParams(kn=100.0, rho_p=2500.0)

    def case(reuse, margin_factor=0.5):
        c = _case(grid, r, params, 2, neighbor="cells", cell_capacity=12, max_neighbors=24,
                  list_reuse=reuse, list_margin_factor=margin_factor)
        return dataclasses.replace(c, dem=dataclasses.replace(c.dem, gravity=(0.0, 0.0, -9.81),
                                                              rho_f=1000.0))

    _, per_step = _steps(case(False), pos0, 5e-5, 6, port_only=True)
    ref, reuse = _steps(case(True), pos0, 5e-5, 6)
    a, b, j = per_step[-1][0], reuse[-1][0], ref[-1][0]
    np.testing.assert_allclose(b.particles.pos.numpy(), a.particles.pos.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(b.particles.vel.numpy(), a.particles.vel.numpy(), rtol=1e-4,
                               atol=1e-8)
    np.testing.assert_allclose(b.fluid.p.numpy(), a.fluid.p.numpy(), rtol=1e-4, atol=1e-7)
    for (s_out, _, _), (s_ref, _, _) in zip(reuse, ref):
        np.testing.assert_array_equal(s_out.particles.nbr.numpy(), np.asarray(s_ref.particles.nbr))
        _close("nbr_ref_pos", s_out.particles.nbr_ref_pos.numpy(),
               np.asarray(s_ref.particles.nbr_ref_pos), 1e-6)
    _close("pos", b.particles.pos.numpy(), np.asarray(j.particles.pos), 1e-5)
    # a vanishing margin: a rebuild every step, its reference positions the step's start
    ref, tiny = _steps(case(True, 1e-9), pos0, 5e-5, 2)
    for k, ((s_out, _, _), (s_ref, _, _)) in enumerate(zip(tiny, ref)):
        np.testing.assert_array_equal(s_out.particles.nbr.numpy(), np.asarray(s_ref.particles.nbr))
        _close("nbr_ref_pos", s_out.particles.nbr_ref_pos.numpy(),
               np.asarray(s_ref.particles.nbr_ref_pos), 1e-6)
    assert not torch.equal(tiny[1][0].particles.nbr_ref_pos, tiny[0][0].particles.nbr_ref_pos)
