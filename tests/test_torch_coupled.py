"""The ported slice end to end at a small size: the bench configuration
(window exchange, frozen Verlet list with carried contacts, kEqn, PIMPLE
with 2 correctors and fftpcg) on a 12^3 channel with ~300 lattice
particles, run by both packages from the same numpy state; plus the
regression test for the Verlet reference-position aliasing fault."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
    SimState,
)
from yade_openfoam_coupling_tpu.models.pimple import PIMPLEConfig
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.models.turbulence import TurbulenceConfig
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops import pressure as pr
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem

NX, N_PART, RADIUS = 12, 300, 4e-4


def bench_config(nx=NX, rebuild_steps=2, **dem_kw):
    """bench.py's configuration on an nx^3 grid (h = 1 mm)."""
    dem_cfg = dict(params=dem.ContactParams(kn=100.0, rho_p=2500.0),
                   gravity=(0.0, 0.0, -9.81), rho_f=1000.0,
                   periodic=(True, True, False), wall_axes=(False, False, True),
                   neighbor="cells", cell_capacity=4, max_neighbors=8,
                   refined_neighbors=4, sorted_fetch=True, list_reuse=True,
                   list_rebuild_steps=rebuild_steps, carry_contact=True,
                   substep_unroll=True, pair_layout="channels")
    dem_cfg.update(dem_kw)
    return jcd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx),
        bcs=FluidBCs.channel_z(),
        transport=jcd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True,
                                   stencil_shape="sphere2", exchange="window",
                                   slot_capacity=4, dy_in_kernel=True,
                                   planes_window=0, window_dynamic=True),
        dem=dem.DEMConfig(**dem_cfg),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=2,
                            pressure=pr.PressureSolverConfig(
                                solver="fftpcg", tol=1e-5, maxiter=40,
                                mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4,
        r_max=RADIUS,
    )


def jax_equivalent(cfg):
    """The JAX package's configuration that builds the port's Verlet lists:
    with ``refined_neighbors`` the port refines a whole candidate row, the
    JAX package only its ``max_neighbors`` largest ids, so its side takes
    ``max_neighbors`` 27 x ``cell_capacity``, the whole row
    (test_torch_dem.py holds the two lists equal)."""
    d = cfg.dem
    if not 0 < d.refined_neighbors < d.max_neighbors:
        return cfg
    return dataclasses.replace(cfg, dem=dataclasses.replace(
        d, max_neighbors=27 * d.cell_capacity))


def lattice(n, length, seed=0):
    """bench.py's jittered lattice."""
    rng = np.random.RandomState(seed)
    k = int(np.ceil(n ** (1.0 / 3.0)))
    lo, hi = 0.1 * length, 0.9 * length
    g = np.stack(np.meshgrid(*[np.linspace(lo, hi, k)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    jitter = 0.2 * length / k
    return (g + rng.uniform(-jitter, jitter, g.shape)).astype(np.float32)


def _initial_parts(cfg):
    """The bench's fluid, particle and turbulence states before
    `initialize_state`, with seeded particle velocities of ~1 cm/s (from
    rest the first steps' alpha - alpha_old is last-bit noise and the fluid
    answers noise)."""
    pos = lattice(N_PART, cfg.grid.lengths[0])
    vel = (1e-2 * np.random.RandomState(1).randn(N_PART, 3)).astype(np.float32)
    return (make_fluid_state(cfg.grid), make_particle_state(pos=pos, vel=vel, radius=RADIUS),
            make_turbulence_state(cfg.grid, k0=1e-6))


def _both_initial(cfg):
    """Each package's initialize_state on the same numpy input state."""
    parts = _initial_parts(cfg)
    ref = jcd.initialize_state(*parts, jax_equivalent(cfg), dt=5e-5)
    raw = _np_tree(SimState(*parts, t=np.float32(0), dt=np.float32(5e-5), step=np.int32(0)))
    t = state_from_numpy(raw, torch.device("cpu"))
    out = tcd.initialize_state(t.fluid, t.particles, t.turb, case_config_from(cfg), dt=5e-5)
    return ref, out


def _np_tree(state):
    return jax.tree.map(np.asarray, state)


def _same_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


@pytest.fixture(scope="module")
def slice_runs():
    cfg = bench_config()
    s0, t0 = _both_initial(cfg)
    init = (_np_tree(s0), state_to_numpy(t0))
    ref_state, ref_diags = jcd.make_scan_fn(jax_equivalent(cfg), 4)(s0)
    out_state, out_diags = tcd.make_scan_fn(case_config_from(cfg), 4)(t0)
    return (_np_tree(ref_state), _np_tree(ref_diags), state_to_numpy(out_state),
            {k: v.numpy() for k, v in out_diags._asdict().items()}, init)


def test_initial_state_matches(slice_runs):
    """initialize_state: the first Verlet list exactly, the initial alpha
    and carried contact force within the window exchange's tolerance."""
    ref, out = slice_runs[4]
    np.testing.assert_array_equal(out.particles.nbr, ref.particles.nbr)
    np.testing.assert_array_equal(out.particles.nbr_ref_pos, ref.particles.pos)
    _close("alpha", out.fluid.alpha, ref.fluid.alpha, 2e-5)
    _close("u_particle", out.fluid.u_particle, ref.fluid.u_particle, 3e-4)
    _close("contact_f", out.particles.contact_f, ref.particles.contact_f, 1e-5)


def test_slice_counters_match(slice_runs):
    """Pressure iterations and every overflow counter equal the JAX
    package's, step by step; the bench's health conditions hold."""
    _, ref_d, _, out_d, _ = slice_runs
    for name in ("p_iters", "n_contact_overflow", "n_coupling_overflow",
                 "n_found", "n_dem_sub", "n_shard_overflow"):
        np.testing.assert_array_equal(out_d[name], np.asarray(getattr(ref_d, name)),
                                      err_msg=name)
    assert out_d["p_iters"].shape == (4,)
    assert np.all(out_d["n_contact_overflow"] == 0)
    assert np.all(out_d["n_coupling_overflow"] == 0)
    assert out_d["cont_err_local"].max() < 1e-5


def test_slice_state_and_diagnostics_match(slice_runs):
    """The final fluid and particle state and the float diagnostics, each
    within 1e-4 of its scale: four coupled steps of f32 arithmetic taken in
    another order (stiff contacts and CG amplify last-bit differences)."""
    ref_s, ref_d, out_s, out_d, _ = slice_runs
    for name in ("u", "p", "alpha", "alpha_old", "u_source", "u_source_drag",
                 "u_particle", "u_old"):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), 1e-4)
    for a in range(3):
        _close(f"phi[{a}]", out_s.fluid.phi[a], ref_s.fluid.phi[a], 1e-4)
    for name in ("pos", "vel", "angvel", "contact_f", "contact_t", "nbr_ref_pos"):
        _close(name, getattr(out_s.particles, name), getattr(ref_s.particles, name), 1e-4)
    np.testing.assert_array_equal(out_s.particles.nbr, ref_s.particles.nbr)
    for name in ("k", "nut"):
        _close(name, getattr(out_s.turb, name), getattr(ref_s.turb, name), 1e-4)
    for name in ("co_mean", "co_max", "p_initial_residual", "max_particle_speed"):
        _close(name, out_d[name], np.asarray(getattr(ref_d, name)), 1e-3)
    # what the pressure solve leaves over: agrees only to the solver's tolerance
    _close("cont_err_local", out_d["cont_err_local"],
           np.asarray(ref_d.cont_err_local), 2e-2)
    _close("t", out_s.t, ref_s.t, 1e-7)


def test_verlet_reference_positions_are_not_aliased():
    """After a chunk the Verlet reference positions are their own storage,
    the drift since the rebuild is nonzero for moving particles, and with a
    tiny skin margin the staleness counter fires on the chunk's second
    step, as in the JAX package. Were nbr_ref_pos an alias of pos, the
    drift would read 0 and the counter could never fire."""
    cfg = bench_config(list_margin_factor=1e-6)
    s0, ts0 = _both_initial(cfg)
    tcfg = case_config_from(cfg)
    run = tcd.make_scan_fn(tcfg, 2)
    st, diags = run(ts0)
    ps = st.particles
    assert not _same_storage(ps.pos, ps.nbr_ref_pos)
    drift = tdem.drift_since(ps.pos, ps.nbr_ref_pos, ps.active, tcfg.grid,
                             tcfg.dem.periodic)
    assert int((drift > 0).sum()) == int(ps.active.sum())
    assert int(diags.n_contact_overflow[0]) == 0
    assert int(diags.n_contact_overflow[1]) > 0
    _, ref_diags = jcd.make_scan_fn(jax_equivalent(cfg), 2)(s0)
    np.testing.assert_array_equal(diags.n_contact_overflow.numpy(),
                                  np.asarray(ref_diags.n_contact_overflow))
    # the initial state's reference positions are a copy as well
    init = tcd.initialize_state(ts0.fluid, ts0.particles._replace(nbr=None, nbr_ref_pos=None),
                                ts0.turb, tcfg, dt=5e-5)
    assert not _same_storage(init.particles.pos, init.particles.nbr_ref_pos)
