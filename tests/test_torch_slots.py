"""The port's slot-table exchange against the JAX package on the same
seeded numpy inputs: the binning exactly, the slot weights, the exchange
(with and without lag_alpha, periodic and walled, with torque, with
overflow), the port's own sparse exchange, the roll sum's route through
kernel B3's wrapper, and four coupled steps with ``exchange="slots"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.models.pimple import PIMPLEConfig
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops import coupling_slots as jcs
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops import pressure as pr
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import coupling_slots as tcs
from yade_openfoam_coupling_tpu_torch.ops import rolls


def _close(name, out, ref, rel):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _inputs(grid, n, seed=1, pad=0, crowd=0):
    """n seeded particles over the box's middle 84% (`pad` inactive slots
    after them), the last `crowd` of them moved into one cell; five seeded
    input fields. -> (JAX ParticleFields, port ParticleFields, numpy fields)."""
    rng = np.random.RandomState(seed)
    lo = [grid.origin[a] + 0.08 * grid.lengths[a] for a in range(3)]
    hi = [grid.origin[a] + 0.92 * grid.lengths[a] for a in range(3)]
    pos = rng.uniform(lo, hi, (n + pad, 3)).astype(np.float32)
    if crowd:
        pos[n - crowd:n] = (np.asarray(grid.spacing) * (np.asarray(grid.shape) // 2 + 0.5)
                            + rng.uniform(-1e-4, 1e-4, (crowd, 3))).astype(np.float32)
    vel = (1e-3 * rng.randn(n + pad, 3)).astype(np.float32)
    ang = (1e-2 * rng.randn(n + pad, 3)).astype(np.float32)
    rad = np.full(n + pad, 4e-4, np.float32)
    act = np.arange(n + pad) < n
    fields = [(1e-2 * rng.randn(3, *grid.shape)).astype(np.float32) for _ in range(5)]
    jpf = jcp.ParticleFields(*(jnp.asarray(x) for x in (pos, vel, ang, rad, act)))
    tpf = tcp.ParticleFields(*(torch.as_tensor(x) for x in (pos, vel, ang, rad, act)))
    return jpf, tpf, fields


def _exchange_both(grid, cfg, periodic, n=40, pad=3, crowd=0, seed=1):
    jpf, tpf, f = _inputs(grid, n, seed=seed, pad=pad, crowd=crowd)
    pa = np.full(grid.shape, 0.97, np.float32)
    args = (grid, periodic, 1e-6, 1000.0, 1e-4)
    ref = jcs.gaussian_coupling_slots(jpf, *map(jnp.asarray, f), *args, cfg,
                                      prev_alpha=jnp.asarray(pa))
    out = tcs.gaussian_coupling_slots(tpf, *map(torch.as_tensor, f), config_from(grid),
                                      *args[1:], config_from(cfg),
                                      prev_alpha=torch.as_tensor(pa))
    return ref, out, tpf, f, pa


@pytest.mark.parametrize("cap,crowd", [(6, 0), (2, 5)])
def test_bin_particles_exact(cap, crowd):
    """slot_of, n_overflow and the slot table equal the JAX package's
    bit for bit, with inactive particles and, at cap 2, a crowded cell."""
    grid = Grid.cube(8, 0.008)
    jpf, tpf, _ = _inputs(grid, 60, pad=4, crowd=crowd)
    ref = jcs.bin_particles(jpf, grid, cap)
    out = tcs.bin_particles(tpf, config_from(grid), cap)
    np.testing.assert_array_equal(out.slot_of.numpy(), np.asarray(ref.slot_of))
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(ref.data))
    assert int(out.n_overflow) == int(ref.n_overflow)
    assert int(out.n_overflow) >= crowd - cap if crowd else int(out.n_overflow) == 0


@pytest.mark.parametrize("periodic", [(True, True, False), (False, False, False)])
def test_build_slot_weights_matches(periodic):
    """W and found within 1e-6, the offsets equal."""
    grid = Grid.cube(10, 0.010)
    cfg = jcp.CouplingConfig(stencil_shape="sphere2", exchange="slots", slot_capacity=4)
    jpf, tpf, _ = _inputs(grid, 50)
    rW, rf, roff = jcs.build_slot_weights(jcs.bin_particles(jpf, grid, 4), grid, periodic, cfg)
    oW, of, ooff = tcs.build_slot_weights(tcs.bin_particles(tpf, config_from(grid), 4),
                                          config_from(grid), periodic, config_from(cfg))
    np.testing.assert_array_equal(ooff, roff)
    np.testing.assert_array_equal(of.numpy(), np.asarray(rf))
    np.testing.assert_allclose(oW.numpy(), np.asarray(rW), rtol=0, atol=1e-6)


@pytest.mark.parametrize("periodic", [(True, True, False), (False, False, False)])
@pytest.mark.parametrize("lag", [False, True])
def test_slots_exchange_matches_jax(periodic, lag):
    """found and n_overflow exact; alpha, u_particle, u_source and the
    forces within 1e-6 of their scale, u_source_drag within 1e-5: its
    drag coefficient's f32 power laws leave a few 1e-6 of scale between
    any two orders of evaluation (the JAX package's own slots and sparse
    exchanges differ by 2.4e-6 on these inputs)."""
    grid = Grid.cube(12, 0.012)
    cfg = jcp.CouplingConfig(gaussian=True, lag_alpha=lag, stencil_shape="sphere2",
                             exchange="slots", slot_capacity=6)
    ref, out, *_ = _exchange_both(grid, cfg, periodic)
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    assert int(out.n_overflow) == int(ref.n_overflow) == 0
    for name in ("alpha", "u_particle", "u_source", "force"):
        _close(name, getattr(out, name), getattr(ref, name), 1e-6)
    _close("u_source_drag", out.u_source_drag, ref.u_source_drag, 1e-5)


def test_slots_with_torque_matches_jax_and_sparse():
    """Torque on a walled box: within 1e-6 of the JAX package's, and
    within the JAX suite's tolerance of the port's sparse exchange."""
    grid = Grid.cube(10, 0.01)
    cfg = jcp.CouplingConfig(gaussian=True, use_torque=True, exchange="slots", slot_capacity=6)
    ref, out, tpf, f, _ = _exchange_both(grid, cfg, (False,) * 3, n=25, pad=0, seed=4)
    _close("torque", out.torque, ref.torque, 1e-6)
    _close("force", out.force, ref.force, 1e-6)
    ones = torch.ones(grid.shape)
    sparse = tcp.gaussian_coupling(tpf, *map(torch.as_tensor, f), config_from(grid),
                                   (False,) * 3, 1e-6, 1000.0, 1e-4, config_from(cfg),
                                   prev_alpha=ones)
    np.testing.assert_allclose(out.torque.numpy(), sparse.torque.numpy(), rtol=1e-4,
                               atol=1e-12)


@pytest.mark.parametrize("lag", [False, True])
def test_slots_matches_port_sparse(lag):
    """The port's slots and sparse exchanges agree to the JAX suite's
    tolerances (tests/test_coupling_slots.py)."""
    grid = Grid.cube(12, 0.012)
    cfg = jcp.CouplingConfig(gaussian=True, lag_alpha=lag, stencil_shape="sphere2",
                             exchange="slots", slot_capacity=6)
    _, out, tpf, f, pa = _exchange_both(grid, cfg, (True, True, False))
    sparse = tcp.gaussian_coupling(tpf, *map(torch.as_tensor, f), config_from(grid),
                                   (True, True, False), 1e-6, 1000.0, 1e-4, config_from(cfg),
                                   prev_alpha=torch.as_tensor(pa))
    np.testing.assert_array_equal(out.found.numpy(), sparse.found.numpy())
    for name, rtol, atol in (("alpha", 1e-5, 1e-7), ("u_particle", 1e-4, 1e-9),
                             ("u_source_drag", 1e-4, 1e-8), ("u_source", 1e-3, 1e-8),
                             ("force", 1e-4, 1e-12)):
        np.testing.assert_allclose(getattr(out, name).numpy(), getattr(sparse, name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_slots_overflow_counted_and_masked():
    """Seven particles in one cell at cap 2: five overflow, get found=False
    and no force, in both packages alike."""
    grid = Grid.cube(8, 0.008)
    cfg = jcp.CouplingConfig(gaussian=True, exchange="slots", slot_capacity=2)
    ref, out, *_ = _exchange_both(grid, cfg, (False,) * 3, n=30, pad=0, crowd=7)
    assert int(out.n_overflow) == int(ref.n_overflow) == 5
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    assert int(out.found.sum()) == 25
    assert int((out.force.abs().sum(1) > 0).sum()) == 25
    _close("force", out.force, ref.force, 1e-6)
    _close("alpha", out.alpha, ref.alpha, 1e-6)


@pytest.mark.parametrize("n", [8, 6])
def test_roll_sum_route(n, monkeypatch):
    """The deposit's roll sum runs through B3's wrapper on grids whose
    sides are all at least 8 (twice per exchange without lag_alpha), and
    the plain roll loop below; the two agree bit for bit."""
    calls = []
    real = rolls.distribute_rolls
    monkeypatch.setattr(rolls, "distribute_rolls",
                        lambda b, o: calls.append(tuple(b.shape)) or real(b, o))
    grid = config_from(Grid.cube(n, 1e-3 * n))
    cfg = tcp.CouplingConfig(gaussian=True, stencil_shape="sphere2", exchange="slots")
    _, tpf, f = _inputs(grid, 20)
    tcs.gaussian_coupling_slots(tpf, *map(torch.as_tensor, f), grid, (True, True, False),
                                1e-6, 1000.0, 1e-4, cfg, prev_alpha=torch.ones(grid.shape))
    assert calls == ([(19, 4, n, n, n), (19, 4, n, n, n)] if n >= 8 else [])
    D = torch.as_tensor(np.random.RandomState(0).randn(19, 3, n ** 3).astype(np.float32))
    offs = tcp.stencil_offsets(cfg)
    if n >= 8:
        np.testing.assert_array_equal(tcs._roll_sum(D, offs, grid.shape).numpy(),
                                      rolls.distribute_rolls_reference(
                                          D.view(19, 3, n, n, n), offs).numpy())


def _coupled_cfg():
    return jcd.CaseConfig(
        grid=Grid.cube(12, 0.012), bcs=FluidBCs.channel_z(), solver="pimple",
        coupling=jcp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                    exchange="slots", slot_capacity=4),
        dem=dem.DEMConfig(params=dem.ContactParams(kn=10.0, rho_p=2500.0),
                          periodic=(True, True, False), wall_axes=(False, False, True),
                          neighbor="cells"),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="pcg", tol=1e-5, maxiter=200)),
        gravity_fluid=(0.0, 0.0, -9.81), n_dem_substeps=2, r_max=4e-4)


def test_coupled_steps_with_slots_match_jax():
    """Four coupled steps with exchange="slots" from the same numpy state
    (tests/test_coupling_slots.py's case, Jacobi CG to the bench's 1e-5;
    at 1e-6 the first solve stalls near the f32 floor in both packages and
    its iteration count follows last-bit differences): the counters equal,
    the state within 1e-4 of its scale (f32 in another order through CG
    and contacts, as for the other exchanges)."""
    cfg = _coupled_cfg()
    rng = np.random.RandomState(0)
    pos = rng.uniform(0.002, 0.010, (50, 3)).astype(np.float32)
    vel = (1e-2 * rng.randn(50, 3)).astype(np.float32)
    parts = (make_fluid_state(cfg.grid), make_particle_state(pos=pos, vel=vel, radius=4e-4),
             make_turbulence_state(cfg.grid))
    s0 = jcd.initialize_state(*parts, cfg, dt=1e-4)
    raw = jax.tree.map(np.asarray, SimState(*parts, t=np.float32(0), dt=np.float32(1e-4),
                                            step=np.int32(0)))
    t = state_from_numpy(raw, torch.device("cpu"))
    tcfg = case_config_from(cfg)
    t0 = tcd.initialize_state(t.fluid, t.particles, t.turb, tcfg, dt=1e-4)
    ref_s, ref_d = jcd.make_scan_fn(cfg, 4)(s0)
    out_s, out_d = tcd.make_scan_fn(tcfg, 4)(t0)
    ref_s, out_s = jax.tree.map(np.asarray, ref_s), state_to_numpy(out_s)
    for name in ("p_iters", "n_found", "n_coupling_overflow", "n_contact_overflow"):
        np.testing.assert_array_equal(getattr(out_d, name).numpy(),
                                      np.asarray(getattr(ref_d, name)), err_msg=name)
    assert int(out_d.n_found[-1]) == 50
    for name in ("u", "p", "alpha", "u_source", "u_source_drag", "u_particle"):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), 1e-4)
    for name in ("pos", "vel"):
        _close(name, getattr(out_s.particles, name), getattr(ref_s.particles, name), 1e-4)
