"""Implicit momentum diffusion in the port against the JAX package:
`solve_helmholtz` (against JAX and a manufactured solution),
`pimple_step(implicit_diffusion=True)`, implicit = explicit at a small dt,
and a kEpsilon case that holds the Courant dt past the explicit-diffusion
cap; tests/test_implicit_diffusion.py's checks, on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import fields as jf
from yade_openfoam_coupling_tpu.models import pimple as jp
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import grid as jg
from yade_openfoam_coupling_tpu.ops import pressure as jpr
from yade_openfoam_coupling_tpu.ops import stencil as jst
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.models import fields as tf
from yade_openfoam_coupling_tpu_torch.models import pimple as tp
from yade_openfoam_coupling_tpu_torch.models.turbulence import TurbulenceConfig
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem
from yade_openfoam_coupling_tpu_torch.ops import grid as tg
from yade_openfoam_coupling_tpu_torch.ops import pressure as tpr
from yade_openfoam_coupling_tpu_torch.utils.diagnostics import TimeControls, diffusive_dt_bound

CPU = torch.device("cpu")


def _close(name, out, ref, rel):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _helmholtz_inputs(grid, seed):
    """x_true, a > 0 and face coefficients from a seeded cell field."""
    rng = np.random.RandomState(seed)
    x_true = rng.normal(0, 1, grid.shape).astype(np.float32)
    a = rng.uniform(5.0, 10.0, grid.shape).astype(np.float32)
    gam = rng.uniform(0.5, 1.5, grid.shape).astype(np.float32)
    gf = jst.face_interp(jnp.asarray(gam), jg.FieldBC.uniform(jg.NEUMANN), grid)
    return x_true, a, gf, tuple(torch.as_tensor(np.array(g)) for g in gf)


@pytest.mark.parametrize("fixed", [0, 60])
def test_solve_helmholtz_matches_jax(fixed):
    """A nonzero-Dirichlet channel (the ghost constant folded into the
    right-hand side), with the while loop and with a fixed budget: the
    same live iterations, x within 1e-5 of its scale."""
    grid = jg.Grid.box((8, 6, 10), (1.0, 0.75, 1.25))
    bc = jg.FieldBC.channel_z(wall_value=0.3)
    _, a, gf, tgf = _helmholtz_inputs(grid, 1)
    rhs = np.random.RandomState(2).randn(*grid.shape).astype(np.float32)
    x0 = (0.1 * np.random.RandomState(3).randn(*grid.shape)).astype(np.float32)
    cfg = jpr.PressureSolverConfig(solver="pcg", tol=1e-6, maxiter=200, fixed_iters=fixed)
    ref = jpr.solve_helmholtz(jnp.asarray(a), gf, jnp.asarray(rhs), jnp.asarray(x0), grid,
                              bc, cfg)
    out = tpr.solve_helmholtz(torch.as_tensor(a), tgf, torch.as_tensor(rhs),
                              torch.as_tensor(x0), config_from(grid), config_from(bc),
                              config_from(cfg))
    assert int(out.iters) == int(ref.iters) > 3
    _close("x", out.x, ref.x, 1e-5)
    _close("residual", out.residual, ref.residual, 1e-2)


def test_helmholtz_manufactured():
    """solve_helmholtz recovers a manufactured solution of
    a x - div(gamma grad x) = rhs, nonzero-Dirichlet folding included."""
    grid = config_from(jg.Grid.cube(12, 1.0))
    bc = tg.FieldBC.channel_z(wall_value=0.3)
    x_true, a, _, tgf = _helmholtz_inputs(grid, 0)
    x_true, a = torch.as_tensor(x_true), torch.as_tensor(a)
    pad = lambda f: tg.pad_scalar(f, bc)  # noqa: E731
    rhs = a * x_true - tpr.poisson_apply(x_true, tgf, grid, pad)
    res = tpr.solve_helmholtz(a, tgf, rhs, torch.zeros_like(rhs), grid, bc,
                              tpr.PressureSolverConfig(tol=1e-7, maxiter=400))
    assert int(res.iters) < 400
    np.testing.assert_allclose(res.x.numpy(), x_true.numpy(), rtol=1e-3, atol=1e-4)


def _fluid(grid, seed):
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid.shape
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    alpha = (0.9 + 0.1 * rng.rand(nx, ny, nz)).astype(np.float32)
    return dict(
        u=1e-3 * r(3, nx, ny, nz), u_old=1e-3 * r(3, nx, ny, nz), p=1e-4 * r(nx, ny, nz),
        phi=(1e-3 * r(nx + 1, ny, nz), 1e-3 * r(nx, ny + 1, nz), 1e-3 * r(nx, ny, nz + 1)),
        alpha=alpha, alpha_old=(alpha + 1e-4 * r(nx, ny, nz)).astype(np.float32),
        u_source=1e-2 * r(3, nx, ny, nz),
        u_source_drag=(-10.0 * rng.rand(nx, ny, nz)).astype(np.float32),
        u_particle=1e-3 * r(3, nx, ny, nz))


def _state(d, jax_side):
    conv = jnp.asarray if jax_side else (lambda x: torch.as_tensor(np.array(x)))
    cls = jf.FluidState if jax_side else tf.FluidState
    return cls(**{k: (tuple(conv(x) for x in v) if isinstance(v, tuple) else conv(v))
                  for k, v in d.items()})


@pytest.mark.parametrize("variant", ["bench", "outer2_relaxed"])
def test_pimple_step_implicit_matches_jax(variant):
    """One implicit-diffusion PIMPLE step on a no-slip channel with a
    turbulent viscosity 100x nu (where the explicit path's dt cap would
    bite): the same pressure iterations, fields within 1e-5 of their
    scale."""
    grid = jg.Grid.box((8, 6, 10), (0.008, 0.006, 0.010))
    bcs = FluidBCs.channel_z()
    d = _fluid(grid, 4)
    nut = (1e-4 * (1 + np.random.RandomState(5).rand(*grid.shape))).astype(np.float32)
    kw = dict(n_outer=1, n_correctors=2)
    if variant == "outer2_relaxed":
        kw = dict(n_outer=2, n_correctors=1, relax_u=0.8, relax_p=0.7,
                  convection_scheme="linearUpwind")
    cfg = jp.PIMPLEConfig(pressure=jpr.PressureSolverConfig(solver="mgpcg", tol=1e-6,
                                                            maxiter=100),
                          implicit_diffusion=True, full_stress=False, **kw)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    ref, rinfo = jp.pimple_step(_state(d, True), grid, bcs, 1e-6, jnp.asarray(nut),
                                jnp.asarray(g), 5e-5, cfg)
    out, oinfo = tp.pimple_step(_state(d, False), config_from(grid), config_from(bcs), 1e-6,
                                torch.as_tensor(nut), torch.as_tensor(g), 5e-5,
                                config_from(cfg))
    assert int(oinfo.iters) == int(rinfo.iters) >= 2
    _close("u", out.u, ref.u, 1e-5)
    _close("p", out.p, ref.p, 1e-5)
    for a in range(3):
        _close(f"phi[{a}]", out.phi[a], ref.phi[a], 1e-5)


def test_implicit_refuses_full_stress():
    """implicit_diffusion with the explicit dev2 term raises, as the JAX
    package asserts."""
    grid = config_from(jg.Grid.cube(8, 0.008))
    fs = tf.make_fluid_state(grid, CPU)
    with pytest.raises(ValueError, match="full_stress"):
        tp.pimple_step(fs, grid, config_from(FluidBCs.channel_z()), 1e-6,
                       torch.zeros(grid.shape), torch.zeros(3), 5e-5,
                       tp.PIMPLEConfig(implicit_diffusion=True, full_stress=True))


def _channel_run(implicit, dt, nsteps, nu=1e-4, gx=0.01):
    """A pressure-free Poiseuille start-up: a 4x4x16 no-slip channel of
    height 1 mm driven by a body force along x."""
    grid = tg.Grid.box((4, 4, 16), (1e-3, 1e-3, 1e-3))
    bcs = config_from(FluidBCs.channel_z())
    fs = tf.make_fluid_state(grid, CPU)
    cfg = tp.PIMPLEConfig(
        n_outer=1, n_correctors=1,
        pressure=tpr.PressureSolverConfig(solver="pcg", tol=1e-7, maxiter=400),
        implicit_diffusion=implicit, full_stress=False,
        momentum=tpr.PressureSolverConfig(solver="pcg", tol=1e-7, maxiter=200))
    g = torch.tensor([gx, 0.0, 0.0])
    nut = torch.zeros(grid.shape)
    for _ in range(nsteps):
        fs2, _ = tp.pimple_step(fs, grid, bcs, nu, nut, g, dt, cfg)
        fs = fs2._replace(u_old=fs.u, alpha_old=fs.alpha)
    return fs


def test_implicit_matches_explicit_at_small_dt():
    """Both discretizations agree where the explicit path is stable (half
    the explicit bound), as the JAX package's test holds them."""
    fs_i = _channel_run(True, 2e-6, 300)
    fs_e = _channel_run(False, 2e-6, 300)
    assert float(fs_e.u[0].abs().max()) > 0.0
    np.testing.assert_allclose(fs_i.u[0].numpy(), fs_e.u[0].numpy(), rtol=2e-2, atol=1e-9)


def _keps_case(implicit):
    grid = tg.Grid.cube(12, 12e-3)
    return tcd.CaseConfig(
        grid=grid, bcs=config_from(FluidBCs.channel_z()),
        transport=tcd.TransportProperties(nu=1e-6), solver="pimple",
        coupling=tcp.CouplingConfig(gaussian=True, lag_alpha=True, exchange="planes",
                                    slot_capacity=8),
        dem=tdem.DEMConfig(params=tdem.ContactParams(kn=100.0), neighbor="allpairs",
                           periodic=(True, True, False), wall_axes=(False, False, True)),
        pimple=tp.PIMPLEConfig(
            n_outer=1, n_correctors=1, implicit_diffusion=implicit,
            full_stress=not implicit,
            momentum=tpr.PressureSolverConfig(solver="pcg", tol=1e-6, maxiter=200)),
        turbulence=TurbulenceConfig(model="kEpsilon"),
        time=TimeControls(adjust_time_step=True, max_co=0.5, max_dt=2e-3),
        n_dem_substeps=2, r_max=2e-4)


def test_kepsilon_holds_courant_dt():
    """A kEpsilon case with nu_eff >> nu (nut = Cmu k^2/eps = 1e-2 m^2/s):
    under implicit diffusion dt grows past 3x the explicit-diffusion cap
    h^2/(6 nu_eff) in 10 steps; the explicit path stays at the cap."""
    def run(implicit):
        cfg = _keps_case(implicit)
        L = cfg.grid.lengths[0]
        pos = np.random.RandomState(2).uniform(0.4 * L, 0.6 * L, (8, 3))
        state = tcd.initialize_state(
            tf.make_fluid_state(cfg.grid, CPU), tf.make_particle_state(pos, CPU, radius=2e-4),
            tf.make_turbulence_state(cfg.grid, CPU, k0=1e-2, eps0=9e-4), cfg, dt=1e-5)
        step = tcd.make_step_fn(cfg)
        dts = []
        for _ in range(10):
            state, _ = step(state)
            dts.append(float(state.dt))
        bound = float(diffusive_dt_bound(cfg.grid, cfg.transport.nu,
                                         float(state.turb.nut.max())))
        assert bool(torch.isfinite(state.fluid.u).all())
        return dts, bound

    dts_imp, bound = run(True)
    assert bound < 5e-5, bound
    assert dts_imp[-1] > 3.0 * bound, (dts_imp, bound)
    dts_exp, bound_e = run(False)
    assert dts_exp[-1] <= 1.05 * bound_e, (dts_exp, bound_e)


def test_diffusive_bound_skipped_under_implicit(monkeypatch):
    """coupled_step computes no explicit-diffusion bound under implicit
    diffusion (its dt is Courant-limited only), and does with explicit."""
    calls = []
    real = tcd.diffusive_dt_bound
    monkeypatch.setattr(tcd, "diffusive_dt_bound", lambda *a: calls.append(a) or real(*a))
    for implicit in (True, False):
        cfg = dataclasses.replace(_keps_case(implicit), grid=tg.Grid.cube(8, 8e-3))
        state = tcd.initialize_state(
            tf.make_fluid_state(cfg.grid, CPU),
            tf.make_particle_state(np.full((1, 3), 4e-3), CPU, radius=2e-4),
            tf.make_turbulence_state(cfg.grid, CPU, k0=1e-4, eps0=1e-4), cfg, dt=1e-5)
        tcd.make_step_fn(cfg)(state)
        assert len(calls) == (0 if implicit else 1)


def test_coupled_steps_build_the_wall_layers_once(monkeypatch):
    """kEpsilon's wall layers are built once per config and device, not at
    every step: three coupled steps call `turbulence.wall_layers` once."""
    from yade_openfoam_coupling_tpu_torch.models import turbulence as tt
    calls = []
    real = tt.wall_layers
    monkeypatch.setattr(tt, "wall_layers", lambda *a: calls.append(a[2]) or real(*a))
    cfg = dataclasses.replace(_keps_case(True), grid=tg.Grid.cube(8, 8e-3))
    state = tcd.initialize_state(
        tf.make_fluid_state(cfg.grid, CPU),
        tf.make_particle_state(np.full((1, 3), 4e-3), CPU, radius=2e-4),
        tf.make_turbulence_state(cfg.grid, CPU, k0=1e-4, eps0=1e-4), cfg, dt=1e-5)
    tcd.make_scan_fn(cfg, 3)(state)
    assert calls == [CPU]
