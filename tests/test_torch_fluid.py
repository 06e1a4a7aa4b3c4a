"""PyTorch port of the fluid main path against the JAX package: the fftpcg
pressure solve, the kEqn turbulence correction and one PIMPLE step with 2
correctors, on a non-cubic channel grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import fields as jf
from yade_openfoam_coupling_tpu.models import pimple as jp
from yade_openfoam_coupling_tpu.models import turbulence as jt
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import pressure as jpr
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.models import fields as tf
from yade_openfoam_coupling_tpu_torch.models import pimple as tp
from yade_openfoam_coupling_tpu_torch.models import turbulence as tt
from yade_openfoam_coupling_tpu_torch.ops import pressure as tpr

GRID = Grid.box((8, 6, 10), (0.008, 0.006, 0.010))
BCS = FluidBCs.channel_z()
PCFG = jpr.PressureSolverConfig(solver="fftpcg", tol=1e-5, maxiter=40)


def _close(out, ref, rel):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max() + 1e-30, err / np.abs(ref).max()


def _fluid(seed=0):
    """A random but smooth-ish fluid state with particles' alpha < 1."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID.shape
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    alpha = (0.9 + 0.1 * rng.rand(nx, ny, nz)).astype(np.float32)
    return dict(
        u=1e-3 * r(3, nx, ny, nz), u_old=1e-3 * r(3, nx, ny, nz), p=1e-4 * r(nx, ny, nz),
        phi=(1e-3 * r(nx + 1, ny, nz), 1e-3 * r(nx, ny + 1, nz), 1e-3 * r(nx, ny, nz + 1)),
        alpha=alpha, alpha_old=(alpha + 1e-4 * r(nx, ny, nz)).astype(np.float32),
        u_source=1e-2 * r(3, nx, ny, nz), u_source_drag=(-10.0 * rng.rand(nx, ny, nz)).astype(np.float32),
        u_particle=1e-3 * r(3, nx, ny, nz))


def _state(d, jax_side):
    conv = jnp.asarray if jax_side else (lambda x: torch.as_tensor(np.array(x)))
    cls = jf.FluidState if jax_side else tf.FluidState
    return cls(**{k: (tuple(conv(x) for x in v) if isinstance(v, tuple) else conv(v))
                  for k, v in d.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pressure_fftpcg_matches(seed):
    """Same iteration count; the solution within 1e-4 of its scale (CG's
    f32 rounding in another order, against a 1e-5 residual target)."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID.shape
    gam = [(1e-4 * (1.0 + 0.1 * rng.rand(*s))).astype(np.float32)
           for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    rhs = rng.randn(nx, ny, nz).astype(np.float32)
    p0 = (1e-2 * rng.randn(nx, ny, nz)).astype(np.float32)
    ref = jpr.solve_pressure(tuple(jnp.asarray(g) for g in gam), jnp.asarray(rhs),
                             jnp.asarray(p0), GRID, BCS.p, PCFG)
    out = tpr.solve_pressure(tuple(torch.as_tensor(g) for g in gam), torch.as_tensor(rhs),
                             torch.as_tensor(p0), config_from(GRID), config_from(BCS.p),
                             config_from(PCFG))
    assert int(out.iters) == int(ref.iters) > 1
    _close(out.x, ref.x, 1e-4)
    _close(out.initial_residual, ref.initial_residual, 1e-5)


@pytest.mark.parametrize("bname", ["channel", "box"])
def test_poisson_diag_matches(bname):
    bc = BCS.p if bname == "channel" else FluidBCs.box_noslip().u
    rng = np.random.RandomState(6)
    nx, ny, nz = GRID.shape
    gam = [rng.rand(*s).astype(np.float32)
           for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    ref = jpr.poisson_diag(tuple(jnp.asarray(g) for g in gam), GRID, bc)
    out = tpr.poisson_diag(tuple(torch.as_tensor(g) for g in gam), config_from(GRID),
                           config_from(bc))
    _close(out, ref, 1e-6)


def test_unported_pressure_solvers_raise():
    """The solver options that once raised now run and match the JAX
    package on a seeded channel problem: fftpcg with ``fixed_iters`` (the
    same live iterations, x within 1e-4 of its scale, as the while loop
    above) and mgpcg with the bf16 V-cycle (CG iterations within 2, x
    within 1e-3 of its scale: bf16 rounds at other places in the two
    frameworks, against a 1e-5 residual target); the zero problem
    converges at entry."""
    rng = np.random.RandomState(9)
    nx, ny, nz = GRID.shape
    gam = [(1e-4 * (1.0 + 0.1 * rng.rand(*s))).astype(np.float32)
           for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    gam[0][-1], gam[1][:, -1] = gam[0][0], gam[1][:, 0]   # one face per periodic seam
    rhs = rng.randn(nx, ny, nz).astype(np.float32)
    for cfg, d_iters, rel in ((jpr.PressureSolverConfig(solver="fftpcg", tol=1e-5, maxiter=40,
                                                        fixed_iters=30), 0, 1e-4),
                              (jpr.PressureSolverConfig(solver="mgpcg", tol=1e-5, maxiter=100,
                                                        mg=jpr.MGConfig(bf16=True)), 2, 1e-3)):
        ref = jpr.solve_pressure(tuple(jnp.asarray(g) for g in gam), jnp.asarray(rhs),
                                 jnp.zeros(GRID.shape), GRID, BCS.p, cfg)
        out = tpr.solve_pressure(tuple(torch.as_tensor(g) for g in gam), torch.as_tensor(rhs),
                                 torch.zeros(GRID.shape), config_from(GRID), config_from(BCS.p),
                                 config_from(cfg))
        assert abs(int(out.iters) - int(ref.iters)) <= d_iters and int(out.iters) > 1
        _close(out.x, ref.x, rel)
        z = torch.zeros(GRID.shape)
        zero = tpr.solve_pressure(tuple(torch.ones_like(torch.as_tensor(g)) for g in gam), z, z,
                                  config_from(GRID), config_from(BCS.p), config_from(cfg))
        assert int(zero.iters) == 0


def test_keqn_correct_matches():
    d = _fluid(2)
    rng = np.random.RandomState(3)
    k = (1e-6 * (1 + rng.rand(*GRID.shape))).astype(np.float32)
    nut = (1e-7 * rng.rand(*GRID.shape)).astype(np.float32)
    cfg = jt.TurbulenceConfig(model="kEqn")
    ref = jt.correct(jf.TurbulenceState(jnp.asarray(k), jnp.zeros_like(jnp.asarray(k)),
                                        jnp.asarray(nut)),
                     _state(d, True), GRID, BCS, 1e-6, 5e-5, cfg)
    out = tt.correct(tf.TurbulenceState(torch.as_tensor(k), torch.zeros_like(torch.as_tensor(k)),
                                        torch.as_tensor(nut)),
                     _state(d, False), config_from(GRID), config_from(BCS), 1e-6, 5e-5,
                     config_from(cfg))
    _close(out.k, ref.k, 1e-6)
    _close(out.nut, ref.nut, 1e-6)
    # kEpsilon (once refused) from the same k, eps = 10 k and nut
    eps = (10.0 * k).astype(np.float32)
    cfg = jt.TurbulenceConfig(model="kEpsilon")
    ref = jt.correct(jf.TurbulenceState(jnp.asarray(k), jnp.asarray(eps), jnp.asarray(nut)),
                     _state(d, True), GRID, BCS, 1e-6, 5e-5, cfg)
    out = tt.correct(tf.TurbulenceState(torch.as_tensor(k), torch.as_tensor(eps),
                                        torch.as_tensor(nut)),
                     _state(d, False), config_from(GRID), config_from(BCS), 1e-6, 5e-5,
                     config_from(cfg))
    for name in ("k", "epsilon", "nut"):
        _close(getattr(out, name), getattr(ref, name), 1e-6)


@pytest.mark.parametrize("variant", ["bench", "outer2_relaxed"])
def test_pimple_step_matches(variant):
    """One PIMPLE step under gravity and a coupling source — the bench's 1
    outer loop x 2 correctors, and 2 relaxed outer loops with the momentum
    predictor and the pressure warm start: same total pressure iterations,
    fields within 1e-5 of their scale."""
    d = _fluid(4)
    nut = (1e-7 * np.random.RandomState(5).rand(*GRID.shape)).astype(np.float32)
    kw = dict(n_outer=1, n_correctors=2)
    if variant == "outer2_relaxed":
        kw = dict(n_outer=2, n_correctors=1, momentum_predictor=True, relax_u=0.8,
                  relax_p=0.7, p_extrapolate=0.5, convection_scheme="linearUpwind")
        d["p_prev"] = (0.9 * d["p"]).astype(np.float32)
    cfg = jp.PIMPLEConfig(pressure=PCFG, **kw)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    ref, rinfo = jp.pimple_step(_state(d, True), GRID, BCS, 1e-6, jnp.asarray(nut),
                                jnp.asarray(g), 5e-5, cfg)
    out, oinfo = tp.pimple_step(_state(d, False), config_from(GRID), config_from(BCS), 1e-6,
                                torch.as_tensor(nut), torch.as_tensor(g), 5e-5,
                                config_from(cfg))
    assert int(oinfo.iters) == int(rinfo.iters) >= 2
    _close(out.u, ref.u, 1e-5)
    _close(out.p, ref.p, 1e-5)
    for a in range(3):
        _close(out.phi[a], ref.phi[a], 1e-5)
    _close(oinfo.final_residual, rinfo.final_residual, 1e-2)


def test_step_diagnostics_match():
    """Courant number, adaptive dt (with the explicit-diffusion cap) and the
    continuity errors."""
    from yade_openfoam_coupling_tpu.utils import diagnostics as jdg
    from yade_openfoam_coupling_tpu_torch.utils import diagnostics as tdg
    d = _fluid(8)
    j, t = _state(d, True), _state(d, False)
    tc = jdg.TimeControls(adjust_time_step=True, max_co=0.4, max_dt=1e-3)
    rco = jdg.courant(j.phi, GRID, 5e-5)
    oco = tdg.courant(t.phi, config_from(GRID), torch.tensor(5e-5))
    for o, r in zip(oco, rco):
        _close(o, r, 1e-6)
    rdt = jdg.new_dt(rco[1], jnp.float32(5e-5), tc,
                     dt_diff=jdg.diffusive_dt_bound(GRID, 1e-6, jnp.float32(1e-3)))
    odt = tdg.new_dt(oco[1], torch.tensor(5e-5), config_from(tc),
                     dt_diff=tdg.diffusive_dt_bound(config_from(GRID), 1e-6,
                                                    torch.tensor(1e-3)))
    _close(odt, rdt, 1e-6)
    rce = jdg.continuity_errors(j.phi, j.alpha, j.alpha_old, GRID, 5e-5)
    oce = tdg.continuity_errors(t.phi, t.alpha, t.alpha_old, config_from(GRID), 5e-5)
    for o, r in zip(oce, rce):
        _close(o, r, 1e-5)
