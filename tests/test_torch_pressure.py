"""The port's pressure solvers against the JAX package's on the same
seeded numpy inputs: kernel B2's plain version against the Pallas
Laplacian in interpret mode, one V-cycle (Jacobi and Chebyshev
smoothers), `solve_pressure` with mgpcg and Jacobi pcg (equal iteration
counts), fftpcg's V-cycle fallback, and ``use_pallas``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import grid as jg
from yade_openfoam_coupling_tpu.ops import pressure as jpr
from yade_openfoam_coupling_tpu.ops import stencil as jst
from yade_openfoam_coupling_tpu.ops.pallas_stencil import laplacian_facegamma_pallas
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as tfs
from yade_openfoam_coupling_tpu_torch.ops import grid as tg
from yade_openfoam_coupling_tpu_torch.ops import pressure as tpr

GRID = jg.Grid.cube(16, 0.016)
P_BC = FluidBCs.channel_z().p            # periodic x/y, zero-gradient z
P = jg.FaceBC(jg.PERIODIC)
SLIP_BC = jg.FieldBC(((P, P), (P, P), (jg.FaceBC(jg.SLIP), jg.FaceBC(jg.SLIP))))


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _faces(grid, seed=1, rough=0.5):
    """Face coefficients from a seeded cell field, both packages' copies."""
    gamma = (1.0 + rough * np.random.RandomState(seed).rand(*grid.shape)).astype(np.float32)
    gf = jst.face_interp(jnp.asarray(gamma), jg.FieldBC.uniform(jg.NEUMANN), grid)
    return gf, tuple(torch.as_tensor(np.array(g)) for g in gf)


@pytest.mark.parametrize("bc_kind", ["periodic", "walls"])
def test_laplacian_plain_matches_pallas(bc_kind):
    """B2's plain version against the Pallas kernel in interpret mode, at
    test_pallas.py's tolerance; on a CPU tensor the wrapper is the plain
    version and counts no launch, and it refuses a non-contiguous input."""
    grid = jg.Grid.box((16, 16, 32), (1.0, 2.0, 1.5))
    bc = jg.FieldBC.periodic() if bc_kind == "periodic" else jg.FieldBC.box(jg.NEUMANN)
    p = np.random.RandomState(0).randn(*grid.shape).astype(np.float32)
    gf, tgf = _faces(grid)
    expect = laplacian_facegamma_pallas(gf, jg.pad_scalar(jnp.asarray(p), bc), grid,
                                        interpret=True)
    pp = tg.pad_scalar(torch.as_tensor(p), config_from(bc))
    got = tfs.laplacian_facegamma_fused(tgf, pp, config_from(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-5, atol=2e-4)
    assert tfs.laplacian_facegamma_fused.launches == 0
    with pytest.raises(ValueError, match="gamma_x"):
        tfs.laplacian_facegamma_fused((tgf[0].transpose(1, 2),) + tgf[1:], pp,
                                      config_from(grid))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_matches_jax(smoother):
    """One V-cycle application (3 levels at 16^3) within 1e-5 of scale."""
    gf, tgf = _faces(GRID)
    r = np.random.RandomState(3).randn(*GRID.shape).astype(np.float32)
    mg = jpr.MGConfig(smoother=smoother)
    hbc = P_BC.homogeneous()
    ref = jpr.make_mg_preconditioner(gf, GRID, hbc, mg)(jnp.asarray(r))
    out = tpr.make_mg_preconditioner(tgf, config_from(GRID), config_from(hbc),
                                     config_from(mg))(torch.as_tensor(r))
    assert tpr.mg_levels_for(config_from(GRID)) == jpr.mg_levels_for(GRID) == 3
    _close("vcycle", out.numpy(), ref, 1e-5)


def _solve_both(cfg, bc=P_BC, seed=4):
    gf, tgf = _faces(GRID)
    rhs = np.random.RandomState(seed).randn(*GRID.shape).astype(np.float32)
    ref = jpr.solve_pressure(gf, jnp.asarray(rhs), jnp.zeros(GRID.shape), GRID, bc, cfg)
    out = tpr.solve_pressure(tgf, torch.as_tensor(rhs), torch.zeros(GRID.shape),
                             config_from(GRID), config_from(bc), config_from(cfg))
    return ref, out


@pytest.mark.parametrize("solver", ["mgpcg", "pcg"])
def test_solve_pressure_matches_jax(solver):
    """mgpcg (Jacobi V-cycle) and Jacobi pcg: equal iteration counts, x
    within 1e-4 of its scale, residuals within 1e-3 of theirs."""
    ref, out = _solve_both(jpr.PressureSolverConfig(solver=solver, tol=1e-6, maxiter=200))
    assert int(out.iters) == int(ref.iters)
    _close("x", out.x.numpy(), ref.x, 1e-4)
    _close("initial_residual", out.initial_residual.numpy(), ref.initial_residual, 1e-5)
    _close("residual", out.residual.numpy(), ref.residual, 1e-3)


def test_fftpcg_falls_back_to_vcycle():
    """With a BC pair that has no trigonometric basis (slip faces) fftpcg
    preconditions with the V-cycle in both packages: the same iteration
    count and x as the port's own mgpcg."""
    cfg = jpr.PressureSolverConfig(solver="fftpcg", tol=1e-6, maxiter=200)
    ref, out = _solve_both(cfg, SLIP_BC)
    assert tpr.make_spectral_preconditioner(None, config_from(GRID),
                                            config_from(SLIP_BC).homogeneous()) is None
    assert int(out.iters) == int(ref.iters)
    _close("x", out.x.numpy(), ref.x, 1e-4)
    _, mg = _solve_both(dataclasses.replace(cfg, solver="mgpcg"), SLIP_BC)
    assert int(mg.iters) == int(out.iters)
    np.testing.assert_array_equal(mg.x.numpy(), out.x.numpy())


@pytest.mark.parametrize("solver", ["mgpcg", "pcg"])
def test_use_pallas_on_cpu_is_the_plain_solve(solver, monkeypatch):
    """On the CPU ``use_pallas`` routes every matvec with sides >= 8
    through the B2 wrapper, whose CPU path is the plain stencil, so the
    solve is bit for bit the plain one; the JAX suite holds its own
    use_pallas path to its plain one (test_pallas.py)."""
    cfg = tpr.PressureSolverConfig(solver=solver, tol=1e-6, maxiter=200)
    _, tgf = _faces(GRID)
    rhs = torch.as_tensor(np.random.RandomState(5).randn(*GRID.shape).astype(np.float32))
    args = (tgf, rhs, torch.zeros(GRID.shape), config_from(GRID), config_from(P_BC))
    calls = []
    real = tfs.laplacian_facegamma_fused
    monkeypatch.setattr(tpr, "laplacian_facegamma_fused",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    fused = tpr.solve_pressure(*args, dataclasses.replace(cfg, use_pallas=True))
    plain = tpr.solve_pressure(*args, cfg)
    assert int(fused.iters) == int(plain.iters)
    np.testing.assert_array_equal(fused.x.numpy(), plain.x.numpy())
    assert calls and all(min(s) - 2 >= 8 for s in calls)
    if solver == "mgpcg":   # the 4^3 coarsest level keeps the plain stencil
        assert {s[0] - 2 for s in calls} == {16, 8}
