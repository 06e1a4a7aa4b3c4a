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
from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
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
    assert LAUNCHES["yofc_laplacian"] + LAUNCHES["yofc_laplacian_bf16"] == 0
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
    """On the CPU ``use_pallas`` routes CG's matvecs (sides >= 8) through
    the B2 wrapper, whose CPU path is the plain stencil, so the solve is
    bit for bit the plain one; the float32 Jacobi V-cycle's sweeps go
    through `mg_fused`'s wrappers on either setting, so B2 sees only the
    16^3 level. The JAX suite holds its own use_pallas path to its plain
    one (test_pallas.py)."""
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
    assert {s[0] - 2 for s in calls} == {16}


def _manufactured_both(cfg):
    """test_pressure.py's manufactured periodic problem at 16^3 with rough
    face coefficients interpolated periodically (a symmetric operator):
    rhs = A(p_exact), so CG converges to its tolerance. -> (JAX result,
    port result)."""
    bc = jg.FieldBC.periodic()
    x = (np.arange(16) + 0.5) / 16 * 2 * np.pi
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    p_exact = (np.sin(X) * np.cos(2 * Y) * np.sin(Z)).astype(np.float32)
    gamma = (1.0 + 0.5 * np.random.RandomState(1).rand(*GRID.shape)).astype(np.float32)
    gf = jst.face_interp(jnp.asarray(gamma), bc, GRID)
    tgf = tuple(torch.as_tensor(np.array(g)) for g in gf)
    rhs = np.asarray(jpr.poisson_apply(jnp.asarray(p_exact), gf, GRID, jpr.default_pad(bc)))
    ref = jpr.solve_pressure(gf, jnp.asarray(rhs), jnp.zeros(GRID.shape), GRID, bc, cfg)
    out = tpr.solve_pressure(tgf, torch.as_tensor(rhs), torch.zeros(GRID.shape),
                             config_from(GRID), config_from(bc), config_from(cfg))
    return ref, out


@pytest.mark.parametrize("solver", ["mgpcg", "pcg"])
def test_fixed_iters_matches_while_loop(solver):
    """``fixed_iters`` with a budget of the while loop's iterations + 3:
    the same live iterations and x within 1e-6 of the while loop's (the
    frozen state is the converged one), in the port and against the JAX
    package's fori_loop; under budget (2 fewer), exactly the budget's
    iterations and a residual no smaller, as in JAX."""
    base = jpr.PressureSolverConfig(solver=solver, tol=1e-6, maxiter=200)
    ref_w, out_w = _manufactured_both(base)
    n = int(out_w.iters)
    ref_f, out_f = _manufactured_both(dataclasses.replace(base, fixed_iters=n + 3))
    assert int(out_f.iters) == int(ref_f.iters) == n == int(ref_w.iters)
    assert out_f.iters.dtype == torch.int32
    _close("x fixed vs while", out_f.x.numpy(), out_w.x.numpy(), 1e-6)
    _close("x fixed vs JAX", out_f.x.numpy(), ref_f.x, 1e-4)
    _close("residual", out_f.residual.numpy(), out_w.residual.numpy(), 1e-6)
    ref_s, out_s = _manufactured_both(dataclasses.replace(base, fixed_iters=n - 2))
    assert int(out_s.iters) == int(ref_s.iters) == n - 2
    assert float(out_s.residual) >= float(out_w.residual)


def test_pcg_fixed_iters_freezes_after_convergence():
    """Past convergence the fixed-budget state is frozen: a budget of 40
    and one of 80 give the same x bit for bit and the same live count."""
    gf, tgf = _faces(GRID)
    rhs = torch.as_tensor(np.random.RandomState(7).randn(*GRID.shape).astype(np.float32))
    cfg = tpr.PressureSolverConfig(solver="mgpcg", tol=1e-5, maxiter=200)
    args = (tgf, rhs, torch.zeros(GRID.shape), config_from(GRID), config_from(P_BC))
    a = tpr.solve_pressure(*args, dataclasses.replace(cfg, fixed_iters=40))
    b = tpr.solve_pressure(*args, dataclasses.replace(cfg, fixed_iters=80))
    assert int(a.iters) == int(b.iters) < 40
    np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())


def test_mg_bf16_vcycle_matches_jax():
    """The bf16 V-cycle as mgpcg's preconditioner against the JAX
    package's on test_pressure.py's 32^3 Neumann problem: bf16 rounds at
    other places in the two frameworks, so no bit match; the same solution
    within the solve's tolerance, CG iterations within 2, and the final
    residual under the JAX test's 1.1 max(1e-5 |r0|, 1e-5 |b|)."""
    grid = jg.Grid.cube(32, 1.0)
    bc = jg.FieldBC.uniform(jg.NEUMANN)
    gamma = tuple(np.ones(s, np.float32) for s in ((33, 32, 32), (32, 33, 32), (32, 32, 33)))
    rhs = np.random.RandomState(0).randn(32, 32, 32).astype(np.float32)
    rhs -= rhs.mean()
    for use_pallas in (False, True):
        cfg = jpr.PressureSolverConfig(solver="mgpcg", tol=1e-5, maxiter=60,
                                       mg=jpr.MGConfig(bf16=True), use_pallas=use_pallas)
        if use_pallas:   # the port's wrapper on the CPU is the plain stencil
            out_p = tpr.solve_pressure(tuple(map(torch.as_tensor, gamma)),
                                       torch.as_tensor(rhs), torch.zeros(grid.shape),
                                       config_from(grid), config_from(bc), config_from(cfg))
            np.testing.assert_array_equal(out_p.x.numpy(), out.x.numpy())
            continue
        ref = jpr.solve_pressure(tuple(map(jnp.asarray, gamma)), jnp.asarray(rhs),
                                 jnp.zeros(grid.shape), grid, bc, cfg)
        out = tpr.solve_pressure(tuple(map(torch.as_tensor, gamma)), torch.as_tensor(rhs),
                                 torch.zeros(grid.shape), config_from(grid), config_from(bc),
                                 config_from(cfg))
        assert abs(int(out.iters) - int(ref.iters)) <= 2
        bound = 1.1 * max(1e-5 * float(out.initial_residual),
                          1e-5 * float(np.linalg.norm(rhs)))
        assert float(out.residual) <= bound
        _close("x", out.x.numpy(), ref.x, 2e-5)
        f32 = tpr.solve_pressure(tuple(map(torch.as_tensor, gamma)), torch.as_tensor(rhs),
                                 torch.zeros(grid.shape), config_from(grid), config_from(bc),
                                 config_from(dataclasses.replace(cfg, mg=jpr.MGConfig())))
        _close("x bf16 vs f32", out.x.numpy(), f32.x.numpy(), 2e-5)


def test_bf16_vcycle_runs_in_bf16(monkeypatch):
    """Under MGConfig.bf16 every level's matvec gets bf16 p and
    coefficients (B2's bf16 entry on sides >= 8 under use_pallas); the
    preconditioner returns float32."""
    seen = []
    real = tfs.laplacian_facegamma_fused
    monkeypatch.setattr(tpr, "laplacian_facegamma_fused",
                        lambda g, pp, gr: seen.append((pp.dtype, g[0].dtype)) or real(g, pp, gr))
    _, tgf = _faces(GRID)
    M = tpr.make_mg_preconditioner(tgf, config_from(GRID), config_from(P_BC.homogeneous()),
                                   tpr.MGConfig(bf16=True), use_pallas=True)
    out = M(torch.as_tensor(np.random.RandomState(3).randn(*GRID.shape).astype(np.float32)))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("shape", [(16, 16, 32), (8, 8, 8), (13, 10, 17)])
@pytest.mark.parametrize("bc_kind", ["periodic", "walls"])
def test_laplacian_bf16_plain_matches_pallas(bc_kind, shape):
    """B2's plain version on bf16 against the Pallas kernel in interpret
    mode on bf16 (both return bf16): within 2 bf16 ulps of the output's
    scale (7.9e-3 of it on the 16x16x32 box), bf16 rounding at other places
    in the two frameworks (the Pallas kernel scales each axis by 1/h^2
    once, the stencil divides by h twice); on an anisotropic box, the
    V-cycle's smallest B2 level (8^3) and an odd shape."""
    grid = jg.Grid.box(shape, (1.0, 2.0, 1.5))
    bc = jg.FieldBC.periodic() if bc_kind == "periodic" else jg.FieldBC.box(jg.NEUMANN)
    p = np.random.RandomState(0).randn(*grid.shape).astype(np.float32)
    gf, tgf = _faces(grid)
    expect = laplacian_facegamma_pallas(tuple(g.astype(jnp.bfloat16) for g in gf),
                                        jg.pad_scalar(jnp.asarray(p, jnp.bfloat16), bc), grid,
                                        interpret=True)
    pp = tg.pad_scalar(torch.as_tensor(p).to(torch.bfloat16), config_from(bc))
    got = tfs.laplacian_facegamma_fused(tuple(g.to(torch.bfloat16) for g in tgf), pp,
                                        config_from(grid))
    assert got.dtype == torch.bfloat16 and expect.dtype == jnp.bfloat16
    ref = np.asarray(expect, np.float64)
    two_ulps = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 6)
    assert np.abs(got.float().numpy() - ref).max() <= two_ulps
    assert LAUNCHES["yofc_laplacian"] == LAUNCHES["yofc_laplacian_bf16"] == 0
    with pytest.raises(ValueError, match="gamma_x"):
        tfs.laplacian_facegamma_fused(tgf, pp, config_from(grid))
