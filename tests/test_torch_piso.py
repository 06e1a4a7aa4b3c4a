"""The port's PISO step, its momentum operator and the masked-cell obstacle
solve against the JAX package's on the same seeded numpy fluid state:
periodic, closed-box, channel and inlet/outflow (adjustPhi) BCs, ddtCorr
on and off, linear and upwind convection, one box obstacle in PISO and in
PIMPLE, and `solve_pressure(solid=...)` with and without `use_pallas` (the
port's plain stencil on the CPU against the Pallas kernel in interpret
mode). Tolerance: 1e-5 of each field's scale, equal CG iteration counts."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import fields as jf
from yade_openfoam_coupling_tpu.models import pimple as jpm
from yade_openfoam_coupling_tpu.models import piso as jps
from yade_openfoam_coupling_tpu.ops import obstacle as job
from yade_openfoam_coupling_tpu.ops import pressure as jpr
from yade_openfoam_coupling_tpu.ops.grid import DIRICHLET, NEUMANN, PERIODIC, FaceBC, FieldBC, Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.models import fields as tf
from yade_openfoam_coupling_tpu_torch.models import pimple as tpm
from yade_openfoam_coupling_tpu_torch.models import piso as tps
from yade_openfoam_coupling_tpu_torch.ops import obstacle as tob
from yade_openfoam_coupling_tpu_torch.ops import pressure as tpr

GRID = Grid.box((8, 10, 12), (0.008, 0.010, 0.012))
CPU = torch.device("cpu")
_P = FaceBC(PERIODIC)
INLET = jps.FluidBCs(
    u=FieldBC(((_P, _P), (_P, _P), (FaceBC(DIRICHLET, (0.0, 0.0, 2e-3)), FaceBC(NEUMANN)))),
    p=FieldBC(((_P, _P), (_P, _P), (FaceBC(NEUMANN), FaceBC(NEUMANN)))))
BCS = {"periodic": jps.FluidBCs.periodic(), "box_noslip": jps.FluidBCs.box_noslip(),
       "channel_z": jps.FluidBCs.channel_z(), "inlet_outflow": INLET}
SOLID = job.box_solid(GRID.shape, (2, 3, 4), (5, 6, 8))


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(out - ref).max() <= rel * scale, (
        name, np.abs(out - ref).max() / scale)


def _fluid(seed):
    """A seeded fluid state with non-zero face fluxes (ddtCorr's limiter
    divides by them) and coupling sources."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID.shape
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ones = np.ones(GRID.shape, np.float32)
    return dict(
        u=1e-3 * r(3, nx, ny, nz), u_old=1e-3 * r(3, nx, ny, nz), p=1e-4 * r(nx, ny, nz),
        phi=(1e-3 * r(nx + 1, ny, nz), 1e-3 * r(nx, ny + 1, nz), 1e-3 * r(nx, ny, nz + 1)),
        alpha=ones, alpha_old=ones, u_source=1e-2 * r(3, nx, ny, nz),
        u_source_drag=(-10.0 * rng.rand(nx, ny, nz)).astype(np.float32),
        u_particle=np.zeros((3, nx, ny, nz), np.float32))


def _states(d):
    j = jf.FluidState(**{k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                             else jnp.asarray(v)) for k, v in d.items()})
    t = tf.FluidState(**{k: (tuple(torch.as_tensor(x) for x in v) if isinstance(v, tuple)
                             else torch.as_tensor(v)) for k, v in d.items()})
    return j, t


@pytest.mark.parametrize("field_nu", [False, True])
def test_momentum_AH_matches(field_nu):
    """A and H with a scalar nu (the constant-coefficient Laplacian) and
    with a nu field and a body force g."""
    j, t = _states(_fluid(0))
    bcs = BCS["channel_z"]
    cfg = jps.PISOConfig(convection_scheme="upwind")
    if field_nu:
        nu = (1e-6 * (1 + np.random.RandomState(1).rand(*GRID.shape))).astype(np.float32)
        g = np.array([0.0, 0.1, -9.81], np.float32)
        ref = jps.momentum_AH(j, GRID, bcs, jnp.asarray(nu), 5e-5, cfg, g=jnp.asarray(g))
        out = tps.momentum_AH(t, config_from(GRID), config_from(bcs), torch.as_tensor(nu),
                              5e-5, config_from(cfg), g=torch.as_tensor(g))
    else:
        ref = jps.momentum_AH(j, GRID, bcs, 1e-6, 5e-5, cfg, u_latest=j.u_old)
        out = tps.momentum_AH(t, config_from(GRID), config_from(bcs), 1e-6, 5e-5,
                              config_from(cfg), u_latest=t.u_old)
    _close("A", out[0], ref[0], 1e-6)
    _close("H", out[1], ref[1], 1e-6)


STEPS = {
    "periodic_linear": ("periodic", dict()),
    "box_noslip_upwind": ("box_noslip", dict(convection_scheme="upwind")),
    "channel_z_ddtcorr": ("channel_z", dict(ddt_corr=True)),
    "inlet_outflow_ddtcorr_upwind": ("inlet_outflow", dict(ddt_corr=True,
                                                           convection_scheme="upwind")),
    "inlet_outflow_fftpcg_no_predictor": ("inlet_outflow", dict(
        momentum_predictor=False, n_correctors=3,
        pressure=jpr.PressureSolverConfig(solver="fftpcg", tol=1e-6))),
    "channel_z_obstacle": ("channel_z", dict(ddt_corr=True)),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_piso_step_matches(name):
    """One PISO step: the same total CG iterations; u, p and phi within
    1e-5 of their scale; the obstacle case keeps u and p zero and the flux
    through blocked faces zero."""
    bname, kw = STEPS[name]
    bcs = BCS[bname]
    cfg = jps.PISOConfig(**kw)
    d = _fluid(2)
    masks = None
    if name.endswith("obstacle"):
        # the state the coupled step starts from: u and phi masked
        masks = job.build_masks(SOLID, bcs.periodic_axes())
        d["u"] = np.array(job.mask_u(d["u"], masks))
        d["phi"] = tuple(np.array(f) for f in job.mask_flux(d["phi"], masks))
    j, t = _states(d)
    ref, rinfo = jps.piso_step(j, GRID, bcs, 1e-6, 5e-5, cfg, masks=masks)
    tmasks = None if masks is None else tob.build_masks(SOLID, bcs.periodic_axes(), CPU)
    out, oinfo = tps.piso_step(t, config_from(GRID), config_from(bcs), 1e-6, 5e-5,
                               config_from(cfg), masks=tmasks)
    assert int(oinfo.iters) == int(rinfo.iters) >= cfg.n_correctors
    _close("u", out.u, ref.u, 1e-5)
    _close("p", out.p, ref.p, 1e-5)
    for a in range(3):
        _close(f"phi[{a}]", out.phi[a], ref.phi[a], 1e-5)
    _close("initial_residual", oinfo.initial_residual, rinfo.initial_residual, 1e-5)
    if tmasks is not None:
        assert float((out.u * tmasks.solid).abs().max()) == 0.0
        assert float((out.p * tmasks.solid).abs().max()) == 0.0
        for a in range(3):
            assert float((out.phi[a] * (1 - tmasks.face[a])).abs().max()) == 0.0


def test_pimple_step_with_obstacle_matches():
    """One PIMPLE step (2 outer x 1 corrector, momentum predictor) with the
    box obstacle under gravity and a coupling source."""
    d = _fluid(3)
    rng = np.random.RandomState(4)
    d["alpha"] = (0.9 + 0.1 * rng.rand(*GRID.shape)).astype(np.float32)
    d["alpha_old"] = (d["alpha"] + 1e-4 * rng.randn(*GRID.shape)).astype(np.float32)
    nut = (1e-7 * rng.rand(*GRID.shape)).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    bcs = BCS["channel_z"]
    cfg = jpm.PIMPLEConfig(n_outer=2, n_correctors=1, momentum_predictor=True,
                           pressure=jpr.PressureSolverConfig(solver="mgpcg", tol=1e-6))
    masks = job.build_masks(SOLID, bcs.periodic_axes())
    j, t = _states(d)
    ref, rinfo = jpm.pimple_step(j, GRID, bcs, 1e-6, jnp.asarray(nut), jnp.asarray(g), 5e-5,
                                 cfg, masks=masks)
    tmasks = tob.build_masks(SOLID, bcs.periodic_axes(), CPU)
    out, oinfo = tpm.pimple_step(t, config_from(GRID), config_from(bcs), 1e-6,
                                 torch.as_tensor(nut), torch.as_tensor(g), 5e-5,
                                 config_from(cfg), masks=tmasks)
    assert int(oinfo.iters) == int(rinfo.iters) >= 2
    _close("u", out.u, ref.u, 1e-5)
    _close("p", out.p, ref.p, 1e-5)
    for a in range(3):
        _close(f"phi[{a}]", out.phi[a], ref.phi[a], 1e-5)
    assert float((out.u * tmasks.solid).abs().max()) == 0.0


def test_build_masks_matches():
    """The masks equal the JAX package's on periodic and wall axes."""
    for periodic in ((True, True, False), (False, True, True)):
        ref = job.build_masks(SOLID, periodic)
        out = tob.build_masks(SOLID, periodic, CPU)
        assert out.n_solid == ref.n_solid == 3 * 3 * 4
        for name in ("fluid", "solid"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
        for a in range(3):
            np.testing.assert_array_equal(out.face[a].numpy(), np.asarray(ref.face[a]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_solve_pressure_solid_matches(use_pallas):
    """The masked solve on face-masked coefficients: the same iteration
    count, p within 1e-5 of its scale, zero in solid cells, the fluid mean
    pinned; under use_pallas the port's B2 wrapper runs its plain version
    on the CPU."""
    bc = FieldBC.channel_z(kind_wall=NEUMANN)
    jm = job.build_masks(SOLID, (True, True, False))
    tm = tob.build_masks(SOLID, (True, True, False), CPU)
    rng = np.random.RandomState(5)
    gam = [(1e-4 * (1.0 + 0.1 * rng.rand(*f.shape))).astype(np.float32) for f in jm.face]
    rhs = rng.randn(*GRID.shape).astype(np.float32)
    p0 = (1e-2 * rng.randn(*GRID.shape)).astype(np.float32)
    cfg = jpr.PressureSolverConfig(solver="mgpcg", tol=1e-6, use_pallas=use_pallas)
    ref = jpr.solve_pressure(job.mask_flux(tuple(map(jnp.asarray, gam)), jm), jnp.asarray(rhs),
                             jnp.asarray(p0), GRID, bc, cfg, solid=jm)
    out = tpr.solve_pressure(tob.mask_flux(tuple(map(torch.as_tensor, gam)), tm),
                             torch.as_tensor(rhs), torch.as_tensor(p0), config_from(GRID),
                             config_from(bc), config_from(cfg), solid=tm)
    assert int(out.iters) == int(ref.iters) > 1
    _close("x", out.x, ref.x, 1e-5)
    assert float((out.x * tm.solid).abs().max()) == 0.0
    assert abs(float(out.x.sum())) <= 1e-5 * float(out.x.abs().sum())


def test_coupled_steps_build_the_obstacle_masks_once(monkeypatch):
    """A multi-step coupled PISO run with a box obstacle (the point-force
    sedimentation cloud, 12^3) builds its masks once, in initialize_state,
    and every step reuses them; the state after 3 steps equals, bit for
    bit, that of a run that rebuilds the masks at every use, as the port
    did before. A config with another solid array starts with no masks."""
    from yade_openfoam_coupling_tpu_torch import cases as tcases
    from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)

    base, state0, dt = tcases.sedimentation_cloud(n_particles=60, n=12, device=CPU)
    pos = state0.particles.pos[:60].numpy().copy()
    pos[:, 2] = np.maximum(pos[:, 2], 0.011)      # above the block

    def run(cfg):
        state = tcd.initialize_state(
            make_fluid_state(cfg.grid, CPU),
            make_particle_state(pos, CPU, radius=150e-6, capacity=64),
            make_turbulence_state(cfg.grid, CPU), cfg, dt=dt)
        return tcd.make_scan_fn(cfg, 3)(state)

    built = []
    real = tob.build_masks
    monkeypatch.setattr(tob, "build_masks", lambda *a: built.append(1) or real(*a))
    cfg = dataclasses.replace(base, solid=tob.box_solid(base.grid.shape, (3, 3, 1), (9, 9, 4)))
    cached, diags = run(cfg)
    assert len(built) == 1 and int(diags.n_found[-1]) == 60
    other = dataclasses.replace(cfg, solid=tob.box_solid(base.grid.shape, (2, 2, 1), (5, 5, 3)))
    assert other.obstacle_masks(CPU).n_solid == 3 * 3 * 2 and len(built) == 2

    monkeypatch.setattr(tcd.CaseConfig, "obstacle_masks", lambda self, device: real(
        self.solid, self.bcs.periodic_axes(), device))
    fresh, _ = run(dataclasses.replace(cfg))
    for name in ("u", "p", "u_source"):
        assert torch.equal(getattr(cached.fluid, name), getattr(fresh.fluid, name)), name
    for a in range(3):
        assert torch.equal(cached.fluid.phi[a], fresh.fluid.phi[a])
    assert torch.equal(cached.particles.pos, fresh.particles.pos)
    assert float(cached.fluid.u.abs().max()) > 0.0
