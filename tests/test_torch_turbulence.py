"""The port's turbulence closures against the JAX package on the same
seeded numpy inputs: Smagorinsky, kEpsilon with the wall functions on and
off and on a slip wall, the wall layers (built once per device by
`CaseConfig.wall_layers`); and the physics checks of
tests/test_turbulence.py run on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import fields as jf
from yade_openfoam_coupling_tpu.models import turbulence as jt
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import grid as jg
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.models import fields as tf
from yade_openfoam_coupling_tpu_torch.models import turbulence as tt
from yade_openfoam_coupling_tpu_torch.ops import stencil as tst

CPU = torch.device("cpu")
P = jg.FaceBC(jg.PERIODIC)
SLIP_Z = FluidBCs(
    u=jg.FieldBC(((P, P), (P, P), (jg.FaceBC(jg.SLIP), jg.FaceBC(jg.DIRICHLET)))),
    p=jg.FieldBC(((P, P), (P, P), (jg.FaceBC(jg.NEUMANN), jg.FaceBC(jg.NEUMANN)))))
BCS = {"channel": FluidBCs.channel_z(), "slip": SLIP_Z, "box": FluidBCs.box_noslip()}


def _close(name, out, ref, rel):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _inputs(grid, seed):
    """A seeded fluid state with alpha < 1, and k, epsilon, nut seeds."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid.shape
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    alpha = (0.9 + 0.1 * rng.rand(nx, ny, nz)).astype(np.float32)
    fluid = dict(
        u=1e-2 * r(3, nx, ny, nz), u_old=1e-2 * r(3, nx, ny, nz), p=1e-4 * r(nx, ny, nz),
        phi=(1e-2 * r(nx + 1, ny, nz), 1e-2 * r(nx, ny + 1, nz), 1e-2 * r(nx, ny, nz + 1)),
        alpha=alpha, alpha_old=(alpha + 1e-4 * r(nx, ny, nz)).astype(np.float32),
        u_source=0 * r(3, nx, ny, nz), u_source_drag=0 * r(nx, ny, nz),
        u_particle=0 * r(3, nx, ny, nz))
    turb = dict(k=(1e-4 * (1 + rng.rand(nx, ny, nz))).astype(np.float32),
                epsilon=(1e-4 * (1 + rng.rand(nx, ny, nz))).astype(np.float32),
                nut=(1e-5 * rng.rand(nx, ny, nz)).astype(np.float32))
    return fluid, turb


def _both(grid, bcs, cfg, seed, dt=1e-4, nu=1e-6):
    fluid, turb = _inputs(grid, seed)
    jfs = jf.FluidState(**{k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                           else jnp.asarray(v) for k, v in fluid.items()})
    tfs = tf.FluidState(**{k: tuple(map(torch.as_tensor, v)) if isinstance(v, tuple)
                           else torch.as_tensor(v) for k, v in fluid.items()})
    ref = jt.correct(jf.TurbulenceState(**{k: jnp.asarray(v) for k, v in turb.items()}),
                     jfs, grid, bcs, nu, dt, cfg)
    out = tt.correct(tf.TurbulenceState(**{k: torch.as_tensor(v) for k, v in turb.items()}),
                     tfs, config_from(grid), config_from(bcs), nu, dt, config_from(cfg))
    return ref, out


def test_smagorinsky_matches_jax():
    """k_sgs and nut within 1e-6 of their scale."""
    grid = jg.Grid.box((8, 6, 10), (0.008, 0.006, 0.010))
    ref, out = _both(grid, BCS["channel"], jt.TurbulenceConfig(model="Smagorinsky"), 0)
    _close("k", out.k, ref.k, 1e-6)
    _close("nut", out.nut, ref.nut, 1e-6)


@pytest.mark.parametrize("bname,walls", [("channel", True), ("channel", False),
                                         ("slip", True), ("box", True)])
def test_kepsilon_matches_jax(bname, walls):
    """k, epsilon and nut within 1e-6 of their scale, with the wall
    functions on (no-slip channel, a slip wall, a closed box) and off."""
    grid = jg.Grid.box((8, 6, 10), (0.008, 0.006, 0.010))
    cfg = jt.TurbulenceConfig(model="kEpsilon", wall_functions=walls)
    ref, out = _both(grid, BCS[bname], cfg, 1)
    for name in ("k", "epsilon", "nut"):
        _close(name, getattr(out, name), getattr(ref, name), 1e-6)


@pytest.mark.parametrize("bname", ["channel", "slip", "box"])
def test_wall_layers_match_jax_and_are_cached(bname):
    """The wall mask and distance equal the JAX package's (a slip face is a
    wall; periodic axes are not); `CaseConfig.wall_layers` builds them
    once per device and returns the same tensors after, and kEpsilon with
    them passed in equals kEpsilon building its own."""
    from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
    grid = jg.Grid.box((6, 5, 7), (0.006, 0.010, 0.007))
    bcs = BCS[bname]
    rm, ry = jt._wall_layers(grid, bcs)
    cfg = tcd.CaseConfig(grid=config_from(grid), bcs=config_from(bcs))
    mask, y = cfg.wall_layers(CPU)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    again = cfg.wall_layers("cpu")
    assert again[0] is mask and again[1] is y
    fluid, turb = _inputs(grid, 2)
    tfs = tf.FluidState(**{k: tuple(map(torch.as_tensor, v)) if isinstance(v, tuple)
                           else torch.as_tensor(v) for k, v in fluid.items()})
    t0 = tf.TurbulenceState(**{k: torch.as_tensor(v) for k, v in turb.items()})
    kcfg = tt.TurbulenceConfig(model="kEpsilon")
    a = tt.correct(t0, tfs, cfg.grid, cfg.bcs, 1e-6, 1e-4, kcfg, walls=(mask, y))
    b = tt.correct(t0, tfs, cfg.grid, cfg.bcs, 1e-6, 1e-4, kcfg)
    for name in ("k", "epsilon", "nut"):
        assert torch.equal(getattr(a, name), getattr(b, name))


# --- the physics checks of tests/test_turbulence.py, on the port -----------

def shear_state(grid, rate=2.0):
    """u_x = rate * z: |S| = rate, S2 = rate^2."""
    z = grid.origin[2] + (np.arange(grid.shape[2]) + 0.5) * grid.spacing[2]
    u = torch.zeros((3,) + grid.shape)
    u[0] = torch.as_tensor(rate * z, dtype=torch.float32)[None, None, :]
    fs = tf.make_fluid_state(grid, CPU)._replace(u=u)
    return fs._replace(phi=tst.flux(u, config_from(FluidBCs.periodic().u), grid))


def test_strain_rate_shear():
    grid = config_from(jg.Grid.cube(16, 1.0))
    fs = shear_state(grid, rate=2.0)
    S2 = tt.strain_rate_sq(fs.u, config_from(FluidBCs.periodic()), grid)
    np.testing.assert_allclose(S2[:, :, 2:-2].numpy(), 4.0, rtol=1e-3)


def test_laminar_zero_nut():
    grid = config_from(jg.Grid.cube(8, 1.0))
    t = tt.correct(tf.make_turbulence_state(grid, CPU), shear_state(grid), grid,
                   config_from(FluidBCs.periodic()), 1e-6, 1e-3,
                   tt.TurbulenceConfig(model="laminar"))
    assert float(t.nut.max()) == 0.0


def test_smagorinsky_nut_value():
    grid = config_from(jg.Grid.cube(16, 1.0))
    cfg = tt.TurbulenceConfig(model="Smagorinsky")
    t = tt.correct(tf.make_turbulence_state(grid, CPU), shear_state(grid, rate=2.0), grid,
                   config_from(FluidBCs.periodic()), 1e-6, 1e-3, cfg)
    d = tt.les_delta(grid)
    expect = cfg.ck * d * np.sqrt((cfg.ck / cfg.ce) * d * d * 4.0)
    np.testing.assert_allclose(float(t.nut[8, 8, 8]), expect, rtol=1e-2)


def test_keqn_production_balance():
    """k grows under shear from a seed and nut stays positive and bounded."""
    grid = config_from(jg.Grid.cube(16, 1.0))
    cfg = tt.TurbulenceConfig(model="kEqn")
    fs = shear_state(grid, rate=5.0)
    t = tf.make_turbulence_state(grid, CPU, k0=1e-4)
    t = t._replace(nut=torch.full(grid.shape, 1e-4))
    for _ in range(20):
        t = tt.correct(t, fs, grid, config_from(FluidBCs.periodic()), 1e-6, 1e-3, cfg)
    assert float(t.k.min()) > 0.0
    assert float(t.nut.max()) <= cfg.nut_max
    assert float(t.k.mean()) > 1e-4


def test_kepsilon_equilibrium_direction():
    """Under constant shear k and eps grow from small seeds and nut = Cmu
    k^2/eps."""
    grid = config_from(jg.Grid.cube(8, 1.0))
    cfg = tt.TurbulenceConfig(model="kEpsilon")
    fs = shear_state(grid, rate=10.0)
    t = tf.make_turbulence_state(grid, CPU, k0=1e-4, eps0=1e-5)
    t = t._replace(nut=cfg.c_mu * t.k ** 2 / torch.clamp(t.epsilon, min=1e-12))
    for _ in range(50):
        t = tt.correct(t, fs, grid, config_from(FluidBCs.periodic()), 1e-6, 5e-4, cfg)
    assert float(t.k.min()) > 1e-4
    assert float(t.epsilon.min()) > 1e-5
    expect = cfg.c_mu * t.k.numpy() ** 2 / t.epsilon.numpy()
    np.testing.assert_allclose(t.nut.numpy(), np.clip(expect, 0, cfg.nut_max), rtol=1e-4)


def test_unknown_model_raises():
    grid = config_from(jg.Grid.cube(8, 1.0))
    with pytest.raises(ValueError):
        tt.correct(tf.make_turbulence_state(grid, CPU), shear_state(grid), grid,
                   config_from(FluidBCs.periodic()), 1e-6, 1e-3,
                   tt.TurbulenceConfig(model="bogus"))


def test_kepsilon_wall_functions():
    """Wall-adjacent cells get eps = Cmu^{3/4} k^{3/2}/(kappa y) and the
    nutk log-law value; interior cells keep the transported eps."""
    grid = config_from(jg.Grid.cube(12, 0.12))
    cfg = tt.TurbulenceConfig(model="kEpsilon", wall_functions=True)
    t0 = tf.make_turbulence_state(grid, CPU, k0=1e-2, eps0=1e-2)
    t0 = t0._replace(nut=torch.full(grid.shape, 1e-4))
    nu = 1e-6
    t = tt.correct(t0, shear_state(grid, rate=10.0), grid, config_from(FluidBCs.channel_z()),
                   nu, 1e-4, cfg)
    eps, nut, k = t.epsilon.numpy(), t.nut.numpy(), t.k.numpy()
    y = 0.5 * grid.spacing[2]
    expect_eps = cfg.c_mu ** 0.75 * k[:, :, 0] ** 1.5 / (cfg.kappa * y)
    np.testing.assert_allclose(eps[:, :, 0], expect_eps, rtol=1e-4)
    y_plus = cfg.c_mu ** 0.25 * np.sqrt(k[:, :, 0]) * y / nu
    assert (y_plus > 11).all()
    expect_nut = nu * (y_plus * cfg.kappa / np.log(cfg.e_wall * y_plus) - 1.0)
    np.testing.assert_allclose(nut[:, :, 0], expect_nut, rtol=1e-3)
    assert not np.allclose(eps[:, :, 5], expect_eps, rtol=1e-2)


def test_kepsilon_wall_functions_off_matches_plain():
    """Wall functions change the wall layer only."""
    grid = config_from(jg.Grid.cube(8, 0.08))
    bcs = config_from(FluidBCs.channel_z())
    fs = shear_state(grid, rate=1.0)
    t0 = tf.make_turbulence_state(grid, CPU, k0=1e-3, eps0=1e-3)
    a = tt.correct(t0, fs, grid, bcs, 1e-6, 1e-4,
                   tt.TurbulenceConfig(model="kEpsilon", wall_functions=False))
    b = tt.correct(t0, fs, grid, bcs, 1e-6, 1e-4,
                   tt.TurbulenceConfig(model="kEpsilon", wall_functions=True))
    np.testing.assert_allclose(a.nut.numpy()[:, :, 2:-2], b.nut.numpy()[:, :, 2:-2],
                               rtol=1e-6)
