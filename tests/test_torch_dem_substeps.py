"""The DEM's substep loop in the PyTorch port against the JAX package: the
masked zero-dt tail of dynamic substeps (bit for bit in the port), the
carried-force and held-force (``contact_mode="step"``) loops, in-call list
rebuilds (``list_rebuild_every``), the Rayleigh critical dt, and in the
coupled step the dynamic substep count and the critical-dt clamp of the
adaptive dt: tests/test_dynamic_substeps.py and test_adaptive_dt.py's
clamp test run in both packages. The coupled cases use the sparse
exchange, which the JAX package runs without Pallas on the CPU (the DEM
under test does not depend on the exchange)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_coupled import _close
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.models.pimple import PIMPLEConfig
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu.utils.diagnostics import TimeControls
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_from_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem

GRID = Grid.cube(16, 1.0)


def _params(**kw):
    d = dict(kn=1e3, kt_over_kn=0.5, restitution=0.9, friction=0.3, rho_p=2500.0)
    d.update(kw)
    return dem.ContactParams(**d)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rand_state(n=24, seed=0, box=1.0):
    rng = np.random.RandomState(seed)
    return tuple(a.astype(np.float32) for a in (rng.uniform(0.2 * box, 0.8 * box, (n, 3)),
                                                rng.normal(0, 0.05, (n, 3)),
                                                rng.normal(0, 0.05, (n, 3))))


def _both_substeps(cfg, arrs, dt, n_sub, r, hydro=None, **kw):
    """dem_substeps of both packages on the same numpy inputs (pos, vel,
    angvel, radius, active); kw arrays (nbr, carried, dt_seq) as numpy.
    -> (JAX outputs, port outputs) as numpy."""
    n = arrs[0].shape[0]
    hf = np.zeros((n, 3), np.float32) if hydro is None else hydro
    z = np.zeros((n, 3), np.float32)
    jkw = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in kw.items()}
    tkw = {k: (tuple(map(_t, v)) if isinstance(v, tuple) else _t(v)) for k, v in kw.items()}
    ref = dem.dem_substeps(*map(jnp.asarray, arrs), dem.DEMForces(jnp.asarray(hf), jnp.asarray(z)),
                           GRID, cfg, jnp.float32(dt), n_sub, r, **jkw)
    out = tdem.dem_substeps(*map(_t, arrs), tdem.DEMForces(_t(hf), _t(z)), config_from(GRID),
                            config_from(cfg), torch.tensor(dt, dtype=torch.float32), n_sub, r,
                            **tkw)
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_masked_tail_is_noop():
    """dt_seq = [h, h, h, 0, 0] over 5 substeps equals 3 substeps of h bit
    for bit in the port (all pairs), and each run meets JAX's to 1e-5."""
    r = 0.03
    pos, vel, ang = _rand_state()
    arrs = (pos, vel, ang, np.full(len(pos), r, np.float32), np.ones(len(pos), bool))
    cfg = dem.DEMConfig(params=dem.ContactParams(kn=1e3, rho_p=2500.0), neighbor="allpairs")
    ref3, out3 = _both_substeps(cfg, arrs, 1e-4, 3, r)
    seq = np.array([1e-4, 1e-4, 1e-4, 0.0, 0.0], np.float32)
    ref5, out5 = _both_substeps(cfg, arrs, 1e-4, 5, r, dt_seq=seq)
    for a, b in zip(out3[:3], out5[:3]):
        np.testing.assert_array_equal(a, b)
    for out, ref in ((out3, ref3), (out5, ref5)):
        for o, rf in zip(out[:3], ref[:3]):
            assert _rel(o, rf) <= 1e-5


@pytest.mark.parametrize("shear", [False, True])
def test_masked_tail_is_noop_frozen_list(shear):
    """The same through the carried-force loop and through the shear loop
    on a frozen list: the zero-dt tail keeps the last live evaluation's
    carried force, and the springs, bit for bit in the port; each run meets
    JAX's to 1e-5 of scale (the keys exactly)."""
    r = 0.03
    pos, vel, ang = _rand_state(seed=3)
    n = len(pos)
    arrs = (pos, vel, ang, np.full(n, r, np.float32), np.ones(n, bool))
    cfg = dem.DEMConfig(params=_params(), neighbor="cells", cell_capacity=32, max_neighbors=16,
                        carry_contact=not shear, shear_history=shear, cundall_damping=0.1)
    nbr = np.asarray(dem.build_neighbor_list(jnp.asarray(pos), jnp.ones(n, bool), GRID, cfg, r))
    kw = {"nbr": nbr}
    if shear:
        sh = dem.make_shear_state(n, 16)
        rng = np.random.RandomState(5)
        kw.update(shear=tuple(np.asarray(x) for x in sh._replace(
            xi=jnp.asarray(1e-4 * rng.randn(n, 16, 3).astype(np.float32)),
            ids=dem.shear_keys(jnp.asarray(nbr), n))), pid=np.arange(n, dtype=np.int32))
    wrap = (lambda k: {**k, "shear": dem.ShearState(*map(jnp.asarray, k["shear"]))}) if shear \
        else (lambda k: k)
    twrap = (lambda k: {**k, "shear": tdem.ShearState(*map(_t, k["shear"]))}) if shear \
        else (lambda k: k)

    def both(n_sub, **extra):
        kk = {**kw, **extra}
        ref = dem.dem_substeps(*map(jnp.asarray, arrs),
                               dem.DEMForces(jnp.zeros((n, 3)), jnp.zeros((n, 3))), GRID, cfg,
                               jnp.float32(1e-4), n_sub, r,
                               **wrap({k: (v if k == "shear" else jnp.asarray(v))
                                       for k, v in kk.items()}))
        out = tdem.dem_substeps(*map(_t, arrs), tdem.DEMForces(torch.zeros(n, 3),
                                                               torch.zeros(n, 3)),
                                config_from(GRID), config_from(cfg), torch.tensor(1e-4), n_sub, r,
                                **twrap({k: (v if k == "shear" else _t(v))
                                         for k, v in kk.items()}))
        flat = lambda xs: [np.asarray(y) for x in xs for y in (x if isinstance(x, tuple)  # noqa: E731
                                                                 else (x,))]
        return flat(ref), flat(out)

    ref3, out3 = both(3)
    ref4, out4 = both(4, dt_seq=np.array([1e-4] * 3 + [0.0], np.float32))
    assert len(out3) == len(ref3) == (7 if shear else 6)
    for k, (a, b) in enumerate(zip(out3, out4)):
        if k != 3:
            np.testing.assert_array_equal(a, b)
    for out, ref in ((out3, ref3), (out4, ref4)):
        for k, (o, rf) in enumerate(zip(out, ref)):
            if k == 5 and shear:
                np.testing.assert_array_equal(o, rf)          # the partner keys
            else:
                assert _rel(o, rf) <= 1e-5, k
    assert np.abs(out4[4]).max() > 0


@pytest.mark.parametrize("variant", ["step", "rebuild_every", "rebuild_every_carried"])
def test_contact_mode_step_and_list_rebuild_every(variant):
    """``contact_mode="step"`` (each chunk's first contact force held over
    the chunk) and ``list_rebuild_every`` (a list built every 2 of 4
    substeps, with and without the carried force) against JAX: the state
    and carried force within 1e-5 of scale, the overflow count exactly."""
    r = 0.03
    pos, vel, ang = _rand_state(n=40, seed=7)
    n = len(pos)
    arrs = (pos, vel, ang, np.full(n, r, np.float32), np.arange(n) < n - 2)
    kw = dict(params=_params(), neighbor="cells", cell_capacity=2, max_neighbors=3,
              gravity=(0.0, 0.0, -9.81))
    if variant == "step":
        kw.update(contact_mode="step", list_rebuild_every=2)
    else:
        kw.update(list_rebuild_every=2, carry_contact=variant.endswith("carried"))
    cfg = dem.DEMConfig(**kw)
    hf = (1e-4 * np.random.RandomState(1).randn(n, 3)).astype(np.float32)
    ref, out = _both_substeps(cfg, arrs, 2e-4, 4, r, hydro=hf)
    assert len(out) == len(ref)
    assert int(out[3]) == int(ref[3]) > 0                 # capacity 2 and 3 truncate
    for k in (0, 1, 2, 4, 5)[:len(out) - 1]:
        assert _rel(out[k], ref[k]) <= 1e-5, k


def test_critical_dt_dynamic():
    """The smallest active radius's Rayleigh dt equals JAX's, also with no
    particle active, and `critical_dt` of that radius."""
    p = dem.ContactParams(kn=100.0, rho_p=2500.0)
    rad = np.asarray([4e-4, 3e-4, 2e-4, 5e-4], np.float32)
    for act in (np.asarray([True, True, False, True]), np.zeros(4, bool)):
        ref = dem.critical_dt_dynamic(jnp.asarray(rad), jnp.asarray(act), p)
        out = tdem.critical_dt_dynamic(_t(rad), _t(act), config_from(p))
        assert out.shape == () and out.dtype == torch.float32
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(tdem.critical_dt_dynamic(_t(rad), _t(rad > 2.5e-4),
                                                              config_from(p))),
                               tdem.critical_dt(3e-4, config_from(p)), rtol=1e-6)


def _case(grid, r, params, n_sub, dynamic=False, enforce=False, adaptive=False, **dem_kw):
    """test_dynamic_substeps.py's coupled case, with the sparse exchange."""
    d = dict(params=params, neighbor="allpairs", periodic=(True, True, False),
             wall_axes=(False, False, True), dynamic_substeps=dynamic,
             enforce_critical_dt=enforce)
    d.update(dem_kw)
    return jcd.CaseConfig(
        grid=grid, bcs=FluidBCs.channel_z(), transport=jcd.TransportProperties(),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, exchange="sparse"),
        dem=dem.DEMConfig(**d),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1),
        time=TimeControls(adjust_time_step=adaptive, max_co=0.5, max_dt=1.0),
        n_dem_substeps=n_sub, r_max=r)


def _steps(cfg, pos0, dt, n_steps, port_only=False):
    """n_steps single coupled steps of each package from one numpy state.
    -> (JAX (states, dts, subs) or None, port (states, dts, subs))."""
    grid = cfg.grid
    parts = (make_fluid_state(grid), make_particle_state(pos=pos0, radius=cfg.r_max),
             make_turbulence_state(grid, k0=1e-6))
    raw = SimState(*parts, t=np.float32(0), dt=np.float32(dt), step=np.int32(0))
    import jax
    t = state_from_numpy(jax.tree.map(np.asarray, raw), torch.device("cpu"))
    tcfg = case_config_from(cfg)
    out = []
    state = tcd.initialize_state(t.fluid, t.particles, t.turb, tcfg, dt=dt)
    for _ in range(n_steps):
        state, diag = tcd.coupled_step(state, tcfg)
        out.append((state, float(state.dt), int(diag.n_dem_sub)))
    if port_only:
        return None, out
    ref = []
    state = jcd.initialize_state(*parts, cfg, dt=dt)
    step = jcd.make_step_fn(cfg)
    for _ in range(n_steps):
        state, diag = step(state)
        ref.append((state, float(state.dt), int(diag.n_dem_sub)))
    return ref, out


def _pos0(grid, n=16, seed=1):
    L = grid.lengths[0]
    return np.random.RandomState(seed).uniform(0.3 * L, 0.7 * L, (n, 3))


def test_dynamic_matches_static_substep_run():
    """Fixed fluid dt 5e-5: the dynamic run (max 8) resolves n_eff =
    ceil(dt / dt_crit) = 4 every step and its trajectory equals the port's
    static run with 4 substeps (the JAX test's tolerances); the dynamic run
    meets JAX's: substep counts exactly, positions to 1e-5 of scale."""
    grid = Grid.cube(16, 16e-3)
    r = 4e-4
    params = dem.ContactParams(kn=100.0, rho_p=2500.0)
    k = int(np.ceil(5e-5 / dem.critical_dt(r, params)))
    assert 1 < k < 8
    ref, dyn = _steps(_case(grid, r, params, 8, dynamic=True), _pos0(grid), 5e-5, 4)
    _, stat = _steps(_case(grid, r, params, k), _pos0(grid), 5e-5, 4, port_only=True)
    assert [s for _, _, s in dyn] == [s for _, _, s in ref] == [k] * 4
    assert [s for _, _, s in stat] == [k] * 4
    sd, ss, sr = dyn[-1][0], stat[-1][0], ref[-1][0]
    np.testing.assert_allclose(sd.particles.pos.numpy(), ss.particles.pos.numpy(), rtol=0,
                               atol=1e-7 * 16e-3)
    np.testing.assert_allclose(sd.particles.vel.numpy(), ss.particles.vel.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(sd.fluid.p.numpy(), ss.fluid.p.numpy(), rtol=1e-5, atol=1e-10)
    _close("pos", sd.particles.pos.numpy(), np.asarray(sr.particles.pos), 1e-5)
    _close("vel", sd.particles.vel.numpy(), np.asarray(sr.particles.vel), 1e-4)


def test_dynamic_keeps_courant_dt_where_enforce_throttles():
    """Adaptive dt with stiff contacts: with dynamic_substeps the fluid dt
    follows the free (2-substep, unclamped) run's Courant trajectory and the
    substep count adapts; enforce_critical_dt throttles dt instead. The
    dynamic run's dts and substep counts meet JAX's."""
    grid = Grid.cube(16, 16e-3)
    r = 4e-4
    params = dem.ContactParams(kn=100.0, rho_p=2500.0)
    dt_c = dem.critical_dt(r, params)
    runs = {}
    for name, kw in (("free", dict(n_sub=2)), ("dyn", dict(n_sub=8, dynamic=True)),
                     ("enf", dict(n_sub=2, enforce=True))):
        ref, out = _steps(_case(grid, r, params, adaptive=True, **kw), _pos0(grid), 1e-5, 8,
                          port_only=name != "dyn")
        runs[name] = ([d for _, d, _ in out], [s for _, _, s in out])
        if ref is not None:
            np.testing.assert_allclose(runs[name][0], [d for _, d, _ in ref], rtol=1e-6)
            assert runs[name][1] == [s for _, _, s in ref]
    dts_free, dts_dyn, subs_dyn, dts_enf = (runs["free"][0], *runs["dyn"], runs["enf"][0])
    assert max(dts_free) / 2 > dt_c and max(dts_free) / 8 < dt_c
    np.testing.assert_allclose(dts_dyn, dts_free, rtol=1e-6)
    assert subs_dyn[-1] == int(np.ceil(dts_dyn[-1] / dt_c))
    assert max(subs_dyn) > 2
    assert dts_enf[-1] < dts_dyn[-1]
    assert all(d / 2 <= dt_c * 1.0001 for d in dts_enf)


def test_adaptive_dt_clamped_to_dem_critical():
    """test_adaptive_dt.py's clamp test: with stiff contacts (kn 5e4) and
    adaptive dt, enforce_critical_dt keeps dt / n_sub under the Rayleigh dt,
    where the Courant logic alone would grow past it; the clamped dts meet
    JAX's."""
    grid = Grid.cube(16, 16e-3)
    r = 4e-4
    params = dem.ContactParams(kn=5e4, rho_p=2500.0)
    dt_c = dem.critical_dt(r, params)
    _, off = _steps(_case(grid, r, params, 2, adaptive=True), _pos0(grid), 1e-5, 8,
                    port_only=True)
    ref, on = _steps(_case(grid, r, params, 2, enforce=True, adaptive=True), _pos0(grid), 1e-5,
                     8)
    assert max(d for _, d, _ in off) / 2 > dt_c
    assert all(d / 2 <= dt_c * 1.0001 for _, d, _ in on)
    np.testing.assert_allclose([d for _, d, _ in on], [d for _, d, _ in ref], rtol=1e-6)
