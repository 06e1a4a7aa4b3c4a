"""The port's PIMPLE case builders against the JAX package's at small
sizes: the same configs, initial states within the sparse exchange's
tolerance, and two coupled steps of the 1M configuration's shape
(particle-chunked sparse exchange, per-step Verlet build, mgpcg)."""

import jax
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu import cases as jcases
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu_torch import cases as tcases
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd

CPU = torch.device("cpu")
BUILDS = {
    "fluidized_bed": dict(n_particles=60, n=12),
    "fluidized_bed_inlet": dict(n_particles=60, n=12, inlet_velocity=0.01),
    "dense_suspension": dict(n_particles=200, n=16),
    "fluidized_bed_1m": dict(n_particles=400, n=16),
}


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _build(name):
    fn = name.replace("_inlet", "")
    ref = getattr(jcases, fn)(**BUILDS[name])
    out = getattr(tcases, fn)(**BUILDS[name], device=CPU)
    return ref, out


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_matches_jax(name):
    """Equal configs and dt; the same particles; the initial alpha and
    u_particle of the first exchange within 1e-5 of their scale."""
    (ref_cfg, ref_state, ref_dt), (cfg, state, dt) = _build(name)
    assert case_config_from(ref_cfg) == cfg and dt == ref_dt
    assert state.fluid.p.device == CPU
    ref = jax.tree.map(np.asarray, ref_state)
    out = state_to_numpy(state)
    np.testing.assert_array_equal(out.particles.pos, ref.particles.pos)
    np.testing.assert_array_equal(out.particles.active, ref.particles.active)
    _close("alpha", out.fluid.alpha, ref.fluid.alpha, 1e-5)
    _close("u_particle", out.fluid.u_particle, ref.fluid.u_particle, 1e-5)
    assert float(out.fluid.alpha.min()) < 1.0


def test_fluidized_bed_1m_shape_steps_match_jax():
    """Two coupled steps of the 1M configuration's shape at 16^3: the
    exchange in 8 particle chunks, one Verlet list per step, mgpcg with
    tol 1e-5; counters equal, state within 1e-4 of its scale, except
    u_source within 1e-3: its Archimedes part is grad p at the particles,
    and p, which agrees to ~1e-5 of its (hydrostatic) scale, differentiates
    over h = 1 mm to ~1e-4 of grad p's scale."""
    (ref_cfg, ref_state, _), (cfg, _, _) = _build("fluidized_bed_1m")
    assert cfg.coupling.particle_chunks == 8 and cfg.dem.neighbor == "cells"
    ref_s, ref_d = jcd.make_scan_fn(ref_cfg, 2)(ref_state)
    # both packages step from the JAX package's initial state
    out_s, out_d = tcd.make_scan_fn(cfg, 2)(
        state_from_numpy(jax.tree.map(np.asarray, ref_state), CPU))
    for name in ("p_iters", "n_contact_overflow", "n_coupling_overflow", "n_found"):
        np.testing.assert_array_equal(getattr(out_d, name).numpy(),
                                      np.asarray(getattr(ref_d, name)), err_msg=name)
    ref, out = jax.tree.map(np.asarray, ref_s), state_to_numpy(out_s)
    for name in ("u", "p", "alpha", "u_source_drag", "u_particle"):
        _close(name, getattr(out.fluid, name), getattr(ref.fluid, name), 1e-4)
    _close("u_source", out.fluid.u_source, ref.fluid.u_source, 1e-3)
    for name in ("pos", "vel"):
        _close(name, getattr(out.particles, name), getattr(ref.particles, name), 1e-4)


@pytest.mark.parametrize("name", ["settling_sphere", "sedimentation_cloud"])
def test_piso_builders_raise(name):
    """The PISO builders match the JAX package's: equal configs and dt,
    the same particles, and the point-force exchange's initial state (alpha
    1, no particle velocity field). Their steps: tests/test_torch_icofoam.py."""
    kw = dict(n=8) if name == "settling_sphere" else dict(n_particles=40, n=8)
    ref_cfg, ref_state, ref_dt = getattr(jcases, name)(**kw)
    cfg, state, dt = getattr(tcases, name)(**kw, device=CPU)
    assert case_config_from(ref_cfg) == cfg and dt == ref_dt
    assert cfg.solver == "piso" and not cfg.coupling.gaussian and cfg.dem.buoyancy
    ref, out = jax.tree.map(np.asarray, ref_state), state_to_numpy(state)
    np.testing.assert_array_equal(out.particles.pos, ref.particles.pos)
    np.testing.assert_array_equal(out.particles.active, ref.particles.active)
    np.testing.assert_array_equal(out.fluid.alpha, ref.fluid.alpha)
    np.testing.assert_array_equal(out.fluid.u_particle, ref.fluid.u_particle)
