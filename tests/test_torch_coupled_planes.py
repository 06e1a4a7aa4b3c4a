"""The planes slice end to end at a small size: bench.py's configuration
with the CLI's `--fast` coupling (planes exchange, fused kernel, 'col'
staging, dy in the kernel, packed unbin) on a 12^3 channel with ~300
lattice particles, run by both packages from the same numpy state, at the
tolerances test_torch_coupled.py holds the window slice to; and the x-slab
chunked exchange (`planes_chunks > 1`) against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as tcpp

from test_torch_coupled import (_both_initial, _close, _np_tree, bench_config,
                                jax_equivalent)
from test_torch_planes import (
    GRID,
    NU,
    PERIODIC,
    RHO,
    _assert_exchange_close,
    _cfg,
    _exchange_both,
    _fields,
    _particles,
    _pf,
)

FAST = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                         exchange="planes", slot_capacity=4, packed_bin="col",
                         dy_in_kernel=True, packed_unbin=True)


def planes_config(**coupling_kw):
    return dataclasses.replace(bench_config(),
                               coupling=dataclasses.replace(FAST, **coupling_kw))


@pytest.fixture(scope="module")
def slice_runs():
    cfg = planes_config()
    s0, t0 = _both_initial(cfg)
    init = (_np_tree(s0), state_to_numpy(t0))
    ref_state, ref_diags = jcd.make_scan_fn(jax_equivalent(cfg), 4)(s0)
    out_state, out_diags = tcd.make_scan_fn(case_config_from(cfg), 4)(t0)
    return (_np_tree(ref_state), _np_tree(ref_diags), state_to_numpy(out_state),
            {k: v.numpy() for k, v in out_diags._asdict().items()}, init)


def test_planes_initial_state_matches(slice_runs):
    """initialize_state through the planes exchange: the initial alpha and
    u_particle within the exchange's tolerances."""
    ref, out = slice_runs[4]
    _close("alpha", out.fluid.alpha, ref.fluid.alpha, 2e-5)
    _close("u_particle", out.fluid.u_particle, ref.fluid.u_particle, 3e-4)


def test_planes_slice_counters_match(slice_runs):
    """Pressure iterations, found particles and every overflow counter equal
    the JAX package's, step by step; the bench's health conditions hold."""
    _, ref_d, _, out_d, _ = slice_runs
    for name in ("p_iters", "n_contact_overflow", "n_coupling_overflow", "n_found",
                 "n_dem_sub"):
        np.testing.assert_array_equal(out_d[name], np.asarray(getattr(ref_d, name)),
                                      err_msg=name)
    assert np.all(out_d["n_coupling_overflow"] == 0)
    assert np.all(out_d["n_found"] > 0)
    assert out_d["cont_err_local"].max() < 1e-5


def test_planes_slice_state_matches(slice_runs):
    """The final fluid and particle state within 1e-4 of each field's scale,
    the float diagnostics within 1e-3, as for the window slice."""
    ref_s, ref_d, out_s, out_d, _ = slice_runs
    for name in ("u", "p", "alpha", "alpha_old", "u_source", "u_source_drag",
                 "u_particle"):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), 1e-4)
    for name in ("pos", "vel", "angvel", "contact_f"):
        _close(name, getattr(out_s.particles, name), getattr(ref_s.particles, name), 1e-4)
    for name in ("co_max", "p_initial_residual", "max_particle_speed"):
        _close(name, out_d[name], np.asarray(getattr(ref_d, name)), 1e-3)


def test_planes_exchange_selection():
    """`planes_chunks > 1` selects the chunked exchange, as in the JAX
    package, and gives the whole-grid exchange's initial alpha; lag_alpha
    False raises ValueError as the window path does."""
    cfg = planes_config()
    s0, t0 = _both_initial(dataclasses.replace(
        cfg, coupling=dataclasses.replace(cfg.coupling, planes_chunks=3)))
    ref = s0.fluid.alpha
    _close("alpha (3 slabs)", t0.fluid.alpha.numpy(), np.asarray(ref), 2e-5)
    tcfg = case_config_from(planes_config(lag_alpha=False))
    with pytest.raises(ValueError, match="lag_alpha"):
        tcd.initialize_state(t0.fluid, t0.particles, t0.turb, tcfg, dt=5e-5)


CHUNKED_CASES = {
    # name: (planes_chunks, periodic, n particles, x range)
    "2_channel": (2, "channel", 60, (0.08, 0.92)),
    "2_walls": (2, "walls", 60, (0.08, 0.92)),
    "3_channel": (3, "channel", 60, (0.0, 1.0)),
    "3_walls": (3, "walls", 60, (0.0, 1.0)),
    # 1100 particles in the first slab, window N_w = 1024 rows
    "3_window_overflow": (3, "channel", 1100, (0.01, 0.32)),
}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_gaussian_coupling_planes_chunked_matches_jax(case):
    """The x-slab chunked exchange against the JAX package: cross-slab halo
    deposits (particles in the edge planes under periodic x), the windowed
    unbin and the window-overflow count."""
    n_chunks, pname, n, x_range = CHUNKED_CASES[case]
    cfg = _cfg(planes_chunks=n_chunks, packed_bin="col")
    ref, out = _exchange_both(GRID, PERIODIC[pname], cfg,
                              _particles(GRID, n, seed=7, x_range=x_range), seed=3,
                              chunked=True)
    if case == "3_window_overflow":
        assert int(ref.n_overflow) >= 1100 - 1024
    else:
        assert int(out.n_overflow) == 0
    _assert_exchange_close(out, ref)


def test_chunked_equals_whole_grid_port():
    """Inside the port, the 3-slab exchange gives the whole-grid exchange's
    fields and forces (the same arithmetic per slot; only the halo planes
    are summed in another order)."""
    cfg = config_from(_cfg())
    arrs = _particles(GRID, 60, seed=9, x_range=(0.0, 1.0))
    u, gp, dtau, ddtu, curl = (torch.as_tensor(a) for a in _fields(GRID, 4))
    alpha = torch.full(GRID.shape, 0.97)
    args = (config_from(GRID), PERIODIC["channel"], NU, RHO, 1e-4)
    whole = tcpp.gaussian_coupling_planes(_pf(arrs, False), u, gp, dtau, ddtu, curl, *args,
                                          cfg, prev_alpha=alpha)
    chunked = tcpp.gaussian_coupling_planes_chunked(
        _pf(arrs, False), u, gp, dtau, ddtu, curl, *args,
        dataclasses.replace(cfg, planes_chunks=3), prev_alpha=alpha)
    assert torch.equal(whole.found, chunked.found)
    for name in ("alpha", "u_particle", "u_source", "u_source_drag", "force"):
        a, b = getattr(chunked, name), getattr(whole, name)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()) + 1e-30, name
