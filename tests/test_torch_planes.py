"""PyTorch port of the planes exchange against the JAX package: the planes
binning bit for bit, the plain versions of the fused, interpolation and
deposit kernels against the Pallas kernels in interpret mode, and the
whole-grid and x-slab chunked exchanges at the JAX suite's own
tolerances. The CUDA kernels themselves are held against the plain
versions in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import coupling_planes as cpp
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as tcpp

GRID = Grid.cube(12, 0.012)
PERIODIC = {"channel": (True, True, False), "walls": (False, False, False)}
NU, RHO = 1e-6, 1000.0


def _particles(grid, n, seed, pad=3, x_range=(0.08, 0.92)):
    """numpy particle arrays inside the box (x within `x_range` of the
    length), with `pad` inactive capacity rows."""
    rng = np.random.RandomState(seed)
    lo = [grid.origin[a] + 0.08 * grid.lengths[a] for a in range(3)]
    hi = [grid.origin[a] + 0.92 * grid.lengths[a] for a in range(3)]
    lo[0] = grid.origin[0] + x_range[0] * grid.lengths[0]
    hi[0] = grid.origin[0] + x_range[1] * grid.lengths[0]
    pos = rng.uniform(lo, hi, (n + pad, 3))
    pos[n:] = 0.0
    vel = rng.randn(n + pad, 3) * 1e-3
    ang = rng.randn(n + pad, 3) * 1e-2
    radius = np.full(n + pad, 4e-4)
    active = np.arange(n + pad) < n
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(pos), f32(vel), f32(ang), f32(radius), active


def _pf(arrs, jax_side):
    if jax_side:
        return cp.ParticleFields(*(jnp.asarray(a) for a in arrs))
    return tcp.ParticleFields(*(torch.as_tensor(a) for a in arrs))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfg(**kw):
    base = dict(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                exchange="planes", slot_capacity=4)
    base.update(kw)
    return cp.CouplingConfig(**base)


def _assert_channels_close(name, out, ref, rtol=1e-5):
    """Each channel (leading axis) within rtol of its own scale."""
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(-1)
    err = np.abs(out - ref).reshape(ref.shape[0], -1).max(-1)
    assert np.all(err <= rtol * scale + 1e-30), (name, (err / (scale + 1e-30)).max())


BIN_CASES = {
    # name: (cap, packed_bin, bin kwargs)
    "rows": (4, False, {}),
    "packed": (4, True, {}),
    "col": (4, "col", {}),
    "truncating": (1, "col", {}),
    "slab": (4, False, dict(x_start=3, n_loc=4)),
    "slab_wrapped": (2, "col", dict(x_start=-1, n_loc=6, wrap_x=True)),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_particles_planes_exact(case):
    """D, sort order, ranks, kept rows and the overflow count equal the JAX
    package's bit for bit under every staging layout, for an x-slab (with
    the wrapped window of the chunked sharded exchange) and for a cap that
    truncates, where the stable sort decides which particle keeps a slot."""
    cap, packed, kw = BIN_CASES[case]
    arrs = _particles(GRID, 200, seed=3, x_range=(0.0, 1.0))
    ref = cpp.bin_particles_planes(_pf(arrs, True), GRID, cap, with_angvel=True,
                                   packed_bin=packed, **kw)
    out = tcpp.bin_particles_planes(_pf(arrs, False), config_from(GRID), cap,
                                    with_angvel=True, packed_bin=packed, **kw)
    for name in ("order", "inv_order", "cell_sorted", "rank", "keep", "n_overflow"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    assert out.D.shape == ref.D.shape
    np.testing.assert_array_equal(_np(out.D).view(np.uint32),
                                  np.asarray(ref.D).view(np.uint32))
    if case == "truncating":
        assert int(out.n_overflow) > 0
    if case == "slab_wrapped":
        # particles of global plane 11 sit in window plane 0, shifted by -L
        assert float(_np(out.D)[0].min()) < GRID.origin[0]


def _kernel_inputs(periodic, cfg, seed, slab):
    """Seeded padded fluid stack and slot table; `slab` = (x0, nxc) cuts
    both to an x-slab as the chunked exchange does."""
    rng = np.random.RandomState(seed)
    C_in = 10 + 3 * cfg.use_torque + 3 * cfg.use_added_mass
    F = rng.randn(C_in, *GRID.shape).astype(np.float32) * 1e-2
    F[-1] = 0.9 + 0.1 * rng.rand(*GRID.shape)          # alpha channel
    Fp = np.array(cpp.pad_wrap_zero(jnp.asarray(F), periodic))
    arrs = _particles(GRID, 60, seed=seed + 1)
    kw = {}
    x0 = 0
    if slab is not None:
        x0, nxc = slab
        Fp = np.ascontiguousarray(Fp[:, x0:x0 + nxc + 2])
        kw = dict(x_start=x0, n_loc=nxc)
    bins = cpp.bin_particles_planes(_pf(arrs, True), GRID, cfg.slot_capacity,
                                    with_angvel=cfg.use_torque, **kw)
    return Fp, np.array(bins.D), x0


SLABS = {"whole": None, "slab": (4, 4)}


@pytest.mark.parametrize("pname,slab", [("channel", "whole"), ("walls", "slab")])
def test_interp_reference_matches_pallas(pname, slab):
    """The plain version of the interpolation kernel against the JAX
    launcher in interpret mode, on the whole grid and on a slab at
    x_off = 4: G and the norm within 1e-5 of each channel's scale (f32
    sums in another order, exp differing by an ulp). The deposit test
    takes the other two (periodicity, slab) pairs, so the two cover all
    four; each JAX call costs ~3-5 s in interpret mode."""
    periodic = PERIODIC[pname]
    cfg = _cfg()
    Fp, D, x0 = _kernel_inputs(periodic, cfg, seed=11, slab=SLABS[slab])
    G_r, n_r = cpp.interp_planes_padded(jnp.asarray(Fp), jnp.asarray(D), GRID, periodic,
                                        cfg, x0, interpret=True)
    G_o, n_o = tcpp.interp_planes_padded(torch.as_tensor(Fp), torch.as_tensor(D),
                                         config_from(GRID), periodic, config_from(cfg), x0)
    _assert_channels_close("G", G_o, G_r)
    _assert_channels_close("norm", n_o[None], np.asarray(n_r)[None])
    assert float(np.abs(np.asarray(n_r)).max()) > 0.0


@pytest.mark.parametrize("pname,slab", [("channel", "slab"), ("walls", "whole")])
def test_deposit_reference_matches_pallas(pname, slab):
    """The plain version of the deposit kernel against the JAX launcher in
    interpret mode, for seeded pre-normalised slot values. The JAX
    launcher returns one stack per (dx, dy) here (dy_in_kernel=False), the
    port one per dx: the landed fields are compared, within 1e-5 of each
    channel's scale."""
    periodic = PERIODIC[pname]
    cfg = _cfg(dy_in_kernel=False)
    Fp, D, x0 = _kernel_inputs(periodic, cfg, seed=13, slab=SLABS[slab])
    nxl = Fp.shape[1] - 2
    V = np.random.RandomState(5).randn(8, cfg.slot_capacity, D.shape[2]).astype(np.float32)
    stk_r, combos_r = cpp.deposit_stacks(jnp.asarray(V), jnp.asarray(D), nxl, GRID,
                                         periodic, cfg, x0, interpret=True)
    stk_o, combos_o = tcpp.deposit_stacks(torch.as_tensor(V), torch.as_tensor(D), nxl,
                                          config_from(GRID), periodic, config_from(cfg), x0)
    assert len(combos_r) == 9 and combos_o == [(-1, 0), (0, 0), (1, 0)]
    _assert_channels_close("fields", tcpp._stack_epilogue(stk_o, combos_o),
                           cpp._stack_epilogue(stk_r, combos_r))


@pytest.mark.parametrize("extras,slab", [(False, "whole"), (True, "slab")])
def test_fused_reference_matches_pallas(extras, slab):
    """The plain version of the fused kernel against the JAX launcher in
    interpret mode, with torque and added mass off and on (C_in 10 / 16,
    C_d 7 / 10, 4 / 7 result channels): landed fields and per-slot
    results within 1e-5 of each channel's scale."""
    periodic = PERIODIC["channel"]
    cfg = _cfg(dy_in_kernel=True, use_torque=extras, use_added_mass=extras)
    Fp, D, x0 = _kernel_inputs(periodic, cfg, seed=17, slab=SLABS[slab])
    ref = cpp.fused_exchange_padded(jnp.asarray(Fp), jnp.asarray(D), GRID, periodic, cfg,
                                    x0, NU, RHO, interpret=True)
    out = tcpp.fused_exchange_padded(torch.as_tensor(Fp), torch.as_tensor(D),
                                     config_from(GRID), periodic, config_from(cfg), x0,
                                     NU, RHO)
    assert out[1] == ref[1]
    _assert_channels_close("fields", tcpp._stack_epilogue(out[0], out[1]),
                           cpp._stack_epilogue(ref[0], ref[1]))
    _assert_channels_close("pres", out[2], ref[2])
    assert out[2].shape[0] == (7 if extras else 4)


def _fields(grid, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, *grid.shape) * 1e-2).astype(np.float32) for _ in range(5)]


def _exchange_both(grid, periodic, cfg, arrs, seed, chunked=False):
    u, gp, dtau, ddtu, curl = _fields(grid, seed)
    alpha = np.full(grid.shape, 0.97, np.float32)
    args = (grid, periodic, NU, RHO, 1e-4)
    fns = ((cpp.gaussian_coupling_planes_chunked, tcpp.gaussian_coupling_planes_chunked)
           if chunked else (cpp.gaussian_coupling_planes, tcpp.gaussian_coupling_planes))
    ref = fns[0](_pf(arrs, True), *(jnp.asarray(a) for a in (u, gp, dtau, ddtu, curl)),
                 *args, cfg, prev_alpha=jnp.asarray(alpha), interpret=True)
    out = fns[1](_pf(arrs, False), *(torch.as_tensor(a) for a in (u, gp, dtau, ddtu, curl)),
                 config_from(grid), *args[1:], config_from(cfg),
                 prev_alpha=torch.as_tensor(alpha))
    return ref, out


def _assert_exchange_close(out, ref, torque=False):
    """The JAX suite's planes tolerances (test_coupling_planes.py)."""
    np.testing.assert_array_equal(_np(out.found), np.asarray(ref.found))
    assert int(out.n_overflow) == int(ref.n_overflow)
    np.testing.assert_allclose(_np(out.alpha), np.asarray(ref.alpha), rtol=2e-5, atol=1e-6)
    for name, atol in (("u_particle", 1e-9), ("u_source_drag", 1e-8),
                       ("u_source", 1e-8), ("force", 1e-12)):
        np.testing.assert_allclose(_np(getattr(out, name)), np.asarray(getattr(ref, name)),
                                   rtol=2e-4, atol=atol, err_msg=name)
    if torque:
        np.testing.assert_allclose(_np(out.torque), np.asarray(ref.torque),
                                   rtol=2e-4, atol=1e-12)
        assert float(np.abs(_np(out.torque)).max()) > 0.0


EXCHANGE_CASES = {
    # name: (periodic, config overrides)
    "fused_channel": ("channel", dict(packed_bin="col", dy_in_kernel=True,
                                      packed_unbin=True)),
    "fused_walls": ("walls", {}),
    "two_kernel_channel": ("channel", dict(fused_planes=False, dy_in_kernel=True)),
    "two_kernel_walls": ("walls", dict(fused_planes=False)),
    "fused_torque": ("channel", dict(use_torque=True, use_added_mass=True, slot_capacity=6)),
}


@pytest.mark.parametrize("case", list(EXCHANGE_CASES))
def test_gaussian_coupling_planes_matches_jax(case):
    """The whole-grid planes exchange, fused and two-kernel, under both BC
    settings and with torque (and added mass)."""
    pname, kw = EXCHANGE_CASES[case]
    cfg = _cfg(**kw)
    ref, out = _exchange_both(GRID, PERIODIC[pname], cfg, _particles(GRID, 40, seed=1),
                              seed=0)
    assert int(out.n_overflow) == 0
    _assert_exchange_close(out, ref, torque=cfg.use_torque)


def test_gaussian_coupling_planes_overflow_matches_jax():
    """5 particles in one cell with cap = 1: 4 are counted as overflow and
    read found = False, as in the JAX package."""
    grid = Grid.cube(8, 0.008)
    cfg = _cfg(slot_capacity=1)
    pos = np.tile(np.array([[0.0042, 0.0042, 0.0042]], np.float32), (5, 1))
    arrs = (pos, np.zeros((5, 3), np.float32), np.zeros((5, 3), np.float32),
            np.full(5, 4e-4, np.float32), np.ones(5, bool))
    ref, out = _exchange_both(grid, PERIODIC["walls"], cfg, arrs, seed=2)
    assert int(out.n_overflow) == 4
    assert int(_np(out.found).sum()) == 1
    _assert_exchange_close(out, ref)
