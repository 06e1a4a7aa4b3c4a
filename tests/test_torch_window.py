"""PyTorch port of the window exchange against the JAX package: the
window binning exactly, the plain version of the window kernel against the
Pallas kernel in interpret mode, the full exchange at the JAX suite's own
window tolerances. The CUDA kernel itself is held against the plain
version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import coupling_planes as cpp
from yade_openfoam_coupling_tpu.ops import coupling_window as cw
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as tcpp
from yade_openfoam_coupling_tpu_torch.ops import coupling_window as tcw

GRIDS = {
    "cube12": Grid.cube(12, 0.012),
    "box8x6x10": Grid.box((8, 6, 10), (0.008, 0.006, 0.010)),
}
PERIODIC = {"channel": (True, True, False), "walls": (False, False, False)}


def _particles(grid, n, seed, pad=3, one_plane=None):
    """numpy particle arrays inside the box (all on x-plane `one_plane` if
    given), with `pad` inactive capacity rows."""
    rng = np.random.RandomState(seed)
    lo = [grid.origin[a] + 0.08 * grid.lengths[a] for a in range(3)]
    hi = [grid.origin[a] + 0.92 * grid.lengths[a] for a in range(3)]
    pos = rng.uniform(lo, hi, (n + pad, 3))
    if one_plane is not None:
        pos[:, 0] = grid.origin[0] + (one_plane + 0.5) * grid.spacing[0]
    pos[n:] = 0.0
    vel = rng.randn(n + pad, 3) * 1e-3
    ang = rng.randn(n + pad, 3) * 1e-2
    radius = np.full(n + pad, 4e-4)
    active = np.arange(n + pad) < n
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(pos), f32(vel), f32(ang), f32(radius), active


def _pf(arrs, jax_side):
    pos, vel, ang, rad, act = arrs
    if jax_side:
        return cp.ParticleFields(*(jnp.asarray(a) for a in arrs))
    return tcp.ParticleFields(*(torch.as_tensor(a) for a in arrs))


def _fields(grid, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, *grid.shape) * 1e-2).astype(np.float32) for _ in range(5)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("gname", list(GRIDS))
@pytest.mark.parametrize("cap,W", [(4, 512), (1, 16)])
def test_window_bins_exact(gname, cap, W):
    """Sort order, ranks, kept rows, plane counts, overflow and the staged
    window tensor (bit for bit, bf16 head split included) equal the JAX
    package's. cap=1 / W=16 force slot and window overflow, so the stable
    sort decides which particle keeps a slot."""
    grid = GRIDS[gname]
    arrs = _particles(grid, 200, seed=3)
    ref = cw.window_bins(_pf(arrs, True), grid, cap, W)
    out = tcw.window_bins(_pf(arrs, False), config_from(grid), cap, W)
    for name in ("order", "inv_order", "cell_sorted", "rank", "keep",
                 "counts", "n_overflow"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    if cap == 1:
        assert int(out.n_overflow) > 0
    np.testing.assert_array_equal(_np(out.dat_win).view(np.uint32),
                                  np.asarray(ref.dat_win).view(np.uint32))


def _kernel_inputs(grid, periodic, cfg, seed):
    rng = np.random.RandomState(seed)
    F = rng.randn(10, *grid.shape).astype(np.float32) * 1e-2
    F[9] = 0.9 + 0.1 * rng.rand(*grid.shape)         # alpha channel
    Fp = np.array(cpp.pad_wrap_zero(jnp.asarray(F), periodic))
    arrs = _particles(grid, 150, seed=seed + 1)
    W = cw.window_size(arrs[0].shape[0], grid.shape[0], cfg.planes_window)
    bins = cw.window_bins(_pf(arrs, True), grid, cfg.slot_capacity, W)
    dat_win = np.array(bins.dat_win)
    # round the lo halves to bf16, so that the Pallas kernel's
    # hi + bf16(lo) staging is exact and both sides stage the same values
    dat_win[:, 7:14] = np.asarray(
        jnp.asarray(dat_win[:, 7:14]).astype(jnp.bfloat16).astype(jnp.float32))
    return Fp, dat_win, np.array(bins.counts)


@pytest.mark.parametrize("pname", list(PERIODIC))
@pytest.mark.parametrize("dyk", [True, False])
def test_window_exchange_reference_matches_pallas(pname, dyk):
    """The plain version of the window kernel against the JAX launcher in
    interpret mode, with the dynamic per-plane counts. The lo halves are
    bf16-exact here, so both sides stage the same values; the tolerance,
    2e-6 of each output channel's scale, covers f32 sums taken in another
    order and exp/pow differing by an ulp. The port always applies the dy
    shift in the kernel (3 stacks); under dy_in_kernel=False the JAX
    launcher returns 9 stacks, so the landed fields are compared."""
    grid = GRIDS["box8x6x10"]
    periodic = PERIODIC[pname]
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window", slot_capacity=4, dy_in_kernel=dyk,
                            planes_window=32, window_dynamic=True)
    Fp, dat_win, counts = _kernel_inputs(grid, periodic, cfg, seed=11)
    ref = cw.window_exchange_padded(
        jnp.asarray(Fp), jnp.asarray(dat_win), grid, periodic, cfg, 0,
        1e-6, 1000.0, interpret=True, w_chunk=16, counts=jnp.asarray(counts))
    out = tcw.window_exchange_padded(
        torch.as_tensor(Fp), torch.as_tensor(dat_win), config_from(grid),
        periodic, config_from(cfg), 0, 1e-6, 1000.0,
        counts=torch.as_tensor(counts))
    assert out[1] == [(-1, 0), (0, 0), (1, 0)]
    if dyk:
        assert out[1] == ref[1]
    landed_out = _np(tcpp._stack_epilogue(out[0], out[1]))[None]
    landed_ref = np.asarray(cpp._stack_epilogue(ref[0], ref[1]))[None]
    for name, o, r in (("fields", landed_out, landed_ref), ("pres", _np(out[2]), ref[2])):
        r = np.asarray(r)
        assert o.shape == r.shape, name
        scale = np.abs(r).reshape(r.shape[0], r.shape[1], -1).max(-1)
        err = np.abs(o - r).reshape(scale.shape + (-1,)).max(-1)
        assert np.all(err <= 2e-6 * scale + 1e-30), (name, (err / (scale + 1e-30)).max())


def _exchange_both(grid, periodic, cfg, arrs, seed):
    u, gp, dtau, ddtu, curl = _fields(grid, seed)
    alpha = np.full(grid.shape, 0.97, np.float32)
    args = (grid, periodic, 1e-6, 1000.0, 1e-4)
    ref = cw.gaussian_coupling_window(
        _pf(arrs, True), *(jnp.asarray(a) for a in (u, gp, dtau, ddtu, curl)),
        *args, cfg, prev_alpha=jnp.asarray(alpha), interpret=True)
    out = tcw.gaussian_coupling_window(
        _pf(arrs, False), *(torch.as_tensor(a) for a in (u, gp, dtau, ddtu, curl)),
        config_from(grid), *args[1:], config_from(cfg),
        prev_alpha=torch.as_tensor(alpha))
    return ref, out


def _assert_exchange_close(out, ref):
    """The JAX suite's window tolerances (test_coupling_window.py)."""
    np.testing.assert_array_equal(_np(out.found), np.asarray(ref.found))
    assert int(out.n_overflow) == int(ref.n_overflow)
    np.testing.assert_allclose(_np(out.alpha), np.asarray(ref.alpha),
                               rtol=2e-5, atol=1e-6)
    for name, atol in (("u_particle", 1e-9), ("u_source_drag", 1e-8),
                       ("u_source", 1e-8), ("force", 1e-12)):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=3e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("pname,extras", [("channel", False), ("walls", False),
                                          ("channel", True)])
def test_gaussian_coupling_window_matches_jax(pname, extras):
    """The bench's exchange under both BC settings; `extras` adds the torque
    and added-mass channels, which only the plain version carries."""
    grid = GRIDS["cube12"]
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window", slot_capacity=4, dy_in_kernel=True,
                            window_dynamic=True, use_torque=extras,
                            use_added_mass=extras)
    ref, out = _exchange_both(grid, PERIODIC[pname], cfg,
                              _particles(grid, 60, seed=1), seed=0)
    _assert_exchange_close(out, ref)
    if extras:
        np.testing.assert_allclose(_np(out.torque), np.asarray(ref.torque),
                                   rtol=3e-4, atol=1e-14)


def test_gaussian_coupling_window_overflow_matches_jax():
    """The window-overflow case: 40 particles on one x-plane of an 8^3
    grid with a window of 32 rows; the 8 past the window are counted and
    read found=False, as in the JAX package."""
    grid = Grid.cube(8, 0.008)
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window", slot_capacity=8, planes_window=32)
    ref, out = _exchange_both(grid, (True, True, False), cfg,
                              _particles(grid, 40, seed=4, pad=0, one_plane=3),
                              seed=5)
    assert int(out.n_overflow) == 8
    assert int(_np(out.found).sum()) == 32
    _assert_exchange_close(out, ref)
