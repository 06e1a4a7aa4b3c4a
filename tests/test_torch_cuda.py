"""The port's hand-written CUDA kernels against their plain PyTorch
versions on a CUDA device. Imports no jax, so that it runs on a GPU
machine without the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
from yade_openfoam_coupling_tpu_torch.ops.coupling_planes import pad_wrap_zero
from yade_openfoam_coupling_tpu_torch.ops.grid import Grid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(grid, periodic, cfg, n, device, seed):
    rng = np.random.RandomState(seed)
    lo = [0.08 * L for L in grid.lengths]
    hi = [0.92 * L for L in grid.lengths]
    pos = torch.as_tensor(rng.uniform(lo, hi, (n, 3)), dtype=torch.float32, device=device)
    vel = torch.as_tensor(rng.randn(n, 3) * 1e-3, dtype=torch.float32, device=device)
    pf = cp.ParticleFields(pos, vel, torch.zeros_like(pos),
                           torch.full((n,), 4e-4, device=device),
                           torch.ones(n, dtype=torch.bool, device=device))
    W = cw.window_size(n, grid.shape[0], cfg.planes_window)
    bins = cw.window_bins(pf, grid, cfg.slot_capacity, W)
    F = rng.randn(10, *grid.shape).astype(np.float32) * 1e-2
    F[9] = 0.9 + 0.1 * rng.rand(*grid.shape)
    Fp = pad_wrap_zero(torch.as_tensor(F, device=device), periodic)
    return Fp, bins


@pytest.mark.cuda
@pytest.mark.parametrize("shape,periodic", [("sphere2", (True, True, False)),
                                            ("cube", (False, False, False))])
def test_window_kernel_matches_plain(cuda, shape, periodic):
    """CUDA tensors launch the kernel of csrc/window_exchange.cu and count
    the launch; it agrees with the plain version to 1e-5 of each output
    channel's scale (f32 sums in the same order; exp and pow of the CUDA
    math library and of PyTorch's kernels may differ by an ulp)."""
    grid = Grid.box((12, 10, 14), (0.012, 0.010, 0.014))
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape=shape,
                            exchange="window", slot_capacity=4, dy_in_kernel=True,
                            window_dynamic=True)
    Fp, bins = _inputs(grid, periodic, cfg, 300, cuda, seed=21)
    args = (Fp, bins.dat_win, grid, periodic, cfg, 0, 1e-6, 1000.0)
    plain = cw.window_exchange_padded_reference(*args, counts=bins.counts)
    before = cw.window_exchange_padded.launches
    kern = cw.window_exchange_padded(*args, counts=bins.counts)
    torch.cuda.synchronize()
    assert cw.window_exchange_padded.launches == before + 1
    assert kern[1] == plain[1]
    for o, r in ((kern[0], plain[0]), (kern[2], plain[2])):
        assert o.shape == r.shape
        err = (o - r).abs().flatten(2).amax(-1)
        scale = r.abs().flatten(2).amax(-1)
        assert bool((err <= 1e-5 * scale + 1e-30).all())


@pytest.mark.cuda
def test_window_kernel_rejects_what_it_does_not_take(cuda):
    grid = Grid.cube(8, 0.008)
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window")
    Fp, bins = _inputs(grid, (True, True, False), cfg, 50, cuda, seed=3)
    args = (grid, (True, True, False), cfg, 0, 1e-6, 1000.0)
    with pytest.raises(ValueError, match="contiguous"):
        cw.window_exchange_padded(Fp.transpose(2, 3), bins.dat_win, *args)
    with pytest.raises(ValueError, match="counts"):
        cw.window_exchange_padded(Fp, bins.dat_win, *args, counts=bins.counts.long())
    torque = cp.CouplingConfig(gaussian=True, lag_alpha=True, exchange="window",
                               use_torque=True)
    with pytest.raises(NotImplementedError):
        cw.window_exchange_padded(Fp, bins.dat_win, grid, (True, True, False), torque,
                                  0, 1e-6, 1000.0)
