"""The window and planes exchanges at slot capacities past 8 against the
JAX package, which takes any capacity: the port's plain versions (which
the CUDA kernels are held against in test_torch_cuda.py) at cap 9 and 16
on a crowded seeded cloud where cells really hold more than 8 particles,
and one more than the capacity, so the overflow count is checked too. The
JAX launchers run their Pallas kernels in interpret mode."""

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

GRID = Grid.cube(10, 0.010)
PERIODIC = (True, True, False)
NU, RHO = 1e-6, 1000.0
# crowded cells (cell index, particles): more than 8, more than 16, 33
CROWDS = (((3, 4, 5), 12), ((6, 2, 7), 17), ((5, 5, 2), 33))


def _crowded_cloud(seed=0, n_bulk=80):
    """numpy particle arrays: a uniform bulk plus CROWDS, each crowd inside
    its cell; 3 inactive capacity rows."""
    rng = np.random.RandomState(seed)
    h = np.asarray(GRID.spacing)
    L = np.asarray(GRID.lengths)
    parts = [rng.uniform(0.08 * L, 0.92 * L, (n_bulk, 3))]
    for cell, k in CROWDS:
        parts.append((np.asarray(cell) + rng.uniform(0.05, 0.95, (k, 3))) * h)
    pos = np.concatenate(parts + [np.zeros((3, 3))])
    n = len(pos)
    active = np.arange(n) < n - 3
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return (f32(pos), f32(rng.randn(n, 3) * 1e-3), f32(rng.randn(n, 3) * 1e-2),
            f32(4e-4 * (1.0 + 0.2 * rng.rand(n))), active)


def _per_cell_max(pos):
    idx = np.floor(pos / np.asarray(GRID.spacing)).astype(int)
    _, counts = np.unique(idx, axis=0, return_counts=True)
    return int(counts.max())


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("exchange", ["window", "planes"])
@pytest.mark.parametrize("cap", [9, 16])
def test_exchange_past_eight_slots_matches_jax(exchange, cap):
    """The whole exchange (binning, the kernel's plain version, landing,
    unbinning) at cap 9 and 16: found and the overflow count equal the JAX
    package's (the crowds of 12 and 17 fill ranks past 8, those of 17 and
    33 overflow), fields and forces within the neighbouring tests'
    tolerances (test_torch_window.py / test_torch_planes.py)."""
    arrs = _crowded_cloud()
    assert _per_cell_max(arrs[0][:-3]) == 33 > cap > 8
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange=exchange, slot_capacity=cap, dy_in_kernel=True,
                            window_dynamic=True)
    rng = np.random.RandomState(1)
    u, gp, dtau, ddtu, curl = [(rng.randn(3, *GRID.shape) * 1e-2).astype(np.float32)
                               for _ in range(5)]
    alpha = np.full(GRID.shape, 0.97, np.float32)
    jfn, tfn = ((cw.gaussian_coupling_window, tcw.gaussian_coupling_window)
                if exchange == "window" else
                (cpp.gaussian_coupling_planes, tcpp.gaussian_coupling_planes))
    ref = jfn(cp.ParticleFields(*map(jnp.asarray, arrs)),
              *map(jnp.asarray, (u, gp, dtau, ddtu, curl)), GRID, PERIODIC, NU, RHO, 1e-4,
              cfg, prev_alpha=jnp.asarray(alpha), interpret=True)
    out = tfn(tcp.ParticleFields(*map(torch.as_tensor, arrs)),
              *map(torch.as_tensor, (u, gp, dtau, ddtu, curl)), config_from(GRID), PERIODIC,
              NU, RHO, 1e-4, config_from(cfg), prev_alpha=torch.as_tensor(alpha))
    over = sum(max(k - cap, 0) for _, k in CROWDS)
    assert int(out.n_overflow) == int(ref.n_overflow) >= over > 0
    np.testing.assert_array_equal(_np(out.found), np.asarray(ref.found))
    assert int(_np(out.found).sum()) == len(arrs[0]) - 3 - int(out.n_overflow)
    rtol = 3e-4 if exchange == "window" else 2e-4
    np.testing.assert_allclose(_np(out.alpha), np.asarray(ref.alpha), rtol=2e-5, atol=1e-6)
    for name, atol in (("u_particle", 1e-9), ("u_source_drag", 1e-8), ("u_source", 1e-8),
                       ("force", 1e-12)):
        np.testing.assert_allclose(_np(getattr(out, name)), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
