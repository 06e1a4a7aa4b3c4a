"""The float32 damped-Jacobi V-cycle of `pressure.make_mg_preconditioner`
as hand-written kernels (`csrc/mg_vcycle.cu`; no Pallas original, the JAX
package runs its V-cycle as XLA ops).

Three wrappers, each with its plain PyTorch version of the same signature
beside it, the V-cycle's own operations in its own order:

* `jacobi(level, x, b, omega, ec=None)`: one sweep x' + omega D^-1 (b - A
  x'), x' = x + prolong(ec), out of place; x None is zero;
* `residual_restrict(level, x, b)`: restrict(b - A x), the fine residual
  never stored;
* `coarse(level, b, sweeps, omega)`: `sweeps` sweeps from zero on a level
  of at most `COARSE_MAX_CELLS` cells, in one launch of one block.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises (`kernels.on_cpu`); `kernels.LAUNCHES` counts the launches. The
ghosts are those of `grid.pad_scalar` under the level's BCs, which must
be homogeneous (every Dirichlet value zero), as the preconditioner's are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .grid import DIRICHLET, NEUMANN, PERIODIC, FieldBC, Grid, pad_scalar
from .stencil import Flux, laplacian_facegamma_padded

_KERNEL = "mg_vcycle kernel"
COARSE_MAX_CELLS = 4096     # the coarse kernel's largest level (16^3)
_GHOST = {PERIODIC: 0, DIRICHLET: 2}   # else 1: the cell repeated (pad_axis)
_DIAG_FACTOR = {NEUMANN: 0.0, DIRICHLET: 2.0}   # poisson_diag's; else 1


class MGLevel(NamedTuple):
    """One level of the V-cycle: its face coefficients, grid and BCs, and
    1/diag(A), which only the plain versions read (None on the card: the
    kernels form it in registers)."""

    gamma_f: Flux
    grid: Grid
    bc: FieldBC
    inv_diag: Optional[torch.Tensor] = None


def restrict(f: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction: average 2x2x2 fine cells."""
    nx, ny, nz = f.shape
    return f.reshape(nx // 2, 2, ny // 2, 2, nz // 2, 2).mean(dim=(1, 3, 5))


def prolong(c: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation (each coarse cell -> 2x2x2 fine), as
    one broadcast copy."""
    nx, ny, nz = c.shape
    return c[:, None, :, None, :, None].expand(nx, 2, ny, 2, nz, 2).reshape(
        2 * nx, 2 * ny, 2 * nz)


def _apply(level: MGLevel, x: torch.Tensor) -> torch.Tensor:
    return laplacian_facegamma_padded(level.gamma_f, pad_scalar(x, level.bc), level.grid)


def _inv_diag(level: MGLevel) -> torch.Tensor:
    if level.inv_diag is None:
        raise ValueError(f"{_KERNEL}: the plain version reads the level's inv_diag; got None")
    return level.inv_diag


def jacobi_plain(level: MGLevel, x: Optional[torch.Tensor], b: torch.Tensor, omega: float,
                 ec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`jacobi`'s plain version."""
    x = torch.zeros_like(b) if x is None else x
    if ec is not None:
        x = x + prolong(ec)
    r = b - _apply(level, x)
    return x + omega * _inv_diag(level) * r


def residual_restrict_plain(level: MGLevel, x: Optional[torch.Tensor],
                            b: torch.Tensor) -> torch.Tensor:
    """`residual_restrict`'s plain version."""
    return restrict(b - _apply(level, torch.zeros_like(b) if x is None else x))


def coarse_plain(level: MGLevel, b: torch.Tensor, sweeps: int, omega: float) -> torch.Tensor:
    """`coarse`'s plain version."""
    x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = jacobi_plain(level, x, b, omega)
    return x


@functools.lru_cache(maxsize=64)
def _params(shape: Tuple[int, int, int], spacing: Tuple[float, float, float], bc: FieldBC,
            omega: float, sweeps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' read-only host parameters: int32 (nx, ny, nz, the six
    faces' ghost rules, sweeps) and float32 (1/h, 1/h^2, the six faces'
    `poisson_diag` factors, omega). The reciprocals are PyTorch's for a
    CUDA tensor divided by a Python float: taken in double, rounded to
    float32."""
    faces = [f for pair in bc.faces for f in pair]
    for f in faces:
        if f.kind == DIRICHLET and f.value != 0.0:
            raise ValueError(f"{_KERNEL}: the BCs must be homogeneous; got Dirichlet value "
                             f"{f.value!r}")
    ip = np.asarray([*shape, *(_GHOST.get(f.kind, 1) for f in faces), sweeps], np.int32)
    fp = np.asarray([*(1.0 / h for h in spacing), *(1.0 / h ** 2 for h in spacing),
                     *(_DIAG_FACTOR.get(f.kind, 1.0) for f in faces), omega], np.float32)
    ip.setflags(write=False)
    fp.setflags(write=False)
    return ip, fp


def _on_cpu(level: MGLevel, b: torch.Tensor, x: Optional[torch.Tensor] = None,
            ec: Optional[torch.Tensor] = None, halves: bool = False) -> bool:
    """Raise on what the kernels do not take: contiguous float32 b (nx,
    ny, nz), the level's face arrays, x (nx, ny, nz) and ec (nx/2, ny/2,
    nz/2) where given, all on b's device; even sides where the level is
    restricted or corrected (``halves``). -> `kernels.on_cpu` of b."""
    cpu = kernels.on_cpu(_KERNEL, b.device)
    nx, ny, nz = shape = level.grid.shape
    if halves and (nx % 2 or ny % 2 or nz % 2):
        raise ValueError(f"{_KERNEL}: a level with a coarse level below must have even "
                         f"sides; got {shape}")
    f32 = torch.float32
    kernels.require(_KERNEL, b.device, ("b", b, shape, f32, False),
                    ("gamma_x", level.gamma_f[0], (nx + 1, ny, nz), f32, False),
                    ("gamma_y", level.gamma_f[1], (nx, ny + 1, nz), f32, False),
                    ("gamma_z", level.gamma_f[2], (nx, ny, nz + 1), f32, False),
                    ("x", x, shape, f32, False),
                    ("ec", ec, (nx // 2, ny // 2, nz // 2), f32, False))
    return cpu


def _launch(fn: str, level: MGLevel, b: torch.Tensor, out_shape, omega: float, sweeps: int,
            *arrays) -> torch.Tensor:
    ip, fp = _params(tuple(level.grid.shape), tuple(float(h) for h in level.grid.spacing),
                     level.bc, float(omega), sweeps)
    out = torch.empty(out_shape, dtype=b.dtype, device=b.device)
    kernels.call("mg_vcycle", fn, _KERNEL, ip, fp, *arrays, *level.gamma_f, out,
                 device=b.device)
    return out


def jacobi(level: MGLevel, x: Optional[torch.Tensor], b: torch.Tensor, omega: float,
           ec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One damped-Jacobi sweep x' + omega D^-1 (b - A x'), x' = x +
    prolong(ec) (x None: zero; ec None: x), into a new tensor."""
    if _on_cpu(level, b, x, ec, halves=ec is not None):
        return jacobi_plain(level, x, b, omega, ec)
    return _launch("yofc_mg_jacobi", level, b, b.shape, omega, 0, x, ec, b)


def residual_restrict(level: MGLevel, x: Optional[torch.Tensor],
                      b: torch.Tensor) -> torch.Tensor:
    """restrict(b - A x) (x None: zero), (nx/2, ny/2, nz/2)."""
    if _on_cpu(level, b, x, halves=True):
        return residual_restrict_plain(level, x, b)
    nx, ny, nz = level.grid.shape
    return _launch("yofc_mg_residual_restrict", level, b, (nx // 2, ny // 2, nz // 2), 1.0, 0,
                   x, b)


def coarse(level: MGLevel, b: torch.Tensor, sweeps: int, omega: float) -> torch.Tensor:
    """`sweeps` sweeps from zero on a level of at most COARSE_MAX_CELLS
    cells (zero sweeps: zero)."""
    if _on_cpu(level, b):
        return coarse_plain(level, b, sweeps, omega)
    if level.grid.ncells > COARSE_MAX_CELLS:
        raise ValueError(f"{_KERNEL}: the coarse kernel takes at most {COARSE_MAX_CELLS} "
                         f"cells; got {level.grid.shape}")
    if sweeps == 0:
        return torch.zeros_like(b)
    return _launch("yofc_mg_coarse", level, b, b.shape, omega, sweeps, b)
