"""Particle <-> grid coupling core (port of the config, tuples and helpers
of `yade_openfoam_coupling_tpu/ops/coupling.py` that the window exchange
uses).

The exchanges live in `coupling_window.py` and `coupling_planes.py`; the
sparse and slots exchanges are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .grid import Grid

# Gaussian support radius: interpRange = 4 * V^(1/3) and
# sigma = 0.4246 * interpRange, as in the reference engine.
INTERP_RANGE_CELLS = 4.0
SIGMA_OVER_RANGE = 0.42460
ALPHA_MIN = 0.10  # volume-fraction clamp


@dataclasses.dataclass(frozen=True)
class CouplingConfig:
    """Static switches of the coupling engine; same fields and defaults as
    the JAX package's `CouplingConfig` (see its field comments).

    Only ``exchange="window"`` and ``"planes"`` with ``gaussian`` and
    ``lag_alpha`` run in the port. ``dy_in_kernel``, ``packed_bin``,
    ``packed_unbin``, ``unbin_gather`` and ``window_dynamic`` change no
    result in the JAX package; the port takes one path for each (dy shifts
    in the kernel, an indexed store into the slot table, flat unbin gather,
    windows read up to each plane's count)."""

    gaussian: bool = True
    stencil_width: int = 3
    stencil_shape: str = "cube"
    use_added_mass: bool = False
    use_torque: bool = False
    added_mass_coeff: float = 0.5
    alpha_min: float = ALPHA_MIN
    lag_alpha: bool = False
    particle_chunks: int = 1
    exchange: str = "sparse"
    fused_planes: bool = True
    packed_bin: object = False
    planes_chunks: int = 1
    dy_in_kernel: bool = False
    packed_unbin: bool = False
    unbin_gather: bool = False
    slot_capacity: int = 4
    planes_window: int = 0
    window_dynamic: bool = False


class ParticleFields(NamedTuple):
    """SoA particle state subset the coupling consumes."""

    pos: torch.Tensor       # (N, 3)
    vel: torch.Tensor       # (N, 3)
    angvel: torch.Tensor    # (N, 3)
    radius: torch.Tensor    # (N,)
    active: torch.Tensor    # (N,) bool


class CouplingResult(NamedTuple):
    """Grid fields and per-particle results of one exchange."""

    force: torch.Tensor          # (N, 3)
    torque: torch.Tensor         # (N, 3)
    alpha: torch.Tensor          # fluid volume fraction field
    u_particle: torch.Tensor     # (3, nx, ny, nz)
    u_source: torch.Tensor       # (3, nx, ny, nz)
    u_source_drag: torch.Tensor  # implicit drag coefficient field (<= 0)
    found: torch.Tensor          # (N,) bool
    n_overflow: object = 0       # slot + window overflow count


def locate(pos: torch.Tensor, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell index (N,3) int32 and in-domain mask: floor((x - x0)/h)."""
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    h = torch.tensor(grid.spacing, dtype=pos.dtype, device=pos.device)
    idx = torch.floor((pos - origin) / h).to(torch.int32)
    n = torch.tensor(grid.shape, dtype=torch.int32, device=pos.device)
    inside = torch.all((idx >= 0) & (idx < n), dim=-1)
    return idx, inside


def _stencil_offsets(width: int, shape: str = "cube") -> np.ndarray:
    r = width // 2
    o = np.arange(-r, r + 1)
    offs = np.stack(np.meshgrid(o, o, o, indexing="ij"), -1).reshape(-1, 3)
    if shape == "sphere2":
        offs = offs[(offs ** 2).sum(1) <= 2]
    return offs


def stencil_offsets(cfg: CouplingConfig) -> np.ndarray:
    return _stencil_offsets(cfg.stencil_width, cfg.stencil_shape)


def particle_volume(radius: torch.Tensor) -> torch.Tensor:
    return (4.0 / 3.0) * math.pi * radius ** 3


def drag_coefficient(alpha_f, alpha_p, mag_ur, dia, nu, rho_f):
    """Wen-Yu / Ergun blended drag momentum-exchange coefficient."""
    small = 1e-12
    Re = small + mag_ur * dia / nu
    cd = torch.where(Re < 1000.0, (24.0 / Re) * (1.0 + 0.15 * Re ** 0.687),
                     torch.full_like(Re, 0.44))
    wen_yu = 0.75 * cd * alpha_f * alpha_p * rho_f * mag_ur * alpha_f ** (-2.65)
    ergun = (
        150.0 * (alpha_p * alpha_p / torch.clamp(alpha_f, min=1e-6))
        * (nu * rho_f) / (dia * dia)
        + 1.75 * alpha_p * rho_f * mag_ur / dia
    )
    return torch.where(alpha_f > 0.8, wen_yu, ergun)


def _stack_channels(fields) -> torch.Tensor:
    """List of scalar (grid,) / vector (3,grid) fields -> (C, grid)."""
    return torch.cat([f if f.dim() == 4 else f[None] for f in fields], dim=0)
