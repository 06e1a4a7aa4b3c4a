"""Masked-cell (immersed-boundary) obstacles on the uniform grid (port of
`yade_openfoam_coupling_tpu/ops/obstacle.py`).

A boolean field marks solid cells. Faces between a solid cell and anything
are blocked (zero flux), velocity is pinned to zero in solid cells, the
pressure equation keeps only fluid-fluid faces and replaces solid rows by a
scaled identity (`pressure.solve_pressure(solid=...)`). The masks are built
on the host with numpy and handed to the solvers as tensors on an explicit
device. Single-device only, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class ObstacleMasks(NamedTuple):
    """One solid-cell configuration.

    fluid/solid: (nx, ny, nz) f32 indicators (fluid + solid == 1); face:
    flux-shaped f32 masks, 1 on faces between two fluid cells (a
    domain-boundary face follows its cell), 0 on any face touching a solid
    cell; n_solid: the number of solid cells."""

    fluid: torch.Tensor
    solid: torch.Tensor
    face: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    n_solid: int


def build_masks(solid: np.ndarray, periodic: Tuple[bool, bool, bool],
                device) -> ObstacleMasks:
    """The masks of a host-side boolean solid field, on ``device``. On a
    periodic axis the wrap face joins the two outermost cells; on a
    non-periodic one the boundary faces take their cell's fluid flag."""
    solid = np.asarray(solid, bool)
    if solid.ndim != 3:
        raise ValueError(f"solid mask must be (nx, ny, nz); got shape {solid.shape}")
    f = (~solid).astype(np.float32)
    faces = []
    for a in range(3):
        if periodic[a]:
            inner = np.roll(f, 1, axis=a) * f                       # face i: cells i-1, i
            m = np.concatenate([inner, np.take(inner, [0], axis=a)], axis=a)
        else:
            n = f.shape[a]
            inner = np.take(f, range(n - 1), axis=a) * np.take(f, range(1, n), axis=a)
            m = np.concatenate([np.take(f, [0], axis=a), inner, np.take(f, [-1], axis=a)],
                               axis=a)
        faces.append(torch.as_tensor(m, device=device))
    return ObstacleMasks(
        fluid=torch.as_tensor(f, device=device),
        solid=torch.as_tensor(solid.astype(np.float32), device=device),
        face=tuple(faces),
        n_solid=int(solid.sum()),
    )


def box_solid(grid_shape: Tuple[int, int, int], lo: Tuple[int, int, int],
              hi: Tuple[int, int, int]) -> np.ndarray:
    """Axis-aligned solid block: cells with lo <= idx < hi on every axis."""
    s = np.zeros(grid_shape, bool)
    s[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    return s


def mask_flux(phi, masks: ObstacleMasks):
    """Zero the flux through blocked faces."""
    return tuple(phi[a] * masks.face[a] for a in range(3))


def mask_u(u: torch.Tensor, masks: ObstacleMasks) -> torch.Tensor:
    """Pin velocity to zero in solid cells (no-slip at cell centres)."""
    return u * masks.fluid[None]
