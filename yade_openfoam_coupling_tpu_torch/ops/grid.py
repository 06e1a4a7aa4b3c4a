"""Structured finite-volume grid and ghost-cell boundary conditions
(port of `yade_openfoam_coupling_tpu/ops/grid.py`).

Fields: scalars ``(nx, ny, nz)``, vectors ``(3, nx, ny, nz)``, face fluxes a
3-tuple of ``(nx+1, ny, nz)``, ``(nx, ny+1, nz)``, ``(nx, ny, nz+1)``.
Every stencil op pads the block by one ghost shell filled from the BC spec
and then runs a pure interior kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# BC kinds ------------------------------------------------------------------
PERIODIC = "periodic"
DIRICHLET = "dirichlet"   # fixedValue   (ghost = 2*value - interior)
NEUMANN = "neumann"       # zeroGradient (ghost = interior)
SLIP = "slip"             # vectors: zero normal component, free tangential


@dataclasses.dataclass(frozen=True)
class FaceBC:
    """BC on one boundary face of the box; ``value`` is a float (scalar
    fields) or a 3-tuple (per-component Dirichlet value)."""

    kind: str = PERIODIC
    value: float | tuple[float, float, float] = 0.0

    def component(self, c: int) -> float:
        if isinstance(self.value, tuple):
            return float(self.value[c])
        return float(self.value)


@dataclasses.dataclass(frozen=True)
class FieldBC:
    """Six-face BC spec: ((x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi))."""

    faces: tuple[tuple[FaceBC, FaceBC], tuple[FaceBC, FaceBC], tuple[FaceBC, FaceBC]]

    @staticmethod
    def periodic() -> "FieldBC":
        p = FaceBC(PERIODIC)
        return FieldBC(((p, p), (p, p), (p, p)))

    @staticmethod
    def uniform(kind: str, value=0.0) -> "FieldBC":
        b = FaceBC(kind, value)
        return FieldBC(((b, b), (b, b), (b, b)))

    @staticmethod
    def channel_z(kind_wall: str = DIRICHLET, wall_value=0.0) -> "FieldBC":
        """Periodic in x/y, walls in z (classic channel)."""
        p = FaceBC(PERIODIC)
        w = FaceBC(kind_wall, wall_value)
        return FieldBC(((p, p), (p, p), (w, w)))

    @staticmethod
    def box(kind_wall: str = DIRICHLET, wall_value=0.0) -> "FieldBC":
        w = FaceBC(kind_wall, wall_value)
        return FieldBC(((w, w), (w, w), (w, w)))

    def is_periodic(self, axis: int) -> bool:
        lo, hi = self.faces[axis]
        return lo.kind == PERIODIC and hi.kind == PERIODIC

    def homogeneous(self) -> "FieldBC":
        """Same BC kinds with all Dirichlet values zeroed."""
        return FieldBC(tuple(
            tuple(FaceBC(f.kind, 0.0) for f in pair) for pair in self.faces
        ))

    def component(self, c: int) -> "FieldBC":
        """The scalar BC seen by component `c` of a vector field."""
        rows = []
        for axis in range(3):
            pair = []
            for f in self.faces[axis]:
                if f.kind == SLIP:
                    pair.append(FaceBC(DIRICHLET, 0.0) if c == axis
                                else FaceBC(NEUMANN, 0.0))
                elif f.kind == DIRICHLET:
                    pair.append(FaceBC(DIRICHLET, f.component(c)))
                else:
                    pair.append(FaceBC(f.kind, 0.0))
            rows.append(tuple(pair))
        return FieldBC(tuple(rows))


# No-slip box / channel presets used by the solvers.
def noslip_box_U() -> FieldBC:
    return FieldBC.box(DIRICHLET, 0.0)


def zerograd_box_p() -> FieldBC:
    return FieldBC.box(NEUMANN, 0.0)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static (hashable) description of a uniform Cartesian grid."""

    shape: tuple[int, int, int]
    spacing: tuple[float, float, float]
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)

    @staticmethod
    def cube(n: int, length: float = 1.0, origin=(0.0, 0.0, 0.0)) -> "Grid":
        h = length / n
        return Grid((n, n, n), (h, h, h), tuple(float(o) for o in origin))

    @staticmethod
    def box(shape: Sequence[int], lengths: Sequence[float], origin=(0.0, 0.0, 0.0)) -> "Grid":
        sp = tuple(float(L) / int(n) for L, n in zip(lengths, shape))
        return Grid(tuple(int(n) for n in shape), sp, tuple(float(o) for o in origin))

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def cell_volume(self) -> float:
        hx, hy, hz = self.spacing
        return hx * hy * hz

    @property
    def lengths(self) -> tuple[float, float, float]:
        return tuple(n * h for n, h in zip(self.shape, self.spacing))

    @property
    def upper(self) -> tuple[float, float, float]:
        return tuple(o + L for o, L in zip(self.origin, self.lengths))

    def zeros_scalar(self, device, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=dtype, device=device)

    def zeros_vector(self, device, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((3,) + self.shape, dtype=dtype, device=device)

    def zeros_flux(self, device, dtype=torch.float32):
        nx, ny, nz = self.shape
        return (
            torch.zeros((nx + 1, ny, nz), dtype=dtype, device=device),
            torch.zeros((nx, ny + 1, nz), dtype=dtype, device=device),
            torch.zeros((nx, ny, nz + 1), dtype=dtype, device=device),
        )


# ---------------------------------------------------------------------------
# Ghost-cell padding
# ---------------------------------------------------------------------------

def pad_axis(f: torch.Tensor, axis: int, lo: FaceBC, hi: FaceBC,
             component: int | None = None) -> torch.Tensor:
    """Append one ghost slab on each side of `axis` according to the BCs."""
    n = f.shape[axis]
    first = f.narrow(axis, 0, 1)
    last = f.narrow(axis, n - 1, 1)

    def ghost(face: FaceBC, interior: torch.Tensor, other_edge: torch.Tensor) -> torch.Tensor:
        if face.kind == PERIODIC:
            return other_edge
        if face.kind == DIRICHLET:
            v = face.component(component) if component is not None else face.component(0)
            return 2.0 * v - interior
        if face.kind == NEUMANN:
            return interior
        if face.kind == SLIP:
            if component is not None and component == axis:
                return -interior
            return interior
        raise ValueError(f"unknown BC kind {face.kind!r}")

    return torch.cat([ghost(lo, first, last), f, ghost(hi, last, first)], dim=axis)


def pad_scalar(f: torch.Tensor, bc: FieldBC) -> torch.Tensor:
    """(nx,ny,nz) -> (nx+2,ny+2,nz+2) with ghost shells from `bc`."""
    for axis in range(3):
        lo, hi = bc.faces[axis]
        f = pad_axis(f, axis, lo, hi)
    return f


def pad_vector(u: torch.Tensor, bc: FieldBC) -> torch.Tensor:
    """(3,nx,ny,nz) -> (3,nx+2,ny+2,nz+2), per-component Dirichlet values."""
    comps = []
    for c in range(3):
        fc = u[c]
        for axis in range(3):
            lo, hi = bc.faces[axis]
            fc = pad_axis(fc, axis, lo, hi, component=c)
        comps.append(fc)
    return torch.stack(comps)


def interior(fp: torch.Tensor) -> torch.Tensor:
    """Strip the one-cell ghost shell: inverse of pad_scalar."""
    return fp[..., 1:-1, 1:-1, 1:-1]
