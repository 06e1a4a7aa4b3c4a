"""What the PIMPLE solver imports from the PISO module (port of part of
`yade_openfoam_coupling_tpu/models/piso.py`): the fluid BCs, the PISO
configuration and the pressure-solve record. `piso_step` itself is not
ported yet (ROADMAP A13)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..ops import pressure as pr
from ..ops.grid import DIRICHLET, NEUMANN, PERIODIC, FaceBC, FieldBC


@dataclasses.dataclass(frozen=True)
class FluidBCs:
    """BCs for the primary fields (the 0/ directory of an OpenFOAM case)."""

    u: FieldBC
    p: FieldBC

    @staticmethod
    def periodic() -> "FluidBCs":
        return FluidBCs(FieldBC.periodic(), FieldBC.periodic())

    @staticmethod
    def box_noslip() -> "FluidBCs":
        return FluidBCs(FieldBC.box(DIRICHLET, 0.0), FieldBC.box(NEUMANN))

    @staticmethod
    def channel_z() -> "FluidBCs":
        p = FaceBC(PERIODIC)
        return FluidBCs(
            FieldBC(((p, p), (p, p), (FaceBC(DIRICHLET, 0.0), FaceBC(DIRICHLET, 0.0)))),
            FieldBC(((p, p), (p, p), (FaceBC(NEUMANN), FaceBC(NEUMANN)))),
        )

    def periodic_axes(self) -> Tuple[bool, bool, bool]:
        return tuple(self.u.is_periodic(a) for a in range(3))


@dataclasses.dataclass(frozen=True)
class PISOConfig:
    """The fvSolution `PISO` controls (config only in the port)."""

    n_correctors: int = 2
    momentum_predictor: bool = True
    convection_scheme: str = "linear"
    pressure: pr.PressureSolverConfig = pr.PressureSolverConfig()
    ddt_corr: bool = False


class PressureSolveInfo(NamedTuple):
    iters: torch.Tensor
    initial_residual: torch.Tensor
    final_residual: torch.Tensor


def _needs_adjust_phi(bcs: FluidBCs) -> bool:
    """adjustPhi applies when the pressure equation is singular (no fixed
    pressure) and adjustable (Neumann-u) outflow faces exist."""
    p_fixed = any(f.kind == DIRICHLET for pair in bcs.p.faces for f in pair)
    u_adjustable = any(f.kind == NEUMANN for pair in bcs.u.faces for f in pair)
    return (not p_fixed) and u_adjustable


def _precond_bc_for(p_bc: FieldBC, ctx) -> FieldBC:
    """Homogenized pressure BC for block-local preconditioning: sharded-axis
    faces become Dirichlet-0."""
    faces = []
    h = p_bc.homogeneous()
    for a in range(3):
        if ctx.mesh_axes[a] is not None:
            faces.append((FaceBC(DIRICHLET, 0.0), FaceBC(DIRICHLET, 0.0)))
        else:
            faces.append(h.faces[a])
    return FieldBC(tuple(faces))
