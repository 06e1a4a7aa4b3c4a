"""Typed case configuration + OpenFOAM case-directory loading (port of
`yade_openfoam_coupling_tpu/utils/config.py`, the same mappings, gaps
included: `_BC_MAP` and `_PATCH_HINTS` are the JAX package's).

Maps an OpenFOAM case layout (the reference's entire configuration surface,
SURVEY.md §5.6) onto the framework's `CaseConfig`:

  system/controlDict        -> RunControls (+ TimeControls: adjustTimeStep,
                               maxCo, maxDeltaT — `pimpleFoamYade.C:62-64`)
  system/fvSolution         -> PressureSolverConfig (p solver/tolerance),
                               PISOConfig / PIMPLEConfig corrector counts
  system/blockMeshDict      -> Grid (single-block hex boxes)
  constant/transportProperties -> TransportProperties (nu, partDensity,
                               fluidDensity — `createFields.H:16-45`)
  constant/turbulenceProperties -> TurbulenceConfig (C6 model selection)
  constant/g                -> gravity vector
  0/U, 0/p                  -> FluidBCs (fixedValue -> Dirichlet,
                               zeroGradient -> Neumann, cyclic -> periodic)

Everything is optional with sane defaults, so partial cases load.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

from ..models.coupled import CaseConfig, TransportProperties
from ..models.pimple import PIMPLEConfig
from ..models.piso import FluidBCs, PISOConfig
from ..models.turbulence import TurbulenceConfig
from ..ops import coupling as cp
from ..ops import dem
from ..ops import pressure as pr
from ..ops.grid import DIRICHLET, NEUMANN, PERIODIC, FaceBC, FieldBC, Grid
from . import foamdict as fd
from .diagnostics import TimeControls


@dataclasses.dataclass(frozen=True)
class RunControls:
    """controlDict subset: the time loop's outer parameters."""

    dt: float = 1e-4
    end_time: float = 1.0
    write_interval: float = 0.1
    adjust_time_step: bool = False
    max_co: float = 0.5
    max_dt: float = 1.0

    def time_controls(self) -> TimeControls:
        return TimeControls(
            adjust_time_step=self.adjust_time_step,
            max_co=self.max_co,
            max_dt=self.max_dt,
        )


def _read(case: Path, *names: str) -> dict:
    for n in names:
        p = case / n
        if p.exists():
            return fd.parse_file(p)
    return {}


def load_run_controls(case: Path) -> RunControls:
    d = _read(case, "system/controlDict")
    return RunControls(
        dt=float(d.get("deltaT", 1e-4)),
        end_time=float(d.get("endTime", 1.0)),
        write_interval=float(d.get("writeInterval", 0.1)),
        adjust_time_step=bool(d.get("adjustTimeStep", False)),
        max_co=float(d.get("maxCo", 0.5)),
        max_dt=float(d.get("maxDeltaT", 1.0)),
    )


def load_transport(case: Path) -> TransportProperties:
    d = _read(case, "constant/transportProperties", "transportProperties")
    return TransportProperties(
        nu=float(d.get("nu", 1e-6)),
        rho_f=float(d.get("fluidDensity", d.get("rhoc", 1000.0))),
        rho_p=float(d.get("partDensity", d.get("rhop", 2500.0))),
    )


def load_turbulence(case: Path) -> TurbulenceConfig:
    d = _read(case, "constant/turbulenceProperties")
    sim = d.get("simulationType", "laminar")
    if sim == "laminar":
        return TurbulenceConfig(model="laminar")
    if sim == "RAS":
        model = fd.get(d, "RAS.RASModel", "kEpsilon")
        on = fd.get(d, "RAS.turbulence", True)
        return TurbulenceConfig(model=model if on else "laminar")
    if sim == "LES":
        model = fd.get(d, "LES.LESModel", "Smagorinsky")
        return TurbulenceConfig(model=model)
    return TurbulenceConfig(model="laminar")


def load_gravity(case: Path) -> Tuple[float, float, float]:
    d = _read(case, "constant/g")
    v = d.get("value", [0.0, 0.0, 0.0])
    if isinstance(v, list) and len(v) == 3:
        return tuple(float(x) for x in v)
    return (0.0, 0.0, 0.0)


def load_pressure_solver(case: Path) -> pr.PressureSolverConfig:
    d = _read(case, "system/fvSolution")
    p = fd.get(d, "solvers.p", {}) or {}
    solver = str(p.get("solver", "GAMG"))
    # OpenFOAM GAMG -> our MG-preconditioned CG; PCG -> Jacobi-PCG.
    # 'FFTPCG'/'spectral' (no OpenFOAM equivalent — our extension keyword)
    # -> the spectral transform-preconditioned CG, which itself falls back
    # to the V-cycle when the BCs admit no trig eigenbasis.
    mapped = {"GAMG": "mgpcg", "FFTPCG": "fftpcg",
              "SPECTRAL": "fftpcg"}.get(solver.upper(), "pcg")
    # fvSolution 'tolerance' is ABSOLUTE in OpenFOAM (on a normFactor-scaled
    # residual; we apply it to the plain 2-norm — documented divergence) and
    # 'relTol' is the per-solve |r|/|r0| early exit. Keep the native
    # relative `tol` at its default as a safety net.
    return pr.PressureSolverConfig(
        solver=mapped,
        abs_tol=float(p.get("tolerance", 1e-30)),
        rel_tol=float(p.get("relTol", 0.0)),
        maxiter=int(p.get("maxIter", 200)),
    )


_SCHEME_MAP = {
    "linear": "linear",
    "upwind": "upwind",
    "linearUpwind": "linearUpwind",
    "limitedLinear": "linearUpwind",   # nearest supported blend
    "Gauss": None,                     # token preceding the scheme name
}


def load_convection_scheme(case: Path) -> str:
    """fvSchemes divSchemes div(phi,U) -> convection scheme name."""
    d = _read(case, "system/fvSchemes")
    entry = fd.get(d, "divSchemes.div(phi,U)") or fd.get(d, "divSchemes.default")
    if entry is None:
        return "linear"
    toks = entry if isinstance(entry, list) else [entry]
    for t in toks:
        m = _SCHEME_MAP.get(str(t), None)
        if m:
            return m
    return "linear"


def load_piso(case: Path, pressure: pr.PressureSolverConfig) -> PISOConfig:
    d = _read(case, "system/fvSolution")
    return PISOConfig(
        n_correctors=int(fd.get(d, "PISO.nCorrectors", 2)),
        momentum_predictor=bool(fd.get(d, "PISO.momentumPredictor", True)),
        convection_scheme=load_convection_scheme(case),
        pressure=pressure,
    )


def _relaxation_factor(d, section: str, names) -> float:
    """fvSolution relaxationFactors lookup: exact name first, then any
    OpenFOAM regex-style key ('U.*', '(U|k|epsilon)') that matches."""
    import re as _re
    sec = fd.get(d, f"relaxationFactors.{section}", {}) or {}
    if not isinstance(sec, dict):
        return 1.0
    sec = {k.strip('"'): v for k, v in sec.items()}
    for n in names:
        if n in sec:
            return float(sec[n])
    for key, v in sec.items():
        try:
            pat = _re.compile(key)
        except _re.error:
            continue
        if any(pat.fullmatch(n) for n in names):
            return float(v)
    return 1.0


def load_pimple(case: Path, pressure: pr.PressureSolverConfig) -> PIMPLEConfig:
    d = _read(case, "system/fvSolution")
    return PIMPLEConfig(
        n_outer=int(fd.get(d, "PIMPLE.nOuterCorrectors", 2)),
        n_correctors=int(fd.get(d, "PIMPLE.nCorrectors", 1)),
        momentum_predictor=bool(fd.get(d, "PIMPLE.momentumPredictor", False)),
        convection_scheme=load_convection_scheme(case),
        pressure=pressure,
        # UcEqn.relax() / p.relax() factors (UcEqn.H:12); 1.0 = off
        relax_u=_relaxation_factor(d, "equations", ("U", "Uc", "U.c")),
        relax_p=_relaxation_factor(d, "fields", ("p",)),
    )


def load_grid(case: Path) -> Optional[Grid]:
    """Single-block hex blockMeshDict -> uniform Grid."""
    d = _read(case, "system/blockMeshDict", "constant/polyMesh/blockMeshDict")
    if not d or "vertices" not in d or "blocks" not in d:
        return None
    scale = float(d.get("convertToMeters", d.get("scale", 1.0)))
    verts = [[float(c) * scale for c in v] for v in d["vertices"]]
    blocks = d["blocks"]
    # pattern: hex (v0..v7) (nx ny nz) simpleGrading (..)
    counts = None
    for item in blocks:
        if isinstance(item, list) and len(item) == 3 and all(
            isinstance(x, int) for x in item
        ):
            counts = item
            break
    if counts is None:
        return None
    lo = [min(v[a] for v in verts) for a in range(3)]
    hi = [max(v[a] for v in verts) for a in range(3)]
    lengths = [hi[a] - lo[a] for a in range(3)]
    return Grid.box(counts, lengths, origin=tuple(lo))


_BC_MAP = {
    "fixedValue": DIRICHLET,
    "noSlip": DIRICHLET,
    "movingWallVelocity": DIRICHLET,
    "zeroGradient": NEUMANN,
    "fixedFluxPressure": NEUMANN,
    "cyclic": PERIODIC,
    "empty": NEUMANN,
    "symmetry": NEUMANN,
    "symmetryPlane": NEUMANN,
}

# conventional patch names per (axis, side) in box cases
_PATCH_HINTS = {
    (0, 0): ("left", "xmin", "inlet", "west"),
    (0, 1): ("right", "xmax", "outlet", "east"),
    (1, 0): ("front", "ymin", "south", "bottomWall"),
    (1, 1): ("back", "ymax", "north", "topWall"),
    (2, 0): ("bottom", "zmin", "lowerWall", "floor", "down"),
    (2, 1): ("top", "zmax", "upperWall", "ceiling", "up"),
}


def _face_bc(bfield: dict, axis: int, side: int, default: FaceBC) -> FaceBC:
    for name in _PATCH_HINTS[(axis, side)]:
        if name in bfield:
            entry = bfield[name]
            kind = _BC_MAP.get(str(entry.get("type", "")), None)
            if kind is None:
                return default
            val = entry.get("value", 0.0)
            if isinstance(val, list):
                val = tuple(float(x) for x in val)
            elif not isinstance(val, (int, float)):
                val = 0.0
            if str(entry.get("type")) == "noSlip":
                val = (0.0, 0.0, 0.0)
            return FaceBC(kind, val)
    return default


def load_bcs(case: Path) -> Optional[FluidBCs]:
    du = _read(case, "0/U", "0.orig/U")
    dp = _read(case, "0/p", "0.orig/p")
    if not du and not dp:
        return None
    bu = du.get("boundaryField", {})
    bp = dp.get("boundaryField", {})

    def build(bfield, default_kind, default_val=0.0):
        faces = []
        for a in range(3):
            pair = []
            for s in range(2):
                pair.append(_face_bc(bfield, a, s, FaceBC(default_kind, default_val)))
            faces.append(tuple(pair))
        return FieldBC(tuple(faces))

    return FluidBCs(
        u=build(bu, DIRICHLET, (0.0, 0.0, 0.0)),
        p=build(bp, NEUMANN),
    )


def load_case(
    case_dir,
    solver: str = "pimple",
    grid: Optional[Grid] = None,
    bcs: Optional[FluidBCs] = None,
    coupling: Optional[cp.CouplingConfig] = None,
    dem_cfg: Optional[dem.DEMConfig] = None,
    **overrides,
) -> Tuple[CaseConfig, RunControls]:
    """Build a `CaseConfig` from an OpenFOAM case directory.

    Anything not derivable from the dictionaries (DEM contact parameters —
    which live on the Yade side in the reference — particle capacity, etc.)
    comes from the keyword overrides."""
    case = Path(case_dir)
    rc = load_run_controls(case)
    pressure = load_pressure_solver(case)
    g = load_gravity(case)
    grid = grid or load_grid(case)
    if grid is None:
        raise ValueError(f"no grid: provide grid= or a system/blockMeshDict in {case}")
    bcs = bcs or load_bcs(case) or FluidBCs.box_noslip()
    cfg = CaseConfig(
        grid=grid,
        bcs=bcs,
        transport=load_transport(case),
        solver=solver,
        coupling=coupling or cp.CouplingConfig(gaussian=(solver == "pimple")),
        dem=dem_cfg or dem.DEMConfig(),
        piso=load_piso(case, pressure),
        pimple=load_pimple(case, pressure),
        turbulence=load_turbulence(case),
        time=rc.time_controls(),
        gravity_fluid=g if solver == "pimple" else (0.0, 0.0, 0.0),
        **overrides,
    )
    return cfg, rc
