"""Checkpoint / resume and OpenFOAM-format time directories (port of
`yade_openfoam_coupling_tpu/utils/checkpoint.py`).

A snapshot holds the whole coupled state (fluid fields, particle arrays,
turbulence state, time and step) in one ``state.npz`` keyed by field name
("fluid.u", "fluid.phi.0", "particles.nbr", "t", ...), so it does not
depend on the order of a pytree's leaves; fields that are None are not
stored. The JAX package's orbax backend has no counterpart here.

`write_time_dir` writes the fluid fields as OpenFOAM ASCII files under
<case>/<time>/ (with the constant/polyMesh companion, once per case), as
the reference's `runTime.write()` does, so OpenFOAM post-processing can
read the output.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.fields import SimState

_MANIFEST = "manifest.json"
_PARTS = ("fluid", "particles", "turb")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _leaves(key: str, t):
    """(key, tensor) for a tensor, or for each element of a (nested) tuple
    keyed by its index: the face fluxes, and the sharded layout's lo-face
    fluxes, whose elements are tuples themselves."""
    if isinstance(t, tuple):
        for i, x in enumerate(t):
            yield from _leaves(f"{key}.{i}", x)
    elif t is not None:
        yield key, t


def _entries(state: SimState):
    """(key, tensor) for every non-None tensor of the state."""
    for part in SimState._fields:
        value = getattr(state, part)
        fields = value._asdict().items() if part in _PARTS else [(None, value)]
        for name, t in fields:
            yield from _leaves(part if name is None else f"{part}.{name}", t)


def save(path, state: SimState, step: Optional[int] = None) -> str:
    """Save a SimState snapshot under <path>/step_<step>; returns its
    directory."""
    base = Path(path)
    step = int(state.step) if step is None else step
    snap = base / f"step_{step:010d}"
    snap.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(snap / "state.npz", **{k: _numpy(t) for k, t in _entries(state)})
    (snap / _MANIFEST).write_text(json.dumps({
        "backend": "npz",
        "step": step,
        "t": float(state.t),
        "dt": float(state.dt),
        "n_particles": int(state.particles.pos.shape[0]),
    }))
    (base / "latest").write_text(snap.name)
    return str(snap)


def latest_step(path) -> Optional[int]:
    marker = Path(path) / "latest"
    if not marker.exists():
        return None
    return int(marker.read_text().strip().split("_")[-1])


def restore(path, template: SimState, step: Optional[int] = None) -> SimState:
    """Restore into the structure of `template` (the restart analog of
    OpenFOAM's `startFrom latestTime`): every field the template holds is
    read by name, with the template's dtype and device."""
    base = Path(path)
    name = (base / "latest").read_text().strip() if step is None else f"step_{step:010d}"
    snap = base / name
    manifest = json.loads((snap / _MANIFEST).read_text())
    if manifest["backend"] != "npz":
        raise ValueError(f"snapshot backend {manifest['backend']!r}: only npz is read")
    data = np.load(snap / "state.npz")

    def load(key, like):
        return torch.as_tensor(data[key], dtype=like.dtype, device=like.device)

    def load_field(key, like):
        if like is None:
            return None
        if isinstance(like, tuple):
            items = [load_field(f"{key}.{i}", x) for i, x in enumerate(like)]
            return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
        return load(key, like)

    out = {}
    for part in SimState._fields:
        value = getattr(template, part)
        if part in _PARTS:
            out[part] = type(value)(**{f: load_field(f"{part}.{f}", v)
                                       for f, v in value._asdict().items()})
        else:
            out[part] = load_field(part, value)
    return SimState(**out)


# ---------------------------------------------------------------------------
# OpenFOAM-format time-directory output (ParaView-compatible)
# ---------------------------------------------------------------------------

_FOAM_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    object      {obj};
}}
"""


def _xfastest(a: np.ndarray) -> np.ndarray:
    """(nx,ny,nz) C-order array -> flat vector in OpenFOAM/blockMesh cell
    ordering (x-fastest): value order must match `foammesh.cell_ids`."""
    return a.transpose(2, 1, 0).reshape(-1)


def _write_foam_field(path: Path, name: str, arr: np.ndarray, is_vector: bool):
    from .foammesh import PATCH_NAMES
    cls = "volVectorField" if is_vector else "volScalarField"
    with open(path, "w") as f:
        f.write(_FOAM_HEADER.format(cls=cls, obj=name))
        dims = "[0 1 -1 0 0 0 0]" if is_vector else "[0 2 -2 0 0 0 0]"
        f.write(f"dimensions      {dims};\n\n")
        if is_vector:
            vals = np.stack([_xfastest(arr[c]) for c in range(3)], axis=-1)
            f.write(f"internalField   nonuniform List<vector>\n{vals.shape[0]}\n(\n")
            f.write("\n".join(f"({v[0]:.8g} {v[1]:.8g} {v[2]:.8g})" for v in vals))
        else:
            vals = _xfastest(arr)
            f.write(f"internalField   nonuniform List<scalar>\n{vals.shape[0]}\n(\n")
            f.write("\n".join(f"{v:.8g}" for v in vals))
        f.write("\n);\n\nboundaryField\n{\n")
        for p in PATCH_NAMES:
            f.write(f"    {p}\n    {{\n        type            zeroGradient;\n    }}\n")
        f.write("}\n")


_CONTROL_DICT = """FoamFile
{
    version     2.0;
    format      ascii;
    class       dictionary;
    location    "system";
    object      controlDict;
}
application     icoFoamYade;
startFrom       latestTime;
writeControl    timeStep;
writeInterval   1;
"""


def write_case_skeleton(case_dir, grid) -> None:
    """Emit the once-per-case companions of an OpenFOAM case layout:
    constant/polyMesh (via `foammesh`), a minimal system/controlDict, and
    the `case.foam` stub ParaView's reader opens."""
    from .foammesh import write_polymesh
    base = Path(case_dir)
    if not (base / "constant" / "polyMesh" / "points").exists():
        write_polymesh(base, grid)
    sysdir = base / "system"
    sysdir.mkdir(parents=True, exist_ok=True)
    cd = sysdir / "controlDict"
    if not cd.exists():
        cd.write_text(_CONTROL_DICT)
    (base / "case.foam").touch()


def write_time_dir(case_dir, state: SimState, fields=("p", "U", "alpha"),
                   grid=None) -> str:
    """Write fluid fields in OpenFOAM ASCII format under <case>/<time>/;
    pass `grid` to also emit the constant/polyMesh companion (once per
    case)."""
    t = float(state.t)
    if grid is not None:
        write_case_skeleton(case_dir, grid)
    tdir = Path(case_dir) / f"{t:.6g}"
    tdir.mkdir(parents=True, exist_ok=True)
    fs = state.fluid
    if "p" in fields:
        _write_foam_field(tdir / "p", "p", _numpy(fs.p), False)
    if "U" in fields:
        _write_foam_field(tdir / "U", "U", _numpy(fs.u), True)
    if "alpha" in fields:
        _write_foam_field(tdir / "alpha", "alpha.air", _numpy(fs.alpha), False)
    # particle cloud in a simple positions file
    act = _numpy(state.particles.active)
    np.savetxt(tdir / "particles.xyz", _numpy(state.particles.pos)[act], fmt="%.8g")
    return str(tdir)
