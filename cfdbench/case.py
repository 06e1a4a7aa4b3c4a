"""A configuration's file -> the program's `CaseConfig`, through the
program's own constructors.

The file's ``"case"`` object mirrors `CaseConfig` field for field: a nested
object builds the dataclass that the field's default is an instance of,
a list becomes a tuple, ``"grid": {"cube": [n, length]}`` is
`Grid.cube(n, length)` and ``"bcs": "channel_z"`` is `FluidBCs.channel_z()`.
An unknown key raises, so a file cannot set what the program does not read.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _make(cls, values: dict, **fixed):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for key, value in values.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        default = fields[key].default
        if dataclasses.is_dataclass(default):
            kw[key] = _make(type(default), value)
        elif isinstance(value, list):
            kw[key] = tuple(value)
        else:
            kw[key] = value
    return cls(**kw, **fixed)


def build(config: dict):
    """The program's CaseConfig of a configuration's ``"case"`` object."""
    from yade_openfoam_coupling_tpu_torch.models.coupled import CaseConfig
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid

    values = dict(config["case"])
    n, length = values.pop("grid")["cube"]
    bcs = getattr(FluidBCs, values.pop("bcs"))()
    return _make(CaseConfig, values, grid=Grid.cube(int(n), float(length)), bcs=bcs)


def shrink(config: dict, nx: int, n_particles: int) -> dict:
    """A copy of the configuration at a small size (h kept), for runs on
    the CPU: an x-slab count that no longer divides nx is cut to 2."""
    out = json.loads(json.dumps(config))
    h = out["case"]["grid"]["cube"][1] / out["case"]["grid"]["cube"][0]
    out["case"]["grid"]["cube"] = [nx, h * nx]
    out["n_particles"] = n_particles
    if nx % out["case"]["coupling"]["planes_chunks"]:
        out["case"]["coupling"]["planes_chunks"] = 2
    return out
