"""Carry state and configuration between the JAX package and the port.

The system has no learned weights: what crosses between the two packages
is the simulation state and the case configuration. Both directions go
through numpy and plain field names, so this module imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import coupled, fields, pimple, piso, turbulence
from .ops import coupling, dem, grid, pressure
from .utils import config, diagnostics

# the named-tuple parts of a SimState
_SIM_PARTS = {"fluid": fields.FluidState, "particles": fields.ParticleState,
              "turb": fields.TurbulenceState}

_CONFIG_CLASSES = {
    cls.__name__: cls for cls in (
        grid.Grid, grid.FaceBC, grid.FieldBC, piso.FluidBCs, piso.PISOConfig,
        coupled.TransportProperties, coupled.CaseConfig, coupling.CouplingConfig,
        dem.DEMConfig, dem.ContactParams, pressure.PressureSolverConfig,
        pressure.MGConfig, pimple.PIMPLEConfig, turbulence.TurbulenceConfig,
        diagnostics.TimeControls, config.RunControls,
    )
}


def _to_tensor(x, device):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_to_tensor(v, device) for v in x)
    return torch.as_tensor(np.array(x, copy=True), device=device)


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_to_numpy(v) for v in x)
    return x.detach().cpu().numpy().copy()


def state_from_numpy(tree, device) -> fields.SimState:
    """A SimState-shaped named tuple with numpy leaves (for example the JAX
    package's state after ``jax.tree.map(np.asarray, state)``) -> the port's
    SimState on ``device``. Fields are matched by name."""
    sub = {}
    for name, cls in _SIM_PARTS.items():
        part = getattr(tree, name)
        sub[name] = cls(**{f: _to_tensor(getattr(part, f), device)
                           for f in cls._fields})
    return fields.SimState(
        **sub, **{f: _to_tensor(getattr(tree, f), device)
                  for f in fields.SimState._fields if f not in sub})


def state_to_numpy(state: fields.SimState) -> fields.SimState:
    """The port's SimState with every tensor copied to a numpy array."""
    sub = {}
    for name, cls in _SIM_PARTS.items():
        part = getattr(state, name)
        sub[name] = cls(**{f: _to_numpy(getattr(part, f)) for f in cls._fields})
    return fields.SimState(
        **sub, **{f: _to_numpy(getattr(state, f))
                  for f in fields.SimState._fields if f not in sub})


def config_from(value):
    """Rebuild any JAX-package config dataclass (Grid, BCs, the solver and
    coupling configs) as the port class of the same name, field by field
    through `dataclasses.fields`; tuples and plain values pass through."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = _CONFIG_CLASSES.get(type(value).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(value).__name__}")
        return cls(**{f.name: config_from(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(config_from(v) for v in value)
    return value


def case_config_from(ref_cfg) -> coupled.CaseConfig:
    """The port's CaseConfig rebuilt from the JAX package's."""
    cfg = config_from(ref_cfg)
    if not isinstance(cfg, coupled.CaseConfig):
        raise TypeError(f"expected a CaseConfig, got {type(ref_cfg).__name__}")
    return cfg
