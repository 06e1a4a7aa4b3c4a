"""The validation cases of the JAX package's `cases` (see `builders.py`):
the PISO cases `settling_sphere` and `sedimentation_cloud`, and
`fluidized_bed`, `dense_suspension` and `fluidized_bed_1m`. Each builder
returns `(CaseConfig, SimState, suggested_dt)`. `example_icoFoamYade/` is
the single-sphere settling case as an OpenFOAM case directory for
`python -m yade_openfoam_coupling_tpu_torch icofoam`."""

from .builders import (  # noqa: F401
    dense_suspension,
    fluidized_bed,
    fluidized_bed_1m,
    sedimentation_cloud,
    settling_sphere,
)
