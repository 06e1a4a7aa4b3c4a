"""The validation cases of the JAX package's `cases` (see `builders.py`):
`fluidized_bed`, `dense_suspension` and `fluidized_bed_1m` run; the PISO
cases `settling_sphere` and `sedimentation_cloud` are not ported yet.
Each builder returns `(CaseConfig, SimState, suggested_dt)`."""

from .builders import (  # noqa: F401
    dense_suspension,
    fluidized_bed,
    fluidized_bed_1m,
    sedimentation_cloud,
    settling_sphere,
)
