"""dem_launches_per_step (launches/step): device kernels, memory copies and
memory sets launched inside the program's ``yofc:dem.substeps`` spans, over
the traced steps: the DEM substep loop's share of `launches_per_step`.
Layer: the DEM (`ops/dem substeps`).

The target is the program's own span name, which imports no module: the
harness wraps nothing for it and keeps its ranges."""

from cfdbench.metrics.pressure_launches_per_step import launches_in

WRAPS = ("yofc:dem.substeps",)


def read(trace):
    if not trace.device_ops or not trace.steps:
        return None
    n = launches_in(trace, WRAPS[0])
    return None if n is None else n / trace.steps
