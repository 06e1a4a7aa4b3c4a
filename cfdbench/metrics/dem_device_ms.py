"""dem_device_ms (ms/step): device milliseconds of every operation
launched inside the program's ``yofc:dem.substeps`` spans (the DEM substep
loop, `ops.dem.dem_substeps`), over the traced steps. Layer: the DEM
(`ops/dem substeps`).

The target is the program's own span name, which imports no module: the
harness wraps nothing for it and keeps its ranges."""

WRAPS = ("yofc:dem.substeps",)


def read(trace):
    if not trace.device_ops or not trace.steps:
        return None
    us = trace.device_us_launched_in(WRAPS[0])
    return None if us is None else us / 1e3 / trace.steps
