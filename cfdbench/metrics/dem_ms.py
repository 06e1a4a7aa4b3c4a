"""dem_ms (ms/step): host milliseconds a coupled step spends in the DEM
substeps, the range around `ops.dem.dem_substeps`. Layer: the DEM
(`ops/dem`)."""

WRAPS = ("yade_openfoam_coupling_tpu_torch.ops.dem:dem_substeps",)


def read(trace):
    us = trace.range_us(WRAPS[0])
    return None if us is None or not trace.steps else us / 1e3 / trace.steps
