"""list_build_ms (ms/step): host milliseconds of the Verlet-list rebuilds,
the range around `models.coupled._rebuild` (once a chunk), over the steps
they serve. Layer: the DEM's list build (`ops/dem`)."""

WRAPS = ("yade_openfoam_coupling_tpu_torch.models.coupled:_rebuild",)


def read(trace):
    us = trace.range_us(WRAPS[0])
    return None if us is None or not trace.steps else us / 1e3 / trace.steps
