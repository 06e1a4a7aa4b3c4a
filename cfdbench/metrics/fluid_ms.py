"""fluid_ms (ms/step): host milliseconds a coupled step spends in the
fluid, the ranges around `turbulence.correct` and `pimple_step` (the
pressure solves with their host reads included). Layer: the fluid
(`models/turbulence`, `models/pimple`, `ops/pressure`)."""

WRAPS = ("yade_openfoam_coupling_tpu_torch.models.turbulence:correct", "yade_openfoam_coupling_tpu_torch.models.coupled:pimple_step")


def read(trace):
    parts = [trace.range_us(t) for t in WRAPS]
    if any(p is None for p in parts) or not trace.steps:
        return None
    return sum(parts) / 1e3 / trace.steps
