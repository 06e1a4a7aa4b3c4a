"""pressure_device_ms (ms/step): device milliseconds of every operation
launched inside the program's ``yofc:pressure`` spans (set-up, CG and its
preconditioner), over the traced steps. Layer: the pressure solve
(`ops/pressure`).

The target is the program's own span name, which imports no module: the
harness wraps nothing for it and keeps its ranges."""

WRAPS = ("yofc:pressure",)


def read(trace):
    if not trace.device_ops or not trace.steps:
        return None
    us = trace.device_us_launched_in(WRAPS[0])
    return None if us is None else us / 1e3 / trace.steps
