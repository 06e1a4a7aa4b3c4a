"""pressure_setup_ms (ms/step): host milliseconds a coupled step spends
setting its pressure solves up, the program's ``yofc:pressure.setup``
spans (the BC constant, the nullspace means, the preconditioner's build:
fftpcg's eigenbases on the host and their copies, or mgpcg's hierarchy),
read from a run on the card. Layer: the pressure solve (`ops/pressure`).

The target is the program's own span name, which imports no module: the
harness wraps nothing for it and keeps its ranges."""

WRAPS = ("yofc:pressure.setup",)


def read(trace):
    us = trace.range_us(WRAPS[0])
    if not trace.device_ops or us is None or not trace.steps:
        return None         # no card, or a program without spans
    return us / 1e3 / trace.steps
