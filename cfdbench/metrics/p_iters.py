"""p_iters (iters/step): CG iterations of the pressure solves a coupled
step, the mean of the program's own `StepDiagnostics.p_iters` over the
traced steps (a count). Layer: the fluid's pressure solve
(`ops/pressure`)."""

WRAPS = ()


def read(trace):
    iters = trace.diags.get("p_iters")
    return None if iters is None or not len(iters) else float(iters.mean())
