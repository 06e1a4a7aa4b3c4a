"""launches_per_step (launches/step): device kernels, memory copies and
memory sets in the traced chunks, over their coupled steps. Layer: the
driver (`models/coupled`: `make_scan_fn`, `coupled_step`), which decides
how many launches a step makes."""

WRAPS = ()


def read(trace):
    if not trace.device_ops or not trace.steps:
        return None
    return len(trace.device_ops) / trace.steps
