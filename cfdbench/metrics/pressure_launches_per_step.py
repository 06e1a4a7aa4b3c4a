"""pressure_launches_per_step (launches/step): device kernels, memory
copies and memory sets launched inside the program's ``yofc:pressure``
spans, over the traced steps: the pressure solve's share of
`launches_per_step`. Layer: the pressure solve (`ops/pressure`).

The target is the program's own span name, which imports no module: the
harness wraps nothing for it and keeps its ranges."""

WRAPS = ("yofc:pressure",)


def launches_in(trace, target):
    """Device operations launched inside a target's ranges (the count that
    `Trace.device_us_launched_in` sums the time of); None without any."""
    spans = sorted(trace.ranges.get(target, ()))
    if not spans:
        return None
    n, j = 0, 0
    for op in sorted(trace.device_ops, key=lambda o: o[3]):
        launch = op[3]
        while j < len(spans) and spans[j][1] < launch:
            j += 1
        if j < len(spans) and spans[j][0] <= launch:
            n += 1
    return n


def read(trace):
    if not trace.device_ops or not trace.steps:
        return None
    n = launches_in(trace, WRAPS[0])
    return None if n is None else n / trace.steps
