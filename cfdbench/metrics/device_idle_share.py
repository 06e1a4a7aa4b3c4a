"""device_idle_share (%): the share of an untraced step in which no
operation ran on the device: 100 x (1 - union of device activity a traced
step / wall time a step of as many chunks run untraced just before), one
stream. The profiler slows the host and not the device, so the traced
window's own length would count its cost as idle. Layer: the device (one
H100)."""

WRAPS = ()


def read(trace):
    if not trace.device_ops or not trace.steps or trace.untraced_step_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.steps / trace.untraced_step_us)
