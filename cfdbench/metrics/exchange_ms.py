"""exchange_ms (ms/step): host milliseconds in the coupling exchange a
coupled step, the range around `models.coupled.exchange` (its input
stencils, the binning and the window or planes kernels). Layer: the
exchange (`ops/coupling_window`, `ops/coupling_planes`,
`csrc/window_exchange.cu`, `csrc/planes_exchange.cu`)."""

WRAPS = ("yade_openfoam_coupling_tpu_torch.models.coupled:exchange",)


def read(trace):
    us = trace.range_us(WRAPS[0])
    return None if us is None or not trace.steps else us / 1e3 / trace.steps
