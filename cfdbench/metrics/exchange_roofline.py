"""exchange_roofline (%): the exchange's bound over the device time of
every operation launched inside the range around `models.coupled.exchange`,
summed over the traced steps. The bound (`roofline.exchange_bound_s`) is
the exchange's particle and field inputs read once and its outputs
written once at the HBM rate, or its float32 operations at the peak rate,
whichever is longer: the same work whatever implements the exchange.
Layer: the exchange's kernels."""

from cfdbench import roofline
from cfdbench.reference.coupled_channel import stencil_offsets

WRAPS = ("yade_openfoam_coupling_tpu_torch.models.coupled:exchange",)


def read(trace):
    device_us = trace.device_us_launched_in(WRAPS[0])
    calls = trace.calls(WRAPS[0])
    if not device_us or not calls:
        return None
    case = trace.config["case"]
    n = case["grid"]["cube"][0]
    n_off = len(stencil_offsets(case["coupling"]["stencil_shape"]))
    bound = roofline.exchange_bound_s(trace.n_particles, n ** 3, n_off)
    return 100.0 * calls * bound / (device_us / 1e6)
