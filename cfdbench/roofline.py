"""The yardstick's table of peaks and its bound arithmetic, frozen here
from the program's `chip_smoke.py` (`HBM_BYTES_PER_S`, `F32_FLOPS`,
`nbytes`, `bound`, `exchange_flops`) so that a later change to the
program cannot move it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
F32, BOOL = 4, 1


def bound_s(n_bytes: float, flops: float) -> float:
    """The least seconds the card could take for the work: its bytes at
    the HBM rate or its float32 operations at the peak rate, whichever is
    longer."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def exchange_flops(n_occ: int, n_off: int, c_in: int) -> int:
    """Operations of a Gaussian exchange over n_occ particles: per stencil
    offset three Gaussian factors and a weight, c_in interpolation and 8
    deposit multiply-adds; ~100 for the force laws."""
    return n_occ * (n_off * (2 * c_in + 16 + 10) + 100)


# the exchange's input stencils a cell: grad p (6), the face volume
# fraction (6), 2 nu div(alpha_f grad u) (3 components x 3 axes x 5, the
# sums and the scale: 54)
EXCHANGE_INPUT_FLOPS_PER_CELL = 66


def exchange_bound_s(n_particles: int, ncells: int, n_off: int) -> float:
    """One coupled step's exchange read and written once: u, p and alpha
    (5 float32 a cell) and each particle's position, velocity, angular
    velocity, radius (10 float32) and active flag in; alpha, the particle
    velocity field, the explicit source and the drag coefficient (8
    float32 a cell) and each particle's force and torque (6 float32) and
    found flag out. Operations: `exchange_flops` with the 10 interpolated
    channels, and the input stencils."""
    n_bytes = (ncells * (5 + 8) * F32
               + n_particles * ((10 + 6) * F32 + 2 * BOOL))
    flops = (exchange_flops(n_particles, n_off, 10)
             + EXCHANGE_INPUT_FLOPS_PER_CELL * ncells)
    return bound_s(n_bytes, flops)
