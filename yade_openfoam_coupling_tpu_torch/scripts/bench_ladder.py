"""The graduated benchmark ladder's configurations #2 and #3 (BASELINE.md)
on one CUDA device (port of `scripts/bench_ladder.py`):

  #2: the 500-sphere sedimentation cloud (`cases/builders.sedimentation_cloud`:
      PISO, point-force exchange, contacts, 32^3);
  #3: the 10k-particle fluidized bed (`cases/builders.fluidized_bed`:
      PIMPLE 2 x 1, kEqn, 24 x 24 x 48) with the reference script's
      overlay: the window exchange with lag_alpha, the sphere2 stencil and 6
      slots a cell, a Verlet list rebuilt once every 10 steps with 4
      refined neighbours and the carried contact force, the spectral
      preconditioner, and the state initialised anew under that
      configuration.

(#1 is a validation case, #4 is the port's `bench` and #5 `scripts/bench_1m.py`.)

    python -m yade_openfoam_coupling_tpu_torch.scripts.bench_ladder [--device D]

The protocol is the reference script's: 50-step chunks of `make_scan_fn`,
one warm-up chunk, then 3 timed chunks, the device synchronised before
every clock read. Prints one JSON line per configuration: steps/s over the
timed chunks, each chunk's ms/step, the largest contact and coupling
overflow counts (printed, not checked, as in the reference: the bed's
uniform cloud starts with overlapping pairs), the range of the pressure
iterations, and the card's name and power limit. Exits 2 when the
device is a CUDA device and there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..bench import card_name, device_or_exit, timed_chunks

N_STEPS, REPS = 50, 3


def sedimentation(device):
    """Ladder #2: (cfg, initial state)."""
    from ..cases import builders
    cfg, state, _ = builders.sedimentation_cloud(device=device)
    return cfg, state


def fluidized_bed_config(cfg):
    """The reference script's overlay of `fluidized_bed`'s configuration
    (`scripts/bench_ladder.py:52-72`)."""
    return dataclasses.replace(
        cfg,
        coupling=dataclasses.replace(cfg.coupling, lag_alpha=True, exchange="window",
                                     stencil_shape="sphere2", slot_capacity=6,
                                     dy_in_kernel=True),
        dem=dataclasses.replace(cfg.dem, list_reuse=True, list_rebuild_steps=10,
                                refined_neighbors=4, carry_contact=True),
        pimple=dataclasses.replace(cfg.pimple, pressure=dataclasses.replace(
            cfg.pimple.pressure, solver="fftpcg")))


def fluidized_bed(device):
    """Ladder #3: (cfg, initial state), the builder's particles initialised
    anew under the overlay, so that the Verlet list and the carried contact
    force exist from the start."""
    from ..cases import builders
    from ..models import coupled as cd
    from ..models.fields import make_fluid_state, make_particle_state, make_turbulence_state
    cfg, state, dt0 = builders.fluidized_bed(device=device)
    cfg = fluidized_bed_config(cfg)
    ps = state.particles
    state = cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(ps.pos.cpu().numpy(), device, radius=ps.radius.cpu().numpy()),
        make_turbulence_state(cfg.grid, device, k0=1e-6), cfg, dt=dt0)
    return cfg, state


CASES = {"#2": ("ladder #2: 500-sphere sedimentation (PISO, 32^3)", sedimentation),
         "#3": ("ladder #3: 10k fluidized bed (PIMPLE 4-way + kEqn)", fluidized_bed)}


def run_case(key: str, device, n_steps: int = N_STEPS, reps: int = REPS):
    """One configuration under the protocol. -> (its JSON line's numbers,
    the final state)."""
    from ..models import coupled as cd
    cfg, state = CASES[key][1](device)
    run = cd.make_scan_fn(cfg, n_steps)
    state, _ = run(state)
    state, d, secs = timed_chunks(run, state, reps, device)
    return {"metric": CASES[key][0], "value": reps * n_steps / sum(secs), "unit": "steps/sec",
            "rep_ms_per_step": [1e3 * s / n_steps for s in secs],
            "overflows": [int(d["n_contact_overflow"].max()),
                          int(d["n_coupling_overflow"].max())],
            "p_iters": [int(d["p_iters"].min()), int(d["p_iters"].max())]}, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_ladder", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "bench_ladder")
    if device is None:
        return 2
    card = card_name() if device.type == "cuda" else None
    for key in CASES:
        res, _ = run_case(key, device)
        print(json.dumps({**res, "device": str(device), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
