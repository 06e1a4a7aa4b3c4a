"""Coupled steps per second at 1M four-way particles on a 256^3 channel,
on one CUDA device (port of `scripts/bench_1m.py`).

    python -m yade_openfoam_coupling_tpu_torch.scripts.bench_1m [--fast] [--rows]
        [--no-donate] [--no-unroll] [--unbin-gather] [--no-dynamic] [--device D]

The default case is the planes exchange in 8 x-slabs of 32 planes with
'col' staging and the multigrid-preconditioned CG (4 + 4 smoothing, tol
1e-5, 40 iterations at most); ``--fast`` runs the window exchange with the
spectral preconditioner. Both: PIMPLE 1 x 1, kEqn, a Verlet list rebuilt
once every 5 steps with 4 refined neighbours and the carried contact
force, 4 DEM substeps, bench.py's jittered lattice from ``RandomState(0)``.
``--rows`` selects the rows pair layout (validated as ``pair_layout``
is); ``--no-donate``, ``--no-unroll``, ``--unbin-gather`` and
``--no-dynamic`` set knobs that change only the JAX package's scheduling
or layout, and the port runs its one path under each.

The protocol is the reference script's: a 3-step call of `make_scan_fn`
as the warm-up, then one timed 3-step call, the device synchronised before
each clock read. Prints one JSON line with the reference's keys (without
its ``vs_baseline``, which divides by a rate set for another device), the
card's name and power limit, the largest initial pressure residual of the
timed steps and whether every final residual met bench.py's bound,
max(1e-5 x initial, 5e-6) (``p_converged``; the reference script does not
check it), and ``peak_mb``, the peak of `torch.cuda.max_memory_allocated`
over the timed call, reset before it. Exits 2 when the device is a CUDA
device and there is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..bench import RADIUS, card_name, device_or_exit, initial_state, sync

NX, N_PARTICLES, N_STEPS = 256, 1_000_000, 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_1m", description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the window exchange with the spectral preconditioner")
    ap.add_argument("--rows", action="store_true", help="the rows pair layout")
    for flag in ("--no-donate", "--no-unroll", "--unbin-gather", "--no-dynamic"):
        ap.add_argument(flag, action="store_true",
                        help="a scheduling or layout knob of the JAX package")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    return ap


def case_config(args, nx: int = NX):
    """The reference script's CaseConfig (`scripts/bench_1m.py:53-110`) for
    parsed arguments, on an nx^3 grid (h = 1 mm)."""
    from ..models import coupled as cd
    from ..models.pimple import PIMPLEConfig
    from ..models.piso import FluidBCs
    from ..models.turbulence import TurbulenceConfig
    from ..ops import coupling as cp
    from ..ops import dem
    from ..ops import pressure as pr
    from ..ops.grid import Grid

    if args.fast:
        coupling = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                     exchange="window", slot_capacity=4, packed_unbin=True,
                                     dy_in_kernel=True, unbin_gather=args.unbin_gather,
                                     window_dynamic=not args.no_dynamic)
    else:
        coupling = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                     exchange="planes", slot_capacity=4, planes_chunks=8,
                                     packed_bin="col", dy_in_kernel=True)
    return cd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx),
        bcs=FluidBCs.channel_z(),
        transport=cd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=coupling,
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0), gravity=(0.0, 0.0, -9.81),
            rho_f=1000.0, periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, force_chunks=8,
            list_reuse=True, list_rebuild_steps=5, refined_neighbors=4, carry_contact=True,
            substep_unroll=not args.no_unroll,
            pair_layout="rows" if args.rows else "channels"),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="fftpcg" if args.fast else "mgpcg", tol=1e-5, maxiter=40,
            mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4,
        r_max=RADIUS,
    )


def build_case(argv, device, nx: int = NX, n: int = N_PARTICLES):
    """(cfg, initial state on ``device``) for the flags in argv; ``nx`` and
    ``n`` cut the case to size for a check on the CPU."""
    cfg = case_config(build_parser().parse_args(argv), nx)
    return cfg, initial_state(cfg, n, device)


def measure(cfg, state, device, n_steps: int = N_STEPS):
    """The reference protocol: one warm-up call of an n_steps-step scan,
    then one timed call, the device synchronised before each clock read,
    the peak device memory reset before the timed call and read after it.
    -> (the JSON line's numbers, the final state)."""
    import torch
    from ..models import coupled as cd
    run = cd.make_scan_fn(cfg, n_steps)
    state, _ = run(state)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, diags = run(state)
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e6 if device.type == "cuda" else None
    d = {k: np.asarray(v.detach().cpu()).reshape(-1) for k, v in diags._asdict().items()}
    return {
        "value": n_steps / wall,
        "overflows": [int(d["n_contact_overflow"].sum()), int(d["n_coupling_overflow"].sum()),
                      int(d["n_shard_overflow"].sum())],
        "n_found": int(d["n_found"][-1]),
        "p_iters": d["p_iters"].tolist(),
        "p_final_residual": float(d["p_final_residual"][-1]),
        "p_initial_residual_max": float(d["p_initial_residual"].max()),
        "p_converged": bool(d["p_final_residual"].max()
                            <= max(1e-5 * max(float(d["p_initial_residual"].max()), 1e-30),
                                   5e-6)),
        "peak_mb": peak,
    }, state


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_or_exit(args.device, "bench_1m")
    if device is None:
        return 2
    cfg, state = build_case(argv, device)
    card = card_name() if device.type == "cuda" else None
    res, _ = measure(cfg, state, device)
    exch = "window, fftpcg" if args.fast else "planes in 8 slabs, mgpcg"
    print(json.dumps({
        "metric": f"coupled steps/sec, 1M 4-way particles, 256^3 grid, 1 device [{exch}]",
        "unit": "steps/sec", **res, "device": str(device), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
