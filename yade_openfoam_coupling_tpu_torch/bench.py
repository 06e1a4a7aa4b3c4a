"""Coupled steps per second of the port: bench.py's case, 100k four-way
particles on a 128^3 channel, on one CUDA device.

    python -m yade_openfoam_coupling_tpu_torch.bench [--small] [--yade-physics]
        [--correctors=1] [--device D]

The case is bench.py's (`bench_config`, `initial_state`): the window
exchange, a Verlet list rebuilt once every 10 steps with carried contact
forces, kEqn, PIMPLE 1 x 2 with fftpcg, on bench.py's jittered lattice
from ``RandomState(0)``. ``--small`` runs 64^3 with 10k particles,
``--yade-physics`` the tangential spring history with dynamic substeps
(up to 8), ``--correctors=1`` PIMPLE 1 x 1. The protocol is bench.py's:
10-step chunks of `make_scan_fn`, one warm-up chunk, then 3 timed chunks,
the device synchronised before every clock read; bench.py's three checks
(pressure converged, continuity below 1e-5, no capacity overflow) must
hold over the timed chunks.

Prints one JSON line with bench.py's keys (without its ``vs_baseline``,
which divides by a rate set for another device), the card's name and power
limit as ``nvidia-smi`` gives them, and each timed chunk's ms/step. Exits
2 when the device is a CUDA device and there is none.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

NX, N_PARTICLES = 128, 100_000
SMALL_NX, SMALL_N = 64, 10_000
RADIUS, DT = 4e-4, 5e-5
STEPS, REPS = 10, 3


def card_name() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def device_or_exit(name: str, prog: str):
    """The torch device `name`; None (after a message on stderr) when it is
    a CUDA device and there is none."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: --device {name}: no CUDA device", file=sys.stderr)
        return None
    return device


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span_ms(fn, device) -> float:
    """Milliseconds of one call of fn from an idle device: between two CUDA
    events on a card (the end event completes only when the card has run
    every launch before it), on the host clock elsewhere."""
    import torch
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def lattice_positions(n: int, length: float, seed: int = 0) -> np.ndarray:
    """bench.py's jittered non-overlapping lattice over the box's middle
    80%, from ``RandomState(seed)``: a uniform cloud at this density
    overlaps pairs whose springs blow them apart."""
    rng = np.random.RandomState(seed)
    k = int(np.ceil(n ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.linspace(0.1 * length, 0.9 * length, k)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    return g + rng.uniform(-0.2 * length / k, 0.2 * length / k, g.shape)


def bench_config(nx: int, yade_physics: bool = False, n_correctors: int = 2):
    """bench.py's CaseConfig (bench.py:59-179) on an nx^3 grid (h = 1 mm);
    ``yade_physics`` as its ``--yade-physics``: spring history, dynamic
    substeps up to 8, the rows pair layout, no carried contact force."""
    from .models import coupled as cd
    from .models.pimple import PIMPLEConfig
    from .models.piso import FluidBCs
    from .models.turbulence import TurbulenceConfig
    from .ops import coupling as cp
    from .ops import dem
    from .ops import pressure as pr
    from .ops.grid import Grid

    return cd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx),
        bcs=FluidBCs.channel_z(),
        transport=cd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                   exchange="window", slot_capacity=4, dy_in_kernel=True,
                                   planes_window=0, window_dynamic=True),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0), gravity=(0.0, 0.0, -9.81),
            rho_f=1000.0, periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, refined_neighbors=4,
            sorted_fetch=True, list_reuse=True, list_rebuild_steps=10,
            carry_contact=not yade_physics, shear_history=yade_physics,
            dynamic_substeps=yade_physics, substep_unroll=True,
            pair_layout="rows" if yade_physics else "channels"),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=n_correctors,
                            pressure=pr.PressureSolverConfig(
                                solver="fftpcg", tol=1e-5, maxiter=40,
                                mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=8 if yade_physics else 4,
        r_max=RADIUS,
    )


def initial_state(cfg, n: int, device, seed: int = 0):
    """bench.py's initial state: n particles of radius RADIUS at rest on
    the jittered lattice, the fluid at rest, k0 = 1e-6, through
    `initialize_state` on ``device`` with dt 5e-5. The lattice is built
    on the host once and moved once."""
    from .models import coupled as cd
    from .models.fields import make_fluid_state, make_particle_state, make_turbulence_state
    pos = lattice_positions(n, cfg.grid.lengths[0], seed)
    return cd.initialize_state(make_fluid_state(cfg.grid, device),
                               make_particle_state(pos, device, radius=RADIUS),
                               make_turbulence_state(cfg.grid, device, k0=1e-6), cfg, dt=DT)


def timed_chunks(run, state, reps: int, device):
    """reps calls of ``run`` after the caller's warm-up, the device
    synchronised before every clock read. -> (state, the per-step
    diagnostics of all reps as numpy arrays by name, seconds of each rep)."""
    diags, secs = [], []
    sync(device)
    for _ in range(reps):
        t0 = time.perf_counter()
        state, d = run(state)
        sync(device)
        secs.append(time.perf_counter() - t0)
        diags.append(d)
    per_step = {k: np.concatenate([np.asarray(getattr(d, k).detach().cpu()).reshape(-1)
                                   for d in diags]) for k in diags[0]._fields}
    return state, per_step, secs


def bench_checks(d) -> tuple:
    """bench.py's three checks (bench.py:205-212) on per-step diagnostics:
    the last pressure residual within max(1e-5 x initial, 5e-6), the
    continuity error below 1e-5, no contact or coupling overflow. Raises
    AssertionError. -> (largest final residual, largest continuity error)."""
    p_final = float(d["p_final_residual"].max())
    p_init = float(d["p_initial_residual"].max())
    cont = float(np.abs(d["cont_err_local"]).max())
    n_over = int(d["n_contact_overflow"].max() + d["n_coupling_overflow"].max())
    if not p_final <= max(1e-5 * max(p_init, 1e-30), 5e-6):
        raise AssertionError(f"pressure solve not converged: final {p_final:g} vs "
                             f"initial {p_init:g}")
    if not cont < 1e-5:
        raise AssertionError(f"continuity error {cont:g}")
    if n_over != 0:
        raise AssertionError(f"capacity overflows: {n_over}")
    return p_final, cont


def measure(cfg, state, device, steps: int = STEPS, reps: int = REPS):
    """bench.py's protocol on (cfg, state): one warm-up chunk of ``steps``
    steps, then ``reps`` timed chunks, then its checks. -> (steps/s over
    the timed chunks, ms/step of each, largest final residual, largest
    continuity error, the final state)."""
    from .models import coupled as cd
    run = cd.make_scan_fn(cfg, steps)
    state, _ = run(state)
    state, d, secs = timed_chunks(run, state, reps, device)
    p_final, cont = bench_checks(d)
    return reps * steps / sum(secs), [1e3 * s / steps for s in secs], p_final, cont, state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yade_openfoam_coupling_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    add_arguments(ap)
    return ap


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--small", action="store_true", help="64^3 with 10k particles")
    ap.add_argument("--yade-physics", action="store_true",
                    help="spring history and dynamic substeps (bench.py --yade-physics)")
    ap.add_argument("--correctors", type=int, choices=(1, 2), default=2,
                    help="PIMPLE pressure correctors (bench.py --correctors=1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")


def run_bench(args) -> int:
    """The bench for parsed arguments (`add_arguments`): prints its JSON line."""
    device = device_or_exit(args.device, "bench")
    if device is None:
        return 2
    nx, n = (SMALL_NX, SMALL_N) if args.small else (NX, N_PARTICLES)
    cfg = bench_config(nx, args.yade_physics, args.correctors)
    card = card_name() if device.type == "cuda" else None
    state = initial_state(cfg, n, device)
    sps, rep_ms, p_final, cont, _ = measure(cfg, state, device)
    tag = " [yade-physics]" if args.yade_physics else ""
    print(json.dumps({
        "metric": f"coupled steps/sec, {n} 4-way particles, {nx}^3 grid, 1 device{tag}",
        "value": sps, "unit": "steps/sec",
        "p_residual_final_max": p_final, "continuity_err_max": cont,
        "rep_ms_per_step": rep_ms, "correctors": cfg.pimple.n_correctors,
        "device": str(device), "card": card}), flush=True)
    return 0


def main(argv=None) -> int:
    return run_bench(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
