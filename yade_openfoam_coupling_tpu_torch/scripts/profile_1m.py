"""Stage budget of the 1M/256^3 step in the window-exchange configuration
(`scripts/bench_1m.py --fast`) on one CUDA device (port of
`scripts/profile_1m.py`): the full step and each stage alone.

    python -m yade_openfoam_coupling_tpu_torch.scripts.profile_1m [--only=S,...] [--small]
        [--dynamic] [--rows] [--no-unroll] [--device D]

Stages (``--only`` picks some): ``full`` (one 5-step chunk of
`make_scan_fn`: one Verlet rebuild and 5 steps, per step), ``exch`` (one
exchange), ``dem`` (4 DEM substeps on the initial list with the carried
force), ``rebuild`` (one Verlet-list build), ``fluid`` (the kEqn
correction and one PIMPLE step), ``exbins`` (`coupling_window.window_bins`
alone) and ``exkern`` (kernel B1, `window_exchange_padded`, alone, on the
initial state's window and a zero padded field stack). ``--small`` runs
64^3 with 16k particles; ``--dynamic`` sets ``window_dynamic`` as the
reference's flag does (the port runs one path either way); ``--rows`` and
``--no-unroll`` as in `bench_1m`.

Each stage runs once as a warm-up, then twice k times in a row (k = 4;
5 steps for ``full``) between two CUDA events; the better of the two
spans over k is printed. The reference script times a 1-call and a
k-call scan and takes the difference, because its backend's
`block_until_ready` could return before the work was done; a CUDA event
recorded after the last launch completes only when the card has run it,
so no difference is needed. Prints one JSON line per stage with the card's
name and power limit. Exits 2 when the device is a CUDA device and there
is none.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

from ..bench import card_name, device_or_exit, initial_state, span_ms
from . import bench_1m

STAGES = ("full", "exch", "dem", "rebuild", "fluid", "exbins", "exkern")
K_REPEATS, FULL_STEPS = 4, 5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="profile_1m", description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(STAGES),
                    help="comma-separated stages out of " + ", ".join(STAGES))
    ap.add_argument("--small", action="store_true", help="64^3 with 16k particles")
    ap.add_argument("--dynamic", action="store_true", help="window_dynamic (a layout knob)")
    ap.add_argument("--rows", action="store_true", help="the rows pair layout")
    ap.add_argument("--no-unroll", action="store_true", help="substep_unroll off (a knob)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    return ap


def case_config(args, nx: int):
    """The reference profile's CaseConfig: bench_1m's ``--fast`` case with
    ``window_dynamic`` set by ``--dynamic``."""
    return bench_1m.case_config(SimpleNamespace(
        fast=True, rows=args.rows, no_unroll=args.no_unroll, unbin_gather=False,
        no_dynamic=not args.dynamic), nx)


def stages(cfg, state, n_particles: int):
    """Each stage's callable on the initial state: name -> (fn, repeats,
    steps per call)."""
    import torch
    from ..models import coupled as cd
    from ..models import turbulence
    from ..models.pimple import pimple_step
    from ..ops import coupling as cp
    from ..ops import coupling_window as cw
    from ..ops import dem
    from ..ops.coupling_planes import pad_wrap_zero

    grid, tp, ccfg = cfg.grid, cfg.transport, cfg.coupling
    fs0, ps0, tb0, dt = state.fluid, state.particles, state.turb, state.dt
    dev = ps0.pos.device
    full = cd.make_scan_fn(cfg, FULL_STEPS)
    hydro0 = dem.DEMForces(torch.zeros_like(ps0.pos), torch.zeros_like(ps0.pos))
    g = torch.tensor(cfg.gravity_fluid, dtype=torch.float32, device=dev)
    pf0 = cp.ParticleFields(ps0.pos, ps0.vel, ps0.angvel, ps0.radius, ps0.active)
    W = cw.window_size(n_particles, grid.shape[0], ccfg.planes_window)
    periodic = cfg.bcs.periodic_axes()

    def bins():
        return cw.window_bins(pf0, grid, ccfg.slot_capacity, W, with_angvel=ccfg.use_torque)

    bins0 = bins()
    # u, grad p, div tau and the lagged alpha: this configuration has no torque
    Fp0 = pad_wrap_zero(torch.zeros((10,) + grid.shape, device=dev), periodic)

    def fluid():
        tb = turbulence.correct(tb0, fs0, grid, cfg.bcs, tp.nu, dt, cfg.turbulence)
        return pimple_step(fs0, grid, cfg.bcs, tp.nu, tb.nut, g, dt, cfg.pimple)

    return {
        "full": (lambda: full(state), 1, FULL_STEPS),
        "exch": (lambda: cd.exchange(fs0, ps0, grid, cfg.bcs, tp, ccfg, dt), K_REPEATS, 1),
        "dem": (lambda: dem.dem_substeps(
            ps0.pos, ps0.vel, ps0.angvel, ps0.radius, ps0.active, hydro0, grid, cfg.dem,
            dt / cfg.n_dem_substeps, cfg.n_dem_substeps, cfg.r_max, nbr=ps0.nbr,
            carried=(ps0.contact_f, ps0.contact_t)), K_REPEATS, 1),
        "rebuild": (lambda: dem.build_neighbor_list(ps0.pos, ps0.active, grid, cfg.dem,
                                                    cfg.r_max), K_REPEATS, 1),
        "fluid": (fluid, K_REPEATS, 1),
        "exbins": (bins, K_REPEATS, 1),
        "exkern": (lambda: cw.window_exchange_padded(
            Fp0, bins0.dat_win, grid, periodic, ccfg, 0, tp.nu, tp.rho_f,
            counts=bins0.counts), K_REPEATS, 1),
    }


def time_stage(fn, repeats: int, device, trials: int = 2) -> float:
    """ms of one call of fn: one warm-up call, then the better of `trials`
    spans of `repeats` calls in a row (`bench.span_ms`) over `repeats`."""
    fn()

    def calls():
        for _ in range(repeats):
            fn()
    return min(span_ms(calls, device) for _ in range(trials)) / repeats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sel = [s for s in args.only.split(",") if s]
    unknown = sorted(set(sel) - set(STAGES))
    if unknown:
        print(f"profile_1m: unknown stages {unknown}", file=sys.stderr)
        return 2
    device = device_or_exit(args.device, "profile_1m")
    if device is None:
        return 2
    nx, n = (64, 16_000) if args.small else (bench_1m.NX, bench_1m.N_PARTICLES)
    card = card_name() if device.type == "cuda" else None
    cfg = case_config(args, nx)
    state = initial_state(cfg, n, device)
    fns = stages(cfg, state, n)
    for name in sel:
        fn, repeats, steps = fns[name]
        ms = time_stage(fn, repeats, device) / steps
        print(json.dumps({"stage": name, "ms": ms, "per": "step" if name == "full" else "call",
                          "particles": n, "grid": nx, "device": str(device), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
