"""Command-line entry points, the solver-application layer (port of
`yade_openfoam_coupling_tpu/cli.py`):

    python -m yade_openfoam_coupling_tpu_torch pimplefoam <case_dir> [options]
    python -m yade_openfoam_coupling_tpu_torch icofoam    <case_dir> [options]

Same options and the same DEM choice as the JAX package's CLI, plus
``--device`` (default ``cuda``; the run exits non-zero when the device is a
CUDA device and there is none). Particle initial state comes from
`<case_dir>/particles.xyz` (one x y z per line; radius via --radius) or
--random-particles N. `pimplefoam` runs the sparse Gaussian exchange, or
with ``--fast`` the planes exchange; `icofoam` runs PISO with the
point-force exchange (`cases/example_icoFoamYade` is its example case).

    python -m yade_openfoam_coupling_tpu_torch bench [--small] [--device D]

runs the port's bench (`bench.py` of this package: bench.py's case and
protocol, one JSON line), as the JAX package's `bench` runs its root
`bench.py`; it takes that module's flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

from . import bench


def _load_particles(args, grid):
    if args.random_particles:
        rng = np.random.RandomState(args.seed)
        lo = np.asarray(grid.origin) + 0.1 * np.asarray(grid.lengths)
        hi = np.asarray(grid.origin) + 0.9 * np.asarray(grid.lengths)
        return rng.uniform(lo, hi, (args.random_particles, 3))
    pfile = Path(args.case) / "particles.xyz"
    if pfile.exists():
        return np.loadtxt(pfile).reshape(-1, 3)
    print("no particles.xyz and no --random-particles; running fluid-only "
          "(1 inert parked particle)", file=sys.stderr)
    return None


def setup(args, solver: str):
    """The case as the CLI runs it, on ``args.device``: the CaseConfig
    (case directory + the CLI's coupling and DEM choices), the initial
    SimState and the RunControls. -> (cfg, state, rc)."""
    import torch

    from .models import coupled as cd
    from .models.fields import make_fluid_state, make_particle_state, make_turbulence_state
    from .ops import coupling as cp
    from .ops import dem
    from .utils.config import load_case

    device = torch.device(args.device)
    dem_cfg = dem.DEMConfig(
        params=dem.ContactParams(kn=args.kn, restitution=args.restitution,
                                 friction=args.friction, rho_p=2500.0),
        gravity=(0.0, 0.0, -9.81),
        buoyancy=(solver == "piso"),
        neighbor="cells" if (args.random_particles or 0) > 4000 else "allpairs",
    )
    if args.fast and solver == "pimple":
        # the planes exchange with its fused kernel, a persistent Verlet
        # list and the carried contact force (lag_alpha: an O(dt) lag)
        coupling_cfg = cp.CouplingConfig(
            gaussian=True, lag_alpha=True, stencil_shape="sphere2",
            exchange="planes", slot_capacity=args.slot_capacity,
            packed_bin="col", dy_in_kernel=True, packed_unbin=True)
        dem_cfg = dataclasses.replace(
            dem_cfg, neighbor="cells", list_reuse=True,
            list_rebuild_steps=min(10, args.chunk), refined_neighbors=4,
            carry_contact=True)
    else:
        coupling_cfg = cp.CouplingConfig(gaussian=(solver == "pimple"))
    cfg, rc = load_case(args.case, solver=solver, coupling=coupling_cfg, dem_cfg=dem_cfg,
                        n_dem_substeps=args.dem_substeps, r_max=args.radius)
    # the DEM material density and wall/periodic axes track the case
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, params=dataclasses.replace(cfg.dem.params, rho_p=cfg.transport.rho_p),
        rho_f=cfg.transport.rho_f, periodic=cfg.periodic_axes(),
        wall_axes=tuple(not p for p in cfg.periodic_axes())))

    pos = _load_particles(args, cfg.grid)
    if pos is None:
        pos = [[c - 10 * cfg.grid.lengths[0] for c in cfg.grid.origin]]  # parked outside
    state = cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(pos, device, radius=args.radius),
        make_turbulence_state(cfg.grid, device, k0=1e-6),
        cfg, dt=rc.dt)
    return cfg, state, rc


def _run_solver(args, solver: str) -> int:
    import torch

    from .models import runner
    from .utils.logging import RunLogger

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2
    cfg, state, rc = setup(args, solver)
    res = runner.run(cfg, state, rc, chunk=args.chunk,
                     case_dir=args.case if args.write else None,
                     checkpoint_dir=args.checkpoint_dir,
                     logger=RunLogger(every=args.chunk), max_steps=args.max_steps)
    print(f"End ({res.steps} steps, t = {float(res.state.t):.6g})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yade_openfoam_coupling_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("icofoam", "pimplefoam"):
        s = sub.add_parser(name)
        s.add_argument("case")
        s.add_argument("--radius", type=float, default=4e-4)
        s.add_argument("--kn", type=float, default=1e3)
        s.add_argument("--restitution", type=float, default=0.5)
        s.add_argument("--friction", type=float, default=0.5)
        s.add_argument("--dem-substeps", type=int, default=10)
        s.add_argument("--random-particles", type=int, default=0)
        s.add_argument("--seed", type=int, default=0)
        s.add_argument("--chunk", type=int, default=10)
        s.add_argument("--max-steps", type=int, default=None)
        s.add_argument("--write", action="store_true")
        s.add_argument("--checkpoint-dir", default=None)
        s.add_argument("--fast", action="store_true",
                       help="planes exchange + fused kernel + persistent Verlet list "
                            "(pimplefoam only)")
        s.add_argument("--slot-capacity", type=int, default=4,
                       help="--fast: max particles per cell in the slot planes "
                            "(overflowed particles are uncoupled for the step and "
                            "counted)")
        s.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs the "
                            "kernels' plain versions)")
    bench.add_arguments(sub.add_parser("bench", help="the port's bench (bench.py's case)"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        return bench.run_bench(args)
    return _run_solver(args, "piso" if args.cmd == "icofoam" else "pimple")


if __name__ == "__main__":
    raise SystemExit(main())
