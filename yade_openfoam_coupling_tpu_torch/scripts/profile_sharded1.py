"""Stage profile of the slab-sharded program at 100k particles on a 128^3
channel on a one-rank mesh (port of `scripts/profile_sharded1.py`): each
component of the sharded step timed as its own call, the full step, and
the card's busy share over one full step.

    python -m yade_openfoam_coupling_tpu_torch.scripts.profile_sharded1
        [--small] [--exchange=planes] [--rows] [--device D] [--backend B]

Components (`parallel/sharded._one_sharded_step`):
  faces    : `lo_to_faces_local` and `faces_to_lo_local`, a round trip;
  exchange : the sharded exchange (owner-rank kernel, halo reduction);
  dem      : the sharded DEM (ghost plan, ghost refresh per substep, list,
             4 substeps);
  migrate  : one ring migration hop;
  full     : one sharded step (`make_sharded_scan`, 6 steps, per step).
The configuration is the reference profile's: `bench_sharded1`'s with the
DEM's list rebuilt every step and its other options at their defaults,
and ``window_dynamic`` off; its uniform cloud. ``--small`` runs 32^3 with
2,000 particles.

Each component runs once as a warm-up, then twice 6 times in a row between
two CUDA events (`bench.span_ms`); the better span over 6 is printed. (The
reference takes a 1-call and a k-call difference because its backend's
`block_until_ready` could return early; an event completes only when the
card has run every launch before it.) The busy share is the summed device
time of the kernels in a `torch.profiler` trace of one full step over
that step's span without the profiler. Prints one JSON line per component
and a summary line, with the card's name and power limit. Exits 2 when the
device is a CUDA device and there is none.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from ..bench import card_name, device_or_exit, span_ms
from . import bench_sharded1 as bs
from .profile_1m import time_stage

K_REPEATS = 6


def build_parser():
    ap = bs.build_parser("profile_sharded1", __doc__)
    ap.add_argument("--small", action="store_true", help="32^3 with 2,000 particles")
    return ap


def case_config(args, nx: int):
    """The reference profile's CaseConfig (`scripts/profile_sharded1.py:57-86`)."""
    from ..ops import dem
    cfg = bs.case_config(args, nx)
    d = dem.DEMConfig()
    return dataclasses.replace(
        cfg, coupling=dataclasses.replace(cfg.coupling, window_dynamic=False),
        dem=dataclasses.replace(cfg.dem, list_reuse=d.list_reuse,
                                list_rebuild_steps=d.list_rebuild_steps,
                                substep_unroll=d.substep_unroll,
                                pair_layout="rows" if args.rows else d.pair_layout))


def components(cfg, mesh, sstate):
    """Each component's callable on this rank's initial block: name -> (fn,
    calls, steps per call)."""
    import torch
    from ..ops import dem as demod
    from ..parallel import particles as pp
    from ..parallel import sharded as sh

    n_loc, ctx, geom = sh._setup(cfg, mesh)
    fs, ps, dt = sstate.fluid, sstate.particles, sstate.dt
    faces = sh.lo_to_faces_local(fs.phi, cfg.bcs.u, ctx)
    ex = sh.make_sharded_exchange(cfg, ctx, n_loc)
    dem_fn = sh._make_dem_fn(cfg, geom)
    hydro = demod.DEMForces(torch.zeros_like(ps.pos), torch.zeros_like(ps.pos))
    K_m = max(8, ps.pos.shape[0] // 4)
    full = sh.make_sharded_scan(cfg, mesh, K_REPEATS)
    return {
        "faces": (lambda: sh.faces_to_lo_local(sh.lo_to_faces_local(fs.phi, cfg.bcs.u, ctx),
                                               ctx), K_REPEATS, 1),
        "exchange": (lambda: ex(fs._replace(phi=faces), ps, dt), K_REPEATS, 1),
        "dem": (lambda: dem_fn(ps, hydro, dt / cfg.n_dem_substeps), K_REPEATS, 1),
        "migrate": (lambda: pp.migrate(ps, cfg.grid, geom, K_m), K_REPEATS, 1),
        "full": (lambda: full(sstate), 1, K_REPEATS),
    }


def busy_share(fn, device):
    """(the card's busy share over one call of fn, its device ms, its span
    ms): the summed device time of the kernels of one profiled call (one
    stream: they do not overlap) over the span of another call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    wall = span_ms(fn, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    dev_us = sum((getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us / 1e3 / wall, dev_us / 1e3, wall


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_or_exit(args.device, "profile_sharded1")
    if device is None:
        return 2
    from ..parallel import sharded as sh

    nx, n = (32, 2_000) if args.small else (bs.NX, bs.N_PARTICLES)
    card = card_name() if device.type == "cuda" else None
    cfg = case_config(args, nx)
    with bs.mesh_for(device, args.backend) as mesh:
        sstate = sh.to_sharded_state(bs.initial_state(cfg, n, mesh.device), cfg, mesh)
        ms = {}
        for name, (fn, calls, steps) in components(cfg, mesh, sstate).items():
            ms[name] = time_stage(fn, calls, mesh.device) / steps
            if mesh.rank == 0:
                print(json.dumps({"stage": name, "ms": ms[name], "ranks": mesh.size,
                                  "device": str(mesh.device), "card": card}), flush=True)
        summary = {**ms, "unattributed (fluid and the rest)":
                   ms["full"] - ms["exchange"] - ms["dem"] - ms["migrate"] - ms["faces"]}
        if mesh.device.type == "cuda":
            step = sh.make_sharded_scan(cfg, mesh, 1)
            share, dev_ms, wall = busy_share(lambda: step(sstate), mesh.device)
            summary.update({"busy_share_full_step": share, "device_ms_full_step": dev_ms,
                            "span_ms_full_step": wall})
        if mesh.rank == 0:
            print(json.dumps({"summary": summary, "particles": n, "grid": nx,
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
