"""The slab-sharded program's ms/step at 100k particles on a 128^3 channel
(port of `scripts/bench_sharded1.py`): on a one-rank mesh by default, a
rank per card when `torch.distributed` is started with more ranks.

    python -m yade_openfoam_coupling_tpu_torch.scripts.bench_sharded1
        [--exchange=planes] [--rows] [--no-dynamic] [--device D] [--backend B]
    torchrun --nproc-per-node N -m yade_openfoam_coupling_tpu_torch.scripts.bench_sharded1

The configuration is the reference script's (`scripts/bench_sharded1.py:46-88`):
the window exchange (``--exchange=planes``: the planes exchange) with 'col'
staging, no carried contact force (the sharded path migrates slots between
steps), a Verlet list rebuilt once every 10 steps with 4 refined
neighbours, kEqn, PIMPLE 1 x 1 with fftpcg, on its uniform cloud from
``RandomState(0)`` over the box's middle 80% (whose overlapping pairs
overflow the DEM list: the overflow counts are printed, not checked, as
in the reference). ``--rows`` and ``--no-dynamic`` as in `bench_1m`.

Two modes: every step migrates and rebuilds (``list_reuse`` off, k = 6),
and the chunked scan, one migration and one (ghost plan, Verlet list)
build per 10 steps (k = 21). Each mode's ms/step is (t_k - t_1) / (k - 1)
from a 1-step and a k-step call of `make_sharded_scan` after a warm-up
of each, the better of two turns; each span runs between CUDA events
(`bench.span_ms`). The difference makes the chunked mode's extra 20
steps carry exactly 2 builds, the rebuild amortised over its 10 steps.

Without a process group the script starts a one-rank group itself (NCCL
on a card, gloo on the CPU; a ``tcp://localhost`` rendezvous on a free
port); under `torchrun` it joins the group from the environment, each rank
on ``cuda:LOCAL_RANK``. Rank 0 prints one JSON line per mode with the
rank count and the card's name and power limit. Exits 2 when the device
is a CUDA device and there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import socket
import sys

import numpy as np

from ..bench import RADIUS, card_name, device_or_exit, span_ms

NX, N_PARTICLES, DT = 128, 100_000, 5e-5
MODES = (("per-step migrate+rebuild", False, 6), ("chunked K=10", True, 21))


def build_parser(prog: str = "bench_sharded1", doc: str = __doc__) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    ap.add_argument("--exchange", choices=("window", "planes"), default="window")
    ap.add_argument("--rows", action="store_true", help="the rows pair layout")
    ap.add_argument("--no-dynamic", action="store_true",
                    help="window_dynamic off (a layout knob of the JAX package)")
    ap.add_argument("--device", default="cuda",
                    help="this rank's device (default cuda, the rank's card; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default nccl on a card, gloo on the CPU)")
    return ap


def case_config(args, nx: int = NX):
    """The reference script's CaseConfig for parsed arguments."""
    from ..models import coupled as cd
    from ..models.pimple import PIMPLEConfig
    from ..models.piso import FluidBCs
    from ..models.turbulence import TurbulenceConfig
    from ..ops import coupling as cp
    from ..ops import dem
    from ..ops import pressure as pr
    from ..ops.grid import Grid

    return cd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx),
        bcs=FluidBCs.channel_z(),
        transport=cd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                   exchange=args.exchange, slot_capacity=4, packed_bin="col",
                                   dy_in_kernel=True,
                                   window_dynamic=not args.no_dynamic),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0), gravity=(0.0, 0.0, -9.81),
            rho_f=1000.0, periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, refined_neighbors=4,
            list_reuse=True, list_rebuild_steps=10, substep_unroll=True,
            pair_layout="rows" if args.rows else "channels"),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="fftpcg", tol=1e-5, maxiter=40, mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4,
        r_max=RADIUS,
    )


def uniform_cloud(n: int, length: float, seed: int = 0) -> np.ndarray:
    """The reference's uniform cloud: n positions over the box's middle 80%
    from ``RandomState(seed)``."""
    return np.random.RandomState(seed).uniform(0.1 * length, 0.9 * length, (n, 3))


def initial_state(cfg, n: int, device, seed: int = 0):
    """The uniform cloud at rest, the fluid at rest, k0 = 1e-6, through
    `initialize_state` on ``device`` with dt 5e-5 (a single-device state:
    every rank builds the same one and takes its block)."""
    from ..models import coupled as cd
    from ..models.fields import make_fluid_state, make_particle_state, make_turbulence_state
    pos = uniform_cloud(n, cfg.grid.lengths[0], seed)
    return cd.initialize_state(make_fluid_state(cfg.grid, device),
                               make_particle_state(pos, device, radius=RADIUS),
                               make_turbulence_state(cfg.grid, device, k0=1e-6), cfg, dt=DT)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def mesh_for(device, backend=None):
    """The 1-D mesh of this process: the running process group's, a group
    joined from the environment (`torchrun`: RANK, WORLD_SIZE,
    MASTER_ADDR), or a one-rank group started here and destroyed at the
    block's end. A card device becomes ``cuda:LOCAL_RANK``."""
    import torch
    import torch.distributed as dist
    from ..parallel import make_mesh
    from ..parallel.mesh import default_device

    if device.type == "cuda":
        device = default_device(dist.get_rank() if dist.is_initialized()
                                else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    if started:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        timeout = datetime.timedelta(seconds=600)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                    rank=0, world_size=1, timeout=timeout)
    try:
        yield make_mesh(device=device)
    finally:
        if started:
            dist.destroy_process_group()


def per_step_ms(run_1, run_k, k: int, device, turns: int = 2) -> float:
    """(t_k - t_1) / (k - 1) ms from spans of a 1-step and a k-step call,
    after a warm-up of each, the better of `turns`."""
    run_1(), run_k()
    return min((span_ms(run_k, device) - span_ms(run_1, device)) / (k - 1)
               for _ in range(turns))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_or_exit(args.device, "bench_sharded1")
    if device is None:
        return 2
    from ..parallel import sharded as sh

    card = card_name() if device.type == "cuda" else None
    cfg = case_config(args, NX)
    with mesh_for(device, args.backend) as mesh:
        state = initial_state(cfg, N_PARTICLES, mesh.device)
        sstate = sh.to_sharded_state(state, cfg, mesh)
        del state
        for label, chunked, k in MODES:
            c = cfg if chunked else dataclasses.replace(
                cfg, dem=dataclasses.replace(cfg.dem, list_reuse=False, list_rebuild_steps=0))
            scan_1, scan_k = (sh.make_sharded_scan(c, mesh, n) for n in (1, k))
            last = {}
            ms = per_step_ms(lambda: scan_1(sstate),
                             lambda: last.update(diags=scan_k(sstate)[1]), k, mesh.device)
            over = [int(getattr(last["diags"], f).sum()) for f in
                    ("n_contact_overflow", "n_coupling_overflow", "n_shard_overflow")]
            if mesh.rank == 0:
                print(json.dumps({
                    "metric": f"sharded-program step ms on a {mesh.size}-rank mesh, "
                              f"{N_PARTICLES // 1000}k/{NX}^3 [{label}, {cfg.coupling.exchange}]",
                    "value": ms, "unit": "ms/step", "k": k,
                    "overflows_in_k_steps": over, "ranks": mesh.size,
                    "backend": mesh.backend, "device": str(mesh.device), "card": card}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
