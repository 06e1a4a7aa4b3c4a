"""Time the coupling-exchange kernels B1 (`window_exchange_padded`), B4
(`fused_exchange_padded`) and B6 (`deposit_stacks`, the two-kernel planes
deposit, of seeded pre-normalised values) on one CUDA device at the main
path's shape: bench.py's 100k-particle jittered lattice on a 128^3 channel
(h = 1 mm, periodic x and y, walls in z), the sphere2 stencil, 4 slots a
cell; B1 also with torque and added mass. Then B3 (`distribute_rolls`) at
its two paths' shapes, 27 taps x 4 channels (the sparse exchange) and 8 x 3
(the point-force exchange), on a seeded anchor buffer laid out as the
timed tree's `_deposit_anchor_rolls` lays it out. Then B7 (`stage_planes`
of `scripts/proto_dynwin.py`, dynamic) at the prototype's shape and at the
window exchange's (this lattice's window value and y rows). Then B2
(`fused_stencil.laplacian_facegamma_fused`), float32 and bf16, on seeded p
and face coefficients at the V-cycle's 128^3 and 64^3 levels.

    python yade_openfoam_coupling_tpu_torch/scripts/exchange_timing.py [--root DIR] [--only S]

Run it by file path: ``--root`` names the checkout whose package is timed
(default: the one that holds this file), so that two trees' kernels can be
compared on one card, in turns, from one shell command; ``--only`` times
the kernels whose name holds S. For each kernel it prints
one JSON line: the median milliseconds of a call with the host's work in
the wrapper (`ms`) and of the card alone (`device_ms`, the card kept busy
while the host enqueues), and the peak device memory while one call runs
(`peak_mb`) and how far it rises above what was allocated before the call
(`above_mb`). Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

N, NX, RADIUS, CAP = 100_000, 128, 4e-4, 4
NU, RHO_F = 1e-6, 1000.0
PERIODIC = (True, True, False)


def cuda_ms(fn, reps, warmup=2, device_only=False):
    """Median milliseconds of fn() over reps runs, each between CUDA events,
    after `warmup` untimed runs (the first timed calls of a run otherwise
    read up to ~40% high). The span includes the host's time in fn before
    its launches reach the idle card; with ``device_only`` the card is kept
    busy (~1 ms of `torch.cuda._sleep`) while the host enqueues fn, so the
    span is the card's own time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def peak_mb(fn):
    """Peak device memory (MB) while one call of fn runs, and how far it
    rises above what was allocated before the call (its outputs, scratch
    and temporaries)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak / 1e6, (peak - base) / 1e6


def anchor_buffer(cp, grid, S, C, gen):
    """A seeded (S, C, grid) view of an offset-major anchor buffer whose rows
    are as long as the timed tree's deposit makes them
    (`coupling.anchor_row_length`, or ncells + 1 where it has none)."""
    import torch
    ncells = grid.ncells
    width = cp.anchor_row_length(ncells) if hasattr(cp, "anchor_row_length") else ncells + 1
    buf = torch.randn((S * C, width), generator=gen, device=gen.device)
    return buf[:, :ncells].view((S, C) + grid.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose yade_openfoam_coupling_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--only", default="", help="time only the kernels whose name holds this")
    ap.add_argument("--profile", action="store_true",
                    help="also print each launch's device time from a torch.profiler trace")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("exchange_timing: no CUDA device", file=sys.stderr)
        return 2
    from yade_openfoam_coupling_tpu_torch import kernels
    from yade_openfoam_coupling_tpu_torch.bench import lattice_positions
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
    from yade_openfoam_coupling_tpu_torch.ops import rolls
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid
    from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    dev = torch.device("cuda", 0)
    grid = Grid.cube(NX, 1e-3 * NX)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.as_tensor(lattice_positions(N, grid.lengths[0]), dtype=torch.float32, device=dev)
    pf = cp.ParticleFields(pos, 1e-2 * torch.randn(pos.shape, generator=gen, device=dev),
                           1e-1 * torch.randn(pos.shape, generator=gen, device=dev),
                           torch.full((N,), RADIUS, device=dev),
                           torch.ones(N, dtype=torch.bool, device=dev))
    F = 1e-2 * torch.randn((16,) + grid.shape, generator=gen, device=dev)
    F[-1] = 0.9 + 0.1 * torch.rand(grid.shape, generator=gen, device=dev)

    calls = {}
    for extras in (False, True):
        ccfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                 exchange="window", slot_capacity=CAP, dy_in_kernel=True,
                                 window_dynamic=True, use_torque=extras, use_added_mass=extras)
        Fp = cpp.pad_wrap_zero(F if extras else torch.cat([F[:9], F[-1:]]), PERIODIC)
        W = cw.window_size(N, NX, 0)
        bins = cw.window_bins(pf, grid, CAP, W, with_angvel=extras)
        calls["window_exchange" + (" (torque, added mass)" if extras else "")] = (
            lambda Fp=Fp, bins=bins, ccfg=ccfg: cw.window_exchange_padded(
                Fp, bins.dat_win, grid, PERIODIC, ccfg, 0, NU, RHO_F, counts=bins.counts))
    pcfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                             exchange="planes", slot_capacity=CAP, packed_bin="col",
                             dy_in_kernel=True, packed_unbin=True)
    D = cpp.bin_particles_planes(pf, grid, CAP).D
    Fp10 = cpp.pad_wrap_zero(torch.cat([F[:9], F[-1:]]), PERIODIC)
    # the bound on occupied slots that the planes exchange passes, where the
    # wrapper takes one
    kw = ({"max_occupied": N}
          if "max_occupied" in inspect.signature(cpp.fused_exchange_padded).parameters else {})
    calls["planes_fused"] = lambda: cpp.fused_exchange_padded(
        Fp10, D, grid, PERIODIC, pcfg, 0, NU, RHO_F, **kw)
    V = 1e-2 * torch.randn((8, CAP, grid.ncells), generator=gen, device=dev)
    dkw = ({"max_occupied": N}
           if "max_occupied" in inspect.signature(cpp.deposit_stacks).parameters else {})
    calls["planes_deposit"] = lambda: cpp.deposit_stacks(V, D, NX, grid, PERIODIC, pcfg, 0,
                                                         **dkw)
    for label, offsets, C in (("rolls_deposit (27, 4)", cp.stencil_offsets(
            cp.CouplingConfig(stencil_shape="cube")), 4),
                              ("rolls_deposit (8, 3)", cp.TRILINEAR_CORNERS, 3)):
        bufT = anchor_buffer(cp, grid, len(offsets), C, gen)
        calls[label] = lambda bufT=bufT, offsets=offsets: rolls.distribute_rolls(bufT, offsets)
    pdat, pnch = (torch.as_tensor(a, device=dev) for a in dw.prototype_inputs())
    calls["dynwin_staging (prototype)"] = lambda: dw.stage_planes(pdat, pnch, dw.NY, dw.NZ,
                                                                  dw.W_CHUNK, True)
    wbins = cw.window_bins(pf, grid, CAP, W)
    ych = wbins.dat_win.shape[1] - 3
    wdat = torch.stack([wbins.dat_win[:, 0], wbins.dat_win[:, ych]], 1).contiguous()
    wnch = torch.div(wbins.counts.clamp(max=W) + dw.W_CHUNK - 1, dw.W_CHUNK,
                     rounding_mode="floor").to(torch.int32)
    calls["dynwin_staging (window shape)"] = lambda: dw.stage_planes(wdat, wnch, NX, NX,
                                                                     dw.W_CHUNK, True)
    from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
    for n in (NX, NX // 2):
        lgrid = Grid.cube(n, 1e-3 * n)
        pp = torch.randn((n + 2,) * 3, generator=gen, device=dev)
        gf = tuple(0.5 + torch.rand(s, generator=gen, device=dev)
                   for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
        for label, dt in (("laplacian", torch.float32), ("laplacian_bf16", torch.bfloat16)):
            lpp, lgf = pp.to(dt), tuple(g.to(dt) for g in gf)
            calls[f"{label} ({n}^3)"] = (
                lambda lpp=lpp, lgf=lgf, lgrid=lgrid: fs.laplacian_facegamma_fused(lgf, lpp, lgrid))
    calls = {k: v for k, v in calls.items() if args.only in k}

    if args.profile and not args.only:
        # the card's rate for the exchange's dense writes, one fill each
        stks = torch.empty((3, 8) + grid.shape, device=dev)
        pres = torch.empty((4, CAP) + grid.shape, device=dev)
        fill = cuda_ms(lambda: (stks.fill_(0.0), pres.fill_(0.0)), args.reps, device_only=True)
        fill_stks = cuda_ms(lambda: stks.fill_(0.0), args.reps, device_only=True)
        print(json.dumps({"fill stks and pres (335 MB)": fill, "fill stks (201 MB)": fill_stks,
                          "card": card}), flush=True)
        del stks, pres
    for name, fn in calls.items():
        ms = cuda_ms(fn, args.reps)
        dev_ms = cuda_ms(fn, args.reps, device_only=True)
        peak, above = peak_mb(fn)
        print(json.dumps({"root": root, "kernel": name, "ms": ms, "device_ms": dev_ms,
                          "peak_mb": peak, "above_mb": above, "card": card}), flush=True)
        if args.profile:
            print(json.dumps({"kernel": name, "launches_us": launch_split(fn, args.reps)}),
                  flush=True)
    return 0


def launch_split(fn, reps):
    """Mean device microseconds per call of each launch (kernel or memset)
    that fn makes, from a `torch.profiler` trace of `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            split[e.key[:60]] = t / reps
    return split


if __name__ == "__main__":
    sys.exit(main())
