#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
checks each against its plain PyTorch version at the main path's shapes,
drives the main path (bench.py's configuration: 100k particles on a 128^3
channel, window exchange, frozen Verlet list, kEqn, PIMPLE with fftpcg)
through `initialize_state` and `make_scan_fn`, checks the bench's health
conditions and that the main path went through every kernel, and checks
the CUDA path against the CPU path of the same port on a small case.

Prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. Exits non-zero
without printing that line when there is no CUDA device, when a kernel
does not build or disagrees, or when any check fails.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

NX, N_PARTICLES, RADIUS, DT = 128, 100_000, 4e-4, 5e-5
STEPS_PER_RUN, TIMED_RUNS = 10, 2
KERNEL_RTOL = 1e-5


def bench_config(nx):
    """bench.py's CaseConfig on an nx^3 grid (h = 1 mm), as port classes."""
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.pimple import PIMPLEConfig
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.models.turbulence import TurbulenceConfig
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.ops import dem
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid

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
            carry_contact=True, substep_unroll=True, pair_layout="channels"),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=2, pressure=pr.PressureSolverConfig(
            solver="fftpcg", tol=1e-5, maxiter=40, mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4,
        r_max=RADIUS,
    )


def lattice_positions(n, length, seed=0):
    """bench.py's jittered non-overlapping lattice."""
    rng = np.random.RandomState(seed)
    k = int(np.ceil(n ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.linspace(0.1 * length, 0.9 * length, k)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    return g + rng.uniform(-0.2 * length / k, 0.2 * length / k, g.shape)


def initial_state(cfg, n, device, vel_scale=0.0):
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)
    pos = lattice_positions(n, cfg.grid.lengths[0])
    vel = vel_scale * np.random.RandomState(1).randn(n, 3)
    return cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(pos, device, vel=vel, radius=RADIUS),
        make_turbulence_state(cfg.grid, device, k0=1e-6), cfg, dt=DT)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, each between CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(cfg, device):
    """The window kernel against its plain version at the main path's
    shapes: the bench lattice with seeded velocities, seeded fluid inputs."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
    from yade_openfoam_coupling_tpu_torch.ops.coupling_planes import pad_wrap_zero

    grid, ccfg = cfg.grid, cfg.coupling
    gen = torch.Generator(device=device).manual_seed(0)
    pos = torch.as_tensor(lattice_positions(N_PARTICLES, grid.lengths[0]),
                          dtype=torch.float32, device=device)
    vel = 1e-2 * torch.randn(pos.shape, generator=gen, device=device)
    pf = cp.ParticleFields(pos, vel, torch.zeros_like(pos),
                           torch.full((N_PARTICLES,), RADIUS, device=device),
                           torch.ones(N_PARTICLES, dtype=torch.bool, device=device))
    W = cw.window_size(N_PARTICLES, grid.shape[0], ccfg.planes_window)
    bins = cw.window_bins(pf, grid, ccfg.slot_capacity, W)
    F = 1e-2 * torch.randn((10,) + grid.shape, generator=gen, device=device)
    F[9] = 0.9 + 0.1 * torch.rand(grid.shape, generator=gen, device=device)
    Fp = pad_wrap_zero(F, cfg.periodic_axes())
    args = (Fp, bins.dat_win, grid, cfg.periodic_axes(), ccfg, 0,
            cfg.transport.nu, cfg.transport.rho_f)
    kw = dict(counts=bins.counts)
    plain = cw.window_exchange_padded_reference(*args, **kw)
    kern = cw.window_exchange_padded(*args, **kw)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, k, p in (("stks", kern[0], plain[0]), ("pres", kern[2], plain[2])):
        if k.shape != p.shape or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"window kernel {name}: shape {tuple(k.shape)} "
                                 f"vs {tuple(p.shape)} or non-finite values")
        err = (k - p).abs().flatten(2).amax(-1)
        scale = p.abs().flatten(2).amax(-1)
        # f32 sums in the same order as the plain version; exp and pow of the
        # CUDA math library and of PyTorch's kernels may differ by an ulp
        if not bool((err <= KERNEL_RTOL * scale + 1e-30).all()):
            raise AssertionError(f"window kernel {name} disagrees with its plain "
                                 f"version: max err/scale {float((err / scale).max()):.3e}")
        max_err = max(max_err, float(err.max()))
    print(f"kernel window_exchange: max_abs_err {max_err:.3e} "
          f"(within {KERNEL_RTOL:g} of each channel's scale)", flush=True)
    ms = cuda_ms(lambda: cw.window_exchange_padded(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: cw.window_exchange_padded_reference(*args, **kw), 5)
    return {"name": "window_exchange", "route": "cuda",
            "source": "yade_openfoam_coupling_tpu_torch/csrc/window_exchange.cu",
            "replaces": "yade_openfoam_coupling_tpu/ops/coupling_window.py:162",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def slice_phase(cfg, device, card):
    """The main path at full size, as bench.py runs it."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw

    cw.window_exchange_padded.launches = 0
    t0 = time.perf_counter()
    state = initial_state(cfg, N_PARTICLES, device)
    run = cd.make_scan_fn(cfg, STEPS_PER_RUN)
    state, diags = run(state)                       # warm-up
    torch.cuda.synchronize()
    print(f"slice set-up + warm-up {STEPS_PER_RUN} steps: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    all_diags = []
    for _ in range(TIMED_RUNS):
        state, diags = run(state)
        all_diags.append(diags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cw.window_exchange_padded.launches
    n_steps = STEPS_PER_RUN * (1 + TIMED_RUNS)

    d = {k: torch.cat([getattr(x, k).reshape(-1) for x in all_diags]).cpu().numpy()
         for k in all_diags[0]._fields}
    p_final = float(d["p_final_residual"].max())
    p_init = float(d["p_initial_residual"].max())
    cont = float(np.abs(d["cont_err_local"]).max())
    n_over = int(d["n_contact_overflow"].max() + d["n_coupling_overflow"].max())
    if not p_final <= max(1e-5 * max(p_init, 1e-30), 5e-6):
        raise AssertionError(f"pressure solve not converged: final {p_final:g} vs initial {p_init:g}")
    if not cont < 1e-5:
        raise AssertionError(f"continuity error {cont:g}")
    if n_over != 0:
        raise AssertionError(f"capacity overflows: {n_over}")
    fs, ps = state.fluid, state.particles
    for name, t in (("u", fs.u), ("p", fs.p), ("alpha", fs.alpha), ("pos", ps.pos),
                    ("vel", ps.vel), ("nut", state.turb.nut)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")
    if launches < n_steps:
        raise AssertionError(f"window kernel launched {launches} times in {n_steps} steps")
    steps_per_sec = TIMED_RUNS * STEPS_PER_RUN / wall
    print(f"slice {N_PARTICLES} particles {NX}^3: {steps_per_sec:.3f} coupled steps/s "
          f"[{card}]; p_iters {d['p_iters'].min()}-{d['p_iters'].max()}, p residual "
          f"{p_final:.3e}, continuity {cont:.3e}, overflows {n_over}, window kernel "
          f"launches {launches} in {n_steps} steps", flush=True)
    return launches


def small_check(device):
    """The CUDA path against the CPU path (plain versions) of the same port
    on a 16^3 case with 400 moving particles, 4 steps: the state agrees to
    1e-3 of each field's scale (f32 arithmetic in another order, amplified
    by stiff contacts and the pressure solve's 1e-5 tolerance)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd

    cfg = bench_config(16)
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, list_rebuild_steps=2))
    out = {}
    for dev in (device, torch.device("cpu")):
        state = initial_state(cfg, 400, dev, vel_scale=1e-2)
        state, diags = cd.make_scan_fn(cfg, 4)(state)
        out[dev.type] = (state, diags)
    (gs, gd), (cs, cd_) = out["cuda"], out["cpu"]
    if not torch.equal(gd.p_iters.cpu(), cd_.p_iters):
        print(f"note: p_iters cuda {gd.p_iters.tolist()} cpu {cd_.p_iters.tolist()}")
    worst = 0.0
    for name, g, c in (("u", gs.fluid.u, cs.fluid.u), ("p", gs.fluid.p, cs.fluid.p),
                       ("alpha", gs.fluid.alpha, cs.fluid.alpha),
                       ("pos", gs.particles.pos, cs.particles.pos),
                       ("vel", gs.particles.vel, cs.particles.vel)):
        rel = float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"small case: {name} on the GPU differs from the CPU "
                                 f"path by {rel:.3e} of its scale")
    print(f"small case 16^3/400, 4 steps: GPU (kernels) vs CPU (plain) worst "
          f"relative difference {worst:.3e}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from yade_openfoam_coupling_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    kernels.library()
    lib = kernels.library_path()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {lib.name}",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    cfg = bench_config(NX)
    entry = kernel_phase(cfg, device)
    print(f"window_exchange at {NX}^3/{N_PARTICLES}: kernel {entry['ms']:.3f} ms, "
          f"plain {entry['plain_ms']:.3f} ms [{smi}]", flush=True)
    entry["launches"] = slice_phase(cfg, device, smi)
    small_check(device)

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
