#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout
(one nvcc per source, all at once), checks each against its plain PyTorch
version at the main paths' shapes (bench.py's 100k particles on a 128^3
channel), and drives through `initialize_state` and `make_scan_fn`:

  * the window slice: bench.py's configuration (window exchange, frozen
    Verlet list, kEqn, PIMPLE with fftpcg);
  * the planes slice: the same case with the CLI's `--fast` coupling
    (planes exchange, fused kernel);
  * the two-kernel planes path (`fused_planes=False`);
  * the CLI slice: `python -m yade_openfoam_coupling_tpu_torch pimplefoam
    <case>` on a 128^3 channel case directory written to a temporary
    directory, 100k random particles, 20 steps (sparse exchange with
    kernel B3, one Verlet list per step, mgpcg); then the configuration the
    CLI's set-up builds, through the bench's checks, and one 10-step chunk
    of it with `use_pallas` (kernel B2 in every matvec on sides >= 8);
  * the PISO slice: `icofoam <case>` on a 128^3 closed box (point-force
    exchange, B3 over the 8 trilinear corners, PISO with mgpcg) the same
    way, with its `use_pallas` chunk; and the settling sphere, whose
    terminal velocity must be Stokes';
  * B7, the per-plane dynamic-trip-count staging of the prototype
    `scripts/proto_dynwin.py`, through its own script;
  * the k-d tree locator (`native/`): a tree over the 128^3 grid's
    2,097,152 cell centres uploaded to the card, `nearest` at the 100k
    particles, `range_query` at r = 1.5h from each particle's cell centre
    (the 19 `sphere2` cells) and `bin_points`, each query call ordered by
    the keys kernel; both tree kernels bit for bit against the host
    library in lattice order and on a shuffle, `nearest` against `locate`;
  * the planes slice's CLI with more than 8 slots a cell: `pimplefoam
    --fast --slot-capacity 9 <case>`, a few steps;
  * the `--yade-physics` slice: bench.py's configuration with the
    tangential spring history, dynamic substeps (up to 8, the count from
    the Rayleigh critical dt), the rows pair layout and no carried contact;
  * the rest of the fluid: `pimplefoam <case>` on a RAS kEpsilon case
    with adjustTimeStep and on an LES Smagorinsky case; the kEpsilon slice
    (the CLI slice's configuration with kEpsilon and implicit momentum
    diffusion, B2 in the pressure and the Helmholtz momentum solves); a
    10-step chunk of it with adjustTimeStep from a stiff start (nut 1e-2,
    dt 1e-5: dt must pass 3x the explicit-diffusion bound); a
    Smagorinsky chunk; a `use_pallas` chunk with the bf16 V-cycle (B2's
    bf16 entry); a `fixed_iters` chunk whose CG iterations run under
    `torch.cuda.set_sync_debug_mode("error")`;
  * the slots slice: the window slice's configuration with the slot-table
    exchange (its deposit is B3), and the sparse exchange at
    `stencil_width=5` (B3 with 125 taps) on a 96^3 grid;
  * the slab-sharded path (`parallel/`): the window slice's configuration
    through `make_sharded_scan` on a one-rank NCCL mesh (20 steps, two
    chunks) against `make_scan_fn` from the same state by pid, its
    ms/step beside the single-device one (timed in turns) and a
    `PhaseTimer` split; two ranks sharing the card on gloo (10 steps,
    halos staged through host memory) against the same single-device run;
    one 10-step chunk each of the sharded sparse (B3 through the slab
    deposit), planes (B4) and two-kernel planes (B5 + B6) exchanges and of
    the window slice with mgpcg under `use_pallas` (B2 on the ring-padded
    slab); each sharded kernel against its plain version at the slab's
    shapes;
  * the bench entry points at full size: `scripts/bench_1m.py`'s default
    case (1M particles on 256^3, the planes exchange in 8 slabs, mgpcg)
    and its `--fast` case (the window exchange, fftpcg) through its own
    `build_case` and `measure`, with B4 on a 256^3 slab and B1 on the 1M
    window against their plain versions and the 8-slab exchange against
    the whole-grid one; `scripts/bench_ladder.py`'s ladder #2 (PISO, B3
    at 8 x 3) and #3 (the fluidized bed, B1 at 6 slots) with a stage
    split each; and `python -m yade_openfoam_coupling_tpu_torch bench
    --small` as a subprocess;
B2's bf16 entry is held bit for bit against the plain stencil at every
level of the 128^3 V-cycle on which it runs and through one whole bf16
V-cycle; the float32 Jacobi V-cycle's kernels (`csrc/mg_vcycle.cu`) are
held against their plain versions on the 256^3 channel, each at level 0
and through one whole V-cycle of the 1M configuration (55 launches), and
the 1M bench case must launch them; the fused DEM substep's kernels
(`csrc/dem_substep.cu`) are held bit for bit against the plain substep
loop at 10k particles in 128^3 and 1M in 256^3 with pushed contacts, wall
contacts and wraps, and the window slice and both 1M bench cases must
launch them 1 + 4 times a step; the `use_pallas` chunks (f32 and bf16 V-cycle) print the
card's busy share over one pressure solve (`torch.profiler`). It
then holds B1, B4 and B6 at slot capacities 9 and 16 against their plain
versions on a crowded lattice, the 4-slab chunked planes exchange against
the whole-grid one, checks the bench's health conditions and that each
path went through its kernels, and checks the CUDA path against the CPU
path of the same port on a small case for the window, planes and sparse
exchanges, for PISO with a box obstacle and for the `--yade-physics`
configuration with loaded springs.

Prints the card's name and power limit, one JSON line describing the
kernels (times, the least time the card could take, and a PyTorch call's
time where one computes the same function), and as its last line
{"ok": true, "device": {...}}. Exits non-zero without printing that line
when there is no CUDA device, when a kernel does not build or disagrees,
or when any check fails.
"""

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

from yade_openfoam_coupling_tpu_torch.bench import bench_config, lattice_positions, sync
from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.scripts.exchange_timing import (
    cuda_ms,
    launch_split,
    peak_mb,
)

NX, N_PARTICLES, RADIUS, DT = 128, 100_000, 4e-4, 5e-5
STEPS_PER_RUN, TIMED_RUNS = 10, 2
CAPACITIES = (9, 16)          # slot capacities past one byte of rank bits
KERNEL_RTOL = 1e-5
JAX_OPS = "yade_openfoam_coupling_tpu/ops/"
JAX_NATIVE = "yade_openfoam_coupling_tpu/native/"
PORT_CSRC = "yade_openfoam_coupling_tpu_torch/csrc/"
W_CHUNK = 512                 # the prototype's staging chunk (proto_dynwin.py)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
CLI_ARGS = ["--random-particles", str(N_PARTICLES), "--radius", str(RADIUS), "--kn", "100",
            "--dem-substeps", "4", "--chunk", "10"]
# the CLI's own initial turbulence state (k0 1e-6, eps 0), and the
# kEpsilon slice's: k 1e-4 m^2/s^2, eps 9e-5 m^2/s^3, nut = C_mu k^2/eps =
# 1e-5 m^2/s (10 nu), whose explicit k and eps transport is stable at dt 5e-5
CLI_TURB, KEPS_TURB = (1e-6, 0.0), (1e-4, 9e-5)
# tests/test_implicit_diffusion.py's stiff start for the adjusted-dt chunk:
# nut = 0.09 * 1e-4 / 9e-4 = 1e-2 m^2/s, dt from 1e-5 growing 1.2x a step
STIFF_TURB, STIFF_DT = (1e-2, 9e-4), 1e-5
CLOSURES = {"kEqn": "simulationType LES; LES { LESModel kEqn; }",
            "kEpsilon": "simulationType RAS; RAS { RASModel kEpsilon; }",
            "Smagorinsky": "simulationType LES; LES { LESModel Smagorinsky; }"}


def planes_config(cfg, **coupling_kw):
    """cfg with the CLI's `--fast` coupling (cli.py): the planes exchange,
    'col' staging, dy in the kernel, packed unbin."""
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    coupling = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                 exchange="planes", slot_capacity=4, packed_bin="col",
                                 dy_in_kernel=True, packed_unbin=True)
    return dataclasses.replace(cfg, coupling=dataclasses.replace(coupling, **coupling_kw))


def closing_pairs(n, length, n_pairs=16, seed=2):
    """bench.py's jittered lattice of n - n_pairs particles over the box's
    middle 80%, with a partner for n_pairs of its sites 13.75 um short of
    contact, closing at 0.2 m/s and sliding at ~1.4 mm/s (the rest at ~1
    mm/s): each pair touches in the second step and stays in contact past
    the fourth, so its springs load. -> numpy (pos, vel)."""
    rng = np.random.RandomState(seed)
    m = n - n_pairs
    k = int(np.ceil(m ** (1 / 3)))
    sites = np.stack(np.meshgrid(*[np.linspace(0.1 * length, 0.9 * length, k)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)[:m]
    sites += rng.uniform(-0.05 * length / k, 0.05 * length / k, sites.shape)
    vel = 1e-3 * rng.randn(m, 3)
    paired = rng.choice(m, n_pairs, replace=False)
    d = 1.0 + 0.2 * rng.randn(n_pairs, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    slide = 1e-3 * rng.randn(n_pairs, 3)
    vel[paired] -= np.sum(vel[paired] * d, axis=1, keepdims=True) * d
    slide -= np.sum(slide * d, axis=1, keepdims=True) * d
    return (np.concatenate([sites, sites[paired] + (2 * RADIUS + 1.375e-5) * d]),
            np.concatenate([vel, vel[paired] + slide - 0.2 * d]))


def initial_state(cfg, n, device, vel_scale=0.0, particles=None, turb=CLI_TURB, dt=DT):
    """The bench lattice (velocities vel_scale x seeded normals), or the
    (pos, vel) that particles(n, box length) returns, and a uniform
    turbulence state (k0, eps0), through `initialize_state` on device
    with the initial dt."""
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)
    if particles is None:
        pos = lattice_positions(n, cfg.grid.lengths[0])
        vel = vel_scale * np.random.RandomState(1).randn(n, 3)
    else:
        pos, vel = particles(n, cfg.grid.lengths[0])
    return cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(pos, device, vel=vel, radius=RADIUS),
        make_turbulence_state(cfg.grid, device, k0=turb[0], eps0=turb[1]), cfg, dt=dt)


def kernel_times(fn, reps=20):
    """(host-inclusive, device-only) milliseconds of fn, as `cuda_ms` reads them."""
    return cuda_ms(fn, reps), cuda_ms(fn, reps, device_only=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops):
    """The least time the card could take for the work: the bytes it must
    move at the HBM rate, or its float32 operations at the peak rate,
    whichever is longer. -> {"bound_ms", "bound_by"}."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def exchange_flops(n_occ, n_off, C_in):
    """Operations of a slot exchange over n_occ occupied slots: per stencil
    offset three Gaussian factors and a weight, C_in interpolation and 8
    deposit multiply-adds; ~100 for the force laws."""
    return n_occ * (n_off * (2 * C_in + 16 + 10) + 100)


def slot_table_bytes(D):
    """What a planes kernel must read of the slot table D (C_d, cap, ncl):
    the radius plane for every slot, the other channels for the occupied
    slots only."""
    n_occ = int((D[6] > 0).sum())
    return nbytes(D[6]) + (D.shape[0] - 1) * n_occ * D.element_size(), n_occ


def check_close(kernel, name, k, p):
    """The kernel's output k against the plain version's p: same shape,
    finite, and within KERNEL_RTOL of each output channel's scale (f32 sums
    in the same order as the plain version; exp and pow of the CUDA math
    library and of PyTorch's kernels may differ by an ulp). -> max abs err."""
    import torch
    if k.shape != p.shape or not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{kernel} {name}: shape {tuple(k.shape)} vs "
                             f"{tuple(p.shape)} or non-finite values")
    rows = k.shape[0] * (k.shape[1] if k.dim() > 2 else 1)
    err = (k - p).abs().reshape(rows, -1).amax(-1)
    scale = p.abs().reshape(rows, -1).amax(-1)
    if not bool((err <= KERNEL_RTOL * scale + 1e-30).all()):
        raise AssertionError(f"{kernel} {name} disagrees with its plain version: "
                             f"max err/scale {float((err / scale).max()):.3e}")
    return float(err.max())


def seeded_inputs(cfg, device, C_in, seed=0, n=N_PARTICLES):
    """The bench lattice of n particles with seeded velocities and angular
    velocities, and a seeded padded fluid stack of C_in channels (alpha
    last, in [0.9, 1])."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.ops.coupling_planes import pad_wrap_zero

    grid = cfg.grid
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = torch.as_tensor(lattice_positions(n, grid.lengths[0]), dtype=torch.float32,
                          device=device)
    vel = 1e-2 * torch.randn(pos.shape, generator=gen, device=device)
    ang = 1e-1 * torch.randn(pos.shape, generator=gen, device=device)
    pf = cp.ParticleFields(pos, vel, ang, torch.full((n,), RADIUS, device=device),
                           torch.ones(n, dtype=torch.bool, device=device))
    F = 1e-2 * torch.randn((C_in,) + grid.shape, generator=gen, device=device)
    F[-1] = 0.9 + 0.1 * torch.rand(grid.shape, generator=gen, device=device)
    return pf, F, pad_wrap_zero(F, cfg.periodic_axes())


def crowded_inputs(cfg, device, C_in, crowds=100, per_crowd=20):
    """`seeded_inputs` with its last crowds * per_crowd particles moved into
    `crowds` seeded cells, per_crowd to a cell: ranks past 16 are filled,
    and 9 or 16 slots a cell overflow."""
    import torch
    pf, F, Fp = seeded_inputs(cfg, device, C_in)
    grid = cfg.grid
    rng = np.random.RandomState(5)
    n = crowds * per_crowd
    cells = rng.choice(grid.ncells, crowds, replace=False)
    idx = np.stack(np.unravel_index(cells, grid.shape), 1).repeat(per_crowd, 0)
    pos = (idx + rng.uniform(0.05, 0.95, idx.shape)) * np.asarray(grid.spacing) + np.asarray(
        grid.origin)
    moved = pf.pos.clone()
    moved[-n:] = torch.as_tensor(pos, dtype=torch.float32, device=device)
    return pf._replace(pos=moved), F, Fp


def window_kernel_phase(cfg, device, extras=False):
    """The window kernel against its plain version at the main path's
    shapes; `extras` adds the torque and added-mass channels (C_in 16,
    C_d 10, 7 result channels)."""
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw

    ccfg = dataclasses.replace(cfg.coupling, use_torque=extras, use_added_mass=extras)
    grid = cfg.grid
    pf, _, Fp = seeded_inputs(cfg, device, 16 if extras else 10)
    W = cw.window_size(N_PARTICLES, grid.shape[0], ccfg.planes_window)
    bins = cw.window_bins(pf, grid, ccfg.slot_capacity, W, with_angvel=extras)
    args = (Fp, bins.dat_win, grid, cfg.periodic_axes(), ccfg, 0,
            cfg.transport.nu, cfg.transport.rho_f)
    kw = dict(counts=bins.counts)
    plain = cw.window_exchange_padded_reference(*args, **kw)
    kern = cw.window_exchange_padded(*args, **kw)
    name = "window_exchange" + (" (torque, added mass)" if extras else "")
    max_err = max(check_close(name, "stks", kern[0], plain[0]),
                  check_close(name, "pres", kern[2], plain[2]))
    if extras and not float(kern[2][3:6].abs().max()) > 0.0:
        raise AssertionError(f"{name}: the torque channels are zero")
    print(f"kernel {name}: max_abs_err {max_err:.3e} "
          f"(within {KERNEL_RTOL:g} of each channel's scale)", flush=True)
    ms = cuda_ms(lambda: cw.window_exchange_padded(*args, **kw), 20)
    dev_ms = cuda_ms(lambda: cw.window_exchange_padded(*args, **kw), 20, device_only=True)
    plain_ms = cuda_ms(lambda: cw.window_exchange_padded_reference(*args, **kw), 5)
    peak, above = peak_mb(lambda: cw.window_exchange_padded(*args, **kw))
    print(f"kernel {name}: {ms:.4f} ms, {dev_ms:.4f} ms device only; peak device memory of "
          f"one call {peak:.1f} MB, {above:.1f} MB above its inputs", flush=True)
    # inputs: Fp, the live window rows, counts; outputs: the stacks, pres
    live = int(bins.counts.clamp(max=W).sum())
    n_bytes = (nbytes(Fp, bins.counts, *kern[::2])
               + live * bins.dat_win.shape[1] * bins.dat_win.element_size())
    n_occ = int(bins.keep.sum())
    return {"max_abs_err": max_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(n_bytes, exchange_flops(n_occ, 19, Fp.shape[0])), "library_ms": None}


def planes_kernel_phase(cfg, device):
    """The fused, interpolation and deposit planes kernels against their
    plain versions at the planes slice's shapes (whole grid, x_off 0)."""
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp

    grid, ccfg, periodic = cfg.grid, cfg.coupling, cfg.periodic_axes()
    nu, rho_f = cfg.transport.nu, cfg.transport.rho_f
    pf, _, Fp = seeded_inputs(cfg, device, 10)
    D = cpp.bin_particles_planes(pf, grid, ccfg.slot_capacity,
                                 packed_bin=ccfg.packed_bin).D
    out = {}

    d_bytes, n_occ = slot_table_bytes(D)
    flops = exchange_flops(n_occ, 19, Fp.shape[0])
    args = (Fp, D, grid, periodic, ccfg, 0, nu, rho_f)
    # the bound on occupied slots that the planes exchange passes
    fused = lambda: cpp.fused_exchange_padded(*args, max_occupied=N_PARTICLES)  # noqa: E731
    plain = cpp.fused_exchange_padded_reference(*args)
    kern = fused()
    err = max(check_close("planes_fused", "stks", kern[0], plain[0]),
              check_close("planes_fused", "pres", kern[2], plain[2]))
    out["planes_fused"] = (err, *kernel_times(fused),
                           cuda_ms(lambda: cpp.fused_exchange_padded_reference(*args), 5),
                           bound(nbytes(Fp, kern[0], kern[2]) + d_bytes, flops))
    peak, above = peak_mb(fused)
    print(f"kernel planes_fused: peak device memory of one call {peak:.1f} MB, {above:.1f} MB "
          "above its inputs", flush=True)

    iargs = (Fp, D, grid, periodic, ccfg, 0)
    G_p, n_p = cpp.interp_planes_padded_reference(*iargs)
    G_k, n_k = cpp.interp_planes_padded(*iargs)
    err = max(check_close("planes_interp", "G", G_k, G_p),
              check_close("planes_interp", "norm", n_k, n_p))
    out["planes_interp"] = (err, *kernel_times(lambda: cpp.interp_planes_padded(*iargs)),
                            cuda_ms(lambda: cpp.interp_planes_padded_reference(*iargs), 5),
                            bound(nbytes(Fp, G_k, n_k) + d_bytes, flops))

    V, _, _, _ = cpp._physics_planes(D, G_p, n_p, grid.cell_volume, nu, rho_f, ccfg)
    inv = 1.0 / n_p.where(n_p > 0, 1.0)
    Vn = (V * inv.where(n_p > 0, 0.0)[None]).contiguous()
    dargs = (Vn, D, grid.shape[0], grid, periodic, ccfg, 0)
    # the bound on occupied slots that the two-kernel planes exchange passes
    deposit = lambda: cpp.deposit_stacks(*dargs, max_occupied=N_PARTICLES)  # noqa: E731
    plain = cpp.deposit_stacks_reference(*dargs)
    kern = deposit()
    err = check_close("planes_deposit", "stks", kern[0], plain[0])
    # the occupied slots' V, the radius plane and their positions in D
    v_bytes = Vn.shape[0] * n_occ * Vn.element_size()
    out["planes_deposit"] = (err, *kernel_times(deposit),
                             cuda_ms(lambda: cpp.deposit_stacks_reference(*dargs), 5),
                             bound(nbytes(kern[0], D[6]) + v_bytes + 3 * n_occ * 4, flops))
    peak, above = peak_mb(deposit)
    print(f"kernel planes_deposit: peak device memory of one call {peak:.1f} MB, {above:.1f} MB "
          "above its inputs", flush=True)
    for name, (err, ms, dev_ms, plain_ms, _) in out.items():
        print(f"kernel {name}: max_abs_err {err:.3e} (within {KERNEL_RTOL:g} of each "
              f"channel's scale); kernel {ms:.4f} ms ({dev_ms:.4f} ms device only), plain "
              f"{plain_ms:.3f} ms", flush=True)
    return {name: {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   **b, "library_ms": None}
            for name, (err, ms, dev_ms, plain_ms, b) in out.items()}


def rolls_kernel_phase(device, offsets, C):
    """B3 against its plain version at a path's shapes: a seeded
    offset-major anchor buffer (S*C, anchor_row_length) seen as (S, C,
    128^3), as the deposit hands it over (the sparse exchange's cube
    stencil with C = 4, and at stencil_width 5 with 125 taps; the
    point-force exchange's 8 corners with C = 3; the slots exchange's
    sphere2 stencil with C = 8). Times the kernel, the plain roll loop and
    one circular Conv3d with one-hot weights w[c, o*C + c, r - dx, r - dy,
    r - dz] = 1, r the widest offset (TF32 off), which computes the same
    function and which the port does not use."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp

    S = len(offsets)
    ncells = NX ** 3
    gen = torch.Generator(device=device).manual_seed(3)
    buf = torch.randn((S * C, cp.anchor_row_length(ncells)), generator=gen, device=device)
    return rolls_entry(buf[:, :ncells].view((S, C) + (NX,) * 3), offsets)


def rolls_entry(bufT, offsets):
    """B3 on one (S, C, nx, ny, nz) anchor buffer against its plain version
    and against a circular Conv3d of one-hot weights (`rolls_kernel_phase`)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import rolls

    S, C = bufT.shape[:2]
    shape = tuple(bufT.shape[2:])
    ncells = int(np.prod(shape))
    plain = rolls.distribute_rolls_reference(bufT, offsets)
    kern = rolls.distribute_rolls(bufT, offsets)
    err = check_close("rolls_deposit", "out", kern, plain)

    r = int(np.abs(offsets).max())
    conv = torch.nn.Conv3d(S * C, C, 2 * r + 1, padding=r, padding_mode="circular",
                           bias=False, device=bufT.device)
    with torch.no_grad():
        conv.weight.zero_()
        for o, (dx, dy, dz) in enumerate(offsets):
            for c in range(C):
                conv.weight[c, o * C + c, r - dx, r - dy, r - dz] = 1.0
        x = bufT.reshape((1, S * C) + shape).contiguous()
        lib = conv(x)[0]
        lib_err = float((lib - plain).abs().max())
        library_ms = cuda_ms(lambda: conv(x), 5)
    del x, conv
    ms = cuda_ms(lambda: rolls.distribute_rolls(bufT, offsets), 20)
    dev_ms = cuda_ms(lambda: rolls.distribute_rolls(bufT, offsets), 20, device_only=True)
    plain_ms = cuda_ms(lambda: rolls.distribute_rolls_reference(bufT, offsets), 5)
    print(f"kernel rolls_deposit (S={S}, C={C}, {shape}): max_abs_err {err:.3e}; kernel "
          f"{ms:.3f} ms ({dev_ms:.4f} ms device only), plain {plain_ms:.3f} ms, Conv3d "
          f"{library_ms:.3f} ms (its max abs difference {lib_err:.3e})", flush=True)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(nbytes(bufT, kern), S * C * ncells), "library_ms": library_ms}


def laplacian_kernel_phase(device):
    """B2 against its plain version at 128^3: seeded p padded with the
    channel's pressure BCs (periodic x/y, zero-gradient z) and random face
    coefficients. No single PyTorch call computes it (library_ms null)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid, pad_scalar

    grid = Grid.cube(NX, 1e-3 * NX)
    gen = torch.Generator(device=device).manual_seed(4)
    pp = pad_scalar(torch.randn(grid.shape, generator=gen, device=device),
                    FluidBCs.channel_z().p)
    n = NX
    gamma_f = tuple(0.5 + torch.rand(s, generator=gen, device=device)
                    for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
    return laplacian_entry(gamma_f, pp, grid, "laplacian")


def laplacian_entry(gamma_f, pp, grid, label):
    """B2 on one padded field against its plain version: its kernels-line
    entry. No single PyTorch call computes it (library_ms null)."""
    from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
    from yade_openfoam_coupling_tpu_torch.ops.stencil import laplacian_facegamma_padded

    plain = laplacian_facegamma_padded(gamma_f, pp, grid)
    kern = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
    err = check_close(label, "out", kern[None], plain[None])
    ms = cuda_ms(lambda: fs.laplacian_facegamma_fused(gamma_f, pp, grid), 50)
    dev_ms = cuda_ms(lambda: fs.laplacian_facegamma_fused(gamma_f, pp, grid), 50,
                     device_only=True)
    plain_ms = cuda_ms(lambda: laplacian_facegamma_padded(gamma_f, pp, grid), 20)
    print(f"kernel {label} (padded {tuple(pp.shape)}): max_abs_err {err:.3e}; kernel "
          f"{ms:.4f} ms ({dev_ms:.4f} ms device only), plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(nbytes(pp, *gamma_f, kern), 25 * kern.numel()), "library_ms": None}


def laplacian_bf16_kernel_phase(device, card):
    """B2's bf16 entry against the plain stencil run on the same bf16
    tensors, torch.equal, at every level of the 128^3 V-cycle on which it
    runs (128, 64, 32, 16, 8), with the channel's ghosts; each level's
    times (host-inclusive and device only) and bound printed, the 128^3
    level's returned. No single PyTorch call computes it (library_ms
    null)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid, pad_scalar
    from yade_openfoam_coupling_tpu_torch.ops.stencil import laplacian_facegamma_padded

    bf = torch.bfloat16
    levels = {}
    n = NX
    while n >= 8:
        grid = Grid.cube(n, 1e-3 * NX)
        gen = torch.Generator(device=device).manual_seed(4)
        pp = pad_scalar(torch.randn(grid.shape, generator=gen, device=device).to(bf),
                        FluidBCs.channel_z().p)
        gamma_f = tuple((0.5 + torch.rand(s, generator=gen, device=device)).to(bf)
                        for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
        plain = laplacian_facegamma_padded(gamma_f, pp, grid)
        kern = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
        if kern.dtype != bf or not bool(torch.isfinite(kern).all()):
            raise AssertionError(f"laplacian_bf16 {n}^3: dtype {kern.dtype} or non-finite values")
        err = float((kern.float() - plain.float()).abs().max())
        if err != 0 or not torch.equal(kern, plain):
            raise AssertionError(f"laplacian_bf16 {n}^3 is not bit for bit with its plain "
                                 f"version: max err {err:.3e}")
        ms = cuda_ms(lambda: fs.laplacian_facegamma_fused(gamma_f, pp, grid), 50)
        dev_ms = cuda_ms(lambda: fs.laplacian_facegamma_fused(gamma_f, pp, grid), 50,
                         device_only=True)
        plain_ms = cuda_ms(lambda: laplacian_facegamma_padded(gamma_f, pp, grid), 20)
        levels[n] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     **bound(nbytes(pp, *gamma_f, kern), 25 * n ** 3), "library_ms": None}
        print(f"kernel laplacian_bf16 ({n}^3): bit for bit; kernel {ms:.4f} ms ({dev_ms:.4f} "
              f"ms device only), plain {plain_ms:.4f} ms, bound {levels[n]['bound_ms']:.4f} ms "
              f"({levels[n]['bound_by']}), device share of bound "
              f"{levels[n]['bound_ms'] / dev_ms:.2f} [{card}]", flush=True)
        n //= 2
    return levels[NX]


def bf16_vcycle_phase(device, card):
    """One whole bf16 V-cycle (MGConfig.bf16) of the 128^3 channel's
    pressure operator on the card, through B2's bf16 entry (every level of
    sides >= 8) and through the plain stencil: the two corrections are
    torch.equal."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid, pad_scalar
    from yade_openfoam_coupling_tpu_torch.ops.stencil import face_interp_all_padded

    grid = Grid.cube(NX, 1e-3 * NX)
    gen = torch.Generator(device=device).manual_seed(5)
    gamma = 0.5 + torch.rand(grid.shape, generator=gen, device=device)
    bc = FluidBCs.channel_z().p.homogeneous()
    gamma_f = face_interp_all_padded(pad_scalar(gamma, FluidBCs.channel_z().p.homogeneous()))
    r = torch.randn(grid.shape, generator=gen, device=device)
    cfg = pr.MGConfig(bf16=True)
    M_kern = pr.make_mg_preconditioner(gamma_f, grid, bc, cfg, use_pallas=True)
    M_plain = pr.make_mg_preconditioner(gamma_f, grid, bc, cfg, use_pallas=False)
    before = LAUNCHES["yofc_laplacian_bf16"]
    kern = M_kern(r)
    per_cycle = LAUNCHES["yofc_laplacian_bf16"] - before
    plain = M_plain(r)
    if per_cycle == 0 or not bool(torch.isfinite(kern).all()) or not torch.equal(kern, plain):
        raise AssertionError(f"bf16 V-cycle: {per_cycle} bf16 launches; the kernel's "
                             f"correction differs from the plain stencil's by "
                             f"{float((kern - plain).abs().max()):.3e}")
    ms_kern = cuda_ms(lambda: M_kern(r), 10)
    ms_plain = cuda_ms(lambda: M_plain(r), 10)
    print(f"bf16 V-cycle at {NX}^3: kernel path == plain path (torch.equal), {per_cycle} B2 "
          f"bf16 launches a cycle; {ms_kern:.3f} ms a cycle (plain stencil {ms_plain:.3f} ms) "
          f"[{card}]", flush=True)


@contextlib.contextmanager
def plain_mg(record=None):
    """While active, `mg_fused`'s wrappers run their plain versions on CUDA
    tensors too, each level's inverse diagonal built once (the V-cycle's
    operations as plain PyTorch on the card); with ``record`` (a list), the
    wrappers run as they are and append each call's bytes instead (its
    inputs once and its output)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import mg_fused as mg
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr

    diags = {}

    def with_diag(level):
        key = level.gamma_f[0].data_ptr()
        if key not in diags:
            diags[key] = pr.inverse_diag(level.gamma_f, level.grid, level.bc)
        return level._replace(inv_diag=diags[key])

    def counted(fn):
        def run(level, *a, **kw):
            out = fn(level, *a, **kw)
            record.append(nbytes(*level.gamma_f, out, *(t for t in (*a, *kw.values())
                                                        if isinstance(t, torch.Tensor))))
            return out
        return run

    names = ("jacobi", "residual_restrict", "coarse")
    reals = {n: getattr(mg, n) for n in names}
    for n in names:
        plain = getattr(mg, n + "_plain")
        setattr(mg, n, counted(reals[n]) if record is not None else
                (lambda level, *a, _p=plain, **kw: _p(with_diag(level), *a, **kw)))
    try:
        yield
    finally:
        for n in names:
            setattr(mg, n, reals[n])


def mg_vcycle_phase(device, card, n=256):
    """The fused Jacobi V-cycle (csrc/mg_vcycle.cu) on the n^3 channel's
    pressure operator (periodic x/y, zero-gradient z; face coefficients in
    [0.5, 1.5)): each kernel at level 0 (the coarse one at 4^3) and one
    whole V-cycle of the 1M configuration (4 + 4 sweeps, 20 coarse) against
    their plain versions, with times (host-inclusive and device only),
    the plain version's and the bound (bytes once at the HBM rate). The
    V-cycle's launches counted (55 at 256^3). -> kernels-line entries."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
    from yade_openfoam_coupling_tpu_torch.ops import mg_fused as mg
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid

    grid = Grid.cube(n, 1e-3 * n)
    bc = FluidBCs.channel_z().p.homogeneous()
    gen = torch.Generator(device=device).manual_seed(6)
    gamma_f = tuple(0.5 + torch.rand(s, generator=gen, device=device)
                    for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
    level = mg.MGLevel(gamma_f, grid, bc, pr.inverse_diag(gamma_f, grid, bc))
    x, b = (torch.randn(grid.shape, generator=gen, device=device) for _ in range(2))
    ec = torch.randn((n // 2,) * 3, generator=gen, device=device)
    g4, grid4 = tuple(0.5 + torch.rand(s, generator=gen, device=device)
                      for s in ((5, 4, 4), (4, 5, 4), (4, 4, 5))), Grid.cube(4, 1e-3 * n)
    small = mg.MGLevel(g4, grid4, bc, pr.inverse_diag(g4, grid4, bc))
    b4 = torch.randn((4, 4, 4), generator=gen, device=device)
    cases = {
        "mg_jacobi": (lambda: mg.jacobi(level, x, b, 0.8),
                      lambda: mg.jacobi_plain(level, x, b, 0.8), (x, b, *gamma_f, x)),
        "mg_jacobi_prolong": (lambda: mg.jacobi(level, x, b, 0.8, ec=ec),
                              lambda: mg.jacobi_plain(level, x, b, 0.8, ec),
                              (x, ec, b, *gamma_f, x)),
        "mg_jacobi_zero": (lambda: mg.jacobi(level, None, b, 0.8),
                           lambda: mg.jacobi_plain(level, None, b, 0.8), (b, *gamma_f, b)),
        "mg_residual_restrict": (lambda: mg.residual_restrict(level, x, b),
                                 lambda: mg.residual_restrict_plain(level, x, b),
                                 (x, b, *gamma_f, ec)),
        "mg_coarse": (lambda: mg.coarse(small, b4, 24, 0.8),
                      lambda: mg.coarse_plain(small, b4, 24, 0.8), (b4, *small.gamma_f, b4)),
    }
    out = {}
    for name, (kern_fn, plain_fn, arrays) in cases.items():
        err = check_close(name, "out", kern_fn()[None], plain_fn()[None])
        ms, dev_ms = kernel_times(kern_fn, 50)
        plain_ms = cuda_ms(plain_fn, 10)
        out[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     **bound(nbytes(*arrays), 45 * arrays[-1].numel()), "library_ms": None}
    del x, ec
    M = pr.make_mg_preconditioner(gamma_f, grid, bc, pr.MGConfig(pre_smooth=4, post_smooth=4))
    record = []
    with plain_mg(record):
        kern = M(b)
    LAUNCHES.clear()
    kern = M(b)
    per_cycle = sum(read_launches()[k] for k in MG_KERNELS)
    with plain_mg():
        plain = M(b)
        plain_ms = cuda_ms(lambda: M(b), 5)
    err = check_close("mg_vcycle", "out", kern[None], plain[None])
    ms, dev_ms = kernel_times(lambda: M(b), 20)
    out["mg_vcycle"] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        **bound(sum(record), 45 * 9 * sum(n ** 3 // 8 ** k for k in range(7))),
                        "library_ms": None}
    expected = 9 * (pr.mg_levels_for(grid) - 1) + 1
    if per_cycle != expected or len(record) != expected:
        raise AssertionError(f"mg_vcycle at {n}^3: {per_cycle} launches a V-cycle "
                             f"({len(record)} wrapper calls), {expected} expected")
    for name, e in out.items():
        where = f"{n}^3 channel" + (", 4^3" if name == "mg_coarse" else "")
        print(f"kernel {name} ({where}): max_abs_err {e['max_abs_err']:.3e}; kernel "
              f"{e['ms']:.4f} ms ({e['device_ms']:.4f} ms device only), plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}), bound / device {e['bound_ms'] / e['device_ms']:.3f} [{card}]",
              flush=True)
    print(f"mg_vcycle: {per_cycle} launches a {n}^3 V-cycle [{card}]", flush=True)
    return out


def dem_contact_case(nx, n, device, seed=0):
    """bench.py's DEM (a frozen list of 4, carried contact force, 4
    substeps, periodic x and y, walls on z) with n particles on its
    jittered lattice in the nx^3 channel (h = 1 mm, r = 0.4 mm), 2% of
    them pushed into contact with their next lattice site (5-30 um of
    overlap, closing at 0.05 m/s), 0.5% overlapping each z wall by 5-30 um
    and moving into it, 0.5% within 1 um of an x or y face and moving out;
    every 97th inactive. Seeded velocities (1e-2 m/s), angular velocities
    (1e-1 rad/s) and hydro force and torque, the force an (N, 3) view of
    an (N, 4) array as the exchange gives it; the list and the first
    contact force as the coupled step holds them. -> (args, kwargs) of
    `dem.dem_substeps`."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import dem

    cfg = bench_config(nx)
    grid, dcfg, r = cfg.grid, cfg.dem, cfg.r_max
    L = grid.lengths[0]
    rng = np.random.RandomState(seed)
    pos = lattice_positions(n, L, seed)
    vel = 1e-2 * rng.randn(n, 3)
    pairs = rng.choice(n - 1, n // 50, replace=False)
    d = rng.randn(len(pairs), 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos[pairs + 1] = pos[pairs] + (2 * r - rng.uniform(5e-6, 3e-5, (len(pairs), 1))) * d
    vel[pairs + 1] = vel[pairs] - 0.05 * d
    rest = np.setdiff1d(np.arange(n), np.concatenate([pairs, pairs + 1]))
    walls, seams = np.split(rng.choice(rest, 3 * (n // 200), replace=False), [2 * (n // 200)])
    hi = np.arange(len(walls)) % 2 == 1
    pos[walls, 2] = np.where(hi, L - r, r) + np.where(hi, 1, -1) * rng.uniform(5e-6, 3e-5,
                                                                                len(walls))
    vel[walls, 2] = np.where(hi, 0.05, -0.05)
    axis, up = np.arange(len(seams)) % 2, np.arange(len(seams)) % 4 >= 2
    pos[seams, axis] = np.where(up, L - 1e-6, 1e-6)
    vel[seams, axis] = np.where(up, 0.08, -0.08)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    pos, vel = t(pos), t(vel)
    gen = torch.Generator(device=device).manual_seed(seed)
    ang = 1e-1 * torch.randn((n, 3), generator=gen, device=device)
    radius = torch.full((n,), r, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    active[::97] = False
    hydro = dem.DEMForces(1e-9 * torch.randn((n, 4), generator=gen, device=device)[:, :3],
                          1e-13 * torch.randn((n, 3), generator=gen, device=device))
    nbr = dem.build_neighbor_list(pos, active, grid, dcfg, r)
    carried = dem.contact_forces(pos, vel, ang, radius, active, grid, dcfg, r, nbr)
    dt = torch.full((), DT / cfg.n_dem_substeps, device=device)
    return ((pos, vel, ang, radius, active, hydro, grid, dcfg, dt, cfg.n_dem_substeps, r),
            {"nbr": nbr, "carried": carried})


@contextlib.contextmanager
def plain_dem():
    """While active, `dem.dem_substeps` takes its plain loop on CUDA
    tensors too."""
    from yade_openfoam_coupling_tpu_torch.ops import dem_fused
    real = dem_fused.on_route
    dem_fused.on_route = lambda *a, **kw: False
    try:
        yield
    finally:
        dem_fused.on_route = real


def dem_substep_phase(device, card, shapes=((128, 10_000), (256, 1_000_000))):
    """The fused DEM substep (csrc/dem_substep.cu; no Pallas kernel is
    replaced: the JAX package leaves `dem_substeps` to XLA) at the two
    benchmark cells' shapes, 10k particles in 128^3 and 1M in 256^3, on
    `dem_contact_case`: one `dem_substeps` call on its kernel route
    against the plain loop on the card, torch.equal, 1 + 4 launches; times
    (host-inclusive and device only) of `pack_drift`, one substep and the
    whole call, the plain versions' and the plain loop's, and the bound
    (bytes once at the HBM rate: a particle's state, hydro force and
    torque in, its record out; a substep's record, list row and hydro
    rows in, its record out; the partners' records come from L2). ->
    kernels-line entries."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import dem
    from yade_openfoam_coupling_tpu_torch.ops import dem_fused as df

    out = {}
    for nx, n in shapes:
        args, kw = dem_contact_case(nx, n, device)
        pos, vel, ang, radius, active, hydro, grid, dcfg, dt, n_sub, r = args
        LAUNCHES.clear()
        kern = dem.dem_substeps(*args, **kw)
        launched = sum(read_launches()[k] for k in ("dem_pack_drift", "dem_substep"))
        with plain_dem():
            plain = dem.dem_substeps(*args, **kw)
        torch.cuda.synchronize()
        label = f"dem_substeps at {nx}^3/{n}"
        if launched != 1 + n_sub:
            raise AssertionError(f"{label}: {launched} kernel launches, {1 + n_sub} expected")
        for name, k, p in zip(("pos", "vel", "angvel", "n_overflow", "fc", "tc"), kern, plain):
            if not torch.equal(k, p):
                check_close(label, name, k[None], p[None])
                raise AssertionError(f"{label}: {name} is not bit for bit the plain loop's "
                                     f"(max abs err {float((k - p).abs().max()):.3e})")
        touching = int((plain[4].abs().sum(1) > 0).sum())
        carried = kw["carried"]
        rec = df.pack_drift(pos, vel, ang, radius, active, carried, hydro, grid, dcfg, dt)
        nbr = kw["nbr"]
        io = {"pack_drift": n * (9 * 4 + 4 + 1 + 6 * 4 + 6 * 4 + 12 * 4),
              "substep": n * (12 * 4 + 4 * nbr.shape[1] + 6 * 4 + 12 * 4)}
        io["substeps"] = io["pack_drift"] + n_sub * io["substep"]
        cases = {
            "pack_drift": (lambda: df.pack_drift(pos, vel, ang, radius, active, carried, hydro,
                                                 grid, dcfg, dt),
                           lambda: df.pack_drift_plain(pos, vel, ang, radius, active, carried,
                                                       hydro, grid, dcfg, dt)),
            "substep": (lambda: df.substep(rec, nbr, hydro, grid, dcfg, dt),
                        lambda: df.substep_plain(rec, nbr, hydro, grid, dcfg, dt)),
            "substeps": (lambda: dem.dem_substeps(*args, **kw), None),
        }
        for name, (kern_fn, plain_fn) in cases.items():
            key = f"dem_{name}_{nx}"
            ms, dev_ms = kernel_times(kern_fn, 50)
            if plain_fn is None:
                with plain_dem():
                    plain_ms = cuda_ms(kern_fn, 10)
            else:
                plain_ms = cuda_ms(plain_fn, 10)
            out[key] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        **bound(io[name], 0), "library_ms": None}
            e = out[key]
            print(f"kernel {key} ({nx}^3, {n} particles, {touching} touching): kernel "
                  f"{ms:.4f} ms ({dev_ms:.4f} ms device only), plain {plain_ms:.4f} ms, bound "
                  f"{e['bound_ms']:.4f} ms ({e['bound_by']}), bound / device "
                  f"{e['bound_ms'] / dev_ms:.3f} [{card}]", flush=True)
        del args, kw, kern, plain, rec
    return out


def solve_busy_share(solves, card, label):
    """The card's busy share over one pressure solve: the longest `pcg`
    call that `solves` (a SolveCounter) saw, run again, its wall time
    (host clock, synchronised) against the summed device time of its
    kernels in a `torch.profiler` trace of another run of it (one stream:
    the kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr

    a, kw = solves.longest
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pr.pcg(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pr.pcg(*a, **kw)
        torch.cuda.synchronize()
    dev_us, n_kernels = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            dev_us += t
            n_kernels += e.count
    share = dev_us / 1e3 / wall_ms
    print(f"{label}: one pressure solve ({int(res.iters)} CG iterations) {wall_ms:.3f} ms on "
          f"the host clock, {dev_us / 1e3:.3f} ms of device time in {n_kernels} launches: "
          f"card busy {share:.3f} of the solve [{card}]", flush=True)
    if dev_us <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time in a solve")
    return share


def dynwin_kernel_phase(device, label, dat, nch, ny, nz):
    """B7 against its plain version: dynamic equal to static bit for bit,
    two launches bit-identical, and within KERNEL_RTOL of each plane's scale
    of the plain one-hot version. Times the kernel (dynamic and static;
    host-inclusive, device only, and the kernel alone in a `torch.profiler`
    trace), the plain version and one batched f32 one-hot torch.bmm (TF32
    off; the one-hot and the broadcast values built outside the timed call;
    host-inclusive and device only), which computes the same function and
    which the port does not use."""
    import torch
    from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw

    args = (dat, nch, ny, nz, W_CHUNK)
    plain = dw.stage_planes_reference(*args, True)
    dyn = dw.stage_planes(*args, True)
    static = dw.stage_planes(*args, False)
    if not torch.equal(dyn, static):
        raise AssertionError(f"dynwin_staging {label}: dynamic and static differ")
    if not torch.equal(dyn, dw.stage_planes(*args, True)):
        raise AssertionError(f"dynwin_staging {label}: two launches differ")
    nxl, _, W = dat.shape
    err = check_close("dynwin_staging", label, dyn.reshape(nxl, -1), plain.reshape(nxl, -1))

    live = torch.clamp(nch.long(), 0, W // W_CHUNK) * W_CHUNK          # rows per plane
    rows = torch.arange(W, device=device)[None, :] < live[:, None]
    onehot = ((torch.arange(ny, device=device)[None, :, None] == dat[:, 1].int()[:, None, :])
              & rows[:, None, :]).float()
    E = dat[:, 0].to(torch.bfloat16).float()[:, :, None].expand(nxl, W, nz).contiguous()
    lib_err = float((torch.bmm(onehot, E) - plain).abs().max())
    library_ms = cuda_ms(lambda: torch.bmm(onehot, E), 5)
    library_dev_ms = cuda_ms(lambda: torch.bmm(onehot, E), 5, device_only=True)
    del onehot, E
    ms = cuda_ms(lambda: dw.stage_planes(*args, True), 50)
    static_ms = cuda_ms(lambda: dw.stage_planes(*args, False), 50)
    dev_ms, dev_static_ms = (cuda_ms(lambda: dw.stage_planes(*args, d), 50, device_only=True)
                             for d in (True, False))
    plain_ms = cuda_ms(lambda: dw.stage_planes_reference(*args, True), 10)
    prof = launch_split(lambda: dw.stage_planes(*args, True), 50)
    prof_ms = 1e-3 * sum(us for name, us in prof.items() if "dynwin" in name)
    n_live = int(live.sum())
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    y_split = int(dw.kernel_params(nxl, W, ny, nz, W_CHUNK, True, n_sm)[6])
    print(f"kernel dynwin_staging ({label}: {nxl} planes, W {W}, {ny}x{nz}, {n_live} live "
          f"rows, grid ({nxl}, {y_split}) on {n_sm} SMs): dynamic == static and two launches "
          f"bit for bit; "
          f"max_abs_err {err:.3e}; kernel {ms:.4f} ms dynamic, {static_ms:.4f} ms static "
          f"({dev_ms:.4f} and {dev_static_ms:.4f} ms device only; profiler {prof_ms:.4f} ms, "
          f"launches {prof}), plain {plain_ms:.4f} ms, bmm {library_ms:.4f} ms "
          f"({library_dev_ms:.4f} ms device only; its max abs difference {lib_err:.3e})",
          flush=True)
    # the live rows' value and y, nch, the output; one add per live row
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "profiler_ms": prof_ms,
            "plain_ms": plain_ms,
            **bound(n_live * 2 * dat.element_size() + nbytes(nch, dyn), n_live),
            "library_ms": library_ms, "library_device_ms": library_dev_ms}


def capacity_phase(cfg, pcfg, device, card):
    """B1, B4 and B6 at slot capacities 9 and 16 against their plain
    versions at 128^3/100k, on the bench lattice with 2,000 particles moved
    into 100 crowded cells (`crowded_inputs`); the planes kernels get the
    particle count as their record bound, as the exchanges pass it."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw

    grid, periodic = cfg.grid, cfg.periodic_axes()
    nu, rho_f = cfg.transport.nu, cfg.transport.rho_f
    pf, _, Fp = crowded_inputs(cfg, device, 10)
    gen = torch.Generator(device=device).manual_seed(6)
    for cap in CAPACITIES:
        wcfg = dataclasses.replace(cfg.coupling, slot_capacity=cap)
        bins = cw.window_bins(pf, grid, cap, cw.window_size(N_PARTICLES, NX, wcfg.planes_window))
        args = (Fp, bins.dat_win, grid, periodic, wcfg, 0, nu, rho_f)
        calls = {"window_exchange": (
            lambda: cw.window_exchange_padded(*args, counts=bins.counts),
            lambda: cw.window_exchange_padded_reference(*args, counts=bins.counts))}
        ccfg = dataclasses.replace(pcfg.coupling, slot_capacity=cap)
        pb = cpp.bin_particles_planes(pf, grid, cap)
        if int((pb.D[6] > 0).sum(0).max()) != cap or int(pb.n_overflow) == 0:
            raise AssertionError(f"capacity {cap}: the crowded lattice fills no cell")
        fargs = (Fp, pb.D, grid, periodic, ccfg, 0, nu, rho_f)
        calls["planes_fused"] = (
            lambda: cpp.fused_exchange_padded(*fargs, max_occupied=N_PARTICLES),
            lambda: cpp.fused_exchange_padded_reference(*fargs))
        V = 1e-2 * torch.randn((8, cap, grid.ncells), generator=gen, device=device)
        dargs = (V, pb.D, NX, grid, periodic, ccfg, 0)
        calls["planes_deposit"] = (
            lambda: cpp.deposit_stacks(*dargs, max_occupied=N_PARTICLES),
            lambda: cpp.deposit_stacks_reference(*dargs))
        for name, (kernel, plain) in calls.items():
            k, p = kernel(), plain()
            err = check_close(f"{name} cap {cap}", "stks", k[0], p[0])
            if name != "planes_deposit":
                err = max(err, check_close(f"{name} cap {cap}", "pres", k[2], p[2]))
            del k, p
            dev_ms = cuda_ms(kernel, 10, device_only=True)
            print(f"kernel {name}, slot capacity {cap} (crowded lattice, {int(pb.n_overflow)} "
                  f"over capacity): max_abs_err {err:.3e} (within {KERNEL_RTOL:g} of each "
                  f"channel's scale); {dev_ms:.4f} ms device only [{card}]", flush=True)


def timing_floor(device, card):
    """What `cuda_ms` reads, host-inclusive and device only, for launches
    with almost no work: a one-element torch add and B7 on one plane of
    W_CHUNK rows with a 1x1 output. The floor of the two methods, against
    which the small kernels' times are read."""
    import torch
    from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw

    x = torch.zeros(1, device=device)
    dat = torch.zeros((1, 2, W_CHUNK), device=device)
    nch = torch.ones(1, dtype=torch.int32, device=device)
    for label, fn in (("torch add, 1 element", lambda: x.add_(1.0)),
                      ("dynwin_staging, 1 plane, 1x1", lambda: dw.stage_planes(
                          dat, nch, 1, 1, W_CHUNK, True))):
        print(f"timing floor, {label}: {cuda_ms(fn, 50):.4f} ms, "
              f"{cuda_ms(fn, 50, device_only=True):.4f} ms device only [{card}]", flush=True)


def dynwin_main_path_inputs(cfg, device):
    """B7 at the window exchange's shape: the value and y channels of
    `window_bins`' window for the bench lattice (128 planes, W =
    window_size(100k, 128) = 2048), nch = ceil(min(counts, W) / 512)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw

    pf, _, _ = seeded_inputs(cfg, device, 10)
    W = cw.window_size(N_PARTICLES, cfg.grid.shape[0], cfg.coupling.planes_window)
    bins = cw.window_bins(pf, cfg.grid, cfg.coupling.slot_capacity, W)
    ych = bins.dat_win.shape[1] - 3
    dat = torch.stack([bins.dat_win[:, 0], bins.dat_win[:, ych]], 1).contiguous()
    nch = torch.div(torch.clamp(bins.counts, max=W) + W_CHUNK - 1, W_CHUNK,
                    rounding_mode="floor").to(torch.int32)
    return dat, nch


def dynwin_script_phase(card):
    """B7's own path: `python -m ...scripts.proto_dynwin` on the card (its
    default device) through its `main`, counts from 0. -> launches."""
    from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw
    LAUNCHES.clear()
    rc = dw.main([])
    launches = read_launches()["dynwin_staging"]
    if rc != 0 or launches < 2:
        raise AssertionError(f"proto_dynwin exited with {rc} after {launches} launches")
    print(f"proto_dynwin on the card: rc 0, {launches} launches [{card}]", flush=True)
    return launches


def native_phase(device, card):
    """The k-d tree locator (`native/`) at 128^3 / 100k: the tree over the
    main path's 2,097,152 cell centres, queried at its particles
    (`scripts/meshtree_timing.py`'s case). The path, its launch counts from
    0 just before and read just after: the card tree's host build and
    upload, `nearest` at the particles, `range_query` at r = 1.5h from each
    particle's cell centre (each call orders its queries by the keys
    kernel), `bin_points` of the particles. Then both kernels bit for bit
    against the host library (idx, d2, counts and members, also of a range
    capped at 8 of its 19 hits), in lattice order and on a seeded shuffle
    of the particles (compared through the permutation), and the keys
    kernel against its plain version; nearest's cell
    against `ops.coupling.locate` (float32) for every particle farther than
    1e-4 h from a face; the 19 `sphere2` cells of every range in the
    interior; `bin_points` on the card against the CPU. Both kernels are
    timed in both orders. -> (kernel entries, launches)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.native import bindings as nb
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.scripts import meshtree_timing as mt

    t_phase = time.perf_counter()
    grid = bench_config(NX).grid
    h, (nx, ny, nz) = grid.spacing[0], grid.shape
    radius = mt.RADIUS_CELLS * h
    pts = mt.cell_centres(NX, h)
    q = mt.particle_queries(N_PARTICLES, NX, h)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    tree = nb.MeshTree(pts, device=device)
    qd = torch.as_tensor(q, device=device)
    idx, d2 = tree.nearest(qd)
    qc = tree.pts[idx.long()]
    ridx, rn = tree.range_query(qc, radius, mt.CAP)
    bins = nb.bin_points(qd, grid.origin, grid.spacing, grid.shape, device=device)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = read_launches()
    launches = {k: counts[k] for k in ("meshtree_keys", "meshtree_nearest", "meshtree_range")}
    if min(launches.values()) < 1:
        raise AssertionError(f"native path: a tree kernel did not launch: {launches}")

    t0 = time.perf_counter()
    host = nb.MeshTree(pts, device="cpu")
    build_s = time.perf_counter() - t0
    qc_h = qc.cpu().numpy()
    checks = {"nearest": ((idx, d2), host.nearest(q)),
              "range": ((ridx, rn), host.range_query(qc_h, radius, mt.CAP)),
              "range, cap 8": (tree.range_query(qc, radius, 8), host.range_query(qc_h, radius, 8))}
    errs = {}
    for name, (got, ref) in checks.items():
        # max |card - host| of d2, plus the number of idx, count and member entries that differ
        errs[name] = sum(float((a.cpu() - b).abs().max()) if a.is_floating_point()
                         else float((a.cpu() != b).sum()) for a, b in zip(got, ref) if a.numel())
        if errs[name] != 0 or not all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)):
            raise AssertionError(f"native path: {name} on the card differs from the host "
                                 f"library (error {errs[name]})")
    if not bool((checks["range, cap 8"][1][1] == 8).all()):
        raise AssertionError("native path: a range capped at 8 kept fewer than 8 cells")
    perm = mt.shuffle(N_PARTICLES)
    pd = torch.as_tensor(perm, device=device)
    shuffled = {"nearest": (tree.nearest(qd[pd]), checks["nearest"][1]),
                "range": (tree.range_query(qc[pd], radius, mt.CAP), checks["range"][1]),
                "range, cap 8": (tree.range_query(qc[pd], radius, 8),
                                 checks["range, cap 8"][1])}
    for name, (got, ref) in shuffled.items():
        if not all(torch.equal(a.cpu(), b[perm]) for a, b in zip(got, ref)):
            raise AssertionError(f"native path: {name} on the card, shuffled, differs from the "
                                 "host library")

    cell, inside = cp.locate(torch.as_tensor(q, dtype=torch.float32, device=device), grid)
    flat = (cell[:, 0].long() * ny + cell[:, 1]) * nz + cell[:, 2]
    s = (q - np.asarray(grid.origin)) / h
    frac = s - np.floor(s)
    far = torch.as_tensor(np.minimum(frac, 1.0 - frac).min(1) > 1e-4, device=device)
    if not bool(inside.all()) or not torch.equal(idx.long()[far], flat[far]):
        raise AssertionError("native path: nearest's cell differs from locate's away from faces")
    if not torch.equal(bins[0].long()[far], flat[far]):
        raise AssertionError("native path: bin_points' cell differs from locate's")

    ijk = torch.stack([idx // (ny * nz), idx // nz % ny, idx % nz], 1).long()
    interior = ((ijk >= 1) & (ijk <= torch.tensor([nx, ny, nz], device=device) - 2)).all(1)
    off = torch.as_tensor(cp.stencil_offsets(cp.CouplingConfig(stencil_shape="sphere2")),
                          device=device)
    nb_ijk = ijk[:, None, :] + off[None]
    expect = (nb_ijk[..., 0] * ny + nb_ijk[..., 1]) * nz + nb_ijk[..., 2]
    got = ridx[:, :19].long()
    if (not bool((rn[interior] == 19).all()) or not bool((ridx[:, 19:] == -1).all())
            or not torch.equal(got.sort(1).values[interior], expect.sort(1).values[interior])):
        raise AssertionError("native path: a range at 1.5h is not the cell's sphere2 stencil")
    for a, b in zip(bins, nb.bin_points(q, grid.origin, grid.spacing, grid.shape, device="cpu")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("native path: bin_points on the card differs from the CPU")

    entries = mt.time_queries(tree, host, q, qc_h, radius)
    shuffled = mt.time_queries(tree, host, q[perm], qc_h[perm], radius)
    for name, e in entries.items():
        s = shuffled[name]
        print(f"kernel {name} ({NX}^3 centres, {N_PARTICLES} queries): bit for bit with the "
              f"host library in lattice and shuffled order; lattice {e['ms']:.4f} ms "
              f"({e['device_ms']:.4f} ms device only, share of bound "
              f"{e['bound_ms'] / e['device_ms']:.4f}), shuffled {s['ms']:.4f} ms "
              f"({s['device_ms']:.4f} ms device only, share {s['bound_ms'] / s['device_ms']:.4f}); "
              f"host library {e['plain_ms']:.3f} / {s['plain_ms']:.3f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), peak {e['peak_mb']:.1f} MB of which "
              f"{e['peak_rise_mb']:.1f} MB in the call [{card}]", flush=True)
        e.update(ms_shuffled=s["ms"], device_ms_shuffled=s["device_ms"])
    entries["meshtree_keys"] = mt.time_keys(tree, q)
    e = entries["meshtree_keys"]
    if e["max_abs_err"] != 0:
        raise AssertionError(f"native path: the keys kernel differs from its plain version in "
                             f"{e['max_abs_err']:.0f} keys")
    print(f"kernel meshtree_keys ({N_PARTICLES} queries): equal to its plain version; "
          f"{e['ms']:.4f} ms ({e['device_ms']:.4f} ms device only), plain {e['plain_ms']:.4f} "
          f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}) [{card}]", flush=True)
    print(f"native path: {launches} on the path ({path_s:.3f} s with the card tree's host "
          f"build and upload); host tree build {build_s:.3f} s; nearest = locate for "
          f"{int(far.sum())} of {N_PARTICLES} particles (the rest within 1e-4 h of a face); "
          f"{int(interior.sum())} ranges of 19 sphere2 cells; bin_points card = CPU; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    entries["meshtree_nearest"]["max_abs_err"] = errs["nearest"]
    entries["meshtree_range"]["max_abs_err"] = errs["range"] + errs["range, cap 8"]
    return entries, launches


def write_cli_case(d: Path, n=NX, length=1e-3 * NX, model="kEqn", adjust=False):
    """The channel case directory of the CLI slice (ASCII OpenFOAM
    dictionaries): one hex block, cyclic x/y patches, no-slip z walls with
    zero-gradient p, nu 1e-6, densities 2500/1000, gravity -z, LES kEqn
    (or `model`), deltaT 5e-5 (with `adjust`, adjustTimeStep yes, maxCo
    0.5), GAMG pressure (mgpcg) to tolerance 0 / relTol 0 in at most 200
    iterations, PIMPLE 1 outer x 2 correctors."""
    for sub in ("system", "constant", "0"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    L = length
    v = [(0, 0, 0), (L, 0, 0), (L, L, 0), (0, L, 0), (0, 0, L), (L, 0, L), (L, L, L), (0, L, L)]
    (d / "system/blockMeshDict").write_text(
        "convertToMeters 1; vertices ( " + " ".join(f"({a} {b} {c})" for a, b, c in v)
        + f" ); blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} {n}) simpleGrading (1 1 1) );")
    cyc = " ".join(f"{p} {{ type cyclic; }}" for p in ("left", "right", "front", "back"))
    (d / "0/U").write_text(f"boundaryField {{ {cyc} bottom {{ type noSlip; }} "
                           "top { type noSlip; } }")
    (d / "0/p").write_text(f"boundaryField {{ {cyc} bottom {{ type zeroGradient; }} "
                           "top { type zeroGradient; } }")
    (d / "constant/transportProperties").write_text(
        "nu nu [0 2 -1 0 0 0 0] 1e-06; partDensity 2500; fluidDensity 1000;")
    (d / "constant/g").write_text("dimensions [0 1 -2 0 0 0 0]; value (0 0 -9.81);")
    (d / "constant/turbulenceProperties").write_text(CLOSURES[model])
    (d / "system/controlDict").write_text(
        "deltaT 5e-05; endTime 1000; writeInterval 1000;"
        + (" adjustTimeStep yes; maxCo 0.5;" if adjust else ""))
    (d / "system/fvSolution").write_text(
        "solvers { p { solver GAMG; tolerance 0; relTol 0; maxIter 200; } }"
        " PIMPLE { nOuterCorrectors 1; nCorrectors 2; }")
    return d


def write_ico_case(d: Path, n=NX, length=1e-3 * NX):
    """The closed-box case directory of the PISO slice: one hex block and
    no 0/ directory (no-slip walls, zero-gradient p), nu 1e-6, densities
    2500/1000, deltaT 5e-5, GAMG pressure (mgpcg) to tolerance 0 / relTol 0
    in at most 200 iterations, PISO 2 correctors with the momentum
    predictor."""
    for sub in ("system", "constant"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    L = length
    v = [(0, 0, 0), (L, 0, 0), (L, L, 0), (0, L, 0), (0, 0, L), (L, 0, L), (L, L, L), (0, L, L)]
    (d / "system/blockMeshDict").write_text(
        "convertToMeters 1; vertices ( " + " ".join(f"({a} {b} {c})" for a, b, c in v)
        + f" ); blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} {n}) simpleGrading (1 1 1) );")
    (d / "constant/transportProperties").write_text(
        "nu nu [0 2 -1 0 0 0 0] 1e-06; partDensity 2500; fluidDensity 1000;")
    (d / "system/controlDict").write_text("deltaT 5e-05; endTime 1000; writeInterval 1000;")
    (d / "system/fvSolution").write_text(
        "solvers { p { solver GAMG; tolerance 0; relTol 0; maxIter 200; } }"
        " PISO { nCorrectors 2; momentumPredictor yes; }")
    return d


# per solver: the CLI command, its case directory and B3's launches per
# step (two deposits per sparse exchange, one per point-force exchange)
CLI_SOLVERS = {"pimple": ("pimplefoam", write_cli_case, 2), "piso": ("icofoam", write_ico_case, 1)}


def cli_phase(card, solver, steps=20, extra=(), kernel=None, **case_kw):
    """`pimplefoam <case>` or `icofoam <case>` through the CLI's own `main`
    on the card (its default device): 100k random particles, `steps`
    steps, with the CLI arguments `extra`. The launch counts are set to 0
    just before and read just after; B3 must have run at least as often
    per step as the exchange deposits, or `kernel` (the exchange kernel
    that `extra` selects) once a step; `case_kw` go to the case writer.
    -> the launch counts."""
    from yade_openfoam_coupling_tpu_torch import cli

    cmd, writer, b3_per_step = CLI_SOLVERS[solver]
    kernel, per_step = (kernel, 1) if kernel else ("rolls_deposit", b3_per_step)
    case = writer(Path(tempfile.mkdtemp(prefix="cli_case_")), **case_kw)
    label = " ".join([cmd, *extra] + [f"{k}={v}" for k, v in case_kw.items()])
    try:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = cli.main([cmd, str(case), *CLI_ARGS, *extra, "--max-steps", str(steps)])
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        shutil.rmtree(case)
    if rc != 0:
        raise AssertionError(f"{label} exited with {rc}")
    if launches[kernel] < per_step * steps:
        raise AssertionError(f"CLI {label}: {kernel} launched "
                             f"{launches[kernel]} times in {steps} steps")
    print(f"CLI {label}, {N_PARTICLES} random particles, {NX}^3: {steps} steps "
          f"in {wall:.2f} s with set-up [{card}]; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def cli_config(solver, **case_kw):
    """The CaseConfig the CLI's set-up function builds for the CLI slice of
    ``solver`` (its initial state, built on the card too, is dropped);
    `case_kw` go to the case writer."""
    from yade_openfoam_coupling_tpu_torch import cli

    cmd, writer, _ = CLI_SOLVERS[solver]
    case = writer(Path(tempfile.mkdtemp(prefix="cli_case_")), **case_kw)
    try:
        args = cli.build_parser().parse_args([cmd, str(case), *CLI_ARGS])
        cfg, _, _ = cli.setup(args, solver)
    finally:
        shutil.rmtree(case)
    return cfg


def stage_phase(cfg, device, card, label, turb=CLI_TURB, state=None):
    """Where one STEPS_PER_RUN-step chunk's time goes, after a warm-up
    chunk: synchronised host-clock time in the exchange, the DEM substeps,
    the fluid step (the turbulence correction and the PIMPLE step, or the
    PISO step), and inside the fluid step the pressure solves. The
    synchronisations add a few ms per step, so the stages are read as
    shares, not as the slice's rate. ``state`` replaces the bench lattice's
    initial state."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models import turbulence
    from yade_openfoam_coupling_tpu_torch.ops import dem, pressure

    fluid = ([(cd, "piso_step")] if cfg.solver == "piso"
             else [(turbulence, "correct"), (cd, "pimple_step")])
    spots = [(cd, "exchange"), (dem, "dem_substeps"), *fluid, (pressure, "solve_pressure")]
    if cfg.solver == "pimple" and cfg.pimple.implicit_diffusion:
        spots.append((pressure, "solve_helmholtz"))
    spent = dict.fromkeys((name for _, name in spots), 0.0)

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return run

    if state is None:
        state = initial_state(cfg, N_PARTICLES, device, turb=turb)
    run = cd.make_scan_fn(cfg, STEPS_PER_RUN)
    state, _ = run(state)
    originals = [(mod, name, getattr(mod, name)) for mod, name in spots]
    try:
        for mod, name, fn in originals:
            setattr(mod, name, timed(name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    per_step = {k: 1e3 * v / STEPS_PER_RUN for k, v in spent.items()}
    print(f"{label} stages (ms/step, synchronised, {1e3 * wall / STEPS_PER_RUN:.1f} ms/step "
          f"in all) [{card}]: " + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items()),
          flush=True)


def with_use_pallas(cfg):
    """cfg with B2 in every pressure matvec of its solver."""
    fluid = cfg.piso if cfg.solver == "piso" else cfg.pimple
    fluid = dataclasses.replace(fluid, pressure=dataclasses.replace(fluid.pressure,
                                                                    use_pallas=True))
    return dataclasses.replace(cfg, **{cfg.solver: fluid})


def fluid_config(cfg, model=None, implicit=False, bf16=False, fixed_iters=0):
    """cfg (a PIMPLE one) with the turbulence `model`; with `implicit`,
    implicit momentum diffusion (full_stress off) with B2 in the Helmholtz
    solves; with `bf16`, the pressure V-cycle in bf16; with `fixed_iters`,
    that CG budget for the pressure solves."""
    from yade_openfoam_coupling_tpu_torch.models.turbulence import TurbulenceConfig
    pim = cfg.pimple
    if implicit:
        pim = dataclasses.replace(pim, implicit_diffusion=True, full_stress=False,
                                  momentum=dataclasses.replace(pim.momentum, use_pallas=True))
    pres = pim.pressure
    if bf16:
        pres = dataclasses.replace(pres, mg=dataclasses.replace(pres.mg, bf16=True))
    pim = dataclasses.replace(pim, pressure=dataclasses.replace(pres, fixed_iters=fixed_iters))
    turbulence = cfg.turbulence if model is None else TurbulenceConfig(model=model)
    return dataclasses.replace(cfg, pimple=pim, turbulence=turbulence)


class SolveCounter:
    """Collects the iteration counts (device tensors, read after the run)
    of every call of `pressure.<name>` while active; for `pcg` calls with
    a fixed budget, runs them under `torch.cuda.set_sync_debug_mode
    ("error")`, which raises on any host read or synchronisation. Keeps
    the arguments of the first call with the most iterations among those
    without a budget (`longest`; their while loop reads the count anyway)."""

    def __init__(self, name):
        self.name, self.iters, self.fixed_calls = name, [], 0
        self.longest, self.most = None, -1

    def __enter__(self):
        import torch
        from yade_openfoam_coupling_tpu_torch.ops import pressure
        self.fn = getattr(pressure, self.name)

        def run(*a, **kw):
            if kw.get("fixed_iters", 0) > 0:
                self.fixed_calls += 1
                torch.cuda.set_sync_debug_mode("error")
                try:
                    res = self.fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                res = self.fn(*a, **kw)
                if int(res.iters) > self.most:
                    self.longest, self.most = (a, kw), int(res.iters)
            self.iters.append(res.iters)
            return res
        setattr(pressure, self.name, run)
        return self

    def __exit__(self, *exc):
        from yade_openfoam_coupling_tpu_torch.ops import pressure
        setattr(pressure, self.name, self.fn)

    def counts(self):
        import torch
        return torch.stack(self.iters).cpu().numpy() if self.iters else np.zeros(0, int)


MG_KERNELS = ("mg_jacobi", "mg_residual_restrict", "mg_coarse")


def read_launches():
    """`kernels.LAUNCHES` under the kernels line's names: each entry point
    without its "yofc_" ("meshtree_" for the tree's "yofc_tree_"), and
    "laplacian" of either dtype (its bf16 entry also as "laplacian_bf16")."""
    counts = Counter({"meshtree_" + fn[10:] if fn.startswith("yofc_tree_") else fn[5:]: n
                      for fn, n in LAUNCHES.items()})
    counts["laplacian"] += counts["laplacian_bf16"]
    return counts


def dem_launches(launches, counts, n):
    """The fused DEM kernels' launch counts of a run into the kernels-line
    entries of the n^3 shape."""
    launches[f"dem_pack_drift_{n}"] = counts["dem_pack_drift"]
    launches[f"dem_substep_{n}"] = counts["dem_substep"]
    launches[f"dem_substeps_{n}"] = counts["dem_pack_drift"] + counts["dem_substep"]


def labelled_checks(label, d):
    """bench.py's three checks (`bench.bench_checks`) on per-step
    diagnostics (numpy), a failure named by label. -> (largest final
    residual, largest continuity error)."""
    from yade_openfoam_coupling_tpu_torch.bench import bench_checks as checks
    try:
        return checks(d)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None


def check_finite(label, state):
    """Every fluid, particle and turbulence field of state is finite."""
    import torch
    fs, ps = state.fluid, state.particles
    for name, t in (("u", fs.u), ("p", fs.p), ("alpha", fs.alpha), ("pos", ps.pos),
                    ("vel", ps.vel), ("k", state.turb.k), ("epsilon", state.turb.epsilon),
                    ("nut", state.turb.nut)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite values in {name}")


def slice_phase(cfg, device, card, label, kernels, timed_runs=TIMED_RUNS, report=None,
                turb=CLI_TURB, n=None, dt=DT):
    """One path at full size, as bench.py runs it: set-up and a warm-up
    chunk, then `timed_runs` timed chunks of STEPS_PER_RUN steps. Every
    launch count is set to 0 just before and read just after; each kernel
    in `kernels` (a list, or a dict of launches per step) must have
    launched at least that often per step (once for a list). `report(state,
    diags)` adds to the printed line (diags: per-step numpy arrays). ->
    (counts, p_iters)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd

    per_step = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
    n = N_PARTICLES if n is None else n
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state = initial_state(cfg, n, device, turb=turb, dt=dt)
    run = cd.make_scan_fn(cfg, STEPS_PER_RUN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, diags = run(state)                       # warm-up
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{label}: set-up {t1 - t0:.2f} s, first {STEPS_PER_RUN} steps {t2 - t1:.3f} s "
          f"({STEPS_PER_RUN / (t2 - t1):.3f} steps/s, no warm-up) [{card}]", flush=True)
    t0 = time.perf_counter()
    all_diags = [diags] if timed_runs == 0 else []
    for _ in range(timed_runs):
        state, diags = run(state)
        all_diags.append(diags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_steps = STEPS_PER_RUN * (1 + timed_runs)

    d = {k: torch.cat([getattr(x, k).reshape(-1) for x in all_diags]).cpu().numpy()
         for k in all_diags[0]._fields}
    p_final, cont = labelled_checks(label, d)
    check_finite(label, state)
    for name, k in per_step.items():
        if launches[name] < k * n_steps:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} "
                                 f"times in {n_steps} steps (at least {k} per step)")
    rate = (f"{timed_runs * STEPS_PER_RUN / wall:.3f} coupled steps/s [{card}]; "
            if timed_runs else "")
    print(f"{label} {n} particles {cfg.grid.shape[0]}^3: {rate}p_iters "
          f"{d['p_iters'].min()}-{d['p_iters'].max()}, p residual {p_final:.3e}, "
          f"continuity {cont:.3e}, overflows 0, launches "
          f"{ {k: launches[k] for k in per_step} } in {n_steps} steps"
          + (f"; {report(state, d)}" if report else ""), flush=True)
    return launches, d["p_iters"]


def chunked_phase(cfg, device, n=N_PARTICLES, chunks=4):
    """One chunked planes exchange of `chunks` slabs at full size (n
    particles on cfg's grid) against the whole-grid one: B4 on each slab.
    The fields and forces agree to KERNEL_RTOL of their scale (the same
    per-slot arithmetic; only the halo planes are summed in another
    order)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp

    grid, periodic = cfg.grid, cfg.periodic_axes()
    pf, F, _ = seeded_inputs(cfg, device, 10, seed=1, n=n)
    fields = (F[0:3], F[3:6], F[6:9], F[0:3], F[0:3])
    args = (grid, periodic, cfg.transport.nu, cfg.transport.rho_f, DT)
    whole = cpp.gaussian_coupling_planes(pf, *fields, *args,
                                         dataclasses.replace(cfg.coupling, planes_chunks=1),
                                         prev_alpha=F[9])
    chunked = cpp.gaussian_coupling_planes_chunked(
        pf, *fields, *args, dataclasses.replace(cfg.coupling, planes_chunks=chunks),
        prev_alpha=F[9])
    label = f"chunked planes exchange ({chunks} slabs) vs whole grid at {grid.shape[0]}^3/{n}"
    if int(whole.n_overflow) != 0 or int(chunked.n_overflow) != 0:
        raise AssertionError(f"{label}: overflows {int(whole.n_overflow)} (whole), "
                             f"{int(chunked.n_overflow)} ({chunks} slabs)")
    if not torch.equal(whole.found, chunked.found) or int(whole.found.sum()) != n:
        raise AssertionError(f"{label}: found differs from the whole-grid exchange")
    worst = 0.0
    for name in ("alpha", "u_particle", "u_source", "u_source_drag", "force"):
        a, b = getattr(chunked, name), getattr(whole, name)
        rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"{label}: {name} differs by {rel:.3e} of its scale")
    print(f"{label}: worst relative difference {worst:.3e}, overflows 0", flush=True)


def keps_report(cfg, helm):
    """The kEpsilon slice's own numbers: dt per step against the explicit
    diffusion bound h^2 / (6 nu_eff,max) of its last state, and the
    Helmholtz momentum iterations per step (three solves a step). With
    adjust_time_step dt must exceed 3x the bound. -> report(state, d)."""
    from yade_openfoam_coupling_tpu_torch.utils.diagnostics import diffusive_dt_bound

    def report(state, d):
        nut_max = float(state.turb.nut.max())
        dt_b = float(diffusive_dt_bound(cfg.grid, cfg.transport.nu, nut_max))
        dt = float(state.dt)
        if cfg.time.adjust_time_step and not dt > 3.0 * dt_b:
            raise AssertionError(f"kEpsilon slice: dt {dt:.3e} not above 3x the explicit "
                                 f"bound {dt_b:.3e}")
        it = helm.counts()
        per_step = it.reshape(-1, 3).sum(1) if it.size % 3 == 0 else it
        return (f"dt {dt:.3e} s ({'adjusted' if cfg.time.adjust_time_step else 'fixed'}), "
                f"explicit-diffusion bound {dt_b:.3e} s at nut_max {nut_max:.3e} m^2/s "
                f"(dt / bound {dt / dt_b:.3g}); Helmholtz iterations per step "
                f"{per_step.tolist()}")
    return report


def slots_exchange_phase(cfg, device, card):
    """One slots exchange at 128^3/100k (the bench lattice, the initial
    fluid state): its peak device memory, and above what was allocated
    before it; its device time by launch from a `torch.profiler` trace of
    3 calls (the 6 longest)."""
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd

    state = initial_state(cfg, N_PARTICLES, device)
    fs, ps = state.fluid, state.particles

    def exchange():
        return cd.exchange(fs, ps, cfg.grid, cfg.bcs, cfg.transport, cfg.coupling, state.dt)

    peak, above = peak_mb(exchange)
    split = launch_split(exchange, 3)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
    print(f"slots exchange ({NX}^3, {N_PARTICLES} particles, cap "
          f"{cfg.coupling.slot_capacity}): peak device memory of one exchange {peak:.1f} MB, "
          f"{above:.1f} MB above what was allocated before it; device {sum(split.values()):.0f} "
          f"us a call, the longest launches (us): "
          + "; ".join(f"{us:.0f} {name[:60]}" for name, us in top) + f" [{card}]", flush=True)


def small_check(device, cfg, label, n=400, particles=None, turb=CLI_TURB):
    """The CUDA path against the CPU path (plain versions) of the same port
    on a 16^3 case with n moving particles (the seeded lattice, or
    `particles`), 4 steps: the state agrees to 1e-3 of each field's scale
    (f32 arithmetic in another order, amplified by stiff contacts and the
    pressure solve's 1e-5 tolerance), the springs too where they are on."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd

    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, list_rebuild_steps=2))
    out = {}
    for dev in (device, torch.device("cpu")):
        state = initial_state(cfg, n, dev, vel_scale=1e-2, particles=particles, turb=turb)
        state, diags = cd.make_scan_fn(cfg, 4)(state)
        out[dev.type] = (state, diags)
    (gs, gd), (cs, cd_) = out["cuda"], out["cpu"]
    if not torch.equal(gd.p_iters.cpu(), cd_.p_iters):
        print(f"note: {label} p_iters cuda {gd.p_iters.tolist()} cpu {cd_.p_iters.tolist()}")
    fields = [("u", gs.fluid.u, cs.fluid.u), ("p", gs.fluid.p, cs.fluid.p),
              ("alpha", gs.fluid.alpha, cs.fluid.alpha),
              ("pos", gs.particles.pos, cs.particles.pos),
              ("vel", gs.particles.vel, cs.particles.vel)]
    if cfg.dem.shear_history:
        if not torch.equal(gs.particles.shear_ids.cpu(), cs.particles.shear_ids) or \
                not torch.equal(gd.n_dem_sub.cpu(), cd_.n_dem_sub):
            raise AssertionError(f"small case ({label}): spring keys or substep counts differ")
        if int((cs.particles.shear_xi.abs().sum(-1) > 0).sum()) == 0:
            raise AssertionError(f"small case ({label}): no spring is loaded")
        fields += [("angvel", gs.particles.angvel, cs.particles.angvel),
                   ("shear_xi", gs.particles.shear_xi, cs.particles.shear_xi)]
    worst = 0.0
    for name, g, c in fields:
        rel = float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"small case ({label}): {name} on the GPU differs from "
                                 f"the CPU path by {rel:.3e} of its scale")
    print(f"small case 16^3/{n} ({label}), 4 steps: GPU (kernels) vs CPU (plain) worst "
          f"relative difference {worst:.3e}", flush=True)


def settling_phase(device, card, steps=60):
    """`settling_sphere()` (16^3, point-force PISO) on the card for `steps`
    steps: the sphere's velocity within 5% of Stokes' terminal velocity
    (rho_p - rho_f) V g / (3 pi d mu), as tests/test_coupled.py holds the
    JAX package, and found every step."""
    import torch
    from yade_openfoam_coupling_tpu_torch.cases import settling_sphere
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd

    cfg, state, _ = settling_sphere(device=device)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, diags = cd.make_scan_fn(cfg, steps)(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r, tp = float(state.particles.radius[0]), cfg.transport
    v_t = (tp.rho_p - tp.rho_f) * (4.0 / 3.0 * np.pi * r ** 3) * 9.81 / (
        3 * np.pi * 2 * r * tp.nu * tp.rho_f)
    vz = -float(state.particles.vel[0, 2])
    if not abs(vz - v_t) <= 0.05 * v_t or not bool((diags.n_found == 1).all()):
        raise AssertionError(f"settling sphere: v {vz:.6g} m/s vs Stokes {v_t:.6g} m/s, "
                             f"found {diags.n_found.tolist()}")
    print(f"settling sphere 16^3, {steps} steps in {wall:.2f} s [{card}]: v {vz:.6g} m/s, "
          f"Stokes {v_t:.6g} m/s ({100 * (vz / v_t - 1):+.2f}%), B3 launches "
          f"{read_launches()['rolls_deposit']}", flush=True)


def spring_report(state, d):
    """The `--yade-physics` slice's own numbers: the substep count per step
    and the springs loaded at the end."""
    ps = state.particles
    return (f"n_eff per step {d['n_dem_sub'].tolist()}, nonzero springs "
            f"{int((ps.shear_xi.abs().sum(-1) > 0).sum())} of {ps.shear_xi.shape[0]} x "
            f"{ps.shear_xi.shape[1]} slots, wall springs "
            f"{int((ps.shear_wall.abs().sum(-1) > 0).sum())}")



# ---------------------------------------------------------------------------
# The slab-sharded path (parallel/): 1 rank on NCCL, 2 ranks on gloo
# ---------------------------------------------------------------------------

SHARDED_STEPS = 2 * STEPS_PER_RUN   # two chunks of the bench's 10-step rebuild
# tests/test_sharding.py's chunked 1-vs-N tolerances, (rtol, atol)
BY_PID_TOL = {"pos": (1e-4, 1e-8), "vel": (5e-3, 5e-5)}
FIELD_TOL = {"alpha": (1e-4, 1e-6), "u": (1e-2, 1e-5)}


def sharded_config(cfg, **coupling_kw):
    """`scripts/bench_sharded1.py`'s configuration (:42-85) from the bench's
    cfg: no carried contact force (the sharded path refuses it: it
    migrates slots between steps), PIMPLE 1 x 1, the column staging
    layout; the coupling changed by coupling_kw. (Its state stays the
    bench's lattice: bench_sharded1's uniform cloud overlaps ~10^4 pairs
    and overflows the DEM list, which bench.py's checks refuse.)"""
    cfg = dataclasses.replace(
        cfg, dem=dataclasses.replace(cfg.dem, carry_contact=False),
        pimple=dataclasses.replace(cfg.pimple, n_correctors=1),
        coupling=dataclasses.replace(cfg.coupling, packed_bin="col"))
    if coupling_kw:
        cfg = dataclasses.replace(cfg, coupling=dataclasses.replace(cfg.coupling,
                                                                    **coupling_kw))
    return cfg


def host_view(state, diags=None):
    """A run's result as host numpy: the particles by pid, alpha and u, and
    the diagnostics stacked over the steps."""
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh
    out = {"particles": sh.particles_by_pid(state.particles),
           "alpha": state.fluid.alpha.detach().cpu().numpy(),
           "u": state.fluid.u.detach().cpu().numpy()}
    if diags is not None:
        out["diags"] = {k: v.detach().cpu().numpy() for k, v in diags._asdict().items()}
    return out


def compare_runs(label, ref, got):
    """The sharded run against the single-device one from the same state:
    the same pids, pos and vel by pid, alpha and u, each at BY_PID_TOL and
    FIELD_TOL. -> the largest difference over each field's scale."""
    pr, pg = ref["particles"], got["particles"]
    if not np.array_equal(pr["pid"], pg["pid"]):
        raise AssertionError(f"{label}: the sharded run holds other particles "
                             f"({len(pg['pid'])} vs {len(pr['pid'])})")
    worst = 0.0
    pairs = [(k, pr[k], pg[k], BY_PID_TOL[k]) for k in BY_PID_TOL]
    pairs += [(k, ref[k], got[k], FIELD_TOL[k]) for k in FIELD_TOL]
    for name, a, b, (rtol, atol) in pairs:
        bad = np.abs(b - a) > atol + rtol * np.abs(a)
        if bad.any():
            raise AssertionError(f"{label}: {name} differs from the single-device run at "
                                 f"{int(bad.sum())} entries (rtol {rtol:g}, atol {atol:g}; "
                                 f"max abs {float(np.abs(b - a).max()):.3e})")
        worst = max(worst, float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)))
    return worst


def got_iters(view):
    """The pressure CG's iterations per step of a run's view, as min-max."""
    it = view["diags"]["p_iters"]
    return f"{it.min()}-{it.max()}"


def bench_checks(label, d, n_steps):
    """bench.py's three checks on per-step diagnostics (numpy), the sharded
    path's migration and ghost overflows counted as overflows too."""
    p_final, cont = labelled_checks(label, d)
    n_over = int(d["n_shard_overflow"].max())
    if n_over != 0:
        raise AssertionError(f"{label}: overflows {n_over}")
    if len(d["n_found"]) != n_steps:
        raise AssertionError(f"{label}: {len(d['n_found'])} diagnostics for {n_steps} steps")
    return p_final, cont


def require_launches(label, launches, per_step, n_steps):
    """Each kernel of `per_step` launched at least that often per step."""
    for name, k in per_step.items():
        if launches[name] < k * n_steps:
            raise AssertionError(f"{label}: kernel {name} launched {launches[name]} times in "
                                 f"{n_steps} steps (at least {k} per step)")


@contextlib.contextmanager
def capture_first(module, name):
    """While active, `module.name` keeps its first call's arguments in the
    yielded list."""
    orig = getattr(module, name)
    seen = []

    def wrapper(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return orig(*a, **kw)
    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def one_rank_mesh(backend, device):
    """A one-rank process group (file rendezvous, 300 s timeout) and its
    mesh on `device`, for the duration of the block."""
    import datetime
    import torch.distributed as dist
    from yade_openfoam_coupling_tpu_torch.parallel import make_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        yield make_mesh(device=device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def slab_kernel_entries(cfg, mesh, state):
    """Each kernel of cfg's sharded exchange on this rank's slab, at the
    shapes one sharded step hands it (the inputs of its first call in one
    exchange), against its plain version: the entries of the kernels line."""
    import torch
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
    from yade_openfoam_coupling_tpu_torch.ops import rolls
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh

    ccfg = cfg.coupling
    if ccfg.exchange == "sparse":
        spots = [(rolls, "distribute_rolls")]
    elif ccfg.exchange == "window":
        spots = [(cw, "window_exchange_padded")]
    elif ccfg.fused_planes:
        spots = [(cpp, "fused_exchange_padded")]
    else:
        spots = [(cpp, "interp_planes_padded"), (cpp, "deposit_stacks")]
    s = sh.to_sharded_state(state, cfg, mesh)
    n_loc, ctx, _ = sh._setup(cfg, mesh)
    chunked = ccfg.exchange != "sparse"
    ex = sh.make_sharded_exchange(cfg, ctx, n_loc, ext_slab=chunked)
    fs = s.fluid._replace(phi=sh.lo_to_faces_local(s.fluid.phi, cfg.bcs.u, ctx))
    with contextlib.ExitStack() as stack:
        seen = [stack.enter_context(capture_first(m, n)) for m, n in spots]
        ex(fs, s.particles, s.dt)
    torch.cuda.synchronize()
    out = {}
    for (mod, name), [(a, kw)] in zip(spots, seen):
        if name == "distribute_rolls":
            out["rolls_deposit_sharded"] = rolls_entry(*a)
        else:
            key = SLAB_KEYS[name]
            out[key] = captured_entry(mod, name, a, kw, key)
    return out


SLAB_KEYS = {"window_exchange_padded": "window_exchange_sharded",
             "fused_exchange_padded": "planes_fused_sharded",
             "interp_planes_padded": "planes_interp_sharded",
             "deposit_stacks": "planes_deposit_sharded"}


def captured_entry(mod, name, a, kw, key):
    """The exchange kernel `mod.name` (B1, B4, B5 or B6) on the arguments
    (a, kw) of a call captured on a path, against its plain version: its
    kernels-line entry, printed under `key`."""
    import torch
    plain_fn = getattr(mod, name + "_reference")
    kern_fn = getattr(mod, name)
    pkw = {k: v for k, v in kw.items() if k != "max_occupied"}
    plain, kern = plain_fn(*a, **pkw), kern_fn(*a, **kw)
    plain = plain if isinstance(plain, tuple) else (plain,)
    kern = kern if isinstance(kern, tuple) else (kern,)
    err = max(check_close(name, str(i), k, p) for i, (k, p) in enumerate(zip(kern, plain))
              if isinstance(k, torch.Tensor))
    del plain
    ms, dev_ms = kernel_times(lambda: kern_fn(*a, **kw))
    plain_ms = cuda_ms(lambda: plain_fn(*a, **pkw), 5)
    outs = [t for t in kern if isinstance(t, torch.Tensor)]
    if name == "window_exchange_padded":
        Fp, dat_win = a[0], a[1]
        counts = kw["counts"]
        live = int(counts.clamp(max=dat_win.shape[-1]).sum())
        n_bytes = (nbytes(Fp, counts, *outs)
                   + live * dat_win.shape[1] * dat_win.element_size())
        flops = exchange_flops(live, 19, Fp.shape[0])
    elif name == "deposit_stacks":
        V, D = a[0], a[1]
        d_bytes, n_occ = slot_table_bytes(D)
        n_bytes = nbytes(*outs, D[6]) + V.shape[0] * n_occ * V.element_size() + 12 * n_occ
        flops = exchange_flops(n_occ, 19, 10)
    else:
        Fp, D = a[0], a[1]
        d_bytes, n_occ = slot_table_bytes(D)
        n_bytes = nbytes(Fp, *outs) + d_bytes
        flops = exchange_flops(n_occ, 19, Fp.shape[0])
    x_off = a[6 if name == "deposit_stacks" else 5]
    print(f"kernel {key} (first input {tuple(a[0].shape)}, x_off {x_off}): "
          f"max_abs_err {err:.3e}; kernel {ms:.4f} ms ({dev_ms:.4f} ms device only), "
          f"plain {plain_ms:.3f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(n_bytes, flops), "library_ms": None}


def sharded_timed_split(cfg, mesh, state, card, label):
    """One STEPS_PER_RUN-step sharded chunk under a `PhaseTimer` (each phase
    synchronised at its end): ms/step in halo pads, migration and the DEM
    plan, ghost refreshes, the exchange, the DEM, and the rest (the fluid:
    turbulence, PIMPLE, diagnostics)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh
    from yade_openfoam_coupling_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    s = sh.to_sharded_state(state, cfg, mesh)
    run = sh.make_sharded_scan(cfg, mesh, STEPS_PER_RUN, timer=timer)
    torch.cuda.synchronize()
    with timer.phase("all", block_on=state.fluid.p):
        run(s)
    per = {k: 1e3 * v / STEPS_PER_RUN for k, v in timer.totals.items()}
    plan = per.get("migration", 0.0) + per.get("DEM plan (ghost set, Verlet list)", 0.0)
    fluid = per["all"] - per.get("exchange", 0.0) - per.get("DEM", 0.0) - plan
    print(f"{label} split (ms/step, synchronised; halo pads and ghosts lie inside the other "
          f"phases) [{card}]: all {per['all']:.2f}, halo pads {per.get('halo pads', 0.0):.2f}, "
          f"migration + DEM plan {plan:.2f}, ghosts {per.get('ghosts', 0.0):.2f}, exchange "
          f"{per.get('exchange', 0.0):.2f}, DEM {per.get('DEM', 0.0):.2f}, fluid and the rest "
          f"{fluid:.2f}", flush=True)
    print(timer.report(), flush=True)


def sharded_phase(cfg, device, card, backend="nccl"):
    """Phase 1 of the sharded path: the bench's configuration (window
    exchange, cell list rebuilt every 10 steps, kEqn, fftpcg) at full size
    on a one-rank mesh, SHARDED_STEPS steps of the chunked
    `make_sharded_scan` (every collective a local copy) against the
    single-device `make_scan_fn` from the same state, by pid; bench.py's
    checks on the sharded run; B1 at least once a step. The two runs are
    timed in turns (single, sharded, sharded, single), each window holding
    its scan alone; the references are taken in untimed runs. -> (kernel
    entries, launches, the single-device run's view after STEPS_PER_RUN
    steps)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh

    scfg = sharded_config(cfg)
    n = N_PARTICLES
    state0 = initial_state(scfg, n, device)
    run = cd.make_scan_fn(scfg, STEPS_PER_RUN)
    s, d1 = run(state0)                             # warm-up, and the references
    ref10 = host_view(s)
    s, d2 = run(s)
    ref20 = host_view(s)
    iters = torch.cat([d1.p_iters, d2.p_iters]).cpu().numpy()
    del s

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / SHARDED_STEPS

    with one_rank_mesh(backend, device) as mesh:
        scan = sh.make_sharded_scan(scfg, mesh, SHARDED_STEPS)
        sh.make_sharded_scan(scfg, mesh, STEPS_PER_RUN)(sh.to_sharded_state(state0, scfg,
                                                                            mesh))  # warm-up
        single_ms, sharded_ms = [], []
        for turn in ("single", "sharded", "sharded", "single"):
            if turn == "single":
                _, ms = timed(lambda: run(run(state0)[0]))
                single_ms.append(ms)
                continue
            s = sh.to_sharded_state(state0, scfg, mesh)
            if not sharded_ms:
                LAUNCHES.clear()
                (out, d), ms = timed(lambda: scan(s))
                launches = read_launches()
            else:
                _, ms = timed(lambda: scan(s))
            sharded_ms.append(ms)
        label = f"sharded window slice, 1 rank ({backend})"
        require_launches(label, launches, {"window_exchange": 1}, SHARDED_STEPS)
        got = host_view(sh.gather_state(out, scfg, mesh), d)
        p_final, cont = bench_checks(label, got["diags"], SHARDED_STEPS)
        worst = compare_runs(label, ref20, got)
        print(f"{label} {n} particles {NX}^3, {SHARDED_STEPS} steps, timed in turns "
              f"(single, sharded, sharded, single): sharded-program step "
              f"{sharded_ms[0]:.2f}, {sharded_ms[1]:.2f} ms on a 1-shard mesh, single-device "
              f"make_scan_fn {single_ms[0]:.2f}, {single_ms[1]:.2f} ms [{card}]; p residual "
              f"{p_final:.3e}, continuity {cont:.3e}, overflows 0, B1 launches "
              f"{launches['window_exchange']}; p_iters per step: sharded {got_iters(got)}, "
              f"single-device {iters.min()}-{iters.max()}; by pid against the single-device "
              f"run: worst difference {worst:.3e} of scale", flush=True)
        del out
        sharded_timed_split(scfg, mesh, state0, card, label)
        entries = slab_kernel_entries(scfg, mesh, state0)
    return entries, {"window_exchange_sharded": launches["window_exchange"]}, ref10


def two_rank_run(mesh, cfg, n, n_steps):
    """One rank of phase 2: the bench state built on this rank's device,
    n_steps of the chunked sharded scan, gathered to rank 0. -> (rank,
    x_off of every B1 launch, B1 launches, ms/step, rank 0's view)."""
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh

    state0 = initial_state(cfg, n, mesh.device)
    s = sh.to_sharded_state(state0, cfg, mesh)
    scan = sh.make_sharded_scan(cfg, mesh, n_steps)
    offs = []
    orig = cw.window_exchange_padded

    def record(*a, **kw):
        offs.append(int(a[5]))
        return orig(*a, **kw)
    LAUNCHES.clear()
    cw.window_exchange_padded = record
    try:
        sync(mesh.device)
        t0 = time.perf_counter()
        out, d = scan(s)
        sync(mesh.device)
        ms = 1e3 * (time.perf_counter() - t0) / n_steps
    finally:
        cw.window_exchange_padded = orig
    g = sh.gather_state(out, cfg, mesh)
    view = host_view(g, d) if g is not None else None
    return mesh.rank, sorted(set(offs)), read_launches()["window_exchange"], ms, view


def two_rank_phase(cfg, card, ref10, device="cuda:0"):
    """Phase 2: two ranks sharing the card on a gloo group (their halos and
    reductions staged through host memory), STEPS_PER_RUN steps of the
    same configuration: the gathered state agrees with the single-device
    run by pid, no overflow, and B1 launched on each rank at its slab's
    x_off (rank * n_loc - 1, the extended window)."""
    from yade_openfoam_coupling_tpu_torch.parallel import launch

    scfg = sharded_config(cfg)
    res = launch(two_rank_run, 2, "gloo", device, (scfg, N_PARTICLES, STEPS_PER_RUN),
                 timeout=300, deadline=600)
    label = "sharded window slice, 2 ranks sharing the card (gloo)"
    n_loc = NX // 2
    for rank, offs, n_b1, ms, _ in res:
        if offs != [rank * n_loc - 1]:
            raise AssertionError(f"{label}: rank {rank} ran B1 at x_off {offs}, not at "
                                 f"{rank * n_loc - 1}")
        require_launches(f"{label}, rank {rank}", {"window_exchange": n_b1},
                         {"window_exchange": 1}, STEPS_PER_RUN)
    got = res[0][4]
    p_final, cont = bench_checks(label, got["diags"], STEPS_PER_RUN)
    worst = compare_runs(label, ref10, got)
    print(f"{label} {N_PARTICLES} particles {NX}^3, {STEPS_PER_RUN} steps: "
          + ", ".join(f"rank {r} {ms:.2f} ms/step, B1 {n} launches at x_off {o[0]}"
                      for r, o, n, ms, _ in res)
          + f" [{card}]; p residual {p_final:.3e}, continuity {cont:.3e}, overflows 0; by "
          f"pid against the single-device run: worst difference {worst:.3e} of scale",
          flush=True)


def slab_laplacian_entry(cfg, mesh, state):
    """B2 at the sharded pressure solve's shapes: one sharded step from
    `state` (a sharded state whose p is nonzero), keeping the first B2
    call on a nonzero slab-sized padded p. With p0 = state's p that is the
    CG's first residual, A(p0), whose x ghosts come from the ring (the
    call before it is the zero field of the ghost constant). -> its
    kernels-line entry."""
    from yade_openfoam_coupling_tpu_torch.ops import pressure
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh

    want = tuple(s + 2 for s in state.fluid.p.shape)
    seen = []
    orig = pressure.laplacian_facegamma_fused

    def keep(gamma_f, pp, grid):
        if not seen and tuple(pp.shape) == want and bool(pp.abs().max() > 0):
            seen.append((tuple(g.clone() for g in gamma_f), pp.clone(), grid))
        return orig(gamma_f, pp, grid)
    pressure.laplacian_facegamma_fused = keep
    try:
        sh.make_sharded_step(cfg, mesh)(state)
    finally:
        pressure.laplacian_facegamma_fused = orig
    if not seen:
        raise AssertionError(f"sharded step: no B2 call on a nonzero {want} padded field")
    return laplacian_entry(*seen[0], "laplacian_sharded")


def mgpcg_config(cfg):
    """cfg with the V-cycle-preconditioned CG and B2 in every matvec."""
    pim = cfg.pimple
    cfg = dataclasses.replace(cfg, pimple=dataclasses.replace(
        pim, pressure=dataclasses.replace(pim.pressure, solver="mgpcg")))
    return with_use_pallas(cfg)


def sharded_chunks_phase(cfg, device, card, backend="nccl"):
    """Phase 3: one STEPS_PER_RUN-step run each of the sharded sparse
    exchange (B3 through the slab deposit), the sharded planes exchange
    (B4) and its two-kernel path (B5 + B6), and the window slice with the
    mgpcg solver under `use_pallas` (B2 on the ring-padded slab), on a
    one-rank mesh, each against the single-device run from the same
    state. -> (kernel entries, launches)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh

    runs = [("sparse", sharded_config(cfg, exchange="sparse"), {"rolls_deposit": 1},
             {"rolls_deposit": "rolls_deposit_sharded"}),
            ("planes", sharded_config(planes_config(cfg)), {"planes_fused": 1},
             {"planes_fused": "planes_fused_sharded"}),
            ("two-kernel planes", sharded_config(planes_config(cfg, fused_planes=False)),
             {"planes_interp": 1, "planes_deposit": 1},
             {"planes_interp": "planes_interp_sharded",
              "planes_deposit": "planes_deposit_sharded"}),
            ("mgpcg use_pallas", mgpcg_config(sharded_config(cfg)),
             {"window_exchange": 1, "laplacian": 1}, {"laplacian": "laplacian_sharded"})]
    entries, launched = {}, {}
    with one_rank_mesh(backend, device) as mesh:
        for name, scfg, per_step, keys in runs:
            state0 = initial_state(scfg, N_PARTICLES, device)
            s, d = cd.make_scan_fn(scfg, STEPS_PER_RUN)(state0)
            ref = host_view(s, d)
            del s
            LAUNCHES.clear()
            out, d = sh.make_sharded_scan(scfg, mesh, STEPS_PER_RUN)(
                sh.to_sharded_state(state0, scfg, mesh))
            torch.cuda.synchronize()
            launches = read_launches()
            label = f"sharded {name} chunk, 1 rank ({backend})"
            require_launches(label, launches, per_step, STEPS_PER_RUN)
            got = host_view(sh.gather_state(out, scfg, mesh), d)
            if "laplacian" in per_step:
                entries["laplacian_sharded"] = slab_laplacian_entry(scfg, mesh, out)
            del out
            p_final, cont = bench_checks(label, got["diags"], STEPS_PER_RUN)
            worst = compare_runs(label, ref, got)
            print(f"{label} {N_PARTICLES} particles {NX}^3, {STEPS_PER_RUN} steps: p residual "
                  f"{p_final:.3e}, continuity {cont:.3e}, overflows 0, launches "
                  f"{ {k: launches[k] for k in per_step} }; p_iters per step: sharded "
                  f"{got_iters(got)}, single-device {got_iters(ref)}; by pid against the "
                  f"single-device run: worst difference {worst:.3e} of scale [{card}]",
                  flush=True)
            launched.update({keys[k]: launches[k] for k in keys})
            if "laplacian" not in per_step:
                entries.update(slab_kernel_entries(scfg, mesh, state0))
    return entries, launched


def unstaged_share(grid, pos, cap):
    """The share of the exchange cells pass's blocks whose halo holds more
    records than its shared memory stages (`csrc/exchange_common.cuh`: a
    block is a band of band_rows(nz) rows of one plane with its +-1-row
    halo, kSmemRecs = 256 records at most; such a block reads its
    sources' records from device memory), for particles at pos, each cell
    holding min(count, cap) records."""
    import torch
    nx, ny, nz = grid.shape
    h = torch.tensor(grid.spacing, device=pos.device)
    o = torch.tensor(grid.origin, device=pos.device)
    ijk = torch.floor((pos - o) / h).long()
    for a, n in enumerate(grid.shape):
        ijk[:, a].clamp_(0, n - 1)
    flat = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    cnt = torch.bincount(flat, minlength=grid.ncells).clamp(max=cap).view(nx, ny, nz)
    per_row = cnt.sum(2)
    band = max(1, min(8, 2048 // nz - 2))
    over = []
    for y0 in range(0, ny, band):
        rows = min(band, ny - y0)
        halo = torch.arange(y0 - 1, y0 + rows + 1, device=pos.device) % ny
        over.append(per_row[:, halo].sum(1) > 256)
    return float(torch.stack(over).float().mean())


def bench_1m_phase(device, card, fast):
    """`scripts/bench_1m.py` (default: the planes exchange in 8 slabs with
    mgpcg; ``fast``: the window exchange with fftpcg) at 1M/256^3 through
    its own `build_case` and `measure` (a 3-step warm-up call, one timed
    3-step call): no overflow, every particle found, a finite state, and
    B4 launched once a slab a step (B1 once a step). Prints steps/s, the
    pressure iterations, the last residual against bench.py's criterion
    and the timed call's peak device memory. Then the exchange kernel of
    the first exchange of the final state against its plain version (B4
    on the first slab, B1 on the whole window), and for the default case
    the 8-slab exchange against the whole-grid one at 256^3. -> (the
    kernel's launches in the 6 steps, its kernels-line entry, every launch
    counter's count in the 6 steps)."""
    import torch
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
    from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
    from yade_openfoam_coupling_tpu_torch.scripts import bench_1m

    argv = ["--fast"] if fast else []
    label = f"bench_1m {' '.join(argv) or '(default)'}"
    t0 = time.perf_counter()
    cfg, state = bench_1m.build_case(argv, device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    mod, name = (cw, "window_exchange_padded") if fast else (cpp, "fused_exchange_padded")
    kernel, per_step = ("window_exchange", 1) if fast else ("planes_fused",
                                                            cfg.coupling.planes_chunks)
    LAUNCHES.clear()
    res, state = bench_1m.measure(cfg, state, device)
    counts = read_launches()
    launches = counts[kernel]
    mg_launches = sum(counts[k] for k in MG_KERNELS)
    n_steps = 2 * bench_1m.N_STEPS
    n = bench_1m.N_PARTICLES
    if res["overflows"] != [0, 0, 0]:
        raise AssertionError(f"{label}: overflows {res['overflows']}")
    if res["n_found"] != n:
        raise AssertionError(f"{label}: {res['n_found']} particles found of {n}")
    check_finite(label, state)
    if launches != per_step * n_steps:
        raise AssertionError(f"{label}: {kernel} launched {launches} times in {n_steps} "
                             f"steps ({per_step} a step expected)")
    if (mg_launches > 0) == fast:
        raise AssertionError(f"{label}: {mg_launches} fused V-cycle launches in {n_steps} steps "
                             f"({'none' if fast else 'some'} expected)")
    dem_runs = (counts["dem_pack_drift"], counts["dem_substep"])
    if dem_runs != (n_steps, cfg.n_dem_substeps * n_steps):
        raise AssertionError(f"{label}: the fused DEM kernels launched {dem_runs} times in "
                             f"{n_steps} steps ({n_steps} and {cfg.n_dem_substeps} a step "
                             f"expected)")
    bound_p = max(1e-5 * res["p_initial_residual_max"], 5e-6)
    print(f"{label} {n} particles 256^3: {res['value']:.4f} steps/s [{card}], set-up "
          f"{setup:.2f} s; p_iters {res['p_iters']}, last p residual "
          f"{res['p_final_residual']:.3e} against bench.py's bound {bound_p:.3e} "
          f"({'met' if res['p_converged'] else 'NOT met'}); peak device memory of the timed "
          f"call {res['peak_mb']:.1f} MB; overflows 0, found {n}, {kernel} {launches} and the "
          f"fused V-cycle's kernels {mg_launches} in {n_steps} steps", flush=True)
    with capture_first(mod, name) as seen:
        cd.exchange(state.fluid, state.particles, cfg.grid, cfg.bcs, cfg.transport,
                    cfg.coupling, state.dt)
    torch.cuda.synchronize()
    [(a, kw)] = seen
    small = bench_config(NX).grid
    lattice = torch.as_tensor(lattice_positions(N_PARTICLES, small.lengths[0]),
                              dtype=torch.float32, device=device)
    print(f"{label}: share of the cells pass's blocks past its shared memory (they read "
          f"records from device memory): "
          f"{unstaged_share(cfg.grid, state.particles.pos, cfg.coupling.slot_capacity):.3f} "
          f"at 256^3/{n}, {unstaged_share(small, lattice, 4):.3f} on the "
          f"{NX}^3/{N_PARTICLES} lattice", flush=True)
    del state
    entry = captured_entry(mod, name, a, kw, kernel + "_256")
    del a, kw, seen
    if not fast:
        chunked_phase(cfg, device, n=n, chunks=cfg.coupling.planes_chunks)
    torch.cuda.empty_cache()
    return launches, entry, counts


def ladder_phase(device, card):
    """`scripts/bench_ladder.py`'s configurations at full size through its
    own `run_case`, with one timed 50-step chunk after the warm-up chunk
    (the reference times 3): ladder #2 must launch B3 (the point-force
    deposit, 8 corners x 3 channels on 32^3) and ladder #3 B1 (6 slots a
    cell) once a step, and both end finite. Prints steps/s and the
    overflow counts (the fluidized bed's uniform cloud starts with
    overlapping pairs; the reference asserts nothing)."""
    from yade_openfoam_coupling_tpu_torch.scripts import bench_ladder as bl

    for key, kernel in (("#2", "rolls_deposit"), ("#3", "window_exchange")):
        LAUNCHES.clear()
        res, state = bl.run_case(key, device, reps=1)
        launches = read_launches()[kernel]
        n_steps = 2 * bl.N_STEPS
        check_finite(res["metric"], state)
        if launches < n_steps:
            raise AssertionError(f"{res['metric']}: {kernel} launched {launches} times in "
                                 f"{n_steps} steps")
        print(f"{res['metric']}: {res['value']:.3f} steps/s [{card}] (one timed chunk of "
              f"{bl.N_STEPS}); overflows (contact, coupling) {res['overflows']}; p_iters "
              f"{res['p_iters']}; {kernel} {launches} in {n_steps} steps", flush=True)
        cfg, state = bl.CASES[key][1](device)
        stage_phase(cfg, device, card, f"ladder {key}", state=state)


def cli_bench_phase(card):
    """`python -m yade_openfoam_coupling_tpu_torch bench --small` as a
    subprocess: exit 0 and one JSON line with the card."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "yade_openfoam_coupling_tpu_torch", "bench",
                           "--small"], capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise AssertionError(f"CLI bench --small exited with {proc.returncode}:\n"
                             f"{proc.stdout}{proc.stderr}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line["card"] != card or not line["value"] > 0:
        raise AssertionError(f"CLI bench --small printed {line}")
    print(f"CLI bench --small in {time.perf_counter() - t0:.1f} s with start-up: "
          f"{json.dumps(line)}", flush=True)


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from yade_openfoam_coupling_tpu_torch import kernels
    from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
    from yade_openfoam_coupling_tpu_torch.ops.obstacle import box_solid
    from yade_openfoam_coupling_tpu_torch.utils.diagnostics import TimeControls
    from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs.values())}", flush=True)
    for path in libs.values():
        print(path.with_suffix(".log").read_text().strip(), flush=True)

    cfg = bench_config(NX)
    pcfg = planes_config(cfg)
    kern = {"window_exchange": window_kernel_phase(cfg, device)}
    e = window_kernel_phase(cfg, device, extras=True)
    print(f"window_exchange (torque, added mass): kernel {e['ms']:.4f} ms "
          f"({e['device_ms']:.4f} ms device only), plain {e['plain_ms']:.4f} ms, bound "
          f"{e['bound_ms']:.4f} ms ({e['bound_by']}) [{smi}]", flush=True)
    kern.update(planes_kernel_phase(pcfg, device))
    capacity_phase(cfg, pcfg, device, smi)
    kern["rolls_deposit"] = rolls_kernel_phase(
        device, cp.stencil_offsets(cp.CouplingConfig(stencil_shape="cube")), 4)
    kern["rolls_deposit_point_force"] = rolls_kernel_phase(device, cp.TRILINEAR_CORNERS, 3)
    kern["laplacian"] = laplacian_kernel_phase(device)
    kern["laplacian_bf16"] = laplacian_bf16_kernel_phase(device, smi)
    bf16_vcycle_phase(device, smi)
    kern.update(mg_vcycle_phase(device, smi))
    kern.update(dem_substep_phase(device, smi))
    kern["rolls_deposit_125"] = rolls_kernel_phase(
        device, cp.stencil_offsets(cp.CouplingConfig(stencil_width=5)), 4)
    kern["rolls_deposit_slots"] = rolls_kernel_phase(
        device, cp.stencil_offsets(cp.CouplingConfig(stencil_shape="sphere2")), 8)
    proto = dynwin_kernel_phase(device, "prototype", *(
        torch.as_tensor(a, device=device) for a in dw.prototype_inputs()), dw.NY, dw.NZ)
    kern["dynwin_staging"] = dynwin_kernel_phase(device, "window shape",
                                                 *dynwin_main_path_inputs(cfg, device), NX, NX)
    timing_floor(device, smi)
    for name, e in [("dynwin_staging (the prototype's shape)", proto), *kern.items()]:
        print(f"{name}: kernel {e['ms']:.4f} ms ({e['device_ms']:.4f} ms device only), plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), library "
              f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} "
              f"ms [{smi}]", flush=True)
    print(f"dynwin_staging, profiler kernel time / device-only bmm: prototype shape "
          f"{proto['profiler_ms']:.4f} / {proto['library_device_ms']:.4f} ms, window shape "
          f"{kern['dynwin_staging']['profiler_ms']:.4f} / "
          f"{kern['dynwin_staging']['library_device_ms']:.4f} ms [{smi}]", flush=True)

    # each path's launches, counted from 0 just before it and read just after
    entries, launches = native_phase(device, smi)
    kern.update(entries)
    runs, _ = slice_phase(cfg, device, smi, "window slice",
                          {"window_exchange": 1, "dem_pack_drift": 1, "dem_substep": 4})
    launches["window_exchange"] = runs["window_exchange"]
    dem_launches(launches, runs, 128)
    runs, _ = slice_phase(pcfg, device, smi, "planes slice", ["planes_fused"])
    launches["planes_fused"] = runs["planes_fused"]
    stage_phase(cfg, device, smi, "window slice")
    stage_phase(pcfg, device, smi, "planes slice")
    ycfg = bench_config(NX, yade_physics=True)
    slice_phase(ycfg, device, smi, "yade-physics slice", ["window_exchange"], timed_runs=3,
                report=spring_report)
    stage_phase(ycfg, device, smi, "yade-physics slice")
    runs, _ = slice_phase(planes_config(cfg, fused_planes=False), device, smi,
                          "two-kernel planes slice", ["planes_interp", "planes_deposit"],
                          timed_runs=0)
    launches["planes_interp"] = runs["planes_interp"]
    launches["planes_deposit"] = runs["planes_deposit"]
    cli_phase(smi, "pimple")
    cli_phase(smi, "pimple", steps=STEPS_PER_RUN, extra=("--fast", "--slot-capacity", "9"),
              kernel="planes_fused")
    ccfg = cli_config("pimple")
    runs, iters = slice_phase(ccfg, device, smi, "CLI slice", {"rolls_deposit": 2})
    launches["rolls_deposit"] = runs["rolls_deposit"]
    pcfg_pal = with_use_pallas(ccfg)
    with SolveCounter("pcg") as solves:
        runs, iters_pal = slice_phase(pcfg_pal, device, smi, "CLI slice, use_pallas",
                                      {"rolls_deposit": 2, "laplacian": 1}, timed_runs=1)
    launches["laplacian"] = runs["laplacian"]
    print(f"CLI slice p_iters per step: {iters.tolist()}; with use_pallas: "
          f"{iters_pal.tolist()}", flush=True)
    stage_phase(ccfg, device, smi, "CLI slice")
    stage_phase(pcfg_pal, device, smi, "CLI slice, use_pallas")

    # the rest of the fluid: the closures, implicit diffusion, bf16, fixed_iters
    for model in ("kEpsilon", "Smagorinsky"):
        cli_phase(smi, "pimple", steps=STEPS_PER_RUN, model=model, adjust=model == "kEpsilon")
    kcfg = fluid_config(pcfg_pal, "kEpsilon", implicit=True)
    with SolveCounter("solve_helmholtz") as helm:
        slice_phase(kcfg, device, smi, "kEpsilon slice (implicit diffusion, use_pallas)",
                    {"laplacian": 1}, timed_runs=1, report=keps_report(kcfg, helm),
                    turb=KEPS_TURB)
    stage_phase(kcfg, device, smi, "kEpsilon slice", turb=KEPS_TURB)
    acfg = dataclasses.replace(kcfg, time=TimeControls(adjust_time_step=True, max_co=0.5,
                                                       max_dt=2e-3))
    with SolveCounter("solve_helmholtz") as helm:
        slice_phase(acfg, device, smi, "kEpsilon slice, adjustTimeStep, nut 1e-2",
                    {"laplacian": 1}, timed_runs=0, report=keps_report(acfg, helm),
                    turb=STIFF_TURB, dt=STIFF_DT)
    scfg = fluid_config(ccfg, "Smagorinsky")
    slice_phase(scfg, device, smi, "Smagorinsky slice", {"rolls_deposit": 2}, timed_runs=1)
    stage_phase(scfg, device, smi, "Smagorinsky slice")
    bcfg = fluid_config(pcfg_pal, bf16=True)
    with SolveCounter("pcg") as bsolves:
        runs, iters_bf = slice_phase(bcfg, device, smi, "CLI slice, use_pallas, bf16 V-cycle",
                                     {"rolls_deposit": 2, "laplacian_bf16": 1}, timed_runs=1)
    launches["laplacian_bf16"] = runs["laplacian_bf16"]
    print(f"CLI slice p_iters per step, use_pallas: f32 V-cycle {iters_pal.tolist()}, bf16 "
          f"V-cycle {iters_bf.tolist()}", flush=True)
    solve_busy_share(solves, smi, "CLI slice, use_pallas, f32 V-cycle")
    solve_busy_share(bsolves, smi, "CLI slice, use_pallas, bf16 V-cycle")
    stage_phase(bcfg, device, smi, "CLI slice, use_pallas, bf16 V-cycle")
    budget = int(solves.counts().max()) + 3
    fcfg = fluid_config(pcfg_pal, fixed_iters=budget)
    with SolveCounter("pcg") as fixed:
        _, iters_fx = slice_phase(fcfg, device, smi,
                                  f"CLI slice, use_pallas, fixed_iters={budget}",
                                  {"rolls_deposit": 2, "laplacian": 1}, timed_runs=1)
    if fixed.fixed_calls == 0:
        raise AssertionError("fixed_iters chunk: no pressure solve ran with a fixed budget")
    print(f"fixed_iters chunk: {fixed.fixed_calls} CG solves of {budget} iterations under "
          f"set_sync_debug_mode('error'), no host read; live p_iters per step "
          f"{iters_fx.tolist()} (while loop {iters_pal.tolist()})", flush=True)

    # the slots exchange, and the sparse exchange at stencil_width 5
    slcfg = dataclasses.replace(cfg, coupling=dataclasses.replace(
        cfg.coupling, exchange="slots", slot_capacity=4))
    runs, _ = slice_phase(slcfg, device, smi, "slots slice", {"rolls_deposit": 1}, timed_runs=1)
    launches["rolls_deposit_slots"] = runs["rolls_deposit"]
    stage_phase(slcfg, device, smi, "slots slice")
    slots_exchange_phase(slcfg, device, smi)
    # 96^3 keeps the anchor buffer (125 x 4 x 96^3) under the roll route's
    # limit; the lattice keeps the 128^3 slices' particle density
    w5cfg = cli_config("pimple", n=96, length=0.096)
    w5cfg = dataclasses.replace(w5cfg, coupling=dataclasses.replace(w5cfg.coupling,
                                                                    stencil_width=5))
    runs, _ = slice_phase(w5cfg, device, smi, "sparse exchange, stencil_width 5",
                          {"rolls_deposit": 2}, timed_runs=0,
                          n=N_PARTICLES * 96 ** 3 // NX ** 3)
    launches["rolls_deposit_125"] = runs["rolls_deposit"]

    cli_phase(smi, "piso")
    picfg = cli_config("piso")
    runs, iters = slice_phase(picfg, device, smi, "PISO slice", {"rolls_deposit": 1})
    launches["rolls_deposit_point_force"] = runs["rolls_deposit"]
    runs, iters_pal = slice_phase(with_use_pallas(picfg), device, smi, "PISO slice, use_pallas",
                                  {"rolls_deposit": 1, "laplacian": 1}, timed_runs=0)
    print(f"PISO slice p_iters per step: {iters.tolist()}; with use_pallas: "
          f"{iters_pal.tolist()}", flush=True)
    stage_phase(picfg, device, smi, "PISO slice")
    settling_phase(device, smi)
    launches["dynwin_staging"] = dynwin_script_phase(smi)

    # the slab-sharded path: 1 rank on NCCL, 2 ranks sharing the card on
    # gloo, and the sparse and planes exchanges' chunks on 1 rank
    entries, launched, ref10 = sharded_phase(cfg, device, smi)
    two_rank_phase(cfg, smi, ref10)
    kern.update(entries)
    launches.update(launched)
    entries, launched = sharded_chunks_phase(cfg, device, smi)
    kern.update(entries)
    launches.update(launched)

    chunked_phase(pcfg, device)
    # the bench scripts at full size: 1M/256^3 both ways, the ladder, the CLI's bench
    for fast in (False, True):
        key = ("window_exchange" if fast else "planes_fused") + "_256"
        launches[key], kern[key], counts = bench_1m_phase(device, smi, fast)
        if not fast:
            for name in MG_KERNELS:
                launches[name] = counts[name]
            launches["mg_jacobi_prolong"] = launches["mg_jacobi_zero"] = counts["mg_jacobi"]
            dem_launches(launches, counts, 256)
            launches["mg_vcycle"] = sum(counts[k] for k in MG_KERNELS)
    ladder_phase(device, smi)
    cli_bench_phase(smi)
    grid16 = bench_config(16).grid
    small_check(device, bench_config(16), "window")
    small_check(device, planes_config(bench_config(16)), "planes")
    small_check(device, dataclasses.replace(with_use_pallas(ccfg), grid=grid16),
                "sparse, use_pallas")
    small_check(device, dataclasses.replace(with_use_pallas(picfg), grid=grid16,
                                            solid=box_solid(grid16.shape, (5, 6, 4), (9, 10, 8))),
                "PISO, box obstacle, use_pallas")
    small_check(device, bench_config(16, yade_physics=True), "yade-physics, loaded springs",
                n=500, particles=closing_pairs)
    small_check(device, dataclasses.replace(slcfg, grid=grid16), "slots")
    # (not the bf16 V-cycle: PyTorch rounds bf16 divisions by a scalar
    # differently on the CPU, so the two paths' preconditioners differ; on
    # the card B2's bf16 entry is held bit for bit against the plain stencil)
    small_check(device, dataclasses.replace(fluid_config(pcfg_pal, "kEpsilon", implicit=True),
                                            grid=grid16),
                "kEpsilon, implicit diffusion, use_pallas", turb=KEPS_TURB)

    sources = {"window_exchange": ("window_exchange.cu", JAX_OPS + "coupling_window.py:162"),
               "planes_fused": ("planes_exchange.cu", JAX_OPS + "coupling_planes.py:508"),
               "planes_interp": ("planes_exchange.cu", JAX_OPS + "coupling_planes.py:278"),
               "planes_deposit": ("planes_exchange.cu", JAX_OPS + "coupling_planes.py:404"),
               "rolls_deposit": ("rolls_deposit.cu", JAX_OPS + "pallas_rolls.py:39"),
               "rolls_deposit_point_force": ("rolls_deposit.cu",
                                             JAX_OPS + "pallas_rolls.py:39"),
               "laplacian": ("laplacian.cu", JAX_OPS + "pallas_stencil.py:37"),
               "laplacian_bf16": ("laplacian.cu", JAX_OPS + "pallas_stencil.py:37"),
               "rolls_deposit_125": ("rolls_deposit.cu", JAX_OPS + "pallas_rolls.py:39"),
               "rolls_deposit_slots": ("rolls_deposit.cu", JAX_OPS + "pallas_rolls.py:39"),
               "dynwin_staging": ("dynwin_staging.cu", "scripts/proto_dynwin.py:34"),
               "window_exchange_sharded": ("window_exchange.cu",
                                           JAX_OPS + "coupling_window.py:162"),
               "rolls_deposit_sharded": ("rolls_deposit.cu", JAX_OPS + "pallas_rolls.py:39"),
               "planes_fused_sharded": ("planes_exchange.cu", JAX_OPS + "coupling_planes.py:508"),
               "planes_interp_sharded": ("planes_exchange.cu",
                                         JAX_OPS + "coupling_planes.py:278"),
               "planes_deposit_sharded": ("planes_exchange.cu",
                                          JAX_OPS + "coupling_planes.py:404"),
               "laplacian_sharded": ("laplacian.cu", JAX_OPS + "pallas_stencil.py:37"),
               "planes_fused_256": ("planes_exchange.cu", JAX_OPS + "coupling_planes.py:508"),
               "window_exchange_256": ("window_exchange.cu",
                                       JAX_OPS + "coupling_window.py:162"),
               # no Pallas kernel: the JAX package's V-cycle as XLA ops
               **{k: ("mg_vcycle.cu", JAX_OPS + "pressure.py:300")
                  for k in ("mg_jacobi", "mg_jacobi_prolong", "mg_jacobi_zero",
                            "mg_residual_restrict", "mg_coarse", "mg_vcycle")},
               # no Pallas kernel: the JAX package leaves dem_substeps to XLA
               **{f"dem_{k}_{n}": ("dem_substep.cu", JAX_OPS + "dem.py:1061")
                  for k in ("pack_drift", "substep", "substeps") for n in (128, 256)},
               # no Pallas kernel: the JAX package's host C++ queries
               "meshtree_keys": ("meshtree.cu", JAX_NATIVE + "meshtree.cpp:121"),
               "meshtree_nearest": ("meshtree.cu", JAX_NATIVE + "meshtree.cpp:121"),
               "meshtree_range": ("meshtree.cu", JAX_NATIVE + "meshtree.cpp:160")}
    entries = []
    for name, e in kern.items():
        src, replaces = sources[name]
        entries.append({"name": name, "route": "cuda", "source": PORT_CSRC + src,
                        "replaces": replaces, "launches": launches[name], **e})
    print(f"chip_smoke: every check passed in {time.perf_counter() - t_start:.1f} s [{smi}]",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
