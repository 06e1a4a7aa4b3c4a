"""The port's hand-written CUDA kernels against their plain PyTorch
versions on a CUDA device. Imports no jax, so that it runs on a GPU
machine without the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
from yade_openfoam_coupling_tpu_torch.ops import rolls
from yade_openfoam_coupling_tpu_torch.ops.coupling_planes import pad_wrap_zero
from yade_openfoam_coupling_tpu_torch.ops.grid import (
    DIRICHLET,
    NEUMANN,
    FaceBC,
    FieldBC,
    Grid,
    pad_scalar,
)
from yade_openfoam_coupling_tpu_torch.ops.stencil import (
    face_interp_all_padded,
    laplacian_facegamma_padded,
)
from yade_openfoam_coupling_tpu_torch.native import bindings as nb
from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as dw

GRID = Grid.box((12, 10, 14), (0.012, 0.010, 0.014))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _particle_fields(grid, n, device, seed):
    rng = np.random.RandomState(seed)
    lo = [0.08 * L for L in grid.lengths]
    hi = [0.92 * L for L in grid.lengths]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return cp.ParticleFields(t(rng.uniform(lo, hi, (n, 3))), t(rng.randn(n, 3) * 1e-3),
                             t(rng.randn(n, 3) * 1e-2), torch.full((n,), 4e-4, device=device),
                             torch.ones(n, dtype=torch.bool, device=device))


def _fluid_stack(grid, periodic, cfg, device, seed):
    """Seeded padded input stack (C_in, nx+2, ny+2, nz+2), alpha last."""
    rng = np.random.RandomState(seed)
    C_in = 10 + 3 * cfg.use_torque + 3 * cfg.use_added_mass
    F = rng.randn(C_in, *grid.shape).astype(np.float32) * 1e-2
    F[-1] = 0.9 + 0.1 * rng.rand(*grid.shape)
    return pad_wrap_zero(torch.as_tensor(F, device=device), periodic)


def _assert_channels_close(out, ref, rtol=1e-5):
    """Within rtol of each output channel's scale: f32 sums in the same
    order as the plain version; exp and pow of the CUDA math library and of
    PyTorch's kernels may differ by an ulp."""
    assert out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs().reshape(ref.shape[0], -1).amax(-1)
    scale = ref.abs().reshape(ref.shape[0], -1).amax(-1)
    assert bool((err <= rtol * scale + 1e-30).all()), float((err / scale).max())


def _window_case(periodic, cfg, device, seed):
    pf = _particle_fields(GRID, 300, device, seed)
    W = cw.window_size(300, GRID.shape[0], cfg.planes_window)
    bins = cw.window_bins(pf, GRID, cfg.slot_capacity, W, with_angvel=cfg.use_torque)
    return _fluid_stack(GRID, periodic, cfg, device, seed), bins


@pytest.mark.cuda
@pytest.mark.parametrize("shape,periodic,extras", [
    ("sphere2", (True, True, False), False),
    ("cube", (False, False, False), False),
    ("sphere2", (True, True, False), True),
])
def test_window_kernel_matches_plain(cuda, shape, periodic, extras):
    """CUDA tensors launch the kernel of csrc/window_exchange.cu and count
    the launch; it agrees with the plain version to 1e-5 of each output
    channel's scale, also with torque and added mass (C_in 16, C_d 10, 7
    result channels)."""
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape=shape,
                            exchange="window", slot_capacity=4, dy_in_kernel=True,
                            window_dynamic=True, use_torque=extras, use_added_mass=extras)
    Fp, bins = _window_case(periodic, cfg, cuda, seed=21)
    args = (Fp, bins.dat_win, GRID, periodic, cfg, 0, 1e-6, 1000.0)
    plain = cw.window_exchange_padded_reference(*args, counts=bins.counts)
    before = cw.window_exchange_padded.launches
    kern = cw.window_exchange_padded(*args, counts=bins.counts)
    torch.cuda.synchronize()
    assert cw.window_exchange_padded.launches == before + 1
    assert kern[1] == plain[1]
    assert kern[2].shape[0] == (7 if extras else 4)
    for o, r in ((kern[0], plain[0]), (kern[2], plain[2])):
        _assert_channels_close(o.reshape(o.shape[0] * o.shape[1], -1),
                               r.reshape(r.shape[0] * r.shape[1], -1))
    if extras:
        assert float(kern[2][3:6].abs().max()) > 0.0


@pytest.mark.cuda
def test_window_kernel_rejects_what_it_does_not_take(cuda):
    grid = Grid.cube(8, 0.008)
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window")
    pf = _particle_fields(grid, 50, cuda, seed=3)
    bins = cw.window_bins(pf, grid, cfg.slot_capacity, 512)
    Fp = _fluid_stack(grid, (True, True, False), cfg, cuda, seed=3)
    args = (grid, (True, True, False), cfg, 0, 1e-6, 1000.0)
    with pytest.raises(ValueError, match="contiguous"):
        cw.window_exchange_padded(Fp.transpose(2, 3), bins.dat_win, *args)
    with pytest.raises(ValueError, match="counts"):
        cw.window_exchange_padded(Fp, bins.dat_win, *args, counts=bins.counts.long())
    # torque mode stages 10 channels: a 7-channel window is refused
    torque = dataclasses.replace(cfg, use_torque=True)
    with pytest.raises(ValueError, match="Fp"):
        cw.window_exchange_padded(Fp, bins.dat_win, grid, (True, True, False), torque,
                                  0, 1e-6, 1000.0)


def _planes_case(periodic, cfg, device, seed, slab=None):
    """Slot table and padded stack of the whole grid, or of the x-slab
    `slab` = (x0, nxc) as the chunked exchange cuts them."""
    pf = _particle_fields(GRID, 300, device, seed)
    Fp = _fluid_stack(GRID, periodic, cfg, device, seed)
    kw, x0 = {}, 0
    if slab is not None:
        x0, nxc = slab
        Fp = Fp[:, x0:x0 + nxc + 2].contiguous()
        kw = dict(x_start=x0, n_loc=nxc)
    bins = cpp.bin_particles_planes(pf, GRID, cfg.slot_capacity,
                                    with_angvel=cfg.use_torque, **kw)
    return Fp, bins.D, x0


PLANES_CASES = [((True, True, False), False, None), ((False, False, False), False, (4, 4)),
                ((True, True, False), True, (8, 4))]


def _planes_cfg(extras):
    return cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                             exchange="planes", slot_capacity=4, use_torque=extras,
                             use_added_mass=extras)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,extras,slab", PLANES_CASES)
def test_planes_fused_kernel_matches_plain(cuda, periodic, extras, slab):
    """The fused planes kernel (csrc/planes_exchange.cu) against its plain
    version on the whole grid and on slabs at x_off 4 and 8, with torque
    and added mass off and on."""
    cfg = _planes_cfg(extras)
    Fp, D, x0 = _planes_case(periodic, cfg, cuda, seed=31, slab=slab)
    args = (Fp, D, GRID, periodic, cfg, x0, 1e-6, 1000.0)
    plain = cpp.fused_exchange_padded_reference(*args)
    before = cpp.fused_exchange_padded.launches
    kern = cpp.fused_exchange_padded(*args)
    torch.cuda.synchronize()
    assert cpp.fused_exchange_padded.launches == before + 1
    assert kern[1] == plain[1]
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))
    _assert_channels_close(kern[2], plain[2])


GRID_256 = Grid.cube(256, 0.256)
CHANNEL = (True, True, False)


def _lattice_1m(device):
    """bench_1m's case: 1M particles on bench.py's jittered lattice over
    256^3 (h = 1 mm), with seeded velocities and angular velocities, and a
    seeded padded 10-channel fluid stack of the whole grid."""
    from yade_openfoam_coupling_tpu_torch.bench import lattice_positions
    n = 1_000_000
    gen = torch.Generator(device=device).manual_seed(11)
    pos = torch.as_tensor(lattice_positions(n, GRID_256.lengths[0]), dtype=torch.float32,
                          device=device)
    pf = cp.ParticleFields(pos, 1e-2 * torch.randn(pos.shape, generator=gen, device=device),
                           1e-1 * torch.randn(pos.shape, generator=gen, device=device),
                           torch.full((n,), 4e-4, device=device),
                           torch.ones(n, dtype=torch.bool, device=device))
    F = 1e-2 * torch.randn((10,) + GRID_256.shape, generator=gen, device=device)
    F[-1] = 0.9 + 0.1 * torch.rand(GRID_256.shape, generator=gen, device=device)
    return pf, pad_wrap_zero(F, CHANNEL)


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [0, 3, 7])
def test_planes_fused_kernel_on_a_256_slab(cuda, slab):
    """B4 on one slab of bench_1m's default exchange (8 slabs of 32 planes
    of 256^2 at 1M particles, 'col' staging), as the chunked exchange cuts
    it, against its plain version; the first, a middle and the last slab
    (whose upper halo plane wraps)."""
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="planes", slot_capacity=4, planes_chunks=8,
                            packed_bin="col", dy_in_kernel=True)
    pf, Fp = _lattice_1m(cuda)
    x0, nxc = 32 * slab, 32
    Fp = Fp[:, x0:x0 + nxc + 2].contiguous()
    D = cpp.bin_particles_planes(pf, GRID_256, 4, packed_bin="col", x_start=x0, n_loc=nxc).D
    args = (Fp, D, GRID_256, CHANNEL, cfg, x0, 1e-6, 1000.0)
    plain = cpp.fused_exchange_padded_reference(*args)
    kern = cpp.fused_exchange_padded(*args, max_occupied=pf.pos.shape[0])
    torch.cuda.synchronize()
    assert kern[1] == plain[1]
    assert int((D[6] > 0).sum()) > 10_000
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))
    _assert_channels_close(kern[2], plain[2])


@pytest.mark.cuda
def test_window_kernel_on_the_1m_window(cuda):
    """B1 on bench_1m --fast's whole window (1M particles on 256^3, W =
    10,240 rows a plane, every particle inside its plane's window), where a
    fifth of the cells pass's blocks hold more records than their shared
    memory, against its plain version."""
    cfg = cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                            exchange="window", slot_capacity=4, packed_unbin=True,
                            dy_in_kernel=True, window_dynamic=True)
    pf, Fp = _lattice_1m(cuda)
    W = cw.window_size(pf.pos.shape[0], 256, cfg.planes_window)
    assert W == 10_240
    bins = cw.window_bins(pf, GRID_256, 4, W)
    assert int(bins.counts.max()) <= W and int(bins.counts.sum()) == pf.pos.shape[0]
    args = (Fp, bins.dat_win, GRID_256, CHANNEL, cfg, 0, 1e-6, 1000.0)
    plain = cw.window_exchange_padded_reference(*args, counts=bins.counts)
    kern = cw.window_exchange_padded(*args, counts=bins.counts)
    torch.cuda.synchronize()
    assert kern[1] == plain[1]
    for o, r in ((kern[0], plain[0]), (kern[2], plain[2])):
        _assert_channels_close(o.reshape(o.shape[0] * o.shape[1], -1),
                               r.reshape(r.shape[0] * r.shape[1], -1))


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,extras,slab", PLANES_CASES)
def test_planes_interp_and_deposit_kernels_match_plain(cuda, periodic, extras, slab):
    """The interpolation and deposit kernels against their plain versions:
    G and the norm, then the deposit of the pre-normalised V that the force
    laws make from them."""
    cfg = _planes_cfg(extras)
    Fp, D, x0 = _planes_case(periodic, cfg, cuda, seed=41, slab=slab)
    nxl = Fp.shape[1] - 2
    args = (Fp, D, GRID, periodic, cfg, x0)
    G_p, n_p = cpp.interp_planes_padded_reference(*args)
    before = cpp.interp_planes_padded.launches
    G_k, n_k = cpp.interp_planes_padded(*args)
    torch.cuda.synchronize()
    assert cpp.interp_planes_padded.launches == before + 1
    _assert_channels_close(G_k, G_p)
    _assert_channels_close(n_k[None], n_p[None])

    V, _, _, _ = cpp._physics_planes(D, G_p, n_p, GRID.cell_volume, 1e-6, 1000.0, cfg)
    inv = torch.where(n_p > 0, 1.0 / torch.where(n_p > 0, n_p, 1.0), 0.0)
    Vn = (V * inv[None]).contiguous()
    dargs = (Vn, D, nxl, GRID, periodic, cfg, x0)
    plain = cpp.deposit_stacks_reference(*dargs)
    before = cpp.deposit_stacks.launches
    kern = cpp.deposit_stacks(*dargs)
    torch.cuda.synchronize()
    assert cpp.deposit_stacks.launches == before + 1
    assert kern[1] == plain[1]
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))


EMPTY_PLANE, FULL_PLANE, EDGE_W = 5, 9, 32


def _edge_particles(device, seed):
    """Particles on GRID that reach every branch of the exchange kernels:
    a random bulk that leaves plane EMPTY_PLANE empty, 45 more in plane
    FULL_PLANE (more than an EDGE_W-row window holds), exactly cap = 4 in
    one cell and 6 (2 over cap) in another, and particles in the first and
    last cells of y and z, against the faces (periodic seams or walls)."""
    rng = np.random.RandomState(seed)
    h = np.asarray(GRID.spacing)
    L = np.asarray(GRID.lengths)
    bulk = rng.uniform(0.08 * L, 0.92 * L, (200, 3))
    ix = np.floor(bulk[:, 0] / h[0]).astype(int)
    bulk[ix == EMPTY_PLANE, 0] += h[0]

    def in_cell(cell, n):
        return (np.asarray(cell) + rng.uniform(0.05, 0.95, (n, 3))) * h

    full = np.column_stack([(FULL_PLANE + rng.uniform(0.05, 0.95, 45)) * h[0],
                            rng.uniform(0.02, 0.98, 45) * L[1],
                            rng.uniform(0.02, 0.98, 45) * L[2]])
    ny, nz = GRID.shape[1], GRID.shape[2]
    faces = np.concatenate([in_cell((2, 0, 6), 2), in_cell((3, ny - 1, 6), 2),
                            in_cell((7, 4, 0), 2), in_cell((8, 5, nz - 1), 2),
                            in_cell((10, 0, nz - 1), 1), in_cell((1, ny - 1, 0), 1)])
    faces[:2, 1] = 0.02 * h[1]
    faces[2:4, 1] = L[1] - 0.02 * h[1]
    faces[4:6, 2] = 0.02 * h[2]
    faces[6:8, 2] = L[2] - 0.02 * h[2]
    pos = np.concatenate([bulk, full, in_cell((3, 4, 5), 4), in_cell((6, 2, 3), 6), faces])
    n = len(pos)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return cp.ParticleFields(t(pos), t(rng.randn(n, 3) * 1e-3), t(rng.randn(n, 3) * 1e-2),
                             t(4e-4 * (1.0 + 0.2 * rng.rand(n))),
                             torch.ones(n, dtype=torch.bool, device=device))


def _window_cfg(extras):
    return cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                             exchange="window", slot_capacity=4, dy_in_kernel=True,
                             window_dynamic=True, use_torque=extras, use_added_mass=extras)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,extras,counts_mode", [
    ((True, True, False), False, "bins"),
    ((True, True, False), True, "bins"),
    ((False, False, False), False, "bins"),
    ((True, True, True), True, "cut"),
    ((True, True, False), False, None),
    ((False, False, False), True, None),
])
def test_window_kernel_edge_cases(cuda, periodic, extras, counts_mode):
    """The window kernel against its plain version at KERNEL_RTOL on a plane
    with no live rows, a plane whose window is full (its count above W, rows
    cut), a cell with exactly cap particles and one past cap, particles on
    the y/z seams and walls; with the bins' counts, with one plane's count
    cut below its live rows (read on the card), and with counts=None; with
    torque and added mass off and on."""
    cfg = _window_cfg(extras)
    bins = cw.window_bins(_edge_particles(cuda, seed=51), GRID, 4, EDGE_W,
                          with_angvel=extras)
    counts = bins.counts.clone()
    assert int(counts[EMPTY_PLANE]) == 0 and int(counts[FULL_PLANE]) > EDGE_W
    assert int(bins.n_overflow) > 0
    if counts_mode == "cut":
        counts[2] = counts[2] // 2
    kw = {} if counts_mode is None else {"counts": counts}
    Fp = _fluid_stack(GRID, periodic, cfg, cuda, seed=52)
    args = (Fp, bins.dat_win, GRID, periodic, cfg, 0, 1e-6, 1000.0)
    plain = cw.window_exchange_padded_reference(*args, **kw)
    before = cw.window_exchange_padded.launches
    kern = cw.window_exchange_padded(*args, **kw)
    torch.cuda.synchronize()
    assert cw.window_exchange_padded.launches == before + 1
    assert kern[1] == plain[1]
    for o, r in ((kern[0], plain[0]), (kern[2], plain[2])):
        _assert_channels_close(o.reshape(o.shape[0] * o.shape[1], -1),
                               r.reshape(r.shape[0] * r.shape[1], -1))
    assert int(kern[2][-1].sum()) == int(plain[2][-1].sum()) > 0   # found slots


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,extras,slab,bounded", [
    ((True, True, False), False, None, True),
    ((True, True, False), True, None, False),
    ((False, False, False), False, (4, 4), True),
    ((True, True, True), True, (8, 4), True),
    ((False, False, False), True, (4, 4), False),
])
def test_planes_fused_kernel_edge_cases(cuda, periodic, extras, slab, bounded):
    """The fused planes kernel against its plain version at KERNEL_RTOL on
    the edge-case particles (an empty plane, exactly cap and past cap in a
    cell, the seams and walls), on the whole grid and on slabs at x_off 4
    and 8, with the compact records bounded by the particle count or by
    every slot."""
    cfg = _planes_cfg(extras)
    pf = _edge_particles(cuda, seed=61)
    Fp = _fluid_stack(GRID, periodic, cfg, cuda, seed=62)
    kw, x0 = {}, 0
    if slab is not None:
        x0, nxc = slab
        Fp = Fp[:, x0:x0 + nxc + 2].contiguous()
        kw = dict(x_start=x0, n_loc=nxc)
    bins = cpp.bin_particles_planes(pf, GRID, 4, with_angvel=extras, **kw)
    if slab is None:
        assert int(bins.n_overflow) >= 2
    args = (Fp, bins.D, GRID, periodic, cfg, x0, 1e-6, 1000.0)
    plain = cpp.fused_exchange_padded_reference(*args)
    before = cpp.fused_exchange_padded.launches
    kern = cpp.fused_exchange_padded(
        *args, max_occupied=pf.pos.shape[0] if bounded else None)
    torch.cuda.synchronize()
    assert cpp.fused_exchange_padded.launches == before + 1
    assert kern[1] == plain[1]
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))
    _assert_channels_close(kern[2], plain[2])
    assert int(kern[2][-1].sum()) == int(plain[2][-1].sum()) > 0


def _seeded_V(cap, ncl, device, seed):
    """Seeded pre-normalised slot values V (8, cap, ncl) for the deposit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((8, cap, ncl), generator=gen, device=device) * 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["window", "planes", "deposit"])
def test_exchange_kernels_crowded_band(cuda, exchange):
    """A plane holding cap = 4 particles in each of 100 of its 400 cells:
    the cells pass's band halo holds more records than its shared memory
    takes, so it reads them from device memory, and B1, B4 and B6 still
    agree with their plain versions at KERNEL_RTOL."""
    grid = Grid.box((4, 10, 40), (0.004, 0.010, 0.040))
    rng = np.random.RandomState(81)
    cells = rng.choice(10 * 40, 100, replace=False)
    base = np.stack([np.ones(100), cells // 40, cells % 40], 1).repeat(4, 0)
    pos = (base + rng.uniform(0.05, 0.95, base.shape)) * 1e-3
    n = len(pos)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    pf = cp.ParticleFields(t(pos), t(rng.randn(n, 3) * 1e-3), t(rng.randn(n, 3) * 1e-2),
                           torch.full((n,), 4e-4, device=cuda),
                           torch.ones(n, dtype=torch.bool, device=cuda))
    periodic = (True, True, False)
    if exchange == "window":
        cfg = _window_cfg(False)
        bins = cw.window_bins(pf, grid, 4, 512)
        args = (_fluid_stack(grid, periodic, cfg, cuda, seed=82), bins.dat_win, grid, periodic,
                cfg, 0, 1e-6, 1000.0)
        plain = cw.window_exchange_padded_reference(*args, counts=bins.counts)
        kern = cw.window_exchange_padded(*args, counts=bins.counts)
    elif exchange == "planes":
        cfg = _planes_cfg(False)
        D = cpp.bin_particles_planes(pf, grid, 4).D
        args = (_fluid_stack(grid, periodic, cfg, cuda, seed=82), D, grid, periodic, cfg, 0,
                1e-6, 1000.0)
        plain = cpp.fused_exchange_padded_reference(*args)
        kern = cpp.fused_exchange_padded(*args, max_occupied=n)
    else:
        cfg = _planes_cfg(False)
        D = cpp.bin_particles_planes(pf, grid, 4).D
        args = (_seeded_V(4, grid.ncells, cuda, 83), D, grid.shape[0], grid, periodic, cfg, 0)
        plain = cpp.deposit_stacks_reference(*args)
        kern = cpp.deposit_stacks(*args, max_occupied=n)
    torch.cuda.synchronize()
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))
    if exchange != "deposit":
        assert int(plain[2][-1].sum()) == n == int(kern[2][-1].sum())
        _assert_channels_close(kern[2].reshape(kern[2].shape[0] * 4, -1),
                               plain[2].reshape(plain[2].shape[0] * 4, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["window", "planes", "deposit"])
def test_exchange_kernels_are_deterministic(cuda, exchange):
    """Two launches of B1, B4 or B6 on the same inputs give the same stacks
    and per-slot results bit for bit (no float atomics; the planes
    kernels' list of occupied slots may come out in another order)."""
    extras = exchange == "planes"
    periodic = (True, True, False)
    pf = _edge_particles(cuda, seed=71)
    if exchange == "window":
        cfg = _window_cfg(extras)
        bins = cw.window_bins(pf, GRID, 4, EDGE_W, with_angvel=extras)
        Fp = _fluid_stack(GRID, periodic, cfg, cuda, seed=72)

        def run():
            return cw.window_exchange_padded(Fp, bins.dat_win, GRID, periodic, cfg, 0, 1e-6,
                                             1000.0, counts=bins.counts)
    elif exchange == "planes":
        cfg = _planes_cfg(extras)
        D = cpp.bin_particles_planes(pf, GRID, 4, with_angvel=extras).D
        Fp = _fluid_stack(GRID, periodic, cfg, cuda, seed=72)

        def run():
            return cpp.fused_exchange_padded(Fp, D, GRID, periodic, cfg, 0, 1e-6, 1000.0,
                                             max_occupied=pf.pos.shape[0])
    else:
        cfg = _planes_cfg(False)
        D = cpp.bin_particles_planes(pf, GRID, 4).D
        V = _seeded_V(4, GRID.ncells, cuda, 73)

        def run():
            return cpp.deposit_stacks(V, D, GRID.shape[0], GRID, periodic, cfg, 0,
                                      max_occupied=pf.pos.shape[0])
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    if exchange != "deposit":
        assert torch.equal(first[2], second[2])
    assert float(first[0].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,slab,bounded", [
    ((True, True, False), None, True),
    ((False, False, False), None, False),
    ((False, False, False), (4, 4), True),
    ((True, True, True), (8, 4), True),
])
def test_planes_deposit_kernel_edge_cases(cuda, periodic, slab, bounded):
    """B6 (scan, records, cells) against its plain version at KERNEL_RTOL
    on the edge-case particles (an empty plane, exactly cap and past cap in
    a cell, the seams and walls), on the whole grid and on slabs at x_off 4
    and 8, with the records bounded by the particle count or by every
    slot."""
    cfg = _planes_cfg(False)
    pf = _edge_particles(cuda, seed=63)
    kw, x0, nxl = {}, 0, GRID.shape[0]
    if slab is not None:
        x0, nxl = slab
        kw = dict(x_start=x0, n_loc=nxl)
    D = cpp.bin_particles_planes(pf, GRID, 4, **kw).D
    ncl = nxl * GRID.shape[1] * GRID.shape[2]
    args = (_seeded_V(4, ncl, cuda, 64), D, nxl, GRID, periodic, cfg, x0)
    plain = cpp.deposit_stacks_reference(*args)
    before = cpp.deposit_stacks.launches
    kern = cpp.deposit_stacks(*args, max_occupied=pf.pos.shape[0] if bounded else None)
    torch.cuda.synchronize()
    assert cpp.deposit_stacks.launches == before + 1
    assert kern[1] == plain[1]
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))


# crowded cells (cell, particles) on GRID: ranks past 8, past 16, past 32
CROWDS = (((3, 4, 5), 12), ((6, 2, 7), 17), ((9, 7, 13), 40), ((0, 0, 0), 10))


def _crowded_particles(device, seed):
    """A uniform bulk of 150 on GRID plus CROWDS, the first particle of the
    first crowd with radius 0 (an empty slot at rank 0 below occupied
    ranks), the last crowd in the corner cell against the seams."""
    rng = np.random.RandomState(seed)
    h, L = np.asarray(GRID.spacing), np.asarray(GRID.lengths)
    parts = [rng.uniform(0.08 * L, 0.92 * L, (150, 3))]
    starts = []
    for cell, k in CROWDS:
        starts.append(sum(len(p) for p in parts))
        parts.append((np.asarray(cell) + rng.uniform(0.05, 0.95, (k, 3))) * h)
    pos = np.concatenate(parts)
    n = len(pos)
    radius = 4e-4 * (1.0 + 0.2 * rng.rand(n))
    radius[starts[0]] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return cp.ParticleFields(t(pos), t(rng.randn(n, 3) * 1e-3), t(rng.randn(n, 3) * 1e-2),
                             t(radius), torch.ones(n, dtype=torch.bool, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [9, 16, 33])
@pytest.mark.parametrize("kernel", ["window", "planes", "deposit"])
def test_exchange_kernels_past_eight_slots(cuda, kernel, cap):
    """B1, B4 and B6 take any slot capacity: at cap 9, 16 and 33, on a
    cloud whose crowds fill ranks past 8 and past 32 (and overflow), with
    an empty slot below occupied ranks, they agree with their plain
    versions at KERNEL_RTOL; the planes kernels get the exact number of
    occupied slots as their record bound."""
    periodic = (True, True, False)
    pf = _crowded_particles(cuda, seed=91)
    if kernel == "window":
        cfg = dataclasses.replace(_window_cfg(False), slot_capacity=cap)
        bins = cw.window_bins(pf, GRID, cap, 512)
        assert int(bins.rank.max()) >= 39 and int(bins.keep.sum()) > 0
        args = (_fluid_stack(GRID, periodic, cfg, cuda, seed=92), bins.dat_win, GRID, periodic,
                cfg, 0, 1e-6, 1000.0)
        plain = cw.window_exchange_padded_reference(*args, counts=bins.counts)
        kern = cw.window_exchange_padded(*args, counts=bins.counts)
    else:
        cfg = dataclasses.replace(_planes_cfg(False), slot_capacity=cap)
        bins = cpp.bin_particles_planes(pf, GRID, cap)
        occupied = int((bins.D[6] > 0).sum())
        assert int((bins.D[6] > 0).sum(0).max()) == cap and int(bins.n_overflow) > 0
        if kernel == "planes":
            args = (_fluid_stack(GRID, periodic, cfg, cuda, seed=92), bins.D, GRID, periodic,
                    cfg, 0, 1e-6, 1000.0)
            plain = cpp.fused_exchange_padded_reference(*args)
            kern = cpp.fused_exchange_padded(*args, max_occupied=int(bins.keep.sum()))
        else:
            args = (_seeded_V(cap, GRID.ncells, cuda, 93), bins.D, GRID.shape[0], GRID,
                    periodic, cfg, 0)
            plain = cpp.deposit_stacks_reference(*args)
            kern = cpp.deposit_stacks(*args, max_occupied=int(bins.keep.sum()))
        assert int(bins.keep.sum()) == occupied + 1      # the radius-0 slot
    torch.cuda.synchronize()
    assert kern[1] == plain[1]
    _assert_channels_close(kern[0].reshape(24, -1), plain[0].reshape(24, -1))
    if kernel != "deposit":
        assert kern[2].shape[1] == cap
        _assert_channels_close(kern[2].reshape(kern[2].shape[0] * cap, -1),
                               plain[2].reshape(plain[2].shape[0] * cap, -1))
        assert int(kern[2][-1].sum()) == int(plain[2][-1].sum()) > 8


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["window_exchange", "planes_exchange"])
def test_scratch_layout_matches_the_library(cuda, lib):
    """The scratch layout that `carve` (csrc/exchange_common.cuh) uses equals
    `_scratch_layout` at sizes past 8 and 32 slots a cell."""
    for ncl, cap in ((7, 1), (210, 9), (1000, 16), (12 ** 3, 33), (128 ** 3, 4)):
        for n_rec in (0, 3, cap * ncl):
            assert cpp.library_scratch_layout(lib, ncl, n_rec) == \
                cpp._scratch_layout(ncl, n_rec)


ASYMMETRIC = np.array([[1, 0, 0], [0, -1, 1], [-1, 1, -1], [0, 0, 1], [1, -1, 0]])


@pytest.mark.cuda
@pytest.mark.parametrize("offsets,C", [
    (cp.stencil_offsets(cp.CouplingConfig(stencil_shape="cube")), 4),
    (cp.stencil_offsets(cp.CouplingConfig(stencil_shape="sphere2")), 8),
    (cp.stencil_offsets(cp.CouplingConfig(stencil_shape="sphere2")), 1),
    (cp.TRILINEAR_CORNERS, 3),
    (ASYMMETRIC, 3),
])
def test_rolls_kernel_matches_plain(cuda, offsets, C):
    """B3 (csrc/rolls_deposit.cu) against the plain roll loop, bit for bit
    (the same sum order), on a strided view of an offset-major buffer with
    a scrap column, as the deposit hands it over (also with one channel,
    whose size-1 dim carries no stride), the point-force exchange's 8
    corners with 3 channels; the asymmetric offset set pins the roll
    direction."""
    S, shape = len(offsets), (12, 10, 14)
    ncells = int(np.prod(shape))
    gen = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn((S * C, ncells + 1), generator=gen, device=cuda)
    bufT = buf[:, :ncells].view((S, C) + shape)
    plain = rolls.distribute_rolls_reference(bufT, offsets)
    before = rolls.distribute_rolls.launches
    kern = rolls.distribute_rolls(bufT, offsets)
    torch.cuda.synchronize()
    assert rolls.distribute_rolls.launches == before + 1
    assert torch.equal(kern, plain)
    with pytest.raises(ValueError, match="strided"):
        rolls.distribute_rolls(bufT.transpose(3, 4), offsets)


ROLL_SETS = {
    "cube (27, 4)": (cp.stencil_offsets(cp.CouplingConfig(stencil_shape="cube")), 4),
    "sphere2 (19, 4)": (cp.stencil_offsets(cp.CouplingConfig(stencil_shape="sphere2")), 4),
    "corners (8, 3)": (cp.TRILINEAR_CORNERS, 3),
    "one tap (1, 1)": (np.array([[1, -1, 1]]), 1),
    "wide dz (5, 2)": (np.array([[0, 0, 2], [1, 0, -3], [0, 1, 4], [-1, -1, -4], [0, 0, -1]]),
                       2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROLL_SETS))
@pytest.mark.parametrize("nz,row", [(16, "padded"), (16, "scrap"), (14, "padded"),
                                    (14, "scrap")])
def test_rolls_kernel_layouts(cuda, name, nz, row):
    """B3 bit for bit against the plain roll loop at the tap counts the
    paths use (27, 19, 8) and at 1 and 5, on the deposit's anchor buffer
    with rows padded to 32 floats (vector loads where nz is a multiple of
    4) and with the old ncells + 1 rows (scalar loads), for nz a multiple
    of 4 and not; every row's z seam is crossed by the dz = +-1 taps, and
    dz = 2, -3, 4, -4 take the other load paths."""
    offsets, C = ROLL_SETS[name]
    S, shape = len(offsets), (12, 10, nz)
    ncells = int(np.prod(shape))
    width = cp.anchor_row_length(ncells) if row == "padded" else ncells + 1
    gen = torch.Generator(device=cuda).manual_seed(17)
    buf = torch.randn((S * C, width), generator=gen, device=cuda)
    bufT = buf[:, :ncells].view((S, C) + shape)
    # one plane alone has no stride to read
    assert rolls._plane_stride(bufT, offsets) == (width if S * C > 1 else ncells)
    plain = rolls.distribute_rolls_reference(bufT, offsets)
    before = rolls.distribute_rolls.launches
    kern = rolls.distribute_rolls(bufT, offsets)
    torch.cuda.synchronize()
    assert rolls.distribute_rolls.launches == before + 1
    assert torch.equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("bc", [
    FieldBC.periodic(),
    FieldBC.box(NEUMANN),
    FieldBC(((FaceBC("periodic"),) * 2, (FaceBC(NEUMANN),) * 2,
             (FaceBC(DIRICHLET, 0.3), FaceBC(DIRICHLET, -0.2)))),
])
def test_laplacian_kernel_matches_plain(cuda, bc):
    """B2 (csrc/laplacian.cu) against the plain stencil to 1e-5 of scale on
    an anisotropic box, with periodic, Neumann and nonzero-Dirichlet
    ghosts."""
    grid = Grid.box((12, 10, 14), (0.012, 0.02, 0.007))
    gen = torch.Generator(device=cuda).manual_seed(8)
    p = torch.randn(grid.shape, generator=gen, device=cuda)
    gamma = 1.0 + 0.5 * torch.rand(grid.shape, generator=gen, device=cuda)
    gamma_f = face_interp_all_padded(pad_scalar(gamma, FieldBC.uniform(NEUMANN)))
    pp = pad_scalar(p, bc)
    plain = laplacian_facegamma_padded(gamma_f, pp, grid)
    before = fs.laplacian_facegamma_fused.launches
    kern = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
    torch.cuda.synchronize()
    assert fs.laplacian_facegamma_fused.launches == before + 1
    _assert_channels_close(kern[None], plain[None])
    with pytest.raises(ValueError, match="gamma_y"):
        fs.laplacian_facegamma_fused((gamma_f[0], gamma_f[1][:, :-1], gamma_f[2]), pp, grid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["prototype", "ragged"])
def test_dynwin_kernel_matches_plain(cuda, shape):
    """B7 (csrc/dynwin_staging.cu) against its plain version to 1e-5 of each
    plane's scale, dynamic equal to static bit for bit, on the prototype's
    inputs and on planes of 300 y rows (more than a block's threads) with
    W = 3 tiles of 1024 rows."""
    if shape == "prototype":
        dat, nch = dw.prototype_inputs()
        ny, nz, w_chunk = dw.NY, dw.NZ, dw.W_CHUNK
    else:
        rng = np.random.RandomState(9)
        ny, nz, w_chunk, W = 300, 7, 256, 3072
        counts = rng.randint(0, W + 1, 5)
        dat = np.zeros((5, 2, W), np.float32)
        dat[:, 0] = rng.randn(5, W)
        dat[:, 1] = rng.randint(0, ny, (5, W))
        for i, c in enumerate(counts):
            dat[i, 1, c:] = -1.0
        nch = np.ceil(counts / w_chunk).astype(np.int32)
    dat, nch = torch.as_tensor(dat, device=cuda), torch.as_tensor(nch, device=cuda)
    plain = dw.stage_planes_reference(dat, nch, ny, nz, w_chunk, True)
    before = dw.stage_planes.launches
    dyn = dw.stage_planes(dat, nch, ny, nz, w_chunk, True)
    static = dw.stage_planes(dat, nch, ny, nz, w_chunk, False)
    torch.cuda.synchronize()
    assert dw.stage_planes.launches == before + 2
    assert torch.equal(dyn, static)
    live = plain.reshape(plain.shape[0], -1).abs().amax(-1) > 0
    _assert_channels_close(dyn.reshape(dyn.shape[0], -1)[live],
                           plain.reshape(plain.shape[0], -1)[live])
    assert not dyn.reshape(dyn.shape[0], -1)[~live].any()


def _dynwin_case(case):
    """Seeded B7 inputs for one edge case: (dat, nch, ny, nz, w_chunk); rows
    past each plane's count are y = -1, so dynamic must equal static."""
    rng = np.random.RandomState(11)
    nxl, ny, nz, W, w_chunk = 6, 100, 8, 512, 64
    if case == "nz_not_mult_4":
        nz = 7
    elif case == "w_not_mult_256":
        W, w_chunk = 384, 128
    elif case == "wide_ny":           # y bands past the 1024 a block may own
        nxl, ny, nz, W = 300, 3000, 1, 128
    counts = rng.randint(1, W + 1, nxl)
    counts[1] = 0                     # a plane with no rows
    counts[2] = W                     # a full plane
    dat = np.zeros((nxl, 2, W), np.float32)
    dat[:, 0] = rng.randn(nxl, W)
    dat[:, 1] = rng.randint(0, ny, (nxl, W))
    if case == "one_y":               # 32-way collisions in every warp step
        dat[:, 0] = np.abs(dat[:, 0])
        dat[:, 1] = 5.0
    if case == "y_outside":
        dat[:, 1, ::3] = rng.choice([-7.0, -2.0, ny, ny + 3.0, 1e6], (nxl, len(range(0, W, 3))))
    for i, c in enumerate(counts):
        dat[i, 1, c:] = -1.0
    nch = np.ceil(counts / w_chunk).astype(np.int32)
    if case == "nch_out_of_range":
        nch[1] = -3                   # no rows either way
        nch[2] = W // w_chunk + 5     # clamped to the static bound
    return dat, nch, ny, nz, w_chunk


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ny_not_mult_32", "nz_not_mult_4", "w_not_mult_256", "one_y",
                                  "y_outside", "nch_out_of_range", "wide_ny"])
def test_dynwin_kernel_edge_cases(cuda, case):
    """B7 on edge cases (each holds an empty plane and a full one): dynamic
    equals static bit for bit, two launches are bit-identical, and both
    stay within 1e-5 of each plane's scale of the plain version (exactly
    zero where it is zero)."""
    dat, nch, ny, nz, w_chunk = _dynwin_case(case)
    dat, nch = torch.as_tensor(dat, device=cuda), torch.as_tensor(nch, device=cuda)
    args = (dat, nch, ny, nz, w_chunk)
    before = dw.stage_planes.launches
    dyn = dw.stage_planes(*args, True)
    static = dw.stage_planes(*args, False)
    again = dw.stage_planes(*args, True)
    torch.cuda.synchronize()
    assert dw.stage_planes.launches == before + 3
    assert torch.equal(dyn, static) and torch.equal(dyn, again)
    plain = dw.stage_planes_reference(*args, True)
    assert torch.equal(plain, dw.stage_planes_reference(*args, False))
    flat, ref = dyn.reshape(dyn.shape[0], -1), plain.reshape(plain.shape[0], -1)
    live = ref.abs().amax(-1) > 0
    assert bool(live.any()) and not bool(live[1])
    _assert_channels_close(flat[live], ref[live])
    assert not flat[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 64, 64), (13, 10, 17)])
def test_laplacian_bf16_kernel_matches_plain(cuda, shape):
    """B2's bf16 entry against the plain stencil run on the same bf16
    tensors (each operation rounded to bf16 as PyTorch rounds it): bit for
    bit, or at most 1 bf16 ulp of the output's scale, at the V-cycle's
    fine-level shapes and an odd one, with periodic x, Neumann y and
    nonzero-Dirichlet z ghosts; both dtypes count in `launches`, the bf16
    ones also in `launches_bf16`."""
    grid = Grid.box(shape, tuple(1e-3 * n for n in shape))
    bc = FieldBC(((FaceBC("periodic"),) * 2, (FaceBC(NEUMANN),) * 2,
                  (FaceBC(DIRICHLET, 0.3), FaceBC(DIRICHLET, -0.2))))
    gen = torch.Generator(device=cuda).manual_seed(18)
    p = torch.randn(grid.shape, generator=gen, device=cuda).to(torch.bfloat16)
    gamma = 1.0 + 0.5 * torch.rand(grid.shape, generator=gen, device=cuda)
    gamma_f = tuple(g.to(torch.bfloat16)
                    for g in face_interp_all_padded(pad_scalar(gamma, FieldBC.uniform(NEUMANN))))
    pp = pad_scalar(p, bc)
    plain = laplacian_facegamma_padded(gamma_f, pp, grid)
    before = (fs.laplacian_facegamma_fused.launches, fs.laplacian_facegamma_fused.launches_bf16)
    kern = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
    torch.cuda.synchronize()
    assert (fs.laplacian_facegamma_fused.launches,
            fs.laplacian_facegamma_fused.launches_bf16) == (before[0] + 1, before[1] + 1)
    assert kern.dtype == plain.dtype == torch.bfloat16 and bool(torch.isfinite(kern).all())
    scale = float(plain.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((kern.float() - plain.float()).abs().max()) <= ulp
    with pytest.raises(ValueError, match="gamma_x"):
        fs.laplacian_facegamma_fused((gamma_f[0].float(),) + gamma_f[1:], pp, grid)


_BF16_GHOSTS = {
    "mixed": FieldBC(((FaceBC("periodic"),) * 2, (FaceBC(NEUMANN),) * 2,
                      (FaceBC(DIRICHLET, 0.3), FaceBC(DIRICHLET, -0.2)))),
    "dirichlet": FieldBC(((FaceBC(DIRICHLET, -0.4), FaceBC(DIRICHLET, 0.1)),
                          (FaceBC(DIRICHLET, 0.25), FaceBC(DIRICHLET, -0.3)),
                          (FaceBC(DIRICHLET, 0.5), FaceBC(DIRICHLET, 0.2)))),
    "neumann": FieldBC.box(NEUMANN),
}


def _misaligned_copy(t):
    """A contiguous copy of t whose data starts 2 bytes past a 4-byte
    boundary (the kernel's 2-byte path)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 4 == 2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ghosts", sorted(_BF16_GHOSTS))
@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 64, 64), (32, 32, 32), (16, 16, 16),
                                   (8, 8, 8), (13, 10, 17), (20, 44, 70), (24, 12, 70)])
def test_laplacian_bf16_kernel_bit_for_bit(cuda, shape, ghosts):
    """B2's bf16 entry equals the plain stencil run on the same bf16 tensors
    (torch.equal) at every V-cycle level of a 128^3 grid, at (13, 10, 17)
    (odd nz: pairs that straddle the row's end, 2-byte loads), and where nz
    is not a multiple of a block's 64 z cells nor ny of its 8 y rows (20,
    44, 70), under mixed (periodic x, Neumann y, Dirichlet z), all
    nonzero-Dirichlet and all Neumann ghosts; and again with every array
    starting 2 bytes past a 4-byte boundary (the 2-byte path on even nz)."""
    grid = Grid.box(shape, tuple(1e-3 * (1 + 0.25 * a) * n for a, n in enumerate(shape)))
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    p = torch.randn(grid.shape, generator=gen, device=cuda).to(torch.bfloat16)
    gamma = 1.0 + 0.5 * torch.rand(grid.shape, generator=gen, device=cuda)
    gamma_f = tuple(g.to(torch.bfloat16)
                    for g in face_interp_all_padded(pad_scalar(gamma, FieldBC.uniform(NEUMANN))))
    pp = pad_scalar(p, _BF16_GHOSTS[ghosts])
    plain = laplacian_facegamma_padded(gamma_f, pp, grid)
    before = fs.laplacian_facegamma_fused.launches_bf16
    kern = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
    odd = fs.laplacian_facegamma_fused(tuple(_misaligned_copy(g) for g in gamma_f),
                                       _misaligned_copy(pp), grid)
    torch.cuda.synchronize()
    assert fs.laplacian_facegamma_fused.launches_bf16 == before + 2
    assert kern.dtype == torch.bfloat16 and bool(torch.isfinite(kern).all())
    assert torch.equal(kern, plain) and torch.equal(odd, plain)


@pytest.mark.cuda
def test_bf16_vcycle_kernel_equals_plain(cuda):
    """A whole bf16 V-cycle (MGConfig.bf16) with B2's bf16 entry on every
    level of sides >= 8 gives the same correction, torch.equal, as the
    same V-cycle on the plain stencil, on a 64^3 channel."""
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
    grid = Grid.cube(64, 0.064)
    bc = FieldBC(((FaceBC("periodic"),) * 2, (FaceBC("periodic"),) * 2,
                  (FaceBC(NEUMANN),) * 2))
    gen = torch.Generator(device=cuda).manual_seed(23)
    gamma = 1.0 + 0.5 * torch.rand(grid.shape, generator=gen, device=cuda)
    gamma_f = face_interp_all_padded(pad_scalar(gamma, FieldBC.uniform(NEUMANN)))
    r = torch.randn(grid.shape, generator=gen, device=cuda)
    cfg = pr.MGConfig(bf16=True)
    before = fs.laplacian_facegamma_fused.launches_bf16
    kern = pr.make_mg_preconditioner(gamma_f, grid, bc, cfg, use_pallas=True)(r)
    launched = fs.laplacian_facegamma_fused.launches_bf16 - before
    plain = pr.make_mg_preconditioner(gamma_f, grid, bc, cfg, use_pallas=False)(r)
    torch.cuda.synchronize()
    assert launched > 0 and fs.laplacian_facegamma_fused.launches_bf16 == before + launched
    assert bool(torch.isfinite(kern).all()) and torch.equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [125, 28])
@pytest.mark.parametrize("nz,row", [(16, "padded"), (14, "scrap")])
def test_rolls_kernel_many_taps(cuda, taps, nz, row):
    """B3's tap loop (more than 27 taps) bit for bit against the plain roll
    loop: the stencil_width=5 cube (125 taps, dz up to +-2) and its first
    28, with C = 4, on the padded anchor rows (vector loads) and on
    ncells + 1 rows with nz 14 (scalar loads)."""
    offsets = cp.stencil_offsets(cp.CouplingConfig(stencil_width=5))[:taps]
    C, shape = 4, (12, 10, nz)
    ncells = int(np.prod(shape))
    width = cp.anchor_row_length(ncells) if row == "padded" else ncells + 1
    gen = torch.Generator(device=cuda).manual_seed(19)
    buf = torch.randn((taps * C, width), generator=gen, device=cuda)
    bufT = buf[:, :ncells].view((taps, C) + shape)
    plain = rolls.distribute_rolls_reference(bufT, offsets)
    before = rolls.distribute_rolls.launches
    kern = rolls.distribute_rolls(bufT, offsets)
    torch.cuda.synchronize()
    assert rolls.distribute_rolls.launches == before + 1
    assert torch.equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcg", "mgpcg", "mgpcg_bf16"])
def test_pcg_fixed_iters_reads_nothing_on_the_host(cuda, solver):
    """`pcg(fixed_iters=)` with B2 in every matvec (use_pallas) runs its
    iterations under `torch.cuda.set_sync_debug_mode("error")`, which
    raises on any host read or synchronisation; with a budget of the while
    loop's iterations + 3 it returns the while loop's live count and x."""
    from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
    grid = Grid.cube(32, 0.032)
    bc = FieldBC.periodic()
    gen = torch.Generator(device=cuda).manual_seed(20)
    gamma = 1.0 + 0.5 * torch.rand(grid.shape, generator=gen, device=cuda)
    gamma_f = face_interp_all_padded(pad_scalar(gamma, bc))
    b = torch.randn(grid.shape, generator=gen, device=cuda)
    b = b - b.mean()
    pad = pr.default_pad(bc)

    def apply_A(x):
        return pr.poisson_apply(x, gamma_f, grid, pad, use_pallas=True)

    if solver == "pcg":
        d = pr.poisson_diag(gamma_f, grid, bc)
        M = lambda r: r / d  # noqa: E731
    else:
        M = pr.make_mg_preconditioner(gamma_f, grid, bc, pr.MGConfig(bf16=solver.endswith("bf16")),
                                      use_pallas=True)
    x0 = torch.zeros_like(b)
    ref = pr.pcg(apply_A, b, x0, precond=M, tol=1e-5, maxiter=200)
    n = int(ref.iters)
    torch.cuda.synchronize()
    launches = fs.laplacian_facegamma_fused.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pr.pcg(apply_A, b, x0, precond=M, tol=1e-5, maxiter=200, fixed_iters=n + 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fs.laplacian_facegamma_fused.launches > launches + n
    assert int(out.iters) == n > 2
    assert float((out.x - ref.x).abs().max()) <= 1e-6 * float(ref.x.abs().max())


@pytest.mark.cuda
def test_ring_exchange_at_one_nccl_rank_is_a_local_copy(cuda, tmp_path):
    """A one-rank NCCL group: the ring permute hands back copies of what
    each direction sent (torch refuses a send to self; JAX's one-shard
    ppermute is a self-permute), and a reduction is the value itself."""
    import datetime

    import torch.distributed as dist

    from yade_openfoam_coupling_tpu_torch.parallel import ctx as pctx
    from yade_openfoam_coupling_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device=cuda)
        assert mesh.backend == "nccl" and mesh.size == 1 and mesh.device.type == "cuda"
        a = torch.arange(6.0, device=mesh.device).reshape(2, 3)
        b = -torch.arange(4.0, device=mesh.device)
        from_left, from_right = pctx.ring_exchange(mesh, [a], [b])
        assert torch.equal(from_left[0], a) and torch.equal(from_right[0], b)
        assert from_left[0].data_ptr() != a.data_ptr()
        assert torch.equal(pctx.all_reduce(mesh, a, "sum"), a)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("x_start,wrap", [(0, False), (4, False), (6, False), (0, True),
                                          (4, True), (6, True), (-1, True)])
def test_window_bins_slab_mode_matches_cpu(cuda, x_start, wrap):
    """`window_bins` on an x-window of n_loc planes (x_off 0, 4 and
    nx - n_loc = 6, wrapped modulo nx or not) gives on the card what it
    gives on the CPU, bit for bit: the sort, the ranks, the counts and the
    staged window."""
    n_loc = 6
    out = {}
    for dev in (torch.device("cpu"), cuda):
        pf = _particle_fields(GRID, 400, dev, seed=11)
        out[dev.type] = cw.window_bins(pf, GRID, 4, 512, with_angvel=True, x_start=x_start,
                                       n_loc=n_loc, wrap_x=wrap)
    for name in ("dat_win", "order", "inv_order", "cell_sorted", "rank", "keep", "counts",
                 "n_overflow"):
        assert torch.equal(getattr(out["cuda"], name).cpu(), getattr(out["cpu"], name)), name
    assert int(out["cpu"].counts.sum()) > 0


def _centres(n, h):
    c = (np.arange(n) + 0.5) * h
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def _tree_case(name):
    """(points, queries, radius, caps) of a tree case: the random clouds of
    tests/test_native.py, the 8^3 dyadic centres queried on every face,
    edge and corner (ties), a 64^3 cloud of centres with 20,000 random
    queries, and the 128^3 centres with 20,000 particles of the bench
    lattice. A cap of 128 or 300 passes the range kernel's shared-memory
    buffer (cap <= 64); the last cap is below some query's hit count."""
    if name == "random500":
        rng = np.random.RandomState(0)
        return rng.rand(500, 3), rng.rand(64, 3), 0.2, (300, 5)
    if name == "random300":
        rng = np.random.RandomState(1)
        return rng.rand(300, 3), rng.rand(16, 3), 0.2, (300, 3)
    if name == "ties8":
        c = np.arange(17) * 0.125
        q = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
        return _centres(8, 0.25), q, 0.375, (64, 7)
    if name == "grid128":
        from yade_openfoam_coupling_tpu_torch.scripts import meshtree_timing as mt
        return (_centres(128, 1.0 / 128), mt.particle_queries(20_000, 128, 1.0 / 128),
                1.5 / 128, (64, 9))
    rng = np.random.RandomState(7)
    return _centres(64, 1.0 / 64), rng.rand(20_000, 3), 1.5 / 64, (64, 128, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random500", "random300", "ties8", "grid64", "grid128"])
@pytest.mark.parametrize("order", ["lattice", "shuffled"])
def test_meshtree_kernels_match_the_host_library(cuda, name, order):
    """Both tree kernels against the host library on the same tree, bit for
    bit: nearest's idx and d2, range's counts and members in their order,
    at a cap above and one below the hit count; the queries as the case
    gives them, or in a seeded shuffle, compared through the permutation.
    One launch of each wrapper a query call, one of the keys kernel."""
    pts, q, r, caps = _tree_case(name)
    host, card = nb.MeshTree(pts, device="cpu"), nb.MeshTree(pts, device=cuda)
    for a, b in zip((card.pts, card.order, card.axes), (host.pts, host.order, host.axes)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert torch.equal(card.nodes.cpu(), nb.node_records(host.pts, host.order, host.axes))
    np.testing.assert_array_equal(card.box, nb.morton_box(pts))
    assert card._handle is None         # the host tree is freed once uploaded
    p = np.random.RandomState(12).permutation(len(q)) if order == "shuffled" else np.arange(len(q))
    n0, r0, k0 = nb.tree_nearest.launches, nb.tree_range.launches, nb.morton_keys.launches
    idx, d2 = card.nearest(torch.as_tensor(q[p], device=cuda))
    torch.cuda.synchronize()
    hidx, hd2 = host.nearest(q)
    assert idx.device.type == "cuda" and idx.dtype == torch.int32 and d2.dtype == torch.float64
    assert torch.equal(idx.cpu(), hidx[p]) and torch.equal(d2.cpu(), hd2[p])
    for cap in caps:
        got, hit = card.range_query(q[p], r, cap=cap), host.range_query(q, r, cap=cap)
        assert torch.equal(got[0].cpu(), hit[0][p]) and torch.equal(got[1].cpu(), hit[1][p])
    assert int(hit[1].max()) == caps[-1]        # the last cap is below some hit count
    assert (nb.tree_nearest.launches - n0, nb.tree_range.launches - r0,
            nb.morton_keys.launches - k0) == (1, len(caps), 1 + len(caps))


@pytest.mark.cuda
def test_meshtree_kernels_edge_cases(cuda):
    """No query launches nothing; one point; a cap of 0; queries far out;
    one query, and 129 (a block and one) at caps on either side of the
    range kernel's shared-memory buffer."""
    n0 = nb.tree_nearest.launches
    tree = nb.MeshTree(np.array([[0.5, 0.5, 0.5]]), device=cuda)
    idx, d2 = tree.nearest(np.zeros((0, 3)))
    assert idx.shape == (0,) and nb.tree_nearest.launches == n0
    idx, n = tree.range_query(np.zeros((0, 3)), 1.0, cap=4)
    assert idx.shape == (0, 4) and n.shape == (0,)
    q = np.array([[0.5, 0.5, 0.5], [1e9, -1e9, 3.0]])
    idx, d2 = tree.nearest(q)
    assert idx.tolist() == [0, 0] and torch.equal(d2.cpu(), nb.MeshTree(
        np.array([[0.5, 0.5, 0.5]]), device="cpu").nearest(q)[1])
    idx, n = tree.range_query(q, 1.0, cap=0)
    assert idx.shape == (2, 0) and n.tolist() == [0, 0]
    idx, n = tree.range_query(q, 1.0, cap=4)
    assert n.tolist() == [1, 0] and idx.cpu().tolist() == [[0, -1, -1, -1], [-1] * 4]
    idx, d2 = tree.nearest(np.array([[0.2, 0.3, 0.4]]))
    dd = [0.5 - c for c in (0.2, 0.3, 0.4)]
    assert idx.tolist() == [0] and d2.tolist() == [((0.0 + dd[0] * dd[0]) + dd[1] * dd[1])
                                                   + dd[2] * dd[2]]
    rng = np.random.RandomState(13)
    pts = rng.rand(300, 3)
    host, card = nb.MeshTree(pts, device="cpu"), nb.MeshTree(pts, device=cuda)
    for nq in (1, 129):
        q = rng.rand(nq, 3)
        got, ref = card.nearest(q), host.nearest(q)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        for cap in (0, 2, 64, 200):
            got, ref = card.range_query(q, 0.25, cap), host.range_query(q, 0.25, cap)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)), (nq, cap)


@pytest.mark.cuda
def test_meshtree_keys_kernel_matches_its_plain_version(cuda):
    """The keys kernel equals `morton_keys_reference` on the card and on the
    CPU, bit for bit: random queries in and around the box, its corners,
    +-1e9, +-inf and NaN; and on a one-point tree's box (scale 0)."""
    rng = np.random.RandomState(14)
    pts = rng.rand(1000, 3) * [1.0, 2.0, 0.5]
    q = np.concatenate([rng.rand(5000, 3) * 3 - 1, pts.min(0)[None], pts.max(0)[None],
                        [[1e9, -1e9, 0.2], [np.inf, -np.inf, np.nan], [np.nan] * 3]])
    k0 = nb.morton_keys.launches
    for box in (nb.morton_box(pts), nb.morton_box(pts[:1])):
        qd = torch.as_tensor(q, device=cuda)
        keys = nb.morton_keys(qd, box)
        assert keys.device.type == "cuda" and keys.dtype == torch.int16
        assert torch.equal(keys, nb.morton_keys_reference(qd, box))
        assert torch.equal(keys.cpu(), nb.morton_keys(torch.as_tensor(q), box))
    assert nb.morton_keys.launches - k0 == 2
    assert nb.morton_keys(torch.zeros((0, 3), dtype=torch.float64, device=cuda),
                          nb.morton_box(pts)).shape == (0,)


@pytest.mark.cuda
def test_bin_points_on_the_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    pts = np.concatenate([rng.rand(5000, 3) * 1.2 - 0.1, [[1.0, 0.5, 0.5], [1e12, 0, 0],
                                                          [0, -1e12, 0]]])
    args = ((0.0, 0.0, 0.0), (1 / 16, 1 / 8, 1 / 32), (16, 8, 32))
    for got, ref in zip(nb.bin_points(pts, *args, device=cuda),
                        nb.bin_points(pts, *args, device="cpu")):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), ref)


def _sync_case(kind: str):
    """A small case of each solver and exchange: bench.py's window + fftpcg,
    or bench_1m's planes in 8 x-slabs + mgpcg, at 32^3, a rebuild every 2
    steps."""
    from yade_openfoam_coupling_tpu_torch import bench
    from yade_openfoam_coupling_tpu_torch.scripts import bench_1m
    cfg = (bench.bench_config(32) if kind == "window_fftpcg" else
           bench_1m.case_config(bench_1m.build_parser().parse_args([]), 32))
    return dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, list_rebuild_steps=2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window_fftpcg", "planes_mgpcg"])
def test_every_stream_sync_lies_in_a_sync_span(cuda, kind, tmp_path):
    """One traced chunk after a warm-up one: every cudaStreamSynchronize or
    cudaDeviceSynchronize the chunk makes lies inside a ``yofc:sync.*``
    span, and there are as many as spans, so no synchronisation escapes
    the spans and no span is without one."""
    import json

    from yade_openfoam_coupling_tpu_torch import bench
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.utils import profiling

    cfg = _sync_case(kind)
    run = cd.make_scan_fn(cfg, 2)
    state, _ = run(bench.initial_state(cfg, 2000, cuda))
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("test.chunk"):
            run(state)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (c0, c1), = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "test.chunk"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("yofc:")]
    sync_spans = [s for s in spans if s[2].startswith("yofc:sync.")]
    syncs = [e for e in events if e.get("cat") == "cuda_runtime"
             and e["name"] in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
             and c0 <= e["ts"] <= c1]

    def innermost(t):
        inside = [s for s in spans if s[0] <= t <= s[1]]
        return max(inside)[2] if inside else None

    escaped = [(e["name"], innermost(e["ts"])) for e in syncs
               if not any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t, _ in sync_spans)]
    assert syncs and escaped == [], sorted(set(escaped))
    assert len(syncs) == len(sync_spans), (len(syncs), len(sync_spans))
