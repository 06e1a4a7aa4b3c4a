"""Host side of the fused exchange kernels B1, B4 and B6, on the CPU: the
scratch layout they are handed (for any slot capacity), their parameter
arrays, and the wrappers' CPU path (the plain version, whatever the record
bound)."""

import dataclasses

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.ops import coupling as cp
from yade_openfoam_coupling_tpu_torch.ops import coupling_planes as cpp
from yade_openfoam_coupling_tpu_torch.ops import coupling_window as cw
from yade_openfoam_coupling_tpu_torch.ops.grid import Grid

GRID = Grid.box((6, 5, 7), (0.006, 0.005, 0.007))
PERIODIC = (True, True, False)


def _cfg(exchange):
    return cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                             exchange=exchange, slot_capacity=4, dy_in_kernel=True)


def _particles(n, seed):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    lo, hi = 0.05 * np.asarray(GRID.lengths), 0.95 * np.asarray(GRID.lengths)
    return cp.ParticleFields(t(rng.uniform(lo, hi, (n, 3))), t(rng.randn(n, 3) * 1e-3),
                             t(rng.randn(n, 3) * 1e-2), torch.full((n,), 4e-4),
                             torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("ncl,cap,max_occupied", [
    (210, 4, 60), (5, 1, 0), (7, 8, 3), (128 ** 3, 4, 100_000),
    (210, 9, None), (1000, 16, 5000), (12 ** 3, 33, None)])
def test_scratch_segments_fit_and_records_align(ncl, cap, max_occupied):
    """The per-cell record counts and bases and the list of slots fit, in
    that order, before the records, which start on 16 bytes and take
    n_rec records of the kernels' 24 floats; n_rec is the bound on
    occupied slots, at most (and by default) every slot. Nothing but n_rec
    grows with the slot capacity, so caps past 8 (one byte of rank bits)
    and past 32 (one word) lay out the same way."""
    n_rec = cpp._record_count(cap, ncl, max_occupied)
    assert n_rec == (cap * ncl if max_occupied is None else min(max_occupied, cap * ncl))
    cnt, base, lst, rec, words = cpp._scratch_layout(ncl, n_rec)
    assert cnt == 0 and base >= ncl and lst - base >= ncl and rec - lst >= 1 + n_rec
    assert all(off % 4 == 0 for off in (base, lst, rec)) and cpp._REC_FLOATS % 4 == 0
    assert words == rec + cpp._REC_FLOATS * n_rec == cpp._scratch_words(ncl, n_rec)
    assert cpp._scratch_layout(ncl, n_rec)[:4] == cpp._scratch_layout(ncl, 0)[:3] + (rec,)


def test_kernel_params_are_built_once_and_read_only():
    """The parameter arrays of one argument set are built once (a list or a
    tuple of periodic flags alike), cannot be written, and carry n_rec and
    the stencil where the kernels read them."""
    cfg = _cfg("planes")
    a = cpp._kernel_params(GRID, PERIODIC, cfg, 6, 7, 10, 2, absolute=True, n_rec=33)
    b = cpp._kernel_params(GRID, list(PERIODIC), cfg, 6, 7, 10, 2, absolute=True, n_rec=33)
    assert a[0] is b[0] and a[1] is b[1]
    assert not a[0].flags.writeable and not a[1].flags.writeable
    ip = a[0]
    offsets = cp.stencil_offsets(cfg)
    assert ip[cpp._IPARAMS.index("n_rec")] == 33
    assert ip[cpp._IPARAMS.index("x_off")] == 2
    assert ip[cpp._IPARAMS.index("n_off")] == len(offsets)
    n = len(cpp._IPARAMS)
    np.testing.assert_array_equal(ip[n:n + 3 * len(offsets)], np.asarray(offsets).reshape(-1))


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors both wrappers return their plain version bit for bit;
    the planes wrapper's record bound changes nothing there."""
    pf = _particles(80, seed=5)
    F = torch.as_tensor(np.random.RandomState(6).randn(10, *GRID.shape).astype(np.float32))
    F[-1] = 0.95
    Fp = cpp.pad_wrap_zero(F * 1e-2, PERIODIC)
    cfg = _cfg("planes")
    D = cpp.bin_particles_planes(pf, GRID, 4).D
    args = (Fp, D, GRID, PERIODIC, cfg, 0, 1e-6, 1000.0)
    plain = cpp.fused_exchange_padded_reference(*args)
    for kw in ({}, {"max_occupied": 80}):
        out = cpp.fused_exchange_padded(*args, **kw)
        assert torch.equal(out[0], plain[0]) and torch.equal(out[2], plain[2])
    wcfg = _cfg("window")
    bins = cw.window_bins(pf, GRID, 4, 512)
    wargs = (Fp, bins.dat_win, GRID, PERIODIC, wcfg, 0, 1e-6, 1000.0)
    plain = cw.window_exchange_padded_reference(*wargs, counts=bins.counts)
    out = cw.window_exchange_padded(*wargs, counts=bins.counts)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[2], plain[2])
    assert int(out[2][-1].sum()) == 80


@pytest.mark.parametrize("cap", [4, 9])
def test_cpu_deposit_wrapper_runs_the_plain_version(cap):
    """On CPU tensors the deposit wrapper (B6) returns its plain version bit
    for bit, with the record bound or without, also past 8 slots a cell
    (a crowded cell holds 12 particles)."""
    pf = _particles(80, seed=7)
    pf = pf._replace(pos=torch.cat([pf.pos[:68], pf.pos[:1].expand(12, 3) * 1.0001]))
    cfg = dataclasses.replace(_cfg("planes"), slot_capacity=cap)
    D = cpp.bin_particles_planes(pf, GRID, cap).D
    assert int((D[6] > 0).sum(0).max()) == min(cap, 13)
    V = torch.as_tensor(np.random.RandomState(8).randn(8, cap, GRID.ncells).astype(np.float32))
    args = (V, D, GRID.shape[0], GRID, PERIODIC, cfg, 0)
    plain = cpp.deposit_stacks_reference(*args)
    for kw in ({}, {"max_occupied": 80}):
        out = cpp.deposit_stacks(*args, **kw)
        assert out[1] == plain[1] and torch.equal(out[0], plain[0])
    assert LAUNCHES["yofc_planes_deposit"] == 0
