"""Host side of the fused exchange kernels B1 and B4, on the CPU: the
scratch layout they are handed, their parameter arrays, the capacity they
take, and the wrappers' CPU path (the plain version, whatever the record
bound)."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("ncl,cap,n_rec", [(210, 4, 60), (5, 1, 0), (7, 8, 3),
                                           (128 ** 3, 4, 100_000)])
def test_scratch_segments_fit_and_records_align(ncl, cap, n_rec):
    """The occupancy bytes, the per-slot record indices and the list of
    occupied slots fit before the records, which start on 16 bytes and
    take n_rec records of the kernels' 24 floats."""
    words = cpp._scratch_words(ncl, cap, n_rec)
    head = words - cpp._REC_FLOATS * n_rec
    assert head % 4 == 0 and cpp._REC_FLOATS % 4 == 0
    assert head >= -(-ncl // 4) + cap * ncl + 1 + n_rec


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


@pytest.mark.parametrize("cap,ok", [(0, False), (1, True), (8, True), (9, False)])
def test_capacity_the_kernels_take(cap, ok):
    """One occupancy byte per cell holds ranks 0..7: 1 <= cap <= 8."""
    if ok:
        cpp._check_cap("kernel", cap)
    else:
        with pytest.raises(ValueError, match="slot_capacity"):
            cpp._check_cap("kernel", cap)


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
