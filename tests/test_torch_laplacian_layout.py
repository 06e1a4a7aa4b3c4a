"""Host side of kernel B2 (`ops/fused_stencil.py`), on the CPU: the bf16
entry's launch geometry covers every cell once, and the parameter arrays
both entries are handed are built once and read-only."""

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
from yade_openfoam_coupling_tpu_torch.ops.grid import FieldBC, Grid, pad_scalar
from yade_openfoam_coupling_tpu_torch.ops.stencil import laplacian_facegamma_padded

# the V-cycle's levels on a 128^3 grid, an odd nz, and nz and ny that are
# not multiples of a block's 64 z cells and 8 y rows
SHAPES = [(128, 128, 128), (64, 64, 64), (32, 32, 32), (16, 16, 16), (8, 8, 8), (13, 10, 17),
          (20, 44, 70)]


def _covered(shape, geometry):
    """How often the kernel's threads write each cell, walking the grid as
    `laplacian_bf16_kernel` does: cells 2t and 2t+1 of z tile bz, row t_y of
    y tile by, planes [slab s, slab s + slab) cut at nx."""
    nx, ny, nz = shape
    tz, ty, bz, by, n_slab, slab = geometry
    hits = np.zeros(shape, np.int64)
    k = 2 * np.arange(bz * tz)
    j = np.arange(by * ty)
    for s in range(n_slab):
        i = np.arange(s * slab, min(nx, (s + 1) * slab))
        for kk in (k, k + 1):
            kk = kk[(k < nz) & (kk < nz)]
            np.add.at(hits, np.ix_(i, j[j < ny], kk), 1)
    return hits


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_sm", [132, 1])
def test_bf16_geometry_covers_every_cell_once(shape, n_sm):
    """Tiles and slabs write every cell of the grid exactly once, the
    block fits the kernel's 256 threads, no slab is empty, and on a 132-SM
    card a 128^3 grid gets at least two blocks an SM."""
    geometry = fs.bf16_geometry(shape, n_sm)
    tz, ty, bz, by, n_slab, slab = geometry
    assert 1 <= tz * ty <= 256 and tz <= 32
    assert (n_slab - 1) * slab < shape[0] <= n_slab * slab
    assert (_covered(shape, geometry) == 1).all()
    if shape == (128, 128, 128) and n_sm == 132:
        assert bz * by * n_slab >= 2 * n_sm


def test_params_are_built_once_and_read_only():
    """One shape and spacing give the same two arrays every call; they
    cannot be written, and carry the shape, the geometry and 1/h rounded
    from a double."""
    spacing = (1e-3, 1.25e-3, 3e-3)
    a = fs._params((20, 44, 70), spacing, 132)
    b = fs._params((20, 44, 70), tuple(float(h) for h in spacing), 132)
    assert a[0] is b[0] and a[1] is b[1]
    assert not a[0].flags.writeable and not a[1].flags.writeable
    assert a[0].dtype == np.int32 and a[1].dtype == np.float32
    np.testing.assert_array_equal(a[0], [20, 44, 70, *fs.bf16_geometry((20, 44, 70), 132)])
    np.testing.assert_array_equal(a[1], np.float32([1.0 / h for h in spacing]))
    with pytest.raises(ValueError):
        a[0][0] = 1
    assert fs._params((20, 44, 70), spacing, 114)[0] is not a[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_the_plain_version(dtype):
    """On CPU tensors the wrapper is the plain stencil, bit for bit, in
    either dtype, and counts no launch."""
    grid = Grid.box((13, 10, 17), (0.013, 0.02, 0.017))
    rng = np.random.RandomState(3)
    pp = pad_scalar(torch.as_tensor(rng.randn(*grid.shape).astype(np.float32)),
                    FieldBC.periodic()).to(dtype)
    gamma_f = tuple(torch.as_tensor((0.5 + rng.rand(*s)).astype(np.float32)).to(dtype)
                    for s in ((14, 10, 17), (13, 11, 17), (13, 10, 18)))
    launches = (LAUNCHES["yofc_laplacian"], LAUNCHES["yofc_laplacian_bf16"])
    out = fs.laplacian_facegamma_fused(gamma_f, pp, grid)
    assert out.dtype == dtype
    assert torch.equal(out, laplacian_facegamma_padded(gamma_f, pp, grid))
    assert (LAUNCHES["yofc_laplacian"], LAUNCHES["yofc_laplacian_bf16"]) == launches
