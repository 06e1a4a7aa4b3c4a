"""The pressure solve's matvec as one kernel (port of
`yade_openfoam_coupling_tpu/ops/pallas_stencil.py`, kernel B2).

`laplacian_facegamma_fused` computes div(gamma_f grad p) from a
ghost-padded p. It runs the hand-written CUDA kernel of `csrc/laplacian.cu`
for CUDA tensors, or raises, and its plain PyTorch version, the port's
`stencil.laplacian_facegamma_padded`, for CPU tensors; the bfloat16 entry
(the V-cycle under `MGConfig.bf16`) is ``yofc_laplacian_bf16``.
`pressure.poisson_apply(..., use_pallas=True)` calls it where the JAX
package calls its Pallas kernel. The kernel's parameter arrays (the shape,
the bf16 entry's launch geometry, 1/h) are built once per shape, spacing
and SM count, read-only (`_params`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from .grid import Grid
from .stencil import Flux, laplacian_facegamma_padded

_KERNEL = "laplacian kernel"
BF16_THREADS = 256      # the bf16 entry's threads a block
BF16_BLOCKS_PER_SM = 4  # the blocks its grid aims to give each SM


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def bf16_geometry(shape: Tuple[int, int, int], n_sm: int) -> Tuple[int, ...]:
    """The bf16 entry's launch: (tz, ty, bz, by, n_slab, slab). A block is
    tz x ty threads, each owning cells 2t and 2t+1 of its z tile of 2 tz
    cells and one row of its y tile of ty rows; bz x by blocks tile a plane,
    and the x axis is cut into n_slab slabs of `slab` planes (the last may
    be shorter, none is empty), enough that the grid gives each of the
    card's n_sm SMs about BF16_BLOCKS_PER_SM blocks."""
    nx, ny, nz = shape
    pairs = -(-nz // 2)
    tz = min(32, _pow2_at_least(pairs))
    ty = min(BF16_THREADS // tz, _pow2_at_least(ny))
    bz, by = -(-pairs // tz), -(-ny // ty)
    n_slab = min(nx, max(1, -(-BF16_BLOCKS_PER_SM * n_sm // (bz * by))))
    slab = -(-nx // n_slab)
    return tz, ty, bz, by, -(-nx // slab), slab


@functools.lru_cache(maxsize=64)
def _params(shape: Tuple[int, int, int], spacing: Tuple[float, float, float],
            n_sm: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's read-only host parameters: int32 (nx, ny, nz, then the
    bf16 entry's launch geometry, `bf16_geometry`), and float32 1/h per
    axis. PyTorch divides a CUDA float or bf16 tensor by a Python float as
    a product with the reciprocal taken in double and rounded to float32:
    the plain version's rounding."""
    ip = np.asarray([*shape, *bf16_geometry(shape, n_sm)], np.int32)
    fp = np.asarray([1.0 / h for h in spacing], np.float32)
    ip.setflags(write=False)
    fp.setflags(write=False)
    return ip, fp


def laplacian_facegamma_fused(gamma_f: Flux, pp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """div(gamma_f grad p) (nx, ny, nz) from the padded pp, in pp's dtype
    (float32 or bfloat16). CPU tensors run the plain version; CUDA tensors
    launch the kernel of csrc/laplacian.cu or raise."""
    dtype, dev = pp.dtype, pp.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{_KERNEL}: pp must be float32 or bfloat16; got {dtype}")
    nx, ny, nz = shape = tuple(s - 2 for s in pp.shape)
    kernels.require(_KERNEL, dev, ("pp", pp, pp.shape, dtype, False),
                    ("gamma_x", gamma_f[0], (nx + 1, ny, nz), dtype, False),
                    ("gamma_y", gamma_f[1], (nx, ny + 1, nz), dtype, False),
                    ("gamma_z", gamma_f[2], (nx, ny, nz + 1), dtype, False))
    if kernels.on_cpu(_KERNEL, dev):
        return laplacian_facegamma_padded(gamma_f, pp, grid)
    ip, fp = _params(shape, tuple(float(h) for h in grid.spacing), kernels.sm_count(dev))
    out = torch.empty(shape, dtype=dtype, device=dev)
    kernels.call("laplacian", "yofc_laplacian_bf16" if dtype == torch.bfloat16 else
                 "yofc_laplacian", _KERNEL, ip, fp, pp, *gamma_f, out, device=dev)
    return out
