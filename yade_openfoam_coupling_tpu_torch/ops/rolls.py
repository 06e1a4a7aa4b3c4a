"""Roll distribution of the sparse exchange's anchor deposits (port of
`yade_openfoam_coupling_tpu/ops/pallas_rolls.py`, kernel B3).

The sparse and point-force deposits scatter every particle's (S*C)
weighted channels onto its anchor cell, offset-major, then distribute
offset o's channels to cell + o:

    out[c] = sum_o roll(bufT[o, c], offsets[o])

`distribute_rolls` runs the hand-written CUDA kernel of
`csrc/rolls_deposit.cu` for CUDA tensors (an unrolled instance for each
count of 1 to 27 taps, a batched tap loop for 28 to 640: the
``stencil_width=5`` cube has 125), or raises, and its plain PyTorch
version `distribute_rolls_reference` (the sequential roll loop of the JAX
package's `coupling._deposit_anchor_rolls`) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_KERNEL = "rolls kernel"
_MAX_TAPS = 640


def distribute_rolls_reference(bufT: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Plain version: from zeros, add roll(bufT[o], offsets[o]) over the
    grid axes in offset order. -> (C, nx, ny, nz)."""
    out = torch.zeros(bufT.shape[1:], dtype=bufT.dtype, device=bufT.device)
    for o in range(bufT.shape[0]):
        dx, dy, dz = (int(v) for v in offsets[o])
        out = out + torch.roll(bufT[o], (dx, dy, dz), dims=(1, 2, 3))
    return out


def _plane_stride(bufT: torch.Tensor, offsets: np.ndarray) -> int:
    """The stride between consecutive (o, c) planes of bufT, after checking
    what the kernel takes: a float32 (S, C, nx, ny, nz) view whose grid
    planes are contiguous and whose S*C planes are evenly strided (an
    offset-major scatter buffer, possibly with trailing columns: the scrap
    bin and the padding to 32 floats), and at most 640 offsets, each
    shorter than its axis. A dim of size 1 has no meaningful stride, so
    the plane stride is read from a dim that has more than one plane. The
    kernel reads a layout whose rows start on 16 bytes (nz and the stride
    multiples of 4) with vector loads, and any other with scalar loads."""
    if bufT.dtype != torch.float32 or bufT.dim() != 5:
        raise ValueError(f"{_KERNEL}: bufT must be a float32 (S, C, nx, ny, nz) tensor; "
                         f"got {bufT.dtype} {tuple(bufT.shape)}")
    S, C, nx, ny, nz = bufT.shape
    st = bufT.stride()
    plane = st[1] if C > 1 else (st[0] if S > 1 else nx * ny * nz)
    if st[2:] != (ny * nz, nz, 1) or plane < nx * ny * nz or (S > 1 and st[0] != C * plane):
        raise ValueError(f"{_KERNEL}: bufT's grid planes must be contiguous and its "
                         f"(S, C) planes evenly strided; got strides {st}")
    offs = np.asarray(offsets)
    if offs.shape != (S, 3) or S > _MAX_TAPS or np.any(np.abs(offs) >= (nx, ny, nz)):
        raise ValueError(f"{_KERNEL}: offsets must be (S={S}, 3) with S <= {_MAX_TAPS} "
                         f"and |offset| < the axis length; got {offs.tolist()}")
    return plane


def distribute_rolls(bufT: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """out[c] = sum_o roll(bufT[o, c], offsets[o]) in one pass over bufT.
    CPU tensors run the plain version; CUDA tensors launch the kernel of
    csrc/rolls_deposit.cu or raise."""
    plane = _plane_stride(bufT, offsets)
    if kernels.on_cpu(_KERNEL, bufT.device):
        return distribute_rolls_reference(bufT, offsets)
    S, C, nx, ny, nz = bufT.shape
    ip = np.concatenate([[S, C, nx, ny, nz, plane],
                         np.asarray(offsets).reshape(-1)]).astype(np.int32)
    out = torch.empty((C, nx, ny, nz), dtype=torch.float32, device=bufT.device)
    kernels.call("rolls_deposit", "yofc_rolls_deposit", _KERNEL, ip, bufT, out,
                 device=bufT.device)
    return out
