"""The pressure solve's matvec as one kernel (port of
`yade_openfoam_coupling_tpu/ops/pallas_stencil.py`, kernel B2).

`laplacian_facegamma_fused` computes div(gamma_f grad p) from a
ghost-padded p. It runs the hand-written CUDA kernel of `csrc/laplacian.cu`
for CUDA tensors, or raises, and its plain PyTorch version, the port's
`stencil.laplacian_facegamma_padded`, for CPU tensors;
``laplacian_facegamma_fused.launches`` counts kernel launches of either
dtype, ``laplacian_facegamma_fused.launches_bf16`` the bfloat16 ones (the
V-cycle under `MGConfig.bf16`).
`pressure.poisson_apply(..., use_pallas=True)` calls it where the JAX
package calls its Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import Grid
from .stencil import Flux, laplacian_facegamma_padded

_KERNEL = "laplacian kernel"


def _check(gamma_f: Flux, pp: torch.Tensor) -> None:
    """What the kernel takes: contiguous float32 or bfloat16 pp (nx+2, ny+2,
    nz+2) and face coefficients (nx+1, ny, nz), (nx, ny+1, nz), (nx, ny,
    nz+1) of pp's dtype on pp's device."""
    if pp.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{_KERNEL}: pp must be float32 or bfloat16; got {pp.dtype}")
    nx, ny, nz = (s - 2 for s in pp.shape)
    shapes = {"pp": (nx + 2, ny + 2, nz + 2), "gamma_x": (nx + 1, ny, nz),
              "gamma_y": (nx, ny + 1, nz), "gamma_z": (nx, ny, nz + 1)}
    for (name, shape), t in zip(shapes.items(), (pp, *gamma_f)):
        if (t.dtype != pp.dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != pp.device):
            raise ValueError(
                f"{_KERNEL}: {name} must be a contiguous {pp.dtype} tensor of shape {shape} "
                f"on {pp.device}; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def laplacian_facegamma_fused(gamma_f: Flux, pp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """div(gamma_f grad p) (nx, ny, nz) from the padded pp, in pp's dtype
    (float32 or bfloat16). CPU tensors run the plain version; CUDA tensors
    launch the kernel of csrc/laplacian.cu or raise."""
    _check(gamma_f, pp)
    if pp.device.type == "cpu":
        return laplacian_facegamma_padded(gamma_f, pp, grid)
    if pp.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {pp.device}")
    from ..kernels import call
    nx, ny, nz = (s - 2 for s in pp.shape)
    ip = np.asarray([nx, ny, nz], np.int32)
    # PyTorch divides a CUDA float or bf16 tensor by a Python float as a
    # product with the reciprocal taken in double and rounded to float32:
    # the plain version's rounding
    fp = np.asarray([1.0 / h for h in grid.spacing], np.float32)
    bf16 = pp.dtype == torch.bfloat16
    out = torch.empty((nx, ny, nz), dtype=pp.dtype, device=pp.device)
    call("laplacian", "yofc_laplacian_bf16" if bf16 else "yofc_laplacian", _KERNEL, ip, fp,
         pp, *gamma_f, out, device=pp.device)
    laplacian_facegamma_fused.launches += 1
    laplacian_facegamma_fused.launches_bf16 += bf16
    return out


laplacian_facegamma_fused.launches = 0
laplacian_facegamma_fused.launches_bf16 = 0
