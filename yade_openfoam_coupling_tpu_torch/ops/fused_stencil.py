"""The pressure solve's matvec as one kernel (port of
`yade_openfoam_coupling_tpu/ops/pallas_stencil.py`, kernel B2).

`laplacian_facegamma_fused` computes div(gamma_f grad p) from a
ghost-padded p. It runs the hand-written CUDA kernel of `csrc/laplacian.cu`
for CUDA tensors, or raises, and its plain PyTorch version, the port's
`stencil.laplacian_facegamma_padded`, for CPU tensors;
``laplacian_facegamma_fused.launches`` counts kernel launches.
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
    """What the kernel takes: contiguous float32 pp (nx+2, ny+2, nz+2) and
    face coefficients (nx+1, ny, nz), (nx, ny+1, nz), (nx, ny, nz+1) on
    pp's device."""
    nx, ny, nz = (s - 2 for s in pp.shape)
    shapes = {"pp": (nx + 2, ny + 2, nz + 2), "gamma_x": (nx + 1, ny, nz),
              "gamma_y": (nx, ny + 1, nz), "gamma_z": (nx, ny, nz + 1)}
    for (name, shape), t in zip(shapes.items(), (pp, *gamma_f)):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != pp.device):
            raise ValueError(
                f"{_KERNEL}: {name} must be a contiguous float32 tensor of shape {shape} "
                f"on {pp.device}; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def laplacian_facegamma_fused(gamma_f: Flux, pp: torch.Tensor, grid: Grid) -> torch.Tensor:
    """div(gamma_f grad p) (nx, ny, nz) from the padded pp. CPU tensors run
    the plain version; CUDA tensors launch the kernel of csrc/laplacian.cu
    or raise."""
    _check(gamma_f, pp)
    if pp.device.type == "cpu":
        return laplacian_facegamma_padded(gamma_f, pp, grid)
    if pp.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {pp.device}")
    from ..kernels import call
    nx, ny, nz = (s - 2 for s in pp.shape)
    ip = np.asarray([nx, ny, nz], np.int32)
    # PyTorch divides a CUDA float tensor by a Python float as a product
    # with float32(1) / float32(h): the plain version's rounding
    fp = np.asarray([np.float32(1.0) / np.float32(h) for h in grid.spacing], np.float32)
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=pp.device)
    call("laplacian", "yofc_laplacian", _KERNEL, ip, fp, pp, *gamma_f, out,
         device=pp.device)
    laplacian_facegamma_fused.launches += 1
    return out


laplacian_facegamma_fused.launches = 0
