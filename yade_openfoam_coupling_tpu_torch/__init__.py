"""PyTorch/CUDA port of the CFD-DEM engine in `yade_openfoam_coupling_tpu`.

The package mirrors the JAX package's layout (`ops/`, `models/`,
`parallel/`, `utils/`) module for module and keeps its public names, so each
port function can be held against its JAX counterpart on the same inputs.
It imports torch and numpy only, never jax.

Plain tensor code is PyTorch; the Pallas kernels of the window and planes
exchanges (`coupling_window._window_kernel`, `coupling_planes._fused_kernel`,
`_interp_kernel`, `_deposit_kernel`), of the sparse deposit
(`pallas_rolls._roll_kernel`) and of the pressure matvec
(`pallas_stencil._lap_kernel`) are CUDA kernels written by hand for Hopper
(`csrc/window_exchange.cu`, `csrc/planes_exchange.cu`, sharing
`csrc/exchange_common.cuh`; `csrc/rolls_deposit.cu`; `csrc/laplacian.cu`),
built at first use into `_build/`. The k-d tree cell locator (`native/`)
builds its tree with a host library of its own and queries it on the card
with the kernels of `csrc/meshtree.cu`. `python -m yade_openfoam_coupling_tpu_torch
pimplefoam <case>` is the command-line front door (`cli.py`).
"""

import torch

# The fftpcg preconditioner's six dense transform products must run in full
# fp32: the JAX reference forces Precision.HIGHEST for them
# (ops/pressure.py, make_spectral_preconditioner) because a reduced-precision
# product leaves the "exact" inverse only ~1e-2 accurate and CG pays extra
# iterations. TF32 keeps about three decimal digits, so it is switched off
# for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
