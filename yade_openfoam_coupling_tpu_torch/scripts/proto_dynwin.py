"""Per-plane staging with a data-dependent trip count (port of the JAX
package's prototype `scripts/proto_dynwin.py`, kernel B7).

For each x-plane i of ``dat`` (nxl, 2, W), channel 0 the value and channel 1
the y row (-1 matches nothing), `stage_planes` sums the bf16-rounded values
of the first ``bound_i`` chunks of ``w_chunk`` rows into their y rows, in
f32, and broadcasts the (ny,) histogram over z:

    out[i, y, z] = sum_{w < bound_i * w_chunk} [int(dat[i,1,w]) == y] bf16(dat[i,0,w])

with bound_i = nch[i] (``dynamic``) or W / w_chunk. It is the prototype of
the window kernel's per-plane dynamic trip count. CPU tensors run the plain
version `stage_planes_reference` (the one-hot product per chunk); CUDA
tensors launch the kernel of `csrc/dynwin_staging.cu`, which reads nch on
the device, or raise.

    python -m yade_openfoam_coupling_tpu_torch.scripts.proto_dynwin [--device cpu]

reproduces the prototype's check: its inputs, static against dynamic, to
equality.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from .. import kernels

_KERNEL = "dynwin staging kernel"
NY, NZ, W, W_CHUNK = 128, 128, 2048, 512
COUNTS = (0, 2048, 512, 0, 1536, 0, 0, 100)
BLOCKS_PER_SM = 2    # the kernel's grid: y bands enough for this many blocks an SM
MAX_BAND = 1024      # y rows a block may own (kMaxBand in csrc/dynwin_staging.cu)


def _chunk_bounds(nch: torch.Tensor, n_chunks: int, dynamic: bool) -> torch.Tensor:
    if dynamic:
        return torch.clamp(nch.to(torch.int64), 0, n_chunks)
    return torch.full(nch.shape, n_chunks, dtype=torch.int64, device=nch.device)


def stage_planes_reference(dat: torch.Tensor, nch: torch.Tensor, ny: int, nz: int,
                           w_chunk: int, dynamic: bool) -> torch.Tensor:
    """Plain version: per chunk, the one-hot (nxl, ny, w_chunk) product with
    the bf16-rounded values, in f32, added while the chunk is below the
    plane's bound. -> (nxl, ny, nz)."""
    nxl, _, Wd = dat.shape
    n_chunks = Wd // w_chunk
    bound = _chunk_bounds(nch, n_chunks, dynamic)
    val = dat[:, 0].to(torch.bfloat16).to(torch.float32)
    y = dat[:, 1].to(torch.int32)
    iota = torch.arange(ny, dtype=torch.int32, device=dat.device)
    D = torch.zeros((nxl, ny), dtype=torch.float32, device=dat.device)
    for k in range(n_chunks):
        sl = slice(k * w_chunk, (k + 1) * w_chunk)
        onehot = (iota[None, :, None] == y[:, None, sl]).to(torch.float32)
        t = torch.bmm(onehot, val[:, sl, None])[..., 0]
        D = D + torch.where((k < bound)[:, None], t, 0.0)
    return D[:, :, None].expand(nxl, ny, nz).contiguous()


def _check(dat: torch.Tensor, nch: torch.Tensor, w_chunk: int) -> None:
    """What the kernel takes: contiguous float32 dat (nxl, 2, W) with W a
    multiple of w_chunk, and int32 nch (nxl,) on dat's device."""
    if (dat.dtype != torch.float32 or dat.dim() != 3 or dat.shape[1] != 2
            or not dat.is_contiguous()):
        raise ValueError(f"{_KERNEL}: dat must be a contiguous float32 (nxl, 2, W) tensor; "
                         f"got {dat.dtype} {tuple(dat.shape)}")
    if nch.dtype != torch.int32 or tuple(nch.shape) != (dat.shape[0],) or \
            nch.device != dat.device:
        raise ValueError(f"{_KERNEL}: nch must be int32 of shape ({dat.shape[0]},) on "
                         f"{dat.device}; got {nch.dtype} {tuple(nch.shape)} on {nch.device}")
    if w_chunk < 1 or dat.shape[2] % w_chunk:
        raise ValueError(f"{_KERNEL}: W = {dat.shape[2]} must be a multiple of "
                         f"w_chunk = {w_chunk}")


@functools.lru_cache(maxsize=64)
def kernel_params(nxl: int, Wd: int, ny: int, nz: int, w_chunk: int, dynamic: bool,
                  n_sm: int) -> np.ndarray:
    """The kernel's read-only int32 parameters (nxl, W, ny, nz, w_chunk,
    dynamic, y_split), built once per shape. y_split cuts each plane's y
    rows into bands of at most MAX_BAND rows, enough that the grid (nxl,
    y_split) gives about BLOCKS_PER_SM blocks to each of the card's n_sm
    SMs, and no band is empty."""
    y_split = min(ny, max(1, -(-BLOCKS_PER_SM * n_sm // nxl)))
    band = min(-(-ny // y_split), MAX_BAND)
    ip = np.asarray([nxl, Wd, ny, nz, w_chunk, int(dynamic), -(-ny // band)], np.int32)
    ip.setflags(write=False)
    return ip


def stage_planes(dat: torch.Tensor, nch: torch.Tensor, ny: int, nz: int, w_chunk: int,
                 dynamic: bool) -> torch.Tensor:
    """-> (nxl, ny, nz). CPU tensors run the plain version; CUDA tensors
    launch the kernel of csrc/dynwin_staging.cu or raise."""
    _check(dat, nch, w_chunk)
    if kernels.on_cpu(_KERNEL, dat.device):
        return stage_planes_reference(dat, nch, ny, nz, w_chunk, dynamic)
    nxl, _, Wd = dat.shape
    ip = kernel_params(nxl, Wd, ny, nz, w_chunk, bool(dynamic), kernels.sm_count(dat.device))
    out = torch.empty((nxl, ny, nz), dtype=torch.float32, device=dat.device)
    kernels.call("dynwin_staging", "yofc_dynwin_staging", _KERNEL, ip, dat, nch.contiguous(),
                 out, device=dat.device)
    return out


def prototype_inputs():
    """The prototype's inputs: 8 planes with COUNTS live rows each (seeded
    values, y in [0, NY)), the rest y = -1; nch = ceil(count / W_CHUNK).
    -> numpy (dat, nch)."""
    rng = np.random.RandomState(0)
    counts = np.asarray(COUNTS, np.int32)
    dat = np.zeros((len(counts), 2, W), np.float32)
    for i, c in enumerate(counts):
        dat[i, 0, :c] = rng.randn(c)
        dat[i, 1, :c] = rng.randint(0, NY, c)
        dat[i, 1, c:] = -1.0
    return dat, np.ceil(counts / W_CHUNK).astype(np.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="proto_dynwin")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device", file=sys.stderr)
        return 2
    dat, nch = (torch.as_tensor(a, device=device) for a in prototype_inputs())
    a = stage_planes(dat, nch, NY, NZ, W_CHUNK, dynamic=False)
    b = stage_planes(dat, nch, NY, NZ, W_CHUNK, dynamic=True)
    err = float((a - b).abs().max())
    print(f"{device.type}: max|static - dynamic| = {err}")
    if not torch.equal(a, b):
        print("static and dynamic differ", file=sys.stderr)
        return 1
    print("EQUIVALENCE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
