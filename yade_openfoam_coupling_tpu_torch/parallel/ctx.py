"""Execution context of a single-device run (port of the `LocalCtx` half of
`yade_openfoam_coupling_tpu/parallel/ctx.py`).

Every solver takes a ctx: ``pad_s``/``pad_v`` produce the ghost shell from
the physical BCs and the reductions are the identity on one device. The
sharded `ShardCtx` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.grid import FieldBC, pad_scalar, pad_vector


class LocalCtx:
    """Single-device context: ghost cells purely from physical BCs."""

    mesh_axes: Tuple[Optional[str], Optional[str], Optional[str]] = (None, None, None)

    def pad_s(self, f: torch.Tensor, bc: FieldBC) -> torch.Tensor:
        return pad_scalar(f, bc)

    def pad_v(self, u: torch.Tensor, bc: FieldBC) -> torch.Tensor:
        return pad_vector(u, bc)

    def sum(self, x):
        return x

    def max(self, x):
        return x

    def min(self, x):
        return x

    def mean_of_sum(self, x, n_local):
        return x / n_local

    def shard_index(self, axis: int):
        return 0

    def shard_count(self, axis: int) -> int:
        return 1


LOCAL = LocalCtx()
