"""Slab-sharded execution (port of `yade_openfoam_coupling_tpu/parallel/`):
the mesh of ranks and its launcher, the halo contexts, the sharded
particle arrays and the sharded coupled step."""

from . import ctx, mesh  # noqa: F401
from .ctx import LOCAL, LocalCtx, ShardCtx  # noqa: F401
from .mesh import launch, make_mesh  # noqa: F401
