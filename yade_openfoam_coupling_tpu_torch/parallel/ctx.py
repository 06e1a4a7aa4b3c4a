"""Execution contexts: the seam between single-device and slab-sharded
runs (port of `yade_openfoam_coupling_tpu/parallel/ctx.py`).

Every solver takes a ctx. ``pad_s``/``pad_v`` produce the one-cell ghost
shell every stencil consumes, and ``sum``/``max``/``min`` are the global
reductions of the CG dot products and the diagnostics. `LocalCtx` fills
ghosts from the physical BCs and reduces nothing. `ShardCtx` runs in one
rank of a `torch.distributed` ring (`parallel/mesh.py`): ghost slabs along
the sharded x axis come from the ring neighbours, physical ghosts at the
global edges, and the reductions are `all_reduce`s, so every rank holds
the same value and takes the same branch.

The ring transport is one function, `ring_exchange`: a batch of four
point-to-point operations posted in one fixed order (send forward, send
backward, receive from the left, receive from the right), which NCCL
matches by posting order and gloo by tag. One rank exchanges with
itself by a local copy. The group's backend picks where the bytes travel:
NCCL moves CUDA tensors; gloo moves CPU tensors, so a CUDA tensor on a
gloo group is copied to host memory and back explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.grid import DIRICHLET, NEUMANN, PERIODIC, SLIP, FaceBC, FieldBC, pad_axis, pad_scalar, \
    pad_vector

_TAG_FWD, _TAG_BWD = 1, 2


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


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _wire_device(mesh, t: torch.Tensor) -> torch.device:
    """Where a tensor travels on the mesh's group: NCCL moves it on its
    card, gloo in host memory."""
    backend = mesh.backend
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors; got one on {t.device}")
        return t.device
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unsupported process-group backend {backend!r}")


def ring_exchange(mesh, to_right: Sequence[torch.Tensor], to_left: Sequence[torch.Tensor]):
    """One ring permute each way: every rank sends ``to_right`` to rank+1
    and ``to_left`` to rank-1 (modulo the size) and returns
    (from_left, from_right): the lists its left neighbour sent right and
    its right neighbour sent left. Each list's tensors are packed into one
    message per direction; both lists must hold tensors of one dtype.
    At one rank this is a local copy (a send to self is a self-permute)."""
    to_right = [t.contiguous() for t in to_right]
    to_left = [t.contiguous() for t in to_left]
    if mesh.size == 1:
        return [t.clone() for t in to_right], [t.clone() for t in to_left]
    dev = to_right[0].device
    wire = _wire_device(mesh, to_right[0])

    def pack(ts):
        return torch.cat([t.reshape(-1) for t in ts]).to(wire)

    def unpack(buf, like):
        out, k = [], 0
        for t in like:
            out.append(buf[k:k + t.numel()].view(t.shape).to(dev))
            k += t.numel()
        return out

    send_r, send_l = pack(to_right), pack(to_left)
    recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
    right = (mesh.rank + 1) % mesh.size
    left = (mesh.rank - 1) % mesh.size
    g = mesh.group
    # one fixed posting order on every rank: at 2 ranks both neighbours are
    # the same rank, and NCCL pairs the messages in this order
    ops = [dist.P2POp(dist.isend, send_r, _peer(g, right), g, _TAG_FWD),
           dist.P2POp(dist.isend, send_l, _peer(g, left), g, _TAG_BWD),
           dist.P2POp(dist.irecv, recv_l, _peer(g, left), g, _TAG_FWD),
           dist.P2POp(dist.irecv, recv_r, _peer(g, right), g, _TAG_BWD)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return unpack(recv_l, to_right), unpack(recv_r, to_left)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group`` (P2P ops take global ranks)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def all_reduce(mesh, x, op: str) -> torch.Tensor:
    """``x`` (a tensor or a Python number, as float32 on the mesh's device)
    reduced over the mesh: "sum", "max" or "min". Returns a new tensor,
    bit-identical on every rank."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float32, device=mesh.device)
    if mesh.size == 1:
        return x.clone()
    wire = _wire_device(mesh, x)
    buf = x.detach().to(wire, copy=True)
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                             "min": dist.ReduceOp.MIN}[op], group=mesh.group)
    return buf.to(x.device)


def all_gather(mesh, x: torch.Tensor) -> list:
    """Every rank's ``x`` (equal shapes), by rank, on ``x``'s device."""
    if mesh.size == 1:
        return [x.clone()]
    wire = _wire_device(mesh, x)
    buf = x.contiguous().to(wire)
    out = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(out, buf, group=mesh.group)
    return [o.to(x.device) for o in out]


# ---------------------------------------------------------------------------
# The sharded context
# ---------------------------------------------------------------------------

def _bc_ghost(face: FaceBC, interior: torch.Tensor, component: Optional[int],
              axis: int) -> torch.Tensor:
    """The physical ghost slab of one global edge (`pad_axis`'s formulas)."""
    if face.kind == DIRICHLET:
        v = face.component(component) if component is not None else face.component(0)
        return 2.0 * v - interior
    if face.kind == SLIP and component is not None and component == axis:
        return -interior
    if face.kind == NEUMANN or face.kind == SLIP:
        return interior
    # PERIODIC at a global edge comes from the ring itself
    return interior


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Per-rank context of the slab decomposition: grid axis a is sharded
    over the mesh when ``mesh_axes[a]`` names the mesh axis (only the x
    axis can be: the mesh is 1-D). Ghost slabs along x come from the ring
    neighbours; the first and last rank substitute the physical BC ghosts
    on a non-periodic x."""

    mesh_axes: Tuple[Optional[str], Optional[str], Optional[str]]
    mesh: Any
    # a `utils.profiling.PhaseTimer`: the halo pads' synchronised time
    timer: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.mesh_axes[1] is not None or self.mesh_axes[2] is not None \
                or self.mesh_axes[0] is None:
            raise NotImplementedError("ShardCtx shards grid axis 0 over a 1-D mesh only")

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- reductions ----------------------------------------------------------
    def sum(self, x):
        return all_reduce(self.mesh, x, "sum")

    def max(self, x):
        return all_reduce(self.mesh, x, "max")

    def min(self, x):
        return all_reduce(self.mesh, x, "min")

    def mean_of_sum(self, x, n_local):
        # every slab holds n_local cells
        return self.sum(x) / (n_local * self.mesh.size)

    # -- halo pads -----------------------------------------------------------
    def _x_ghosts(self, f: torch.Tensor, lo: FaceBC, hi: FaceBC, depth: int,
                  components: Sequence[Optional[int]]):
        """(g_lo, g_hi): the ``depth`` ghost planes below and above the slab
        along the last-but-two axis of ``f`` ((..., nx, ny, nz), the
        leading axis indexing ``components``), from the ring; at a
        non-periodic global edge the BC ghost, repeated ``depth`` times."""
        ax = f.dim() - 3
        n = f.shape[ax]
        from_left, from_right = ring_exchange(
            self.mesh, [f.narrow(ax, n - depth, depth)], [f.narrow(ax, 0, depth)])
        g_lo, g_hi = from_left[0], from_right[0]
        if lo.kind == PERIODIC and hi.kind == PERIODIC:
            return g_lo, g_hi
        r, size = self.mesh.rank, self.mesh.size
        if r == 0 or r == size - 1:
            def edge(face, plane):
                if ax == 0:
                    g = _bc_ghost(face, plane, components[0], 0)
                else:
                    g = torch.stack([_bc_ghost(face, plane[i], c, 0)
                                     for i, c in enumerate(components)])
                return torch.cat([g] * depth, dim=ax) if depth > 1 else g
            if r == 0:
                g_lo = edge(lo, f.narrow(ax, 0, 1))
            if r == size - 1:
                g_hi = edge(hi, f.narrow(ax, n - 1, 1))
        return g_lo, g_hi

    def _pad(self, f, bc: FieldBC, depth: int, components):
        lo, hi = bc.faces[0]
        if self.timer is None:
            g_lo, g_hi = self._x_ghosts(f, lo, hi, depth, components)
        else:
            with self.timer.phase("halo pads", block_on=f):
                g_lo, g_hi = self._x_ghosts(f, lo, hi, depth, components)
        return torch.cat([g_lo, f, g_hi], dim=f.dim() - 3)

    def pad_s(self, f: torch.Tensor, bc: FieldBC) -> torch.Tensor:
        f = self._pad(f, bc, 1, [None])
        for axis in (1, 2):
            lo, hi = bc.faces[axis]
            f = pad_axis(f, axis, lo, hi)
        return f

    def pad_s_x2(self, f: torch.Tensor, bc: FieldBC) -> torch.Tensor:
        """pad_s with a depth-2 ghost shell on the sharded x axis and the
        one-cell shell on y/z -> (n_loc+4, ny+2, nz+2). At a non-periodic
        global edge the outer ghost plane repeats the BC ghost: only
        stencils of particles outside the domain there would read it, and
        the extended window holds none."""
        f = self._pad(f, bc, 2, [None])
        for axis in (1, 2):
            lo, hi = bc.faces[axis]
            f = pad_axis(f, axis, lo, hi)
        return f

    def pad_v(self, u: torch.Tensor, bc: FieldBC) -> torch.Tensor:
        ux = self._pad(u, bc, 1, [0, 1, 2])       # one ring exchange for 3 components
        comps = []
        for c in range(3):
            fc = ux[c]
            for axis in (1, 2):
                lo, hi = bc.faces[axis]
                fc = pad_axis(fc, axis, lo, hi, component=c)
            comps.append(fc)
        return torch.stack(comps)

    # -- shard geometry ------------------------------------------------------
    def shard_index(self, axis: int) -> int:
        return self.mesh.rank if self.mesh_axes[axis] is not None else 0

    def shard_count(self, axis: int) -> int:
        return self.mesh.size if self.mesh_axes[axis] is not None else 1
