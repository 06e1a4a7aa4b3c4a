"""The k-d tree cell locator and the CSR binner (port of
`yade_openfoam_coupling_tpu/native/bindings.py`, the reference's
libMeshTree capability).

`MeshTree(points, device="cuda")` builds a median-layout k-d tree over a
cloud of cell centres on the host, with the port's own copy of the host
library (`meshtree.cpp`, compiled by ``g++`` at first use into the
package's ``_build/``; a failed build raises with the compiler's output).
On a CUDA device the tree's arrays are uploaded once, with its nodes as
32-byte records in tree order (`node_records`) and its bounding box, and
its queries are the kernels of ``csrc/meshtree.cu``: each call gives its
queries Morton keys in that box (`morton_keys`), walks them in the keys'
stable sorted order (`query_order`) and writes each answer to its
query's own row, so the order changes no answer. The walks visit nodes
in the host's order (`nearest` skipping subtrees that hold no strictly
nearer point) and return the host's answers bit for bit; a launch that
fails raises. ``device="cpu"`` runs the host library's queries. There is
no third route. `bin_points` is plain torch ops on either device.

It locates points in arbitrary (non-uniform) cell-centre clouds, which the
uniform-grid `ops.coupling.locate` cannot serve; no path of the solver
calls it.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels

SOURCE = Path(__file__).resolve().parent / "meshtree.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
_NEAREST = "meshtree nearest kernel"
_RANGE = "meshtree range kernel"
_KEYS = "meshtree keys kernel"
KEY_BITS = 5                  # Morton cells a side of the box: 2^KEY_BITS
RECORD_BYTES = 32             # a node record: 3 f64, i32 index, i8 axis, 3 bytes padding

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p


def library_path() -> Path:
    """Where the host library for the current source and flags lives
    (built or not): its name carries a hash of both."""
    digest = kernels.source_digest(CXX_FLAGS, [SOURCE], SOURCE.parent)
    return kernels.BUILD / f"libmeshtree_host_{digest}.so"


def _load() -> ctypes.CDLL:
    """The host library, built on first use, its argument types declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                cxx = shutil.which("g++")
                if cxx is None:
                    raise RuntimeError("g++ not found: the k-d tree's host library needs a "
                                       "C++ compiler")
                kernels.compile_shared({path: [cxx, *CXX_FLAGS, str(SOURCE)]})
            lib = ctypes.CDLL(str(path))
            lib.yofc_tree_build.restype = _P
            lib.yofc_tree_build.argtypes = [_P, ctypes.c_int32]
            lib.yofc_tree_free.argtypes = [_P]
            lib.yofc_tree_size.restype = ctypes.c_int32
            lib.yofc_tree_size.argtypes = [_P]
            lib.yofc_tree_export.argtypes = [_P] * 4
            lib.yofc_tree_nearest.argtypes = [_P, _P, ctypes.c_int32, _P, _P]
            lib.yofc_tree_range.argtypes = [_P, _P, ctypes.c_int32, ctypes.c_double,
                                            ctypes.c_int32, _P, _P]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float64).reshape(-1, 3)


class MeshTree:
    """k-d tree over a point cloud (cell centres): the C2 capability.

    ``points`` (n, 3) is a tensor or a numpy array; ``device`` the device
    of the tree's arrays (``pts`` (n, 3) f64, ``order`` (n,) i32, ``axes``
    (n,) i8), of its queries and of their results. A CPU tree keeps the host
    library's tree for its queries; a CUDA tree frees it once uploaded and
    keeps ``nodes`` (n, 4) f64, the records the kernels walk, and ``box``
    (lo (3), scale (3)) f64 of its Morton keys."""

    def __init__(self, points, device="cuda"):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"MeshTree: unsupported device {self.device}")
        pts = _host_f64(points)
        if pts.shape[0] >= 2 ** 31:
            raise ValueError(f"MeshTree: {pts.shape[0]} points; an int32 index takes < 2^31")
        self._lib = _load()
        self._handle = _P(self._lib.yofc_tree_build(_ptr(pts), pts.shape[0]))
        self.n = int(self._lib.yofc_tree_size(self._handle))
        order = np.empty(self.n, np.int32)
        axes = np.empty(self.n, np.int8)
        pts = np.empty((self.n, 3), np.float64)
        self._lib.yofc_tree_export(self._handle, _ptr(pts), _ptr(order), _ptr(axes))
        self.pts, self.order, self.axes = (torch.from_numpy(a).to(self.device)
                                           for a in (pts, order, axes))
        self.nodes = self.box = None
        if self.device.type == "cuda":      # the kernels walk the uploaded records alone
            self.nodes = node_records(pts, order, axes).to(self.device)
            self.box = morton_box(pts)
            self._lib.yofc_tree_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.yofc_tree_free(self._handle)
            self._handle = None

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries)
        return q.to(device=self.device, dtype=torch.float64).reshape(-1, 3).contiguous()

    def nearest(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """The nearest point of each query: (idx (nq,) i32, d2 (nq,) f64)."""
        return tree_nearest(self, self._queries(queries))

    def range_query(self, queries, radius: float, cap: int = 64):
        """Every point within ``radius`` of each query, at most ``cap`` in
        traversal order: (idx (nq, cap) i32 padded with -1, n (nq,) i32)."""
        return tree_range(self, self._queries(queries), float(radius), int(cap))

    def _host_nearest(self, q: np.ndarray):
        idx = np.empty(q.shape[0], np.int32)
        d2 = np.empty(q.shape[0], np.float64)
        self._lib.yofc_tree_nearest(self._handle, _ptr(q), q.shape[0], _ptr(idx), _ptr(d2))
        return idx, d2

    def _host_range(self, q: np.ndarray, radius: float, cap: int):
        idx = np.empty((q.shape[0], cap), np.int32)
        n = np.empty(q.shape[0], np.int32)
        self._lib.yofc_tree_range(self._handle, _ptr(q), q.shape[0], radius, cap, _ptr(idx),
                                  _ptr(n))
        return idx, n


def node_records(pts, order, axes) -> torch.Tensor:
    """The nodes the kernels walk, in tree order, as (n, 4) f64 on the CPU:
    record m (32 bytes) holds pts[order[m]] (3 x f64), order[m] (i32,
    bytes 24-27), axes[m] (i8, byte 28) and 3 zero bytes. ``pts``,
    ``order``, ``axes`` are the tree's exported arrays (numpy or CPU
    tensors)."""
    pts, order, axes = (np.asarray(a) for a in (pts, order, axes))
    rec = np.zeros((order.shape[0], RECORD_BYTES // 8), np.float64)
    rec[:, :3] = pts[order]
    rec.view(np.int32)[:, 6] = order
    rec.view(np.int8)[:, 28] = axes
    return torch.from_numpy(rec)


def morton_box(pts: np.ndarray) -> np.ndarray:
    """(lo (3), scale (3)) f64 of the Morton keys of queries to a tree over
    ``pts`` (n, 3): the box's lower corner and 2^KEY_BITS cells over its
    extent on each axis (scale 0 on an axis of no extent, or one whose
    scale would not be finite)."""
    if pts.shape[0] == 0:
        return np.zeros(6)
    lo = pts.min(0)
    ext = pts.max(0) - lo
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        scale = np.where(ext > 0, float(2 ** KEY_BITS) / ext, 0.0)
    scale[~np.isfinite(scale)] = 0.0
    return np.concatenate([lo, scale]).astype(np.float64)


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Up to 10 bits of each int64 spread to every third bit."""
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
        x = (x | (x << shift)) & mask
    return x


def morton_keys_reference(q: torch.Tensor, box: np.ndarray) -> torch.Tensor:
    """Plain version of the keys kernel: for queries (nq, 3) f64, the cell
    c = min(max(floor((q - lo) * scale), 0), 2^KEY_BITS - 1) on each axis,
    clamped in f64 before the cast (a query however far out, or NaN, lands
    on the box's face), and its bits interleaved, x highest: (nq,) i16
    keys below 2^(3 KEY_BITS)."""
    b = torch.as_tensor(np.asarray(box, np.float64), device=q.device)
    t = torch.floor((q - b[:3]) * b[3:])
    c = torch.fmin(torch.fmax(t, t.new_tensor(0.0)), t.new_tensor(2.0 ** KEY_BITS - 1))
    c = c.to(torch.int64)
    key = (_spread3(c[:, 0]) << 2) | (_spread3(c[:, 1]) << 1) | _spread3(c[:, 2])
    return key.to(torch.int16)


def morton_keys(q: torch.Tensor, box: np.ndarray) -> torch.Tensor:
    """The Morton keys of contiguous f64 queries (nq, 3) in a tree's
    ``box`` (`morton_box`): the plain version on a CPU tensor, the keys
    kernel of csrc/meshtree.cu on a CUDA tensor (or raise)."""
    if kernels.on_cpu(_KEYS, q.device):
        return morton_keys_reference(q, box)
    keys = torch.empty(q.shape[0], dtype=torch.int16, device=q.device)
    if q.shape[0]:
        kernels.call("meshtree", "yofc_tree_keys", _KEYS, np.asarray([q.shape[0]], np.int32),
                     np.ascontiguousarray(box, np.float64), q, keys, device=q.device)
    return keys


def query_order(q: torch.Tensor, box: np.ndarray) -> torch.Tensor:
    """The order the kernels walk queries in: the stable sort of their
    Morton keys, (nq,) i64 query indices. A permutation of the queries,
    so it changes no answer; equal keys keep the caller's order."""
    return torch.sort(morton_keys(q, box), stable=True).indices


def _check_queries(nq: int) -> None:
    if nq >= 2 ** 31:
        raise ValueError(f"MeshTree: {nq} queries; an int32 count takes < 2^31")


def tree_nearest(tree: MeshTree, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`MeshTree.nearest` on contiguous f64 queries (nq, 3) on the tree's
    device. A CPU tree runs the host library; a CUDA tree orders the
    queries (`query_order`) and launches the kernel of csrc/meshtree.cu,
    or raises."""
    nq = q.shape[0]
    _check_queries(nq)
    if kernels.on_cpu(_NEAREST, tree.device):
        return tuple(torch.from_numpy(a) for a in tree._host_nearest(q.numpy()))
    idx = torch.empty(nq, dtype=torch.int32, device=q.device)
    d2 = torch.empty(nq, dtype=torch.float64, device=q.device)
    if nq:
        ip = np.asarray([tree.n, nq], np.int32)
        kernels.call("meshtree", "yofc_tree_nearest", _NEAREST, ip, tree.nodes, q,
                     query_order(q, tree.box), idx, d2, device=q.device)
    return idx, d2


def tree_range(tree: MeshTree, q: torch.Tensor, radius: float, cap: int):
    """`MeshTree.range_query` on contiguous f64 queries (nq, 3) on the
    tree's device. A CPU tree runs the host library; a CUDA tree orders
    the queries (`query_order`) and launches the kernel of
    csrc/meshtree.cu, or raises."""
    nq = q.shape[0]
    _check_queries(nq)
    if cap < 0:
        raise ValueError(f"{_RANGE}: cap must be >= 0, got {cap}")
    if kernels.on_cpu(_RANGE, tree.device):
        return tuple(torch.from_numpy(a) for a in tree._host_range(q.numpy(), radius, cap))
    idx = torch.empty((nq, cap), dtype=torch.int32, device=q.device)
    n = torch.empty(nq, dtype=torch.int32, device=q.device)
    if nq:
        ip = np.asarray([tree.n, nq, cap], np.int32)
        fp = np.asarray([radius], np.float64)
        kernels.call("meshtree", "yofc_tree_range", _RANGE, ip, fp, tree.nodes, q,
                     query_order(q, tree.box), idx, n, device=q.device)
    return idx, n


def bin_points(points, origin, spacing, dims, device="cuda"):
    """CSR spatial binning of points into the uniform grid (origin,
    spacing, dims = (nx, ny, nz)), in float64 torch ops on ``device``.

    Returns (cell_of (n,) i32, order (n,) i64, cell_start (ncell + 2,)
    i64) with the out-of-domain scrap bin at index ncell; within a cell,
    order ascends by point index (a stable sort), as the host library's
    sequential placement gives. The domain test is taken on the floored
    float64 coordinates before any cast to an integer, so a point however
    far out lands in the scrap bin."""
    dev = torch.device(device)
    p = torch.as_tensor(points).to(device=dev, dtype=torch.float64).reshape(-1, 3)
    o, s = (torch.as_tensor(v).to(device=dev, dtype=torch.float64) for v in (origin, spacing))
    nx, ny, nz = (int(d) for d in dims)
    ncell = nx * ny * nz
    f = torch.floor((p - o) / s)
    ok = ((f >= 0) & (f < torch.tensor([nx, ny, nz], dtype=torch.float64, device=dev))).all(1)
    ijk = torch.where(ok[:, None], f, 0.0).to(torch.int64)
    flat = torch.where(ok, (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2], ncell)
    order = torch.sort(flat, stable=True).indices
    cell_start = torch.zeros(ncell + 2, dtype=torch.int64, device=dev)
    cell_start[1:] = torch.cumsum(torch.bincount(flat, minlength=ncell + 1), 0)
    return flat.to(torch.int32), order, cell_start
