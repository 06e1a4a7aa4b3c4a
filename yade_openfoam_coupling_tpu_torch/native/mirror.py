"""The walks of the k-d tree kernels (`csrc/meshtree.cu`) in plain Python,
one query at a time, over a tree's exported arrays (``pts`` (n, 3) f64,
``order`` (n,) i32, ``axes`` (n,) i8, numpy). They count the nodes each
query visits; the tests hold their answers to the host library bit for
bit, and `scripts/meshtree_timing.py` prints their visits. No query path
calls them.

Python floats are IEEE doubles and are never contracted into an FMA, so
dist2 is the host build's sum of rounded products."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _point(pts, order, mid):
    return tuple(float(c) for c in pts[order[mid]])


def _float_down(x: float) -> float:
    """x rounded down to a float32 (`__double2float_rd`), as a float."""
    with np.errstate(over="ignore"):
        f = np.float32(x)
    if float(f) > x:
        f = np.nextafter(f, np.float32(-np.inf))
    return float(f)


def _dist2(p, q) -> float:
    d = 0.0
    for a in range(3):
        dd = p[a] - q[a]
        d = d + dd * dd
    return d


def stack_depth(n: int) -> int:
    """The far spans the kernels' stacks hold a query: one for each level
    above the deepest (levels = n.bit_length()), at least one."""
    return max(n.bit_length() - 1, 1)


def nearest(pts, order, axes, queries, prune: bool = True
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """`nearest_kernel`'s walk: the near child in registers, the far span
    on the stack when delta^2 < best, with delta^2 rounded down to a
    float, and (``prune``) skipped at its pop once that float >= best.
    ``prune=False`` is the host library's walk: the same nodes in the same
    order. -> (idx (nq,) i32, d2 (nq,) f64, visits (nq,) i64, the most
    spans each query's stack held (nq,) i64)."""
    n = len(order)
    nq = len(queries)
    out_idx = np.empty(nq, np.int32)
    out_d2 = np.empty(nq, np.float64)
    visits = np.zeros(nq, np.int64)
    held = np.zeros(nq, np.int64)
    for i in range(nq):
        q = tuple(float(c) for c in queries[i])
        stack = []
        lo, hi = 0, n
        best, bestd = -1, 1e300
        while True:
            if lo < hi:
                mid = (lo + hi) // 2
                p = _point(pts, order, mid)
                visits[i] += 1
                d = _dist2(p, q)
                if d < bestd:
                    best, bestd = int(order[mid]), d
                if hi - lo > 1:
                    axis = int(axes[mid])
                    delta = q[axis] - p[axis]
                    dd = delta * delta
                    right = delta > 0
                    if dd < bestd:
                        fd = _float_down(dd)
                        stack.append((lo, mid, fd) if right else (mid + 1, hi, fd))
                        held[i] = max(held[i], len(stack))
                    lo, hi = (mid + 1, hi) if right else (lo, mid)
                    continue
            while prune and stack and stack[-1][2] >= bestd:
                stack.pop()
            if not stack:
                break
            lo, hi, _ = stack.pop()
        out_idx[i], out_d2[i] = best, bestd
    return out_idx, out_d2, visits, held


def range_query(pts, order, axes, queries, radius: float, cap: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """`range_kernel`'s walk: where the ball straddles the plane the left
    span goes on the stack and the walk goes right, else it goes to the
    one side taken; at most ``cap`` members in traversal order. ->
    (idx (nq, cap) i32 padded with -1, n (nq,) i32, visits (nq,) i64, the
    most spans each query's stack held (nq,) i64)."""
    n = len(order)
    nq = len(queries)
    r2 = radius * radius
    out_idx = np.full((nq, cap), -1, np.int32)
    out_n = np.zeros(nq, np.int32)
    visits = np.zeros(nq, np.int64)
    held = np.zeros(nq, np.int64)
    for i in range(nq):
        q = tuple(float(c) for c in queries[i])
        stack = []
        lo, hi = 0, n
        count = 0
        while count < cap:
            if lo < hi:
                mid = (lo + hi) // 2
                p = _point(pts, order, mid)
                visits[i] += 1
                if _dist2(p, q) <= r2:
                    out_idx[i, count] = order[mid]
                    count += 1
                if hi - lo > 1:
                    axis = int(axes[mid])
                    delta = q[axis] - p[axis]
                    straddle = delta * delta <= r2
                    left, right = delta <= 0 or straddle, delta >= 0 or straddle
                    if left and right:
                        stack.append((lo, mid))
                        held[i] = max(held[i], len(stack))
                    if right:
                        lo = mid + 1
                        continue
                    if left:
                        hi = mid
                        continue
            if not stack:
                break
            lo, hi = stack.pop()
        out_n[i] = count
    return out_idx, out_n, visits, held
