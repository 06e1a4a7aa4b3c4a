"""Time the k-d tree cell locator (`native/`) on one card.

The tree holds the cell centres of an nx^3 grid of h = 1 mm (bench.py's
grid: 128^3 is 2,097,152 centres), the queries are the main path's
particles, `bench.lattice_positions(queries, nx h)` in float32 (as the
solver holds them) widened to float64; `nearest` runs at the particles,
`range_query` (r = 1.5 h, cap 64) at each particle's cell centre (its
nearest point), where it finds the 19 cells of the `sphere2` stencil.
For each it prints one JSON line: the median
milliseconds of a call with the host's work in the wrapper (`ms`) and of
the card alone (`device_ms`), the host library's single-thread time for
the same queries (`plain_ms`) and the bound; then one line with the host
tree build's seconds and the card tree's (host build and upload). The
card's answers are held to the host library's bit for bit first.

    python -m yade_openfoam_coupling_tpu_torch.scripts.meshtree_timing [--nx 128] [--queries 100000]

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12             # H100 SXM float64 outside the tensor cores (data sheet)
DIST2_FLOPS = 8               # dist2's 3 differences, 3 products and 2 sums
H = 1e-3                      # bench.py's spacing
RADIUS_CELLS, CAP = 1.5, 64   # the range query's radius in cells, and its cap


def cell_centres(nx: int, h: float = H) -> np.ndarray:
    """(nx^3, 3) float64 centres in C order: point i is flat cell i."""
    c = (np.arange(nx) + 0.5) * h
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def particle_queries(n: int, nx: int, h: float = H) -> np.ndarray:
    """The main path's particle positions (float32) as float64 queries."""
    from ..bench import lattice_positions
    return lattice_positions(n, nx * h).astype(np.float32).astype(np.float64)


def bound(tree, nq: int, out_bytes_per_query: int, n_dist2: int) -> dict:
    """The least time of a query call: the tree's arrays (pts, order, axes)
    and the queries read once and the results written once at the HBM
    rate, or the float64 operations of the ``n_dist2`` distances that the
    answers need (one a query for `nearest`, one a member found for
    `range_query`) at the peak rate, whichever is longer (the bytes)."""
    t_bytes = (tree.n * (24 + 4 + 1) + nq * (24 + out_bytes_per_query)) / HBM_BYTES_PER_S * 1e3
    t_ops = n_dist2 * DIST2_FLOPS / F64_FLOPS * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def time_queries(card, host, q: np.ndarray, qc: np.ndarray, radius: float,
                 reps: int = 10) -> dict:
    """Times of both kernels on the card tree (`nearest` at q, `range_query`
    at qc) and of the host library's same queries on the host tree (one
    call each), with the bound. -> {"meshtree_nearest": {...},
    "meshtree_range": {...}}."""
    import torch
    from .exchange_timing import cuda_ms

    qd, qcd = (torch.as_tensor(a, device=card.device) for a in (q, qc))
    calls = {"meshtree_nearest": (lambda: card.nearest(qd), lambda: host.nearest(q), 12),
             "meshtree_range": (lambda: card.range_query(qcd, radius, CAP),
                                lambda: host.range_query(qc, radius, CAP), 4 * CAP + 4)}
    out = {}
    for name, (kernel, plain, out_bytes) in calls.items():
        t0 = time.perf_counter()
        res = plain()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        n_dist2 = len(q) if name == "meshtree_nearest" else int(res[1].sum())
        out[name] = {"ms": cuda_ms(kernel, reps), "device_ms": cuda_ms(kernel, reps,
                                                                       device_only=True),
                     "plain_ms": plain_ms, **bound(card, len(q), out_bytes, n_dist2),
                     "library_ms": None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="meshtree_timing")
    ap.add_argument("--nx", type=int, default=128, help="grid side (default 128)")
    ap.add_argument("--queries", type=int, default=100_000, help="queries (default 100000)")
    args = ap.parse_args(argv)
    import torch
    from ..bench import card_name
    from ..native import MeshTree

    if not torch.cuda.is_available():
        print("meshtree_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    device = torch.device("cuda", 0)
    pts = cell_centres(args.nx)
    q = particle_queries(args.queries, args.nx)
    t0 = time.perf_counter()
    host = MeshTree(pts, device="cpu")
    t1 = time.perf_counter()
    tree = MeshTree(pts, device=device)
    torch.cuda.synchronize()
    build_s, card_s = t1 - t0, time.perf_counter() - t1
    radius = RADIUS_CELLS * H
    near = host.nearest(q)
    qc = pts[near[0].numpy()]
    for got, ref in ((tree.nearest(q), near),
                     (tree.range_query(qc, radius, CAP), host.range_query(qc, radius, CAP))):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)):
            raise AssertionError("meshtree_timing: the card and the host library differ")
    for name, e in time_queries(tree, host, q, qc, radius).items():
        print(json.dumps({"kernel": name, "nx": args.nx, "points": tree.n,
                          "queries": args.queries, **e, "card": card}), flush=True)
    print(json.dumps({"host_build_s": build_s, "card_tree_s": card_s, "nx": args.nx,
                      "points": tree.n, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
