"""Time the k-d tree cell locator (`native/`) on one card.

The tree holds the cell centres of an nx^3 grid of h = 1 mm (bench.py's
grid: 128^3 is 2,097,152 centres), the queries are the main path's
particles, `bench.lattice_positions(queries, nx h)` in float32 (as the
solver holds them) widened to float64; `nearest` runs at the particles,
`range_query` (r = 1.5 h, cap 64) at each particle's cell centre (its
nearest point), where it finds the 19 cells of the `sphere2` stencil.
``--order`` hands the card the queries in lattice order, in one seeded
shuffle of it (``--seed``), or both in turn. For each kernel and order it
prints one JSON line: the median milliseconds of a call with the host's
work in the wrapper (`ms`) and of the card alone (`device_ms`), the host
library's single-thread time for the same queries (`plain_ms`), the
bound, and the peak device memory of one call (`peak_mb`, the tree
included, and `peak_rise_mb` above what was allocated before it), with
``--profile`` also each launch's device time (`launches_us`); then,
where the timed package has them, one line for the keys kernel and one
with the mean visits a query of the walks' mirror (`native/mirror.py`)
on a 300-query sample (nearest: the host's walk and the pruned walk);
then one line with the host tree build's seconds and the card tree's
(host build and upload). The card's answers are held to the host
library's bit for bit first, in every order (the host answers the
lattice order; a shuffle's answers are those, shuffled).

    python -m yade_openfoam_coupling_tpu_torch.scripts.meshtree_timing [--nx 128] \
        [--queries 100000] [--order lattice shuffled] [--profile]

``--root DIR`` times the package of another checkout (the parent's,
unpacked with `git archive`) on the same queries; run the script by its
file path then, so that the package is imported from DIR:

    python yade_openfoam_coupling_tpu_torch/scripts/meshtree_timing.py --root DIR

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12             # H100 SXM float64 outside the tensor cores (data sheet)
DIST2_FLOPS = 8               # dist2's 3 differences, 3 products and 2 sums
H = 1e-3                      # bench.py's spacing
RADIUS_CELLS, CAP = 1.5, 64   # the range query's radius in cells, and its cap
VISIT_SAMPLE = 300            # queries the mirror walks for its visit counts
PKG = "yade_openfoam_coupling_tpu_torch"


def cell_centres(nx: int, h: float = H) -> np.ndarray:
    """(nx^3, 3) float64 centres in C order: point i is flat cell i."""
    c = (np.arange(nx) + 0.5) * h
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def particle_queries(n: int, nx: int, h: float = H) -> np.ndarray:
    """The main path's particle positions (float32) as float64 queries."""
    from yade_openfoam_coupling_tpu_torch.bench import lattice_positions
    return lattice_positions(n, nx * h).astype(np.float32).astype(np.float64)


def shuffle(n: int, seed: int = 0) -> np.ndarray:
    """The seeded permutation of n queries that ``--order shuffled`` uses."""
    return np.random.RandomState(seed).permutation(n)


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
                 reps: int = 10, profile: bool = False) -> dict:
    """Times of both kernels on the card tree (`nearest` at q, `range_query`
    at qc) and of the host library's same queries on the host tree (one
    call each), with the bound and the peak memory of one call; with
    ``profile``, each launch's mean device microseconds in a call
    (`launches_us`, from a `torch.profiler` trace). ->
    {"meshtree_nearest": {...}, "meshtree_range": {...}}."""
    import torch
    from yade_openfoam_coupling_tpu_torch.scripts.exchange_timing import (cuda_ms, launch_split,
                                                                          peak_mb)

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
        peak, rise = peak_mb(kernel)
        out[name] = {"ms": cuda_ms(kernel, reps), "device_ms": cuda_ms(kernel, reps,
                                                                       device_only=True),
                     "plain_ms": plain_ms, **bound(card, len(q), out_bytes, n_dist2),
                     "library_ms": None, "peak_mb": peak, "peak_rise_mb": rise}
        if profile:
            out[name]["launches_us"] = launch_split(kernel, reps)
    return out


def time_keys(card, q: np.ndarray, reps: int = 10) -> dict:
    """The keys kernel on q against its plain version on the card (entries
    that differ, which must be 0), with both times and the bound: the
    queries read and the keys written once."""
    import torch
    from yade_openfoam_coupling_tpu_torch.native import bindings as nb
    from yade_openfoam_coupling_tpu_torch.scripts.exchange_timing import cuda_ms

    qd = torch.as_tensor(q, device=card.device)
    err = int((nb.morton_keys(qd, card.box) != nb.morton_keys_reference(qd, card.box)).sum())
    return {"ms": cuda_ms(lambda: nb.morton_keys(qd, card.box), reps),
            "device_ms": cuda_ms(lambda: nb.morton_keys(qd, card.box), reps, device_only=True),
            "plain_ms": cuda_ms(lambda: nb.morton_keys_reference(qd, card.box), reps),
            "bound_ms": len(q) * (24 + 2) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": float(err)}


def mirror_visits(mirror, host, q: np.ndarray, qc: np.ndarray, radius: float,
                  seed: int = 0) -> dict:
    """Mean nodes a query visits in the mirror's walks over the host tree,
    on a seeded sample of VISIT_SAMPLE queries: nearest's host walk and
    pruned walk at q, and the range walk at qc."""
    pick = np.random.RandomState(seed).choice(len(q), min(VISIT_SAMPLE, len(q)), replace=False)
    arrays = [a.numpy() for a in (host.pts, host.order, host.axes)]
    return {"nearest_host_walk": float(mirror.nearest(*arrays, q[pick], prune=False)[2].mean()),
            "nearest_pruned": float(mirror.nearest(*arrays, q[pick])[2].mean()),
            "range": float(mirror.range_query(*arrays, qc[pick], radius, CAP)[2].mean()),
            "sample": len(pick)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="meshtree_timing")
    ap.add_argument("--nx", type=int, default=128, help="grid side (default 128)")
    ap.add_argument("--queries", type=int, default=100_000, help="queries (default 100000)")
    ap.add_argument("--order", nargs="+", choices=("lattice", "shuffled"), default=["lattice"],
                    help="the order the card gets the queries in, one run each (default lattice)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the shuffle (default 0)")
    ap.add_argument("--profile", action="store_true",
                    help="also print each launch's device time in a call (torch.profiler)")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose package is timed (default this one)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from yade_openfoam_coupling_tpu_torch import native
    from yade_openfoam_coupling_tpu_torch.bench import card_name

    if Path(native.__file__).resolve().parents[1] != root / PKG:
        print(f"meshtree_timing: {PKG} was imported from {native.__file__}, not from {root}; "
              "run the script by its file path to time another checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("meshtree_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    device = torch.device("cuda", 0)
    pts = cell_centres(args.nx)
    q = particle_queries(args.queries, args.nx)
    t0 = time.perf_counter()
    host = native.MeshTree(pts, device="cpu")
    t1 = time.perf_counter()
    tree = native.MeshTree(pts, device=device)
    torch.cuda.synchronize()
    build_s, card_s = t1 - t0, time.perf_counter() - t1
    radius = RADIUS_CELLS * H
    near = host.nearest(q)
    qc = pts[near[0].numpy()]
    ref = (near, host.range_query(qc, radius, CAP))
    tag = {"nx": args.nx, "points": tree.n, "queries": args.queries, "root": root.name,
           "card": card}
    for order in args.order:
        p = shuffle(len(q), args.seed) if order == "shuffled" else np.arange(len(q))
        got = (tree.nearest(q[p]), tree.range_query(qc[p], radius, CAP))
        for g, r in zip(got, ref):
            if not all(torch.equal(a.cpu(), b[p]) for a, b in zip(g, r)):
                raise AssertionError(f"meshtree_timing: the card and the host library differ "
                                     f"({order} order)")
        for name, e in time_queries(tree, host, q[p], qc[p], radius,
                                    profile=args.profile).items():
            print(json.dumps({"kernel": name, "order": order, **e,
                              "share_of_bound": e["bound_ms"] / e["device_ms"], **tag}),
                  flush=True)
    if hasattr(native.bindings, "morton_keys"):
        print(json.dumps({"kernel": "meshtree_keys", **time_keys(tree, q), **tag}), flush=True)
    try:
        from yade_openfoam_coupling_tpu_torch.native import mirror
    except ImportError:
        mirror = None
    if mirror is not None:
        print(json.dumps({"visits": mirror_visits(mirror, host, q, qc, radius, args.seed),
                          **tag}), flush=True)
    print(json.dumps({"host_build_s": build_s, "card_tree_s": card_s, **tag}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
