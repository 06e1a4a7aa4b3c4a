"""The port's k-d tree locator and CSR binner (`native/`) on the CPU against
the JAX package's native runtime (`yade_openfoam_coupling_tpu.native`).

Both packages build their trees from the same numpy points, so the
traversal order, and with it the choice among equidistant points and the
members of a capped range query, must agree exactly. The port's host
library is compiled with -ffp-contract=off (the card's kernels sum d2 the
same way); the JAX package's Makefile builds with -march=native and g++'s
default contraction for C++, which fuses dist2's multiply-adds into FMAs
where the host has them. So d2 equals the unfused sum of squares bit for
bit in the port, and the JAX package's d2 to rtol 1e-12 (its own tests'
tolerance); on dyadic points every product is exact, and d2 agrees bit for
bit with the JAX package too.

The kernels' walks (`native/mirror.py`: the near child in registers,
`nearest` pruned at pop; `range` pushing only where the ball straddles)
are held to the host library bit for bit, and the query order's Morton
keys and the nodes' records checked, on the host; the kernels themselves
run in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.native import bindings as jnb
from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.native import MeshTree, available, bin_points
from yade_openfoam_coupling_tpu_torch.native import bindings as tnb
from yade_openfoam_coupling_tpu_torch.native import mirror

H = 0.25          # the dyadic grid's spacing: every tie is exact in either build


def _exact_d2(q, pts):
    """Unfused ((0 + dx^2) + dy^2) + dz^2 of every query to every point."""
    dd = pts[None] - q[:, None]
    return (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + dd[..., 2] * dd[..., 2]


def _centres(n, h=H):
    c = (np.arange(n) + 0.5) * h
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def _face_queries(n, h=H):
    """Every point of the half-spacing lattice over the box: cell centres,
    face centres, edge midpoints and corners (2, 4 and 8 equidistant
    centres)."""
    c = np.arange(2 * n + 1) * (h / 2)
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def _port(tree_out):
    return tuple(t.numpy() for t in tree_out)


def _walk_case(name):
    """(points, queries, radius, caps) of a walk case: test_native.py's
    random clouds, the 8^3 dyadic centres queried on every face, edge and
    corner, and 16^3 centres at random queries and at every 7th point of
    the half-spacing lattice (faces, edges, corners). The last cap is below
    some query's hit count."""
    if name == "random500":
        rng = np.random.RandomState(0)
        return rng.rand(500, 3), rng.rand(64, 3), 0.2, (300, 5)
    if name == "random300":
        rng = np.random.RandomState(1)
        return rng.rand(300, 3), rng.rand(16, 3), 0.2, (300, 3)
    if name == "ties8":
        return _centres(8), _face_queries(8), 1.5 * H, (64, 7)
    h = 1.0 / 16
    if name == "grid16_random":
        return _centres(16, h), np.random.RandomState(9).rand(500, 3), 1.5 * h, (64, 9)
    return _centres(16, h), _face_queries(16, h)[::7], 1.5 * h, (64, 9)


WALK_CASES = ["random500", "random300", "ties8", "grid16_random", "grid16_faces"]


def _arrays(tree):
    return [a.numpy() for a in (tree.pts, tree.order, tree.axes)]


@pytest.mark.parametrize("name", WALK_CASES)
def test_mirror_nearest_walk_matches_the_host_library(name):
    """The kernel's nearest walk, pruned at pop, and the same walk unpruned
    (the host's) give the host library's idx and d2 bit for bit, and the
    pruned walk visits no more nodes than the host's on any query."""
    pts, q, _, _ = _walk_case(name)
    tree = MeshTree(pts, device="cpu")
    hidx, hd2 = _port(tree.nearest(q))
    idx, d2, visits, held = mirror.nearest(*_arrays(tree), q)
    idx0, d20, visits0, held0 = mirror.nearest(*_arrays(tree), q, prune=False)
    for i, d in ((idx, d2), (idx0, d20)):
        np.testing.assert_array_equal(i, hidx)
        np.testing.assert_array_equal(d, hd2)
    assert (visits <= visits0).all() and visits.sum() < visits0.sum()
    assert (visits >= 1).all()
    assert max(held.max(), held0.max()) <= mirror.stack_depth(len(pts))


@pytest.mark.parametrize("name", WALK_CASES)
@pytest.mark.parametrize("which", ["above", "below"])
def test_mirror_range_walk_matches_the_host_library(name, which):
    """The kernel's range walk keeps the host library's members in the
    host's order, its counts and its -1 padding, at a cap above every hit
    count and at one below some."""
    pts, q, r, caps = _walk_case(name)
    cap = caps[0] if which == "above" else caps[1]
    tree = MeshTree(pts, device="cpu")
    hidx, hn = _port(tree.range_query(q, r, cap=cap))
    idx, n, visits, held = mirror.range_query(*_arrays(tree), q, r, cap)
    np.testing.assert_array_equal(idx, hidx)
    np.testing.assert_array_equal(n, hn)
    full = (_exact_d2(q, pts) <= r * r).sum(1)
    assert (full > cap).any() == (which == "below")
    assert (visits >= 1).all() and held.max() <= mirror.stack_depth(len(pts))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 255, 256, 1000])
def test_walks_fit_the_stack_depth(n):
    """No walk holds more far spans than the kernels allot (levels - 1):
    a range over every point, whose ball straddles every plane, and
    nearest from inside and far outside the cloud."""
    rng = np.random.RandomState(n)
    pts = rng.rand(n, 3)
    tree = MeshTree(pts, device="cpu")
    q = np.concatenate([rng.rand(8, 3), [[5.0, 5.0, 5.0], [-3.0, 0.5, 9.0]]])
    depth = mirror.stack_depth(n)
    assert depth == max(n.bit_length() - 1, 1)
    _, cnt, _, held = mirror.range_query(*_arrays(tree), q, 20.0, n)
    assert (cnt == n).all() and held.max() <= depth
    if n in (3, 7, 255):                       # a full range over a perfect tree fills it
        assert held.max() == depth
    idx, d2, _, held = mirror.nearest(*_arrays(tree), q)
    assert held.max() <= depth
    np.testing.assert_array_equal(idx, _port(tree.nearest(q))[0])


def test_node_records_hold_the_tree_in_tree_order():
    """Record m is 32 bytes: pts[order[m]], order[m] and axes[m] bit for
    bit, then 3 zero bytes."""
    rng = np.random.RandomState(10)
    tree = MeshTree(rng.rand(257, 3), device="cpu")
    rec = tnb.node_records(tree.pts, tree.order, tree.axes)
    assert rec.dtype == torch.float64 and rec.shape == (257, 4)
    assert rec.element_size() * rec.shape[1] == tnb.RECORD_BYTES == 32
    pts, order, axes = _arrays(tree)
    r = rec.numpy()
    np.testing.assert_array_equal(r[:, :3], pts[order])
    np.testing.assert_array_equal(r.view(np.int32)[:, 6], order)
    np.testing.assert_array_equal(r.view(np.int8)[:, 28], axes)
    assert (r.view(np.uint8)[:, 29:] == 0).all()
    assert set(np.unique(axes[axes != 0])) <= {1, 2} and (axes != 0).any()
    assert tree.nodes is None and tree.box is None      # only a card tree keeps them


def _order_queries(case):
    if case == "random":
        return np.random.RandomState(11).rand(2000, 3)
    if case == "lattice":
        from yade_openfoam_coupling_tpu_torch.scripts import meshtree_timing as mt
        return mt.particle_queries(3000, 16, 1.0 / 16)
    return np.concatenate([_face_queries(4), [[1e9, -1e9, 0.5], [-np.inf, np.inf, np.nan],
                                              [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]])


@pytest.mark.parametrize("case", ["random", "lattice", "far_out_and_ties"])
def test_query_order_is_a_permutation_along_ascending_keys(case):
    """The order the kernels walk queries in: every query once, keys
    ascending along it, equal keys in query order (a stable sort)."""
    pts = _centres(16, 1.0 / 16)
    box = tnb.morton_box(pts)
    q = torch.as_tensor(_order_queries(case))
    keys = tnb.morton_keys(q, box)
    perm = tnb.query_order(q, box)
    assert keys.dtype == torch.int16 and perm.dtype == torch.int64
    assert torch.equal(perm.sort().values, torch.arange(len(q)))
    k = keys[perm]
    assert bool((k[1:] >= k[:-1]).all())
    assert bool((perm[1:][k[1:] == k[:-1]] > perm[:-1][k[1:] == k[:-1]]).all())
    assert bool((keys >= 0).all()) and int(keys.max()) < 2 ** (3 * tnb.KEY_BITS)


def test_morton_keys_clamp_queries_outside_the_box():
    """Cells are clamped in f64 before the cast: a query past a face, +-inf
    or NaN takes the face's cell (NaN the lower), whatever its size; the
    corners of the box are keys 0 and 2^15 - 1; an axis of no extent has
    scale 0."""
    pts = _centres(4)                       # box [0.125, 0.875]^3
    box = tnb.morton_box(pts)
    np.testing.assert_array_equal(box, [0.125] * 3 + [32 / 0.75] * 3)
    top = 2 ** 15 - 1
    q = torch.tensor([[0.125, 0.125, 0.125], [0.875, 0.875, 0.875], [-1e9, -1e9, -1e9],
                      [1e9, 1e9, 1e9], [np.inf, -np.inf, np.nan], [1e300, 0.5, -1e300]],
                     dtype=torch.float64)
    keys = tnb.morton_keys(q, box).tolist()
    x_only = int("100" * 5, 2)              # the x bits alone set
    cell = int((0.5 - 0.125) * (32 / 0.75))
    mid_y = sum(((cell >> b) & 1) << (3 * b + 1) for b in range(5))
    assert keys == [0, top, 0, top, x_only, x_only | mid_y]
    one = tnb.morton_box(np.array([[0.5, 0.5, 0.5]]))
    np.testing.assert_array_equal(one, [0.5] * 3 + [0.0] * 3)
    assert tnb.morton_keys(q, one).tolist() == [0] * 6
    np.testing.assert_array_equal(tnb.morton_box(np.zeros((0, 3))), np.zeros(6))


def test_host_library_builds_and_is_named_by_its_hash():
    assert available()
    path = tnb.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libmeshtree_host_") and len(path.stem) == 33


def test_nearest_random_cloud_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.rand(500, 3)
    q = rng.rand(64, 3)
    idx, d2 = _port(MeshTree(pts, device="cpu").nearest(q))
    jidx, jd2 = jnb.MeshTree(pts).nearest(q)
    bf = _exact_d2(q, pts)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(idx, bf.argmin(1))
    np.testing.assert_array_equal(d2, bf.min(1))
    np.testing.assert_allclose(d2, jd2, rtol=1e-12)
    assert idx.dtype == np.int32 and d2.dtype == np.float64


def test_range_random_cloud_matches_jax():
    rng = np.random.RandomState(1)
    pts = rng.rand(300, 3)
    q = rng.rand(16, 3)
    r = 0.2
    idx, n = _port(MeshTree(pts, device="cpu").range_query(q, r, cap=300))
    jidx, jn = jnb.MeshTree(pts).range_query(q, r, cap=300)
    np.testing.assert_array_equal(idx, jidx)     # members and their order
    np.testing.assert_array_equal(n, jn)
    bf = _exact_d2(q, pts) <= r * r
    for i in range(16):
        assert set(idx[i, : n[i]].tolist()) == set(np.nonzero(bf[i])[0].tolist())
        assert (idx[i, n[i]:] == -1).all()


def test_nearest_ties_on_faces_edges_and_corners_match_jax():
    pts = _centres(8)
    q = _face_queries(8)
    idx, d2 = _port(MeshTree(pts, device="cpu").nearest(q))
    jidx, jd2 = jnb.MeshTree(pts).nearest(q)
    bf = _exact_d2(q, pts)
    ties = (bf == bf.min(1, keepdims=True)).sum(1)
    assert (ties == 8).sum() > 0 and (ties == 2).sum() > 0     # corners and faces tie
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d2, jd2)
    np.testing.assert_array_equal(d2, bf.min(1))
    assert (bf[np.arange(len(q)), idx] == d2).all()


@pytest.mark.parametrize("cloud,cap", [("grid", 7), ("grid", 19), ("random", 5)])
def test_range_query_capped_below_the_hits_matches_jax(cloud, cap):
    """`cap` below the hit count: the members kept, and their order, are the
    traversal's, the same in both packages."""
    if cloud == "grid":
        pts, q, r = _centres(8), _face_queries(8)[::7], 1.5 * H
    else:
        rng = np.random.RandomState(3)
        pts, q, r = rng.rand(400, 3), rng.rand(32, 3), 0.3
    idx, n = _port(MeshTree(pts, device="cpu").range_query(q, r, cap=cap))
    jidx, jn = jnb.MeshTree(pts).range_query(q, r, cap=cap)
    full = (_exact_d2(q, pts) <= r * r).sum(1)
    assert (full > cap).sum() > 0
    np.testing.assert_array_equal(n, np.minimum(full, cap))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(n, jn)


def test_range_at_one_and_a_half_cells_is_the_sphere2_stencil():
    """r = 1.5h from an interior cell centre holds its 19 `sphere2` cells."""
    pts = _centres(8)
    tree = MeshTree(pts, device="cpu")
    q = pts[(np.abs(pts - 1.0) < 0.6).all(1)]          # centres two cells from every wall
    idx, n = _port(tree.range_query(q, 1.5 * H, cap=64))
    assert (n == 19).all()
    sphere2 = sorted(tuple(o) for o in np.argwhere(np.ones((3, 3, 3))) - 1
                     if (o ** 2).sum() <= 2)
    for i in range(len(q)):
        off = np.round((pts[idx[i, :19]] - q[i]) / H).astype(int)
        assert sorted(map(tuple, off)) == sphere2


def test_tree_arrays_are_a_median_layout():
    """order is a permutation; every span's median splits it on axes[mid]."""
    rng = np.random.RandomState(4)
    pts = rng.rand(257, 3)
    tree = MeshTree(torch.as_tensor(pts), device="cpu")
    order, axes, tp = tree.order.numpy(), tree.axes.numpy(), tree.pts.numpy()
    np.testing.assert_array_equal(tp, pts)
    np.testing.assert_array_equal(np.sort(order), np.arange(257))
    spans = [(0, 257)]
    while spans:
        lo, hi = spans.pop()
        if hi - lo <= 1:
            continue
        mid, a = (lo + hi) // 2, axes[(lo + hi) // 2]
        split = pts[order[mid], a]
        assert (pts[order[lo:mid], a] <= split).all() and (pts[order[mid + 1:hi], a] >= split).all()
        spans += [(lo, mid), (mid + 1, hi)]


def test_queries_take_tensors_and_arrays_and_launch_nothing_on_the_cpu():
    rng = np.random.RandomState(5)
    pts, q = rng.rand(100, 3), rng.rand(10, 3).astype(np.float32)
    before = (LAUNCHES["yofc_tree_nearest"], LAUNCHES["yofc_tree_range"])
    a = MeshTree(pts, device="cpu")
    b = MeshTree(torch.as_tensor(pts, dtype=torch.float64), device="cpu")
    for x in (q, torch.as_tensor(q)):
        for out_a, out_b in ((a.nearest(x), b.nearest(q)), (a.range_query(x, 0.3, 16),
                                                             b.range_query(q, 0.3, 16))):
            for s, t in zip(out_a, out_b):
                assert s.device.type == "cpu" and torch.equal(s, t)
    idx, n = a.range_query(q, 0.3, 16)
    assert idx.shape == (10, 16) and idx.dtype == torch.int32 and n.dtype == torch.int32
    e_idx, e_d2 = a.nearest(np.zeros((0, 3)))
    assert e_idx.shape == (0,) and e_d2.shape == (0,)
    assert (LAUNCHES["yofc_tree_nearest"], LAUNCHES["yofc_tree_range"]) == before


def test_timing_bound_reads_the_tree_once():
    """meshtree_timing's bound: the tree's 29 bytes a point and each query's
    24 bytes in and its results out, once, or the answers' distances when
    they take longer."""
    from yade_openfoam_coupling_tpu_torch.scripts import meshtree_timing as mt
    tree = MeshTree(np.random.RandomState(6).rand(1000, 3), device="cpu")
    b = mt.bound(tree, 50, 12, 50)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx((1000 * 29 + 50 * 36) / mt.HBM_BYTES_PER_S * 1e3)
    b = mt.bound(tree, 50, 12, 10 ** 9)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(8e9 / mt.F64_FLOPS * 1e3)


def test_compile_shared_raises_with_the_compilers_output(tmp_path):
    """The build helper that names the host library and the CUDA libraries
    alike: a failed compile raises with the compiler's report, leaves no
    library and no temporary file behind."""
    import shutil
    from yade_openfoam_coupling_tpu_torch import kernels
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    out = tmp_path / "libbroken.so"
    before = set(kernels.BUILD.iterdir())
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        kernels.compile_shared({out: [shutil.which("g++"), *tnb.CXX_FLAGS, str(src)]})
    assert not out.exists() and set(kernels.BUILD.iterdir()) == before


def test_bin_points_csr_matches_jax():
    rng = np.random.RandomState(2)
    pts = rng.rand(1000, 3)
    args = ((0, 0, 0), (0.25, 0.25, 0.25), (4, 4, 4))
    cell_of, order, cell_start = _port(bin_points(pts, *args, device="cpu"))
    for got, ref in zip((cell_of, order, cell_start), jnb.bin_points(pts, *args)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert cell_start[-1] == 1000
    for c in range(64):
        seg = order[cell_start[c]:cell_start[c + 1]]
        assert (cell_of[seg] == c).all() and (np.diff(seg) > 0).all()


@pytest.mark.parametrize("case", ["out_of_domain", "upper_face_and_far"])
def test_bin_points_scrap_bin_matches_jax(case):
    if case == "out_of_domain":
        pts = np.array([[0.5, 0.5, 0.5], [2.0, 0.5, 0.5], [-1.0, 0, 0]])
        args = ((0, 0, 0), (1, 1, 1), (1, 1, 1))
        expect = [0, 1, 1]
    else:
        # a (4, 5, 6) grid of h 0.5 from (-1, 0, 0.25): upper faces x = 1,
        # y = 2.5, z = 3.25 belong to no cell; +-1e12 overflow an int32
        args = ((-1.0, 0.0, 0.25), (0.5, 0.5, 0.5), (4, 5, 6))
        pts = np.array([[0.99, 2.49, 3.24], [1.0, 1.0, 1.0], [0.0, 2.5, 1.0],
                        [0.0, 1.0, 3.25], [-1.0, 0.0, 0.25], [1e12, 1.0, 1.0],
                        [0.0, -1e12, 1.0], [0.0, 1.0, 1e12], [-1e12, -1e12, -1e12],
                        [0.1, 0.2, 0.3]])
        expect = [119, 120, 120, 120, 0, 120, 120, 120, 120, 60]
    cell_of, order, cell_start = _port(bin_points(pts, *args, device="cpu"))
    np.testing.assert_array_equal(cell_of, expect)
    for got, ref in zip((cell_of, order, cell_start), jnb.bin_points(pts, *args)):
        np.testing.assert_array_equal(got, ref)
