"""OpenFOAM polyMesh writer for the uniform Cartesian grid (the port's own
copy of `yade_openfoam_coupling_tpu/utils/foammesh.py`, plain numpy).

The reference inherits a complete case layout (constant/polyMesh from
blockMesh) and gets ParaView compatibility for free through
`runTime.write()` (`icoFoamYade/icoFoamYade.C:142`). Our
time-directory writer needs the companion mesh to be readable by OpenFOAM
post-processing, so this module emits the blockMesh-equivalent polyMesh for
a `Grid`: points / faces / owner / neighbour / boundary, in OpenFOAM's
canonical ordering (cells x-fastest, internal faces owner-major with
increasing neighbour, boundary faces grouped into the six box patches with
outward normals).

Everything is generated with vectorized numpy and written as ASCII blocks —
a 64^3 mesh (~800k faces) writes in a few seconds; meshes are written once
per case, not per step.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.grid import Grid

PATCH_NAMES = ("xMin", "xMax", "yMin", "yMax", "zMin", "zMax")

_HDR = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "constant/polyMesh";
    object      {obj};
}}
"""


def _vertex_ids(grid: Grid):
    """(nx+1, ny+1, nz+1) array of vertex ids, x-fastest ordering."""
    nx, ny, nz = grid.shape
    ids = np.arange((nx + 1) * (ny + 1) * (nz + 1), dtype=np.int64)
    # x-fastest: v(i,j,k) = i + j*(nx+1) + k*(nx+1)*(ny+1)
    return ids.reshape(nz + 1, ny + 1, nx + 1).transpose(2, 1, 0)


def cell_ids(grid: Grid) -> np.ndarray:
    """(nx, ny, nz) cell ids in OpenFOAM/blockMesh x-fastest ordering —
    the ordering `write_time_dir` must flatten fields into."""
    nx, ny, nz = grid.shape
    return np.arange(nx * ny * nz, dtype=np.int64).reshape(nz, ny, nx).transpose(2, 1, 0)


def _quad(v, axis: int, plane: int, flip: bool) -> np.ndarray:
    """All quad faces on vertex-plane `plane` normal to `axis`, as an
    (nfaces, 4) vertex-id array ordered so the right-hand normal points in
    +axis (flip=False) or -axis (flip=True)."""
    if axis == 0:
        base = v[plane, :-1, :-1]
        e1 = v[plane, 1:, :-1]      # +y
        e12 = v[plane, 1:, 1:]
        e2 = v[plane, :-1, 1:]      # +z
    elif axis == 1:
        base = v[:-1, plane, :-1]
        e1 = v[:-1, plane, 1:]      # +z
        e12 = v[1:, plane, 1:]
        e2 = v[1:, plane, :-1]      # +x
    else:
        base = v[:-1, :-1, plane]
        e1 = v[1:, :-1, plane]      # +x
        e12 = v[1:, 1:, plane]
        e2 = v[:-1, 1:, plane]      # +y
    quad = np.stack([base, e1, e12, e2], axis=-1).reshape(-1, 4)
    if flip:
        quad = quad[:, ::-1]
    return quad


def build_polymesh(grid: Grid):
    """Return (points, faces, owner, neighbour, patch_slices).

    points: (npts, 3) float; faces: (nfaces, 4) vertex ids; owner/neighbour:
    int arrays (neighbour only for internal faces); patch_slices: dict
    name -> (startFace, nFaces)."""
    nx, ny, nz = grid.shape
    v = _vertex_ids(grid)
    cid = cell_ids(grid)

    # points, x-fastest
    xs = [grid.origin[a] + np.arange(grid.shape[a] + 1) * grid.spacing[a] for a in range(3)]
    Z, Y, X = np.meshgrid(xs[2], xs[1], xs[0], indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    # internal faces: for each cell (in x-fastest order) its +x, +y, +z
    # faces, neighbour ids increasing (c+1 < c+nx < c+nx*ny) -> canonical
    # owner-major upper-triangular ordering.
    own_x = cid[:-1, :, :]
    nbr_x = cid[1:, :, :]
    own_y = cid[:, :-1, :]
    nbr_y = cid[:, 1:, :]
    own_z = cid[:, :, :-1]
    nbr_z = cid[:, :, 1:]

    # per-face quads on interior planes
    fx = np.stack([_quad(v, 0, i, False) for i in range(1, nx)]) if nx > 1 else np.zeros((0, 0, 4), np.int64)
    fy = np.stack([_quad(v, 1, j, False) for j in range(1, ny)]) if ny > 1 else np.zeros((0, 0, 4), np.int64)
    fz = np.stack([_quad(v, 2, k, False) for k in range(1, nz)]) if nz > 1 else np.zeros((0, 0, 4), np.int64)
    # _quad plane arrays are (ny*nz) etc. in y-fast-then-z? base=v[plane,:-1,:-1]
    # has shape (ny, nz) -> reshape(-1) is z-fastest within the plane; match
    # the owner arrays' layout by flattening them identically below.

    faces, owner, neighbour = [], [], []
    # interleave per owner cell: iterate owner-major. Simplest canonical
    # construction: sort all internal faces by (owner, neighbour).
    int_faces = []
    if nx > 1:
        int_faces.append((own_x.reshape(nx - 1, -1, order="C"),
                          nbr_x.reshape(nx - 1, -1, order="C"), fx))
    if ny > 1:
        oy = own_y.transpose(1, 0, 2).reshape(ny - 1, -1)
        nyb = nbr_y.transpose(1, 0, 2).reshape(ny - 1, -1)
        int_faces.append((oy, nyb, fy))
    if nz > 1:
        oz = own_z.transpose(2, 0, 1).reshape(nz - 1, -1)
        nzb = nbr_z.transpose(2, 0, 1).reshape(nz - 1, -1)
        int_faces.append((oz, nzb, fz))

    all_own, all_nbr, all_quad = [], [], []
    for o, n, q in int_faces:
        # o: (nplanes, cells_per_plane); q: (nplanes, faces_per_plane, 4)
        # plane flattening of _quad: for axis 0, base shape (ny, nz) ->
        # row-major = y-major/z-fastest; owner own_x[i] has shape (ny, nz)
        # row-major too. For axes 1/2 the transposes above align them.
        if q.ndim == 3 and q.shape[0] > 0:
            all_own.append(o.reshape(-1))
            all_nbr.append(n.reshape(-1))
            all_quad.append(q.reshape(-1, 4))
    if all_own:
        o = np.concatenate(all_own)
        n = np.concatenate(all_nbr)
        q = np.concatenate(all_quad)
        order = np.lexsort((n, o))
        owner = o[order]
        neighbour = n[order]
        faces = q[order]
    else:
        owner = np.zeros(0, np.int64)
        neighbour = np.zeros(0, np.int64)
        faces = np.zeros((0, 4), np.int64)

    # boundary patches (outward normals)
    patch_slices = {}
    b_faces, b_owner = [], []
    start = len(faces)
    specs = [
        ("xMin", 0, 0, True, cid[0, :, :].reshape(-1)),
        ("xMax", 0, nx, False, cid[-1, :, :].reshape(-1)),
        ("yMin", 1, 0, True, cid[:, 0, :].transpose(0, 1).reshape(-1)),
        ("yMax", 1, ny, False, cid[:, -1, :].reshape(-1)),
        ("zMin", 2, 0, True, cid[:, :, 0].reshape(-1)),
        ("zMax", 2, nz, False, cid[:, :, -1].reshape(-1)),
    ]
    for name, axis, plane, flip, own in specs:
        q = _quad(v, axis, plane, flip)
        # align quad flattening with owner flattening:
        if axis == 0:
            pass            # both (ny, nz) row-major
        elif axis == 1:
            # _quad base v[:-1, plane, :-1] is (nx, nz); owner cid[:, j, :]
            # is (nx, nz) — aligned
            pass
        else:
            pass            # (nx, ny) both
        patch_slices[name] = (start, len(q))
        start += len(q)
        b_faces.append(q)
        b_owner.append(own)

    faces = np.concatenate([faces] + b_faces)
    owner = np.concatenate([owner] + b_owner)
    return points, faces, owner, neighbour, patch_slices


def _write_list(f, arr: np.ndarray, fmt):
    f.write(f"{len(arr)}\n(\n")
    if len(arr):
        f.write("\n".join(fmt(row) for row in arr))
        f.write("\n")
    f.write(")\n")


def write_polymesh(case_dir, grid: Grid, patch_types=None) -> str:
    """Write constant/polyMesh/{points,faces,owner,neighbour,boundary}.

    `patch_types`: optional dict name -> OpenFOAM patch type string
    (default 'patch' everywhere; pass 'wall' for wall patches)."""
    points, faces, owner, neighbour, patches = build_polymesh(grid)
    pm = Path(case_dir) / "constant" / "polyMesh"
    pm.mkdir(parents=True, exist_ok=True)
    patch_types = patch_types or {}

    with open(pm / "points", "w") as f:
        f.write(_HDR.format(cls="vectorField", obj="points"))
        _write_list(f, points, lambda p: f"({p[0]:.8g} {p[1]:.8g} {p[2]:.8g})")

    with open(pm / "faces", "w") as f:
        f.write(_HDR.format(cls="faceList", obj="faces"))
        _write_list(f, faces, lambda q: f"4({q[0]} {q[1]} {q[2]} {q[3]})")

    with open(pm / "owner", "w") as f:
        f.write(_HDR.format(cls="labelList", obj="owner"))
        _write_list(f, owner, lambda x: str(x))

    with open(pm / "neighbour", "w") as f:
        f.write(_HDR.format(cls="labelList", obj="neighbour"))
        _write_list(f, neighbour, lambda x: str(x))

    with open(pm / "boundary", "w") as f:
        f.write(_HDR.format(cls="polyBoundaryMesh", obj="boundary"))
        f.write(f"{len(patches)}\n(\n")
        for name in PATCH_NAMES:
            start, n = patches[name]
            ptype = patch_types.get(name, "patch")
            f.write(
                f"    {name}\n    {{\n        type            {ptype};\n"
                f"        nFaces          {n};\n"
                f"        startFace       {start};\n    }}\n"
            )
        f.write(")\n")
    return str(pm)


def check_polymesh(grid: Grid) -> None:
    """Self-consistency checks (no OpenFOAM available in CI): face counts,
    owner<neighbour canonical ordering, every face's vertices coplanar on
    the claimed cell boundary, outward boundary normals."""
    points, faces, owner, neighbour, patches = build_polymesh(grid)
    nx, ny, nz = grid.shape
    n_int = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    n_bnd = 2 * (ny * nz + nx * nz + nx * ny)
    assert len(faces) == n_int + n_bnd, (len(faces), n_int, n_bnd)
    assert len(neighbour) == n_int
    assert np.all(owner[:n_int] < neighbour), "owner must be < neighbour"
    key = owner[:n_int] * (nx * ny * nz) + neighbour
    assert np.all(np.diff(key) > 0), "internal faces not in canonical order"

    # geometric checks: face normal points owner -> neighbour / outward
    pts = points[faces]                                   # (nf, 4, 3)
    centers = pts.mean(axis=1)
    normal = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
    cc = _cell_centers_xfastest(grid)
    d_own = centers - cc[owner]
    assert np.all(np.einsum("ij,ij->i", normal, d_own) > 0), "normal not outward of owner"
    d_nbr = centers[:n_int] - cc[neighbour]
    assert np.all(np.einsum("ij,ij->i", normal[:n_int], d_nbr) < 0)


def _cell_centers_xfastest(grid: Grid) -> np.ndarray:
    xs = [grid.origin[a] + (np.arange(grid.shape[a]) + 0.5) * grid.spacing[a] for a in range(3)]
    Z, Y, X = np.meshgrid(xs[2], xs[1], xs[0], indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
