"""Rank functions of the port's sharding tests (tests/test_torch_sharding*.py).

`parallel.mesh.launch` starts each rank with the ``spawn`` method, so the
function a rank runs must be importable by name in a fresh interpreter:
it lives here, in a module that imports torch and the port only (no
jax), and returns numpy arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yade_openfoam_coupling_tpu_torch.convert import state_from_numpy, state_to_numpy
from yade_openfoam_coupling_tpu_torch.models import coupled as cd
from yade_openfoam_coupling_tpu_torch.ops.grid import DIRICHLET, NEUMANN, PERIODIC, SLIP, \
    FieldBC
from yade_openfoam_coupling_tpu_torch.parallel import ctx as pctx
from yade_openfoam_coupling_tpu_torch.parallel import particles as pp
from yade_openfoam_coupling_tpu_torch.parallel import sharded as sh
from yade_openfoam_coupling_tpu_torch.parallel.ctx import ShardCtx
from yade_openfoam_coupling_tpu_torch.utils import checkpoint as ckpt

BC_KINDS = ("periodic", "dirichlet", "neumann", "slip")


def field_bc(kind: str) -> FieldBC:
    """The same BC on all six faces; a per-component Dirichlet value."""
    value = (2.5, -1.0, 0.5) if kind == DIRICHLET else 0.0
    return FieldBC.uniform({"periodic": PERIODIC, "dirichlet": DIRICHLET,
                            "neumann": NEUMANN, "slip": SLIP}[kind], value)


def _slab(x: np.ndarray, rank: int, size: int, axis: int = 0) -> torch.Tensor:
    n = x.shape[axis] // size
    return torch.as_tensor(np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis))


def pads_and_reductions(mesh, f: np.ndarray, u: np.ndarray, phi):
    """Every halo pad of this rank's slab under every BC kind, the
    reductions of rank-dependent values, the lo-face round trip and one
    ring exchange of asymmetric data, as numpy."""
    ctx = ShardCtx(("x", None, None), mesh)
    r, n = mesh.rank, mesh.size
    fl, ul = _slab(f, r, n), _slab(u, r, n, axis=1)
    out = {}
    for kind in BC_KINDS:
        bc = field_bc(kind)
        out["pad_s", kind] = ctx.pad_s(fl, bc).numpy()
        out["pad_v", kind] = ctx.pad_v(ul, bc).numpy()
        out["pad_s_x2", kind] = ctx.pad_s_x2(fl, bc).numpy()
    x = torch.tensor([1.5 * r - 2.0, 0.25 * r * r], dtype=torch.float32)
    out["sum"] = ctx.sum(x).numpy()
    out["max"] = ctx.max(x).numpy()
    out["min"] = ctx.min(x).numpy()
    out["mean_of_sum"] = ctx.mean_of_sum(torch.sum(fl), fl.numel()).numpy()
    out["sum_int"] = ctx.sum(torch.tensor(r + 1, dtype=torch.int32)).numpy()
    out["sum_float"] = ctx.sum(0.5).numpy()
    # lo-face round trip of this rank's slab of a global flux
    lo = sh.faces_to_lo(tuple(torch.as_tensor(p) for p in phi))
    lo_loc = sh.LoFaces(lo=tuple(_slab(a.numpy(), r, n) for a in lo.lo),
                        hi=(lo.hi[0], _slab(lo.hi[1].numpy(), r, n),
                            _slab(lo.hi[2].numpy(), r, n)))
    faces = sh.lo_to_faces_local(lo_loc, None, ctx)
    out["faces"] = [a.numpy() for a in faces]
    back = sh.faces_to_lo_local(faces, ctx)
    out["lo_back"] = ([a.numpy() for a in back.lo], [a.numpy() for a in back.hi])
    # asymmetric messages: each direction carries other values, and a
    # second tensor of another length rides in the same message
    to_right = [torch.full((3,), 10.0 * r + 1.0), torch.arange(5.0) + 100 * r]
    to_left = [torch.full((3,), 10.0 * r + 2.0), -torch.arange(5.0) - 100 * r]
    from_left, from_right = pctx.ring_exchange(mesh, to_right, to_left)
    out["from_left"] = [t.numpy() for t in from_left]
    out["from_right"] = [t.numpy() for t in from_right]
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    pctx.all_reduce(mesh, torch.ones(1), "sum")


def hang_on_rank_one(mesh):
    """Rank 1 sleeps past the launch deadline; the others wait for it."""
    if mesh.rank == 1:
        time.sleep(600)
    pctx.all_reduce(mesh, torch.ones(1), "sum")


def particle_ops(mesh, grid, dem_cfg, blocks, K_mig, periodic_x):
    """`migrate` of this rank's block of a slot array, and `plan_ghosts` +
    `fetch_ghosts` (with pids) of it, as numpy."""
    geom = pp.SlabGeom(grid.shape[0] // mesh.size, mesh)
    ps = blocks[mesh.rank]
    new, n_over = pp.migrate(ps, grid, geom, K_mig)
    out = {"migrate": {k: v.numpy() for k, v in new._asdict().items() if v is not None},
           "migrate_over": n_over.numpy()}
    gw = pp.ghost_width(grid, dem_cfg, 4e-4)
    K_g = pp.ghost_capacity(ps.pos.shape[0], grid, dem_cfg, 4e-4, geom)
    plan = pp.plan_ghosts(ps.pos, ps.active, grid, geom, gw, periodic_x, K_g)
    out["plan"] = (plan.ids_lo.numpy(), plan.val_lo.numpy(), plan.ids_hi.numpy(),
                   plan.val_hi.numpy(), plan.shift_lo, plan.shift_hi, plan.n_overflow.numpy())
    g = pp.fetch_ghosts(plan, ps.pos, ps.vel, ps.angvel, ps.radius, geom, pid=ps.pid)
    out["ghosts"] = [t.numpy() for t in g]
    return out


def _host_state(g):
    g = g._replace(fluid=g.fluid._replace(phi=sh.lo_to_faces_host(g.fluid.phi)))
    return state_to_numpy(g)


def run_cases(mesh, cases):
    """Each case (name, cfg, state, n_steps, how) from the same global
    state on every rank: ``how`` "scan" runs `make_sharded_scan`, "step"
    `make_sharded_step` n_steps times. -> on rank 0 {name: (global state
    as numpy, diagnostics as numpy)}."""
    out = {}
    for name, cfg, state, n, how in cases:
        s = sh.to_sharded_state(state_from_numpy(state, mesh.device), cfg, mesh)
        if how == "step":
            step = sh.make_sharded_step(cfg, mesh)
            ds = []
            for _ in range(n):
                s, d = step(s)
                ds.append(d)
            d = cd._stack_diags(ds)
        else:
            s, d = sh.make_sharded_scan(cfg, mesh, n)(s)
        g = sh.gather_state(s, cfg, mesh)
        if mesh.rank == 0:
            out[name] = (_host_state(g), {k: v.numpy() for k, v in d._asdict().items()})
    return out if mesh.rank == 0 else None


def checkpoint_round_trip(mesh, cfg, state, n, path):
    """n sharded steps, then two continuations of n steps: one straight on,
    one through a checkpoint of the sharded-layout state (gathered to rank
    0, saved by `utils.checkpoint`, restored by every rank into the layout
    of its template, scattered). -> on rank 0 (straight on, resumed,
    diagnostics of the resumed run), as numpy."""
    state = state_from_numpy(state, mesh.device)
    s = sh.to_sharded_state(state, cfg, mesh)
    cap = s.particles.pos.shape[0]
    scan = sh.make_sharded_scan(cfg, mesh, n)
    s, _ = scan(s)
    direct, _ = scan(s)
    g = sh.gather_state(s, cfg, mesh)
    if mesh.rank == 0:
        ckpt.save(path, g)
    pctx.all_reduce(mesh, torch.ones(1), "sum")      # the snapshot is on disk
    template = sh.sharded_layout(state, cfg, mesh.size, cap)
    restored = ckpt.restore(path, template)
    resumed, d = scan(sh.scatter_state(restored, cfg, mesh))
    g_direct = sh.gather_state(direct, cfg, mesh)
    g_resumed = sh.gather_state(resumed, cfg, mesh)
    if mesh.rank == 0:
        return (_host_state(g_direct), _host_state(g_resumed),
                {k: v.numpy() for k, v in d._asdict().items()})
    return None
