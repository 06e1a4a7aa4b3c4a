"""The port's sharded particle plumbing against the JAX package: `migrate`,
`plan_ghosts` and `fetch_ghosts` on 4 gloo CPU ranks against the JAX
functions under `jax.shard_map` on 4 of the conftest's virtual devices
(slot arrays bit for bit); the sharded sparse deposit's B3 route against
the JAX package's clipped roll loop (bit for bit); `window_bins` in slab
mode against the JAX package's; and the refusal of the sharded sparse
exchange at stencil_width=5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from torch_sharding_ranks import particle_ops
from yade_openfoam_coupling_tpu.models.fields import ParticleState as JParticleState
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import coupling_window as cw
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu.parallel import particles as jpp
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.models.fields import ParticleState
from yade_openfoam_coupling_tpu_torch.models.piso import FluidBCs
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import coupling_window as tcw
from yade_openfoam_coupling_tpu_torch.ops import rolls
from yade_openfoam_coupling_tpu_torch.parallel import launch
from yade_openfoam_coupling_tpu_torch.parallel import sharded as tsh
from yade_openfoam_coupling_tpu_torch.parallel.ctx import ShardCtx
from yade_openfoam_coupling_tpu_torch.parallel.mesh import Mesh

N_SH, CAP, K_MIG, M = 4, 24, 8, 4
GRID = Grid.cube(16, 0.016)

pytestmark = pytest.mark.skipif(len(jax.devices()) < N_SH, reason="needs 4 virtual devices")


def _blocks(seed=0):
    """N_SH blocks of CAP slots: active particles anywhere in the domain (so
    many must hop 1-3 slabs), shear springs and keys filled with noise."""
    rng = np.random.RandomState(seed)
    n = N_SH * CAP
    pos = rng.uniform(0.0, 0.016, (n, 3)).astype(np.float32)
    # straddlers of every slab edge, within a ghost width of it
    pos[::5, 0] = (np.repeat(np.arange(N_SH), CAP)[::5] * 0.004
                   + rng.choice([-1.0, 1.0], len(pos[::5])) * 3e-4) % 0.016
    active = rng.uniform(size=n) < 0.6
    return dict(
        pos=pos, vel=rng.standard_normal((n, 3)).astype(np.float32),
        angvel=rng.standard_normal((n, 3)).astype(np.float32),
        radius=rng.uniform(3e-4, 4e-4, n).astype(np.float32), active=active,
        pid=np.where(active, rng.permutation(n), -1).astype(np.int32),
        shear_xi=rng.standard_normal((n, M, 3)).astype(np.float32),
        shear_ids=rng.randint(-1, n, (n, M)).astype(np.int32),
        shear_wall=rng.standard_normal((n, 3, 3)).astype(np.float32))


def _dem_cfg(periodic_x):
    return dem.DEMConfig(neighbor="cells", cell_capacity=8, max_neighbors=8,
                         periodic=(periodic_x, True, False))


def _jax_ops(arrs, periodic_x):
    mesh = JMesh(np.asarray(jax.devices()[:N_SH]), ("x",))
    geom = jpp.SlabGeom(n_loc=GRID.shape[0] // N_SH, name="x")
    cfg = _dem_cfg(periodic_x)
    gw = jpp.ghost_width(GRID, cfg, 4e-4)
    K_g = jpp.ghost_capacity(CAP, GRID, cfg, 4e-4, geom)

    def body(ps):
        new, over = jpp.migrate(ps, GRID, geom, K_MIG)
        plan = jpp.plan_ghosts(ps.pos, ps.active, GRID, geom, gw, periodic_x, K_g)
        g = jpp.fetch_ghosts(plan, ps.pos, ps.vel, ps.angvel, ps.radius, geom, pid=ps.pid)
        scal = jnp.stack([plan.shift_lo, plan.shift_hi])[None]
        return new, over[None], (plan.ids_lo, plan.val_lo, plan.ids_hi, plan.val_hi), \
            scal, plan.n_overflow[None], g

    ps = JParticleState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                                 check_vma=False))(ps)


def _port_blocks(arrs):
    return [ParticleState(**{k: torch.as_tensor(v[r * CAP:(r + 1) * CAP])
                             for k, v in arrs.items()}) for r in range(N_SH)]


@pytest.fixture(scope="module", params=[True, False], ids=["periodic_x", "walls_x"])
def both(request):
    periodic_x = request.param
    arrs = _blocks()
    ref = jax.tree.map(np.asarray, _jax_ops(arrs, periodic_x))
    out = launch(particle_ops, N_SH, "gloo", "cpu",
                 (config_from(GRID), config_from(_dem_cfg(periodic_x)), _port_blocks(arrs),
                  K_MIG, periodic_x), timeout=60)
    return ref, out


def test_migrate_slot_arrays_bit_for_bit(both):
    (new, over, _, _, _, _), out = both
    n_moved = 0
    for r, o in enumerate(out):
        sl = slice(r * CAP, (r + 1) * CAP)
        for name, got in o["migrate"].items():
            np.testing.assert_array_equal(got, np.asarray(getattr(new, name))[sl],
                                          err_msg=f"rank {r} {name}")
        assert int(o["migrate_over"]) == int(over[r])
        n_moved += int(np.sum(o["migrate"]["pid"] != _blocks()["pid"][sl]))
    assert n_moved > 10          # particles really travelled


def test_ghost_plan_bit_for_bit(both):
    (_, _, plan, scal, n_over, _), out = both
    K = plan[0].shape[0] // N_SH
    for r, o in enumerate(out):
        sl = slice(r * K, (r + 1) * K)
        for i in range(4):
            np.testing.assert_array_equal(o["plan"][i], plan[i][sl])
        assert np.float32(o["plan"][4]) == scal[r, 0]
        assert np.float32(o["plan"][5]) == scal[r, 1]
        assert int(o["plan"][6]) == int(n_over[r])
    assert sum(int(o["plan"][1].sum() + o["plan"][3].sum()) for o in out) > 8


def test_fetched_ghosts_bit_for_bit(both):
    (*_, ghosts), out = both
    K2 = ghosts[0].shape[0] // N_SH
    for r, o in enumerate(out):
        sl = slice(r * K2, (r + 1) * K2)
        for got, want in zip(o["ghosts"], ghosts):
            np.testing.assert_array_equal(got, np.asarray(want)[sl])


def _clipped_loop(bufT, offsets, n_loc):
    """The JAX package's sharded `dep_stack` distribution
    (`parallel/sharded.py:217-225`): buffer plane j (n_loc+1 planes) adds
    into extended plane j + dx of n_loc+2, clipped, after the (dy, dz) roll."""
    C, ny, nz = bufT.shape[1], bufT.shape[3], bufT.shape[4]
    ext = torch.zeros((C, n_loc + 2, ny, nz), dtype=bufT.dtype)
    for o in range(len(offsets)):
        dx, dy, dz = (int(v) for v in offsets[o])
        plane = torch.roll(bufT[o], (dy, dz), dims=(2, 3))
        j0, j1 = max(0, -dx), min(n_loc + 1, n_loc + 2 - dx)
        ext[:, j0 + dx:j1 + dx] += plane[:, j0:j1]
    return ext


@pytest.mark.parametrize("stencil", ["cube", "sphere2", "trilinear"])
def test_dep_stack_b3_route_equals_clipped_loop(stencil):
    """B3 on the (n_loc+2)-plane buffer (its last plane empty) computes the
    clipped roll loop bit for bit: a Gaussian anchor never sits in plane 0,
    a trilinear one may, but its offsets have dx in {0, 1}."""
    n_loc, ny, nz, C = 4, 6, 5, 3
    if stencil == "trilinear":
        offsets = tcp.TRILINEAR_CORNERS
    else:
        offsets = tcp.stencil_offsets(tcp.CouplingConfig(stencil_shape=stencil))
    rng = np.random.RandomState(1)
    buf = torch.as_tensor(rng.standard_normal((len(offsets), C, n_loc + 2, ny, nz))
                          .astype(np.float32))
    buf[:, :, n_loc + 1] = 0.0
    if stencil != "trilinear":
        buf[:, :, 0] = 0.0
    want = _clipped_loop(buf[:, :, :n_loc + 1], offsets, n_loc)
    assert torch.equal(rolls.distribute_rolls(buf, offsets), want)


def test_dep_stack_of_one_rank_through_b3():
    """The sharded support's deposit at one rank (no process group: the
    ring is a local copy) lands every particle's weighted volume once and
    goes through `rolls.distribute_rolls`."""
    grid = config_from(GRID)
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    ctx = ShardCtx(("x", None, None), mesh)
    ccfg = tcp.CouplingConfig(gaussian=True)
    rng = np.random.RandomState(2)
    pos = torch.as_tensor(rng.uniform(0.001, 0.015, (30, 3)).astype(np.float32))
    active = torch.ones(30, dtype=torch.bool)
    cells, w_raw, valid = tcp.gaussian_cells_raw_weights(pos, active, grid, ccfg)
    w = tcp.normalize_weights(w_raw, valid[:, None])
    base, _ = tcp.locate(pos, grid)
    calls = []
    real = rolls.distribute_rolls
    try:
        rolls.distribute_rolls = lambda b, o: calls.append(b.shape) or real(b, o)
        ops, w_own = tsh._sharded_support_ops(cells, w, valid, base,
                                              tcp.stencil_offsets(ccfg), grid,
                                              FluidBCs.channel_z(), ctx, 16)
        dep = ops.deposit(w_own)
    finally:
        rolls.distribute_rolls = real
    assert calls and calls[0][2] == 16 + 2
    assert abs(float(dep.sum()) - 30.0) < 1e-4


@pytest.mark.parametrize("x_start,wrap", [(0, False), (4, False), (12, False), (-1, True),
                                          (13, True)])
def test_window_bins_slab_mode_exact(x_start, wrap):
    """`window_bins` on an x-window (n_loc planes from x_start, wrapped
    modulo nx) equals the JAX package's, staged window bit for bit."""
    n_loc = 4 + (2 if wrap else 0)
    rng = np.random.RandomState(4)
    n = 300
    arrs = (rng.uniform(0.0005, 0.0155, (n, 3)).astype(np.float32),
            (rng.standard_normal((n, 3)) * 1e-3).astype(np.float32),
            (rng.standard_normal((n, 3)) * 1e-2).astype(np.float32),
            np.full(n, 4e-4, np.float32), rng.uniform(size=n) < 0.9)
    ref = cw.window_bins(cp.ParticleFields(*(jnp.asarray(a) for a in arrs)), GRID, 4, 512,
                         with_angvel=True, x_start=x_start, n_loc=n_loc, wrap_x=wrap)
    out = tcw.window_bins(tcp.ParticleFields(*(torch.as_tensor(a) for a in arrs)),
                          config_from(GRID), 4, 512, with_angvel=True, x_start=x_start,
                          n_loc=n_loc, wrap_x=wrap)
    for name in ("order", "inv_order", "cell_sorted", "rank", "keep", "counts",
                 "n_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(out.dat_win.numpy().view(np.uint32),
                                  np.asarray(ref.dat_win).view(np.uint32))
    assert int(out.counts.sum()) > 0


def test_sharded_sparse_exchange_refuses_stencil_width_5():
    """The JAX package's sharded sparse exchange holds one halo plane a
    side and folds or drops dx = +-2 at width 5; the port refuses it."""
    cfg = tcd.CaseConfig(grid=config_from(GRID), bcs=FluidBCs.channel_z(), solver="pimple",
                         coupling=tcp.CouplingConfig(gaussian=True, stencil_width=5))
    ctx = ShardCtx(("x", None, None), Mesh(None, 0, 1, torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="stencil_width=5"):
        tsh.make_sharded_exchange(cfg, ctx, 16)
    cfg3 = dataclasses.replace(cfg, coupling=tcp.CouplingConfig(gaussian=True))
    assert callable(tsh.make_sharded_exchange(cfg3, ctx, 16))
