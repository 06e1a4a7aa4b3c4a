"""The port's sparse Gaussian exchange against the JAX package's on the
same seeded numpy inputs: kernel B3's plain version against the Pallas
roll kernel in interpret mode, `gaussian_coupling` (with and without
lag_alpha, cube and sphere2 stencils), `gaussian_coupling_chunked`, the
direct-scatter route of `deposit_stack` and the size rule of the roll
distribution."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu.ops.pallas_rolls import distribute_rolls_pallas
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import rolls

GRID = Grid.cube(16, 0.016)
PERIODIC = (True, True, False)
FIELDS = ("force", "torque", "alpha", "u_particle", "u_source", "u_source_drag")


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


@pytest.mark.parametrize("shape", ["sphere2", "cube", "asymmetric"])
def test_rolls_plain_matches_pallas(shape):
    """The plain roll distribution equals the Pallas kernel in interpret
    mode at test_pallas.py's tolerance, also for an asymmetric offset set
    (the roll direction) and through a strided view of an offset-major
    buffer with a scrap column, the layout the deposit hands the kernel."""
    if shape == "asymmetric":
        offsets = np.array([[1, 0, 0], [0, -1, 1], [-1, 1, -1], [0, 0, 1], [1, -1, 0]])
    else:
        offsets = jcp.stencil_offsets(jcp.CouplingConfig(stencil_shape=shape))
    S, C, grid_shape = len(offsets), 8, (8, 16, 32)
    ncells = int(np.prod(grid_shape))
    buf = np.random.RandomState(2).randn(S * C, ncells + 1).astype(np.float32)
    bufT = buf[:, :ncells].reshape((S, C) + grid_shape)
    expect = np.asarray(distribute_rolls_pallas(jnp.asarray(bufT), offsets, interpret=True))
    view = torch.as_tensor(buf)[:, :ncells].view((S, C) + grid_shape)
    got = rolls.distribute_rolls(view, offsets)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert LAUNCHES["yofc_rolls_deposit"] == 0           # CPU: the plain version
    # one channel: the size-1 dim's stride says nothing of the layout
    one = torch.as_tensor(buf[:S])[:, :ncells].view((S, 1) + grid_shape)
    assert rolls._plane_stride(one, offsets) == ncells + 1
    np.testing.assert_array_equal(rolls.distribute_rolls(one, offsets).numpy(),
                                  rolls.distribute_rolls_reference(one, offsets).numpy())
    with pytest.raises(ValueError, match="offsets"):
        rolls.distribute_rolls(view, offsets[:, :2])


def _inputs(n=300, seed=0):
    rng = np.random.RandomState(seed)
    pf = (rng.uniform(0.001, 0.015, (n, 3)), 1e-2 * rng.randn(n, 3), 1e-1 * rng.randn(n, 3),
          np.full(n, 4e-4), np.ones(n, bool))
    pf = tuple(np.asarray(a, np.float32) if a.dtype != bool else a for a in pf)
    F = (1e-2 * rng.randn(13, *GRID.shape)).astype(np.float32)
    alpha = (0.9 + 0.1 * rng.rand(*GRID.shape)).astype(np.float32)
    return pf, F, alpha


def _run_both(cfg, fn="gaussian_coupling", n=300):
    pf, F, alpha = _inputs(n)
    args = (F[0:3], F[3:6], F[6:9], F[9:12], F[10:13])
    ref = getattr(jcp, fn)(jcp.ParticleFields(*map(jnp.asarray, pf)),
                           *map(jnp.asarray, args), GRID, PERIODIC, 1e-6, 1000.0, 5e-5, cfg,
                           prev_alpha=jnp.asarray(alpha))
    out = getattr(tcp, fn)(tcp.ParticleFields(*map(torch.as_tensor, pf)),
                           *map(torch.as_tensor, args), config_from(GRID), PERIODIC,
                           1e-6, 1000.0, 5e-5, config_from(cfg),
                           prev_alpha=torch.as_tensor(alpha))
    return ref, out


@pytest.mark.parametrize("shape", ["cube", "sphere2"])
@pytest.mark.parametrize("lag", [False, True])
def test_gaussian_coupling_matches_jax(shape, lag):
    """`found` is equal; the fields and forces are within 1e-5 of their
    scale (f32 sums in another order; the deposits' scatter adds in the
    same order). Torque and added mass are on for the cube stencil."""
    extras = shape == "cube"
    cfg = jcp.CouplingConfig(gaussian=True, stencil_shape=shape, lag_alpha=lag,
                             use_torque=extras, use_added_mass=extras)
    ref, out = _run_both(cfg)
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    assert int(out.found.sum()) == 300
    for name in FIELDS:
        _close(name, getattr(out, name).numpy(), getattr(ref, name), 1e-5)
    if extras:
        assert float(out.torque.abs().max()) > 0.0


def test_volume_fraction_fields_match_jax():
    """`volume_fraction_fields` (direct scatters) against the JAX package's,
    and its injected-ops form through `local_support_ops` (anchor-roll
    deposits) against it; `gather_vec` against the JAX package's."""
    cfg = jcp.CouplingConfig(gaussian=True, stencil_shape="sphere2")
    pf, F, _ = _inputs()
    ref_sup = jcp.gaussian_support(jnp.asarray(pf[0]), jnp.asarray(pf[4]), GRID, PERIODIC, cfg)
    ref = jcp.volume_fraction_fields(jcp.ParticleFields(*map(jnp.asarray, pf)), ref_sup,
                                     GRID, cfg)
    tpf, tcfg, tgrid = tcp.ParticleFields(*map(torch.as_tensor, pf)), config_from(cfg), \
        config_from(GRID)
    sup = tcp.gaussian_support(tpf.pos, tpf.active, tgrid, PERIODIC, tcfg)
    np.testing.assert_array_equal(sup.flat_ids.numpy(), np.asarray(ref_sup.flat_ids))
    np.testing.assert_array_equal(sup.base_flat.numpy(), np.asarray(ref_sup.base_flat))
    out = tcp.volume_fraction_fields(tpf, sup, tgrid, tcfg)
    ops = tcp.local_support_ops(sup, tgrid, tcp.stencil_offsets(tcfg))
    via_ops = tcp.volume_fraction_fields_ops(tpf, sup.weights, ops, tgrid.cell_volume, tcfg)
    for i, name in enumerate(("alpha", "u_particle")):
        _close(name, out[i].numpy(), ref[i], 1e-5)
        _close(name + " (ops)", via_ops[i].numpy(), ref[i], 1e-5)
    _close("gather_vec", tcp.gather_vec(torch.as_tensor(F[0:3]), sup).numpy(),
           jcp.gather_vec(jnp.asarray(F[0:3]), ref_sup), 1e-6)


def test_gaussian_coupling_chunked_matches_jax():
    """Four particle chunks against the JAX package's scan over chunks,
    and against the port's unchunked exchange."""
    cfg = jcp.CouplingConfig(gaussian=True, lag_alpha=True, particle_chunks=4)
    ref, out = _run_both(cfg, "gaussian_coupling_chunked")
    _, whole = _run_both(dataclasses.replace(cfg, particle_chunks=1))
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    for name in FIELDS:
        _close(name, getattr(out, name).numpy(), getattr(ref, name), 1e-5)
        _close(name, getattr(out, name).numpy(), getattr(whole, name).numpy(), 1e-5)


def test_deposit_direct_scatter_route(monkeypatch):
    """Above ROLL_BUFFER_ELEM_LIMIT `deposit_stack` takes the direct
    (N*S)-row scatter, as the JAX package does; lowering the port's limit
    to 0 sends the whole exchange that way and the result still equals
    the JAX package's (which takes the anchor-roll route)."""
    cfg = jcp.CouplingConfig(gaussian=True, stencil_shape="sphere2")
    calls = []
    monkeypatch.setattr(tcp, "_deposit_anchor_rolls",
                        lambda *a: calls.append(1) or pytest.fail("anchor-roll route"))
    monkeypatch.setattr(tcp, "ROLL_BUFFER_ELEM_LIMIT", 0)
    ref, out = _run_both(cfg)
    for name in FIELDS:
        _close(name, getattr(out, name).numpy(), getattr(ref, name), 1e-5)
    assert not calls


def test_roll_distribution_size_rule(monkeypatch):
    """The roll distribution goes through the B3 wrapper only when every
    side of the grid is at least 8 (the JAX package's own rule); a smaller
    grid takes the plain roll loop on any device."""
    seen = []
    real = rolls.distribute_rolls
    monkeypatch.setattr(rolls, "distribute_rolls",
                        lambda b, o: seen.append(tuple(b.shape[2:])) or real(b, o))
    cfg = tcp.CouplingConfig(gaussian=True, stencil_shape="sphere2")
    for shape, expect in (((16, 8, 8), 2), ((16, 8, 6), 0)):
        grid = config_from(Grid.box(shape, tuple(1e-3 * n for n in shape)))
        n = 50
        rng = np.random.RandomState(3)
        pos = torch.as_tensor(rng.uniform(0.001, 0.005, (n, 3)), dtype=torch.float32)
        pf = tcp.ParticleFields(pos, torch.zeros(n, 3), torch.zeros(n, 3),
                                torch.full((n,), 4e-4), torch.ones(n, dtype=torch.bool))
        u = torch.zeros((3,) + shape)
        seen.clear()
        res = tcp.gaussian_coupling(pf, u, u, u, u, u, grid, PERIODIC, 1e-6, 1000.0, 5e-5, cfg)
        assert len(seen) == expect and all(s == shape for s in seen)
        assert float(res.alpha.min()) < 1.0


@pytest.mark.parametrize("support", ["sparse", "point_force"])
def test_anchor_rolls_padded_rows_match_jax(monkeypatch, support):
    """`_deposit_anchor_rolls` scatters into rows padded to 32 floats
    (column ncells stays the scrap bin), so every plane the roll
    distribution reads starts 128-byte aligned; the deposit still equals
    the JAX package's, for the sparse exchange's sphere2 support (C = 4)
    and the point-force exchange's trilinear corners (C = 3)."""
    pf, _, _ = _inputs(n=200, seed=6)
    pos, active = pf[0], pf[4]
    pos[:5] = -1.0                                   # outside: the scrap bin
    if support == "sparse":
        cfg = jcp.CouplingConfig(gaussian=True, stencil_shape="sphere2")
        offsets = jcp.stencil_offsets(cfg)
        ref_sup = jcp.gaussian_support(jnp.asarray(pos), jnp.asarray(active), GRID, PERIODIC,
                                       cfg)
        sup = tcp.gaussian_support(torch.as_tensor(pos), torch.as_tensor(active),
                                   config_from(GRID), PERIODIC, config_from(cfg))
        C = 4
    else:
        offsets = tcp.TRILINEAR_CORNERS
        ref_sup = jcp.trilinear_weights(jnp.asarray(pos), GRID, PERIODIC, jnp.asarray(active))
        sup = tcp.trilinear_weights(torch.as_tensor(pos), config_from(GRID), PERIODIC,
                                    torch.as_tensor(active))
        C = 3
    np.testing.assert_array_equal(sup.base_flat.numpy(), np.asarray(ref_sup.base_flat))
    values = np.random.RandomState(7).randn(200, len(offsets), C).astype(np.float32)
    ref = jcp._deposit_anchor_rolls(jnp.asarray(values), ref_sup, GRID, offsets)
    strides = []
    real = rolls.distribute_rolls
    monkeypatch.setattr(rolls, "distribute_rolls",
                        lambda b, o: strides.append(rolls._plane_stride(b, o)) or real(b, o))
    out = tcp._deposit_anchor_rolls(torch.as_tensor(values), sup, config_from(GRID), offsets)
    ncells = GRID.ncells
    assert strides == [tcp.anchor_row_length(ncells)] and strides[0] % 32 == 0
    assert ncells + 1 <= strides[0] < ncells + 33
    _close("deposit", out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("n", [8, 16])
def test_gaussian_coupling_width5_matches_jax(n, monkeypatch):
    """``stencil_width=5`` (the 125-cell cube) at 8^3 and 16^3 with
    lag_alpha off (two deposits): the deposits go through B3's wrapper
    with S = 125 (its CPU path, the plain roll loop); `found` equal, the
    fields and forces within 1e-5 of their scale as at width 3."""
    grid = Grid.cube(n, 1e-3 * n)
    rng = np.random.RandomState(n)
    pf = (rng.uniform(0.1e-3 * n, 0.9e-3 * n, (40, 3)), 1e-2 * rng.randn(40, 3),
          1e-1 * rng.randn(40, 3), np.full(40, 4e-4), np.ones(40, bool))
    pf = tuple(np.asarray(a, np.float32) if a.dtype != bool else a for a in pf)
    F = (1e-2 * rng.randn(15, *grid.shape)).astype(np.float32)
    cfg = jcp.CouplingConfig(gaussian=True, stencil_width=5)
    calls = []
    real = rolls.distribute_rolls
    monkeypatch.setattr(rolls, "distribute_rolls",
                        lambda b, o: calls.append(b.shape[0]) or real(b, o))
    ref = jcp.gaussian_coupling(jcp.ParticleFields(*map(jnp.asarray, pf)),
                                *map(jnp.asarray, F.reshape(5, 3, *grid.shape)), grid,
                                PERIODIC, 1e-6, 1000.0, 5e-5, cfg)
    out = tcp.gaussian_coupling(tcp.ParticleFields(*map(torch.as_tensor, pf)),
                                *map(torch.as_tensor, F.reshape(5, 3, *grid.shape)),
                                config_from(grid), PERIODIC, 1e-6, 1000.0, 5e-5,
                                config_from(cfg))
    assert calls == [125, 125]
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    assert int(out.found.sum()) == 40
    for name in FIELDS:
        _close(name, getattr(out, name).numpy(), getattr(ref, name), 1e-5)
