"""PyTorch port of the DEM main path against the JAX package: the Verlet
candidate list exactly (overflow counts included), the channel-major pair
forces, the wall forces and the carried-contact substep loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem

GRID = Grid.box((12, 10, 12), (0.012, 0.010, 0.012))
R = 4e-4


def _cfg(**kw):
    base = dict(params=dem.ContactParams(kn=100.0, rho_p=2500.0),
                gravity=(0.0, 0.0, -9.81), periodic=(True, True, False),
                wall_axes=(False, False, True), neighbor="cells",
                cell_capacity=4, max_neighbors=8, refined_neighbors=4,
                sorted_fetch=True, list_reuse=True, carry_contact=True,
                substep_unroll=True, pair_layout="channels")
    base.update(kw)
    return dem.DEMConfig(**base)


def _packing(n=300, pad=4, seed=0):
    """A jittered lattice at a spacing just under one diameter, so that
    neighbours overlap; wall-touching rows at both z faces."""
    rng = np.random.RandomState(seed)
    k = int(np.ceil(n ** (1 / 3)))
    step = 0.95 * 2 * R
    g = np.stack(np.meshgrid(*[np.arange(k) * step] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3)[:n] + np.array([1e-3, 1e-3, 0.9 * R])
    pos = g + rng.uniform(-0.1 * R, 0.1 * R, g.shape)
    pos = np.concatenate([pos, np.zeros((pad, 3))])
    vel = rng.randn(n + pad, 3) * 1e-2
    ang = rng.randn(n + pad, 3) * 1.0
    radius = np.full(n + pad, R)
    active = np.arange(n + pad) < n
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(pos), f32(vel), f32(ang), f32(radius), active


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(np.array(a)) for a in arrs]


def _tt(x):
    return torch.as_tensor(np.array(x))


def _close(out, ref, rtol=1e-5):
    """Relative to the array's scale: f32 sums in another order."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max() + 1e-30


@pytest.mark.parametrize("cap,M,Mr", [(4, 8, 4), (2, 6, 3), (4, 8, 0), (1, 3, 2)])
def test_build_neighbor_list_exact(cap, M, Mr):
    """Same candidates in the same slots and the same overflow count; the
    small capacities truncate bins and candidate rows, so the top_k
    tie-break and the stable sort decide who survives. With
    ``refined_neighbors`` the port refines the whole candidate row, the
    JAX package its ``max_neighbors`` largest ids: the reference is the
    JAX list built with ``max_neighbors`` 27 x ``cell_capacity``, which
    keeps the whole row."""
    cfg = _cfg(cell_capacity=cap, max_neighbors=M, refined_neighbors=Mr)
    pos, _, _, _, active = _packing()
    ref_cfg = cfg if Mr == 0 else _cfg(cell_capacity=cap, max_neighbors=27 * cap,
                                       refined_neighbors=Mr)
    ref, ref_ov = dem.build_neighbor_list(jnp.asarray(pos), jnp.asarray(active),
                                          GRID, ref_cfg, R, return_overflow=True)
    out, out_ov = tdem.build_neighbor_list(
        torch.as_tensor(pos), torch.as_tensor(active), config_from(GRID),
        config_from(cfg), R, return_overflow=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out_ov) == int(ref_ov)
    if cap < 4:
        assert int(out_ov) > 0


def test_refined_list_keeps_a_touching_pair_past_max_neighbors():
    """A 1M-particle channel's geometry in small: a jittered lattice at
    2.048 mm in hash bins of 2.03 mm (max_bins), so that every row holds
    ~26 candidates against max_neighbors 8, and one particle moved to 0.39
    mm of its +z neighbour. The JAX package keeps the 8 largest ids before
    refining, a layer over in x, and drops the moved particle from its
    neighbour's list; the port keeps the pair in both lists, and every
    pair it keeps is within reach."""
    grid = Grid.cube(16, 0.0164)
    n, sp = 8, 2.048e-3
    rng = np.random.RandomState(0)
    g = np.stack(np.meshgrid(*[np.arange(n) * sp + 2e-4] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = g + rng.uniform(-0.1 * sp, 0.1 * sp, g.shape)
    a = (3 * n + 4) * n + 3
    pos[a] = pos[a + 1] - np.array([2.4e-4, 3e-4, 5e-5])
    pos = pos.astype(np.float32)
    active = np.ones(len(pos), bool)
    cfg = _cfg(max_bins=int((0.0164 / 2.03e-3) ** 3))
    bin_size = dem.effective_bin_size(grid, cfg, R)
    assert 2.0e-3 < bin_size < 2.048e-3
    ref = np.asarray(dem.build_neighbor_list(jnp.asarray(pos), jnp.asarray(active), grid, cfg, R))
    out = tdem.build_neighbor_list(torch.as_tensor(pos), torch.as_tensor(active),
                                   config_from(grid), config_from(cfg), R).numpy()
    assert a not in ref[a + 1]
    assert a in out[a + 1] and a + 1 in out[a]
    cutoff = 2 * R + 2 * cfg.list_margin_factor * (bin_size - 2 * R)
    i, k = np.nonzero(out != len(pos))
    d = pos[i] - pos[out[i, k]]
    d[:, :2] -= 0.0164 * np.round(d[:, :2] / 0.0164)    # periodic in x and y
    assert np.linalg.norm(d, axis=-1).max() <= cutoff


def test_contact_forces_match():
    cfg = _cfg()
    arrs = _packing()
    nbr = np.asarray(dem.build_neighbor_list(jnp.asarray(arrs[0]),
                                             jnp.asarray(arrs[4]), GRID, cfg, R))
    rf, rt = dem.neighbor_contact_forces(jnp.asarray(nbr), *_j(arrs), GRID, cfg)
    of, ot = tdem.neighbor_contact_forces(_tt(nbr), *_t(arrs),
                                          config_from(GRID), config_from(cfg))
    assert np.abs(np.asarray(rf)).max() > 0
    _close(of.numpy(), rf)
    _close(ot.numpy(), rt)
    wf, wt = dem.wall_contact_forces(*_j(arrs), GRID, cfg)
    owf, owt = tdem.wall_contact_forces(*_t(arrs), config_from(GRID), config_from(cfg))
    assert np.abs(np.asarray(wf)).max() > 0
    _close(owf.numpy(), wf)
    _close(owt.numpy(), wt)


@pytest.mark.parametrize("variant", ["carried", "damped_buoyant"])
def test_dem_substeps_match(variant):
    """Four velocity-Verlet substeps on a frozen list under a hydro force:
    the bench's carried contact force, and an uncarried run with Cundall
    damping and buoyancy. The state is held at 1e-5 of its scale; the
    carried contact force at 5e-5, because the overlap r_i + r_j - |dx|
    cancels ~20x at this packing's 5% overlap and amplifies last-bit
    differences of the positions four times over."""
    cfg = _cfg() if variant == "carried" else _cfg(
        carry_contact=False, cundall_damping=0.2, buoyancy=True)
    arrs = _packing()
    rng = np.random.RandomState(7)
    hf = (rng.randn(*arrs[0].shape) * 1e-6).astype(np.float32)
    ht = np.zeros_like(hf)
    nbr = np.asarray(dem.build_neighbor_list(jnp.asarray(arrs[0]),
                                             jnp.asarray(arrs[4]), GRID, cfg, R))
    fc, tc = (np.asarray(x) for x in dem.contact_forces(
        *_j(arrs), GRID, cfg, R, nbr=jnp.asarray(nbr)))
    dt_dem = 5e-5 / 4
    ref = dem.dem_substeps(*_j(arrs), dem.DEMForces(jnp.asarray(hf), jnp.asarray(ht)),
                           GRID, cfg, jnp.float32(dt_dem), 4, R,
                           nbr=jnp.asarray(nbr), carried=(jnp.asarray(fc), jnp.asarray(tc)))
    out = tdem.dem_substeps(*_t(arrs), tdem.DEMForces(torch.as_tensor(hf), torch.as_tensor(ht)),
                            config_from(GRID), config_from(cfg),
                            torch.tensor(dt_dem, dtype=torch.float32), 4, R,
                            nbr=_tt(nbr),
                            carried=(_tt(fc), _tt(tc)))
    assert len(out) == len(ref) == (6 if cfg.carry_contact else 4)
    assert int(out[3]) == int(ref[3]) == 0
    for o, r in zip(out[:3], ref[:3]):
        _close(o.numpy(), r)
    for o, r in zip(out[4:], ref[4:]):
        _close(o.numpy(), r, rtol=5e-5)


def test_drift_since_and_config_validation():
    pos = np.random.RandomState(1).uniform(0, 0.01, (20, 3)).astype(np.float32)
    moved = pos.copy()
    moved[3, 0] += 1e-4
    moved[5, 1] = pos[5, 1] + 0.0099   # wraps on the periodic y axis
    active = np.ones(20, bool)
    ref = dem.drift_since(jnp.asarray(moved), jnp.asarray(pos), jnp.asarray(active),
                          GRID, (True, True, False))
    out = tdem.drift_since(torch.as_tensor(moved), torch.as_tensor(pos),
                           torch.as_tensor(active), config_from(GRID), (True, True, False))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="pair_layout"):
        tdem.DEMConfig(pair_layout="channel")
