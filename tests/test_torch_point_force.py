"""The port's point-force (icoFoamYade) exchange against the JAX package's
on the same seeded numpy inputs: the trilinear support exactly, and
`point_force_coupling` on wall and periodic grids, with particles at the
periodic seam, on and near the walls, outside the domain and inactive."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import rolls

GRID = Grid.box((8, 10, 12), (0.008, 0.010, 0.012))
PERIODICS = [(True, True, False), (False, False, False), (True, False, True)]


def _particles(n=200, seed=0):
    """Random interior particles, then: on the low faces, within h/4 of the
    high faces (across the periodic seam's anchor wrap), exactly on the
    high faces (outside), far outside (a parked particle), and an inactive
    one."""
    rng = np.random.RandomState(seed)
    L = np.asarray(GRID.lengths)
    h = np.asarray(GRID.spacing)
    pos = [rng.uniform(0.0, L, (n, 3)),
           [[0.0, 0.0, 0.0], [0.0, 0.5 * L[1], 0.5 * L[2]]],
           L - 0.25 * h * rng.rand(3, 3),
           [L, [L[0], 0.5 * L[1], 0.5 * L[2]]],
           [[-10 * L[0], -10 * L[0], -10 * L[0]]],
           [0.5 * L]]
    pos = np.concatenate([np.asarray(p, np.float64).reshape(-1, 3) for p in pos])
    m = len(pos)
    active = np.ones(m, bool)
    active[-1] = False
    return (pos.astype(np.float32), (1e-2 * rng.randn(m, 3)).astype(np.float32),
            (1e-1 * rng.randn(m, 3)).astype(np.float32),
            rng.uniform(5e-5, 2e-4, m).astype(np.float32), active)


@pytest.mark.parametrize("periodic", PERIODICS)
def test_trilinear_support_exact(periodic):
    """Corner cells, raw weights, the in-domain mask, flat ids, anchors and
    normalised weights equal the JAX package's bit for bit."""
    pos, _, _, _, active = _particles()
    rc, rw, rv = jcp.trilinear_cells_raw_weights(jnp.asarray(pos), jnp.asarray(active), GRID)
    tpos, tact, tgrid = torch.as_tensor(pos), torch.as_tensor(active), config_from(GRID)
    oc, ow, ov = tcp.trilinear_cells_raw_weights(tpos, tact, tgrid)
    for a in range(3):
        np.testing.assert_array_equal(oc[a].numpy(), np.asarray(rc[a]))
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    ref = jcp.trilinear_weights(jnp.asarray(pos), GRID, periodic, jnp.asarray(active))
    out = tcp.trilinear_weights(tpos, tgrid, periodic, tact)
    for name in ("flat_ids", "weights", "valid", "base_flat"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # the far-away, on-the-high-face and inactive particles have no support
    assert not out.valid[-4:].any() and float(out.weights[-4:].abs().sum()) == 0.0


@pytest.mark.parametrize("periodic", PERIODICS)
def test_point_force_coupling_matches_jax(periodic, monkeypatch):
    """`found` equal; force, torque and u_source within 1e-5 of their scale;
    the deposit goes through the B3 wrapper with the 8 corners and 3
    channels; a particle outside the domain gets no force."""
    pf = _particles(seed=1)
    rng = np.random.RandomState(2)
    u = (1e-2 * rng.randn(3, *GRID.shape)).astype(np.float32)
    curl = (1e-1 * rng.randn(3, *GRID.shape)).astype(np.float32)
    cfg = jcp.CouplingConfig(gaussian=False)
    ref = jcp.point_force_coupling(jcp.ParticleFields(*map(jnp.asarray, pf)), jnp.asarray(u),
                                   jnp.asarray(curl), GRID, periodic, 1e-6, 1000.0, cfg)
    seen = []
    real = rolls.distribute_rolls
    monkeypatch.setattr(rolls, "distribute_rolls",
                        lambda b, o: seen.append((tuple(b.shape), o.tolist())) or real(b, o))
    out = tcp.point_force_coupling(tcp.ParticleFields(*map(torch.as_tensor, pf)),
                                   torch.as_tensor(u), torch.as_tensor(curl),
                                   config_from(GRID), periodic, 1e-6, 1000.0)
    assert seen == [((8, 3) + GRID.shape, tcp.TRILINEAR_CORNERS.tolist())]
    np.testing.assert_array_equal(out.found.numpy(), np.asarray(ref.found))
    assert not bool(out.found[-4:].any()) and int(out.found.sum()) >= 200
    assert float(out.force[-4:].abs().sum()) == 0.0
    for name in ("force", "torque", "u_source"):
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert o.shape == r.shape and np.abs(r).max() > 0
        assert np.abs(o - r).max() <= 1e-5 * np.abs(r).max(), name
    for name in ("alpha", "u_particle", "u_source_drag"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
