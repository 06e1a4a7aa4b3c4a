"""The port's slab-sharding context on gloo CPU ranks: halo pads, ring
transport, reductions, the lo-face layout, and the launcher's failure
handling. Each pad of a rank's slab must equal the single-device pad of
the global field over that slab, bit for bit, ghosts included (the JAX
package's `test_halo_pad_matches_bc_pad`, at 2 and 4 ranks)."""

import inspect

import numpy as np
import pytest
import torch

from torch_sharding_ranks import BC_KINDS, fail_on_rank_one, field_bc, hang_on_rank_one, \
    pads_and_reductions
from yade_openfoam_coupling_tpu_torch.ops.grid import PERIODIC, pad_axis, pad_scalar, \
    pad_vector
from yade_openfoam_coupling_tpu_torch.parallel import launch
from yade_openfoam_coupling_tpu_torch.parallel.ctx import _bc_ghost
from yade_openfoam_coupling_tpu_torch.parallel.mesh import RankFailed

NX, NY, NZ = 8, 5, 6
RANKS = (2, 4)


def _inputs():
    rng = np.random.RandomState(0)
    f = rng.standard_normal((NX, NY, NZ)).astype(np.float32)
    u = rng.standard_normal((3, NX, NY, NZ)).astype(np.float32)
    phi = (rng.standard_normal((NX + 1, NY, NZ)).astype(np.float32),
           rng.standard_normal((NX, NY + 1, NZ)).astype(np.float32),
           rng.standard_normal((NX, NY, NZ + 1)).astype(np.float32))
    return f, u, phi


@pytest.fixture(scope="module")
def runs():
    f, u, phi = _inputs()
    return {n: launch(pads_and_reductions, n, "gloo", "cpu", (f, u, phi), timeout=60)
            for n in RANKS}


def _pad2(f: torch.Tensor, bc):
    """Single-device depth-2 x pad: the ring's two planes when periodic,
    else the BC ghost twice; then the one-cell y/z shell."""
    lo, hi = bc.faces[0]
    if lo.kind == PERIODIC:
        g_lo, g_hi = f[-2:], f[:2]
    else:
        g_lo = torch.cat([_bc_ghost(lo, f[:1], None, 0)] * 2)
        g_hi = torch.cat([_bc_ghost(hi, f[-1:], None, 0)] * 2)
    f = torch.cat([g_lo, f, g_hi])
    for axis in (1, 2):
        f = pad_axis(f, axis, *bc.faces[axis])
    return f


@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("kind", BC_KINDS)
@pytest.mark.parametrize("pad", ["pad_s", "pad_v", "pad_s_x2"])
def test_halo_pad_matches_single_device_pad(runs, n_ranks, kind, pad):
    f, u, _ = (torch.as_tensor(a) if not isinstance(a, tuple) else a for a in _inputs())
    bc = field_bc(kind)
    n = NX // n_ranks
    if pad == "pad_s":
        ref, depth, lead = pad_scalar(f, bc), 1, ()
    elif pad == "pad_v":
        ref, depth, lead = pad_vector(u, bc), 1, (slice(None),)
    else:
        ref, depth, lead = _pad2(f, bc), 2, ()
    for r, out in enumerate(runs[n_ranks]):
        want = ref[lead + (slice(r * n, r * n + n + 2 * depth),)].numpy()
        np.testing.assert_array_equal(out[pad, kind], want)


@pytest.mark.parametrize("n_ranks", RANKS)
def test_reductions(runs, n_ranks):
    f, _, _ = _inputs()
    xs = np.array([[1.5 * r - 2.0, 0.25 * r * r] for r in range(n_ranks)], np.float32)
    for out in runs[n_ranks]:
        np.testing.assert_allclose(out["sum"], xs.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(out["max"], xs.max(0))
        np.testing.assert_array_equal(out["min"], xs.min(0))
        np.testing.assert_allclose(out["mean_of_sum"], f.mean(), rtol=1e-5, atol=1e-6)
        assert int(out["sum_int"]) == n_ranks * (n_ranks + 1) // 2
        assert float(out["sum_float"]) == 0.5 * n_ranks
    # bit-identical on every rank: host branches on them agree
    for key in ("sum", "max", "min", "mean_of_sum"):
        for out in runs[n_ranks][1:]:
            np.testing.assert_array_equal(out[key], runs[n_ranks][0][key])


@pytest.mark.parametrize("n_ranks", RANKS)
def test_lo_face_round_trip(runs, n_ranks):
    """lo_to_faces_local rebuilds each rank's (n_loc+1)-face tuple, the top
    x plane from the next rank (the carried plane on the last), and
    faces_to_lo_local returns the rank's lo faces and the global top
    planes on every rank."""
    _, _, phi = _inputs()
    n = NX // n_ranks
    for r, out in enumerate(runs[n_ranks]):
        np.testing.assert_array_equal(out["faces"][0], phi[0][r * n:r * n + n + 1])
        np.testing.assert_array_equal(out["faces"][1], phi[1][r * n:r * n + n])
        np.testing.assert_array_equal(out["faces"][2], phi[2][r * n:r * n + n])
        lo, hi = out["lo_back"]
        np.testing.assert_array_equal(lo[0], phi[0][r * n:r * n + n])
        np.testing.assert_array_equal(hi[0], phi[0][-1:])
        np.testing.assert_array_equal(hi[1], phi[1][r * n:r * n + n, -1:])
        np.testing.assert_array_equal(hi[2], phi[2][r * n:r * n + n, :, -1:])


@pytest.mark.parametrize("n_ranks", RANKS)
def test_ring_messages_do_not_swap(runs, n_ranks):
    """At 2 ranks both neighbours are one rank: the message sent forward
    must arrive as from_left and the one sent backward as from_right."""
    for r, out in enumerate(runs[n_ranks]):
        left, right = (r - 1) % n_ranks, (r + 1) % n_ranks
        np.testing.assert_array_equal(out["from_left"][0], np.full(3, 10.0 * left + 1.0))
        np.testing.assert_array_equal(out["from_left"][1], np.arange(5.0) + 100 * left)
        np.testing.assert_array_equal(out["from_right"][0], np.full(3, 10.0 * right + 2.0))
        np.testing.assert_array_equal(out["from_right"][1], -np.arange(5.0) - 100 * right)


def test_failing_rank_stops_the_launch_with_its_traceback():
    with pytest.raises(RankFailed, match="rank one fails on purpose"):
        launch(fail_on_rank_one, 2, "gloo", "cpu", timeout=30)


def test_hung_rank_stops_the_launch_at_its_deadline():
    with pytest.raises(RankFailed, match=r"still running|exited"):
        launch(hang_on_rank_one, 2, "gloo", "cpu", timeout=10, deadline=15)


def test_launch_defaults_to_the_card():
    """Like `make_mesh`, `launch` puts its ranks on the cards over NCCL unless
    the caller asks for gloo on the CPU, as every test here does."""
    params = inspect.signature(launch).parameters
    assert (params["backend"].default, params["device"].default) == ("nccl", "cuda")
