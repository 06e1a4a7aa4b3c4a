"""The fused DEM substep's wrappers (`ops/dem_fused.py`) on the CPU: the
plain versions of `pack_drift` and `substep`, chained over 4 substeps,
against `dem.dem_substeps`' carried-contact loop, torch.equal, on a 16^3
channel cloud (periodic x and y, walls on z) with touching pairs, pairs
across the periodic seams, wall contacts on both z faces, wraps across x
and y, inactive particles and empty list slots, with buoyancy and Cundall
damping on and off; the route predicate; the refusals. No jax."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.ops import dem
from yade_openfoam_coupling_tpu_torch.ops import dem_fused as df
from yade_openfoam_coupling_tpu_torch.ops.grid import Grid

GRID = Grid.cube(16, 0.016)
R = 4e-4
CFG = dem.DEMConfig(
    params=dem.ContactParams(kn=100.0, kt_over_kn=0.5, restitution=0.5, friction=0.5,
                             rho_p=2500.0),
    neighbor="cells", cell_capacity=4, max_neighbors=8, list_reuse=True, carry_contact=True,
    refined_neighbors=4, wall_axes=(False, False, True), periodic=(True, True, False))
N_SUB = 4


def _cloud(seed=0):
    """A jittered lattice (12^3 sites 1 mm apart, 2-13 mm on each axis)
    with partners pushed into contact: 40 closing pairs inside, 6 across
    the x seam and 6 across the y seam, 8 particles in contact with each z
    wall, 8 about to wrap across x and y; 12 inactive, 2 of them in a
    touching pair. -> (pos, vel, angvel, radius, active) on the CPU."""
    rng = np.random.RandomState(seed)
    L = GRID.lengths[0]
    k = 12
    sites = np.stack(np.meshgrid(*[(np.arange(k) + 2) * 1e-3] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    sites += rng.uniform(-5e-5, 5e-5, sites.shape)
    pos, vel = [sites], [0.02 * rng.randn(*sites.shape)]
    # closing pairs: partners 2r - 20 um away along a random direction
    idx = rng.choice(len(sites), 40, replace=False)
    d = rng.randn(40, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos.append(sites[idx] + (2 * R - 2e-5) * d)
    vel.append(vel[0][idx] - 0.05 * d)
    # across the seams: one just inside x = 0 (y = 0), its partner just below L
    for axis in (0, 1):
        p = rng.uniform(4e-3, 12e-3, (6, 3))
        q = p.copy()
        p[:, axis] = rng.uniform(1e-5, 2e-4, 6)
        q[:, axis] = p[:, axis] + L - (2 * R - 3e-5)
        pos += [p, q]
        vel += [0.01 * rng.randn(6, 3), 0.01 * rng.randn(6, 3)]
    # on the z walls, overlapping by 10-40 um, moving into the wall
    for z, vz in ((R - 2e-5, -0.05), (L - R + 2e-5, 0.05)):
        p = rng.uniform(2e-3, 14e-3, (8, 3))
        p[:, 2] = z + rng.uniform(-1e-5, 1e-5, 8)
        v = 0.01 * rng.randn(8, 3)
        v[:, 2] = vz
        pos.append(p)
        vel.append(v)
    # about to wrap: within 2 um of a periodic face, moving out of the box
    p = rng.uniform(2e-3, 14e-3, (8, 3))
    v = 0.01 * rng.randn(8, 3)
    for r in range(8):
        axis, hi = r % 2, r // 4
        p[r, axis] = L - 1e-6 if hi else 1e-6
        v[r, axis] = 0.08 if hi else -0.08
    pos.append(p)
    vel.append(v)
    pos = np.concatenate(pos).astype(np.float32)
    vel = np.concatenate(vel).astype(np.float32)
    n = len(pos)
    ang = (20.0 * rng.randn(n, 3)).astype(np.float32)
    active = np.ones(n, bool)
    active[rng.choice(len(sites), 10, replace=False)] = False
    active[len(sites) + np.array([3, 17])] = False          # partners of closing pairs
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    return t(pos), t(vel), t(ang), torch.full((n,), R), t(active)


def _inputs(cfg, seed=0):
    pos, vel, ang, radius, active = _cloud(seed)
    n = pos.shape[0]
    nbr = dem.build_neighbor_list(pos, active, GRID, cfg, R)
    gen = torch.Generator().manual_seed(seed)
    # the exchange's (N, 3) view of its (N, 4) result, and a plain torque
    hydro = dem.DEMForces(1e-6 * torch.randn((n, 4), generator=gen)[:, :3],
                          1e-10 * torch.randn((n, 3), generator=gen))
    carried = dem.contact_forces(pos, vel, ang, radius, active, GRID, cfg, R, nbr)
    return pos, vel, ang, radius, active, nbr, hydro, carried


def _chained(pos, vel, ang, radius, active, nbr, hydro, carried, cfg, dt, plain):
    pd, sub = (df.pack_drift_plain, df.substep_plain) if plain else (df.pack_drift, df.substep)
    rec = pd(pos, vel, ang, radius, active, carried, hydro, GRID, cfg, dt)
    for _ in range(N_SUB - 1):
        rec = sub(rec, nbr, hydro, GRID, cfg, dt)
    return sub(rec, nbr, hydro, GRID, cfg, dt, last=True)


CASES = {"plain physics": {}, "buoyancy": {"buoyancy": True},
         "damping": {"cundall_damping": 0.3},
         "buoyancy and damping": {"buoyancy": True, "cundall_damping": 0.3}}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_chained_equal_the_carried_loop(case):
    """pack_drift + 3 substeps + the last one (the plain versions, and the
    wrappers on CPU tensors, which run them and launch nothing) equal
    dem_substeps' carried-contact loop bit for bit, with every mechanism
    the cloud holds at work."""
    cfg = dataclasses.replace(CFG, **CASES[case])
    pos, vel, ang, radius, active, nbr, hydro, carried = _inputs(cfg)
    dt = torch.tensor(2e-4 / N_SUB, dtype=torch.float32)
    ref = dem.dem_substeps(pos, vel, ang, radius, active, hydro, GRID, cfg, dt, N_SUB, R,
                           nbr=nbr, carried=carried)
    ref = ref[:3] + ref[4:]
    before = LAUNCHES["yofc_dem_pack_drift"] + LAUNCHES["yofc_dem_substep"]
    for plain in (True, False):
        out = _chained(pos, vel, ang, radius, active, nbr, hydro, carried, cfg, dt, plain)
        for name, a, b in zip(("pos", "vel", "angvel", "fc", "tc"), out, ref):
            assert torch.equal(a, b), (case, plain, name)
    assert LAUNCHES["yofc_dem_pack_drift"] + LAUNCHES["yofc_dem_substep"] == before
    # the cloud holds what the case is about: touching pairs (also across
    # the seams), both z walls (in the first evaluation: the wall pairs
    # bounce off within the call), wraps, inactive particles, empty slots
    n = pos.shape[0]
    fc = carried[0]
    assert int((nbr == n).sum()) > 0 and not bool(active.all())
    L = GRID.lengths[0]
    assert bool(((pos[:, :2] - L / 2).abs().amax(1) > L / 2 - 2e-6).any())
    wrapped = ((ref[0][:, :2] - pos[:, :2]).abs() > L / 2).any(1)
    assert int(wrapped.sum()) >= 6
    lo, hi = pos[:, 2] < R, pos[:, 2] > L - R
    assert bool((fc[lo, 2] > 0).all()) and bool((fc[hi, 2] < 0).all())
    assert int((fc.abs().sum(1)[~(lo | hi)] > 0).sum()) > 60
    assert bool((fc[~active] == 0).all())


def test_substeps_runs_the_plain_versions_on_the_cpu():
    """`dem_fused.substeps` (the kernel route's driver) on CPU tensors,
    with the carried force given and without, equals dem_substeps, a float
    dt as a 0-d tensor; n_overflow is 0."""
    pos, vel, ang, radius, active, nbr, hydro, carried = _inputs(CFG, seed=1)
    dt = 5e-5
    for c in (carried, None):
        ref = dem.dem_substeps(pos, vel, ang, radius, active, hydro, GRID, CFG,
                               torch.tensor(dt, dtype=torch.float32), N_SUB, R, nbr=nbr,
                               carried=c)
        out = df.substeps(pos, vel, ang, radius, active, hydro, GRID, CFG, dt, N_SUB, R, nbr,
                          c)
        assert int(out[3]) == 0 and out[3].dtype == torch.int32
        for a, b in zip(out[:3] + out[4:], ref[:3] + ref[4:]):
            assert torch.equal(a, b)


def _like(device_type="cuda", dtype=torch.float32):
    return types.SimpleNamespace(device=types.SimpleNamespace(type=device_type), dtype=dtype)


def test_route():
    """The kernels take a float32 state on a card with a list of at most
    MAX_NEIGHBORS slots, carried contact in substep mode, no springs, no dt
    sequence and at least one substep; every other call stays plain."""
    nbr = torch.zeros((8, 4), dtype=torch.int32)
    assert df.on_route(_like(), CFG, 4, nbr)
    assert df.on_route(_like(), CFG, 1, torch.zeros((8, df.MAX_NEIGHBORS), dtype=torch.int32))
    plain = {
        "cpu": (_like("cpu"), CFG, 4, nbr, None),
        "float64": (_like(dtype=torch.float64), CFG, 4, nbr, None),
        "no list (all pairs, cell lists)": (_like(), CFG, 4, None, None),
        "a long row": (_like(), CFG, 4,
                       torch.zeros((8, df.MAX_NEIGHBORS + 1), dtype=torch.int32), None),
        "contact_mode step": (_like(), dataclasses.replace(CFG, contact_mode="step"), 4, nbr,
                              None),
        "no carried contact": (_like(), dataclasses.replace(CFG, carry_contact=False), 4, nbr,
                               None),
        "shear history": (_like(), dataclasses.replace(CFG, shear_history=True), 4, nbr,
                          None),
        "dynamic substeps": (_like(), CFG, 4, nbr, torch.zeros(4)),
        "no substep": (_like(), CFG, 0, nbr, None),
    }
    for name, args in plain.items():
        assert not df.on_route(*args), name


def test_params_are_pytorchs_float32_constants():
    """The host parameters: flags and strides, and each constant the
    float32 of the Python number PyTorch applies (products in double)."""
    cfg = dataclasses.replace(CFG, buoyancy=True, cundall_damping=0.25)
    ip, fp = df._params(GRID, cfg, 100, 4, 4, 3)
    assert ip.tolist() == [100, 4, 1, 1, 0, 0, 0, 1, 1, 1, 4, 3]
    p = cfg.params
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert fp[15] == f32(p.rho_p * (4.0 / 3.0) * np.pi)
    assert fp[16] == f32((4.0 / 3.0) * np.pi)
    assert fp[19] == f32(dem.damping_factor(p.restitution))
    assert fp[20] == f32(p.kt_over_kn * p.kn)
    assert fp[12] == f32(1.0 / GRID.lengths[0]) and fp[22] == f32(0.25)
    assert not ip.flags.writeable and not fp.flags.writeable
    r = torch.full((3,), R)
    assert torch.equal(dem._normal_damping(p.kn, r, p.restitution),
                       2.0 * float(-np.log(0.5) / np.sqrt(np.pi ** 2 + np.log(0.5) ** 2))
                       * torch.sqrt(p.kn * r))


def test_wrappers_refuse_what_they_do_not_take():
    pos, vel, ang, radius, active, nbr, hydro, carried = _inputs(CFG)
    dt = torch.tensor(5e-5)
    rec = df.pack_drift(pos, vel, ang, radius, active, carried, hydro, GRID, CFG, dt)
    with pytest.raises(ValueError, match="pos must be"):
        df.pack_drift(pos.double(), vel, ang, radius, active, carried, hydro, GRID, CFG, dt)
    with pytest.raises(ValueError, match="active must be"):
        df.pack_drift(pos, vel, ang, radius, active.float(), carried, hydro, GRID, CFG, dt)
    with pytest.raises(ValueError, match="hydro force must be"):
        df.pack_drift(pos, vel, ang, radius, active, carried,
                      hydro._replace(force=hydro.force.T.contiguous().T), GRID, CFG, dt)
    with pytest.raises(ValueError, match="records must be"):
        df.substep(rec[:, :8], nbr, hydro, GRID, CFG, dt)
    with pytest.raises(ValueError, match="nbr must be"):
        df.substep(rec, nbr.long(), hydro, GRID, CFG, dt)
    with pytest.raises(ValueError, match="1 <= K"):
        df.substep(rec, torch.zeros((nbr.shape[0], 33), dtype=torch.int32), hydro, GRID, CFG,
                   dt)
    with pytest.raises(ValueError, match="dt must be"):
        df.substep(rec, nbr, hydro, GRID, CFG, dt.double())
    with pytest.raises(ValueError, match="unsupported device"):
        df.substep(rec.to("meta"), nbr, hydro, GRID, CFG, dt)
