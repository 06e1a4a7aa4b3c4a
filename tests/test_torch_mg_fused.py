"""The fused Jacobi V-cycle's wrappers (`ops/mg_fused.py`) on the CPU: each
plain version against the V-cycle's own operations bit for bit, the whole
`make_mg_preconditioner` V-cycle against the one before the kernels came
(a copy below), the route each configuration takes, the host parameters
and what the wrappers refuse. The kernels themselves run in
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.ops import mg_fused as mg
from yade_openfoam_coupling_tpu_torch.ops import pressure as pr
from yade_openfoam_coupling_tpu_torch.ops.grid import (
    DIRICHLET,
    NEUMANN,
    PERIODIC,
    SLIP,
    FaceBC,
    FieldBC,
    Grid,
)

P = FaceBC(PERIODIC)
BCS = {
    "periodic": FieldBC.periodic(),
    "zero_gradient": FieldBC.box(NEUMANN),
    "dirichlet": FieldBC.box(DIRICHLET),
    "channel": FieldBC(((P, P), (P, P), (FaceBC(NEUMANN), FaceBC(NEUMANN)))),
}
OMEGA = 0.8
MG_ENTRIES = ("yofc_mg_jacobi", "yofc_mg_residual_restrict", "yofc_mg_coarse")


def _level(shape, bc, seed=0):
    grid = Grid.box(shape, tuple(1e-3 * (1 + 0.25 * a) * n for a, n in enumerate(shape)))
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    gamma_f = tuple(torch.as_tensor((0.5 + rng.rand(*s)).astype(np.float32))
                    for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)))
    return mg.MGLevel(gamma_f, grid, bc, pr.inverse_diag(gamma_f, grid, bc))


def _field(shape, seed):
    return torch.as_tensor(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _old_apply(level, v):
    return pr.poisson_apply(v, level.gamma_f, level.grid, pr.default_pad(level.bc))


def _old_inv_diag(level):
    d = pr.poisson_diag(level.gamma_f, level.grid, level.bc)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, -1.0, d)


def _old_sweeps(level, x, b, iters):
    for _ in range(iters):
        r = b - _old_apply(level, x)
        x = x + OMEGA * _old_inv_diag(level) * r
    return x


def _old_restrict(f):
    nx, ny, nz = f.shape
    return f.reshape(nx // 2, 2, ny // 2, 2, nz // 2, 2).mean(dim=(1, 3, 5))


def _old_prolong(c):
    nx, ny, nz = c.shape
    return c[:, None, :, None, :, None].expand(nx, 2, ny, 2, nz, 2).reshape(
        2 * nx, 2 * ny, 2 * nz)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 12, 10)])
@pytest.mark.parametrize("bc", list(BCS))
def test_plain_versions_are_the_vcycles_operations(bc, shape):
    """Each plain version equals the V-cycle's operations, torch.equal: a
    sweep from x, from zero and with the coarse correction added first;
    the restricted residual from x and from zero; the coarse level's
    sweeps from zero; and the inverse diagonal."""
    level = _level(shape, BCS[bc])
    x, b = _field(shape, 1), _field(shape, 2)
    ec = _field(tuple(n // 2 for n in shape), 3)
    zero = torch.zeros(shape)
    assert torch.equal(level.inv_diag, _old_inv_diag(level))
    assert torch.equal(mg.jacobi_plain(level, x, b, OMEGA), _old_sweeps(level, x, b, 1))
    assert torch.equal(mg.jacobi_plain(level, None, b, OMEGA), _old_sweeps(level, zero, b, 1))
    assert torch.equal(mg.jacobi_plain(level, x, b, OMEGA, ec),
                       _old_sweeps(level, x + _old_prolong(ec), b, 1))
    assert torch.equal(mg.residual_restrict_plain(level, x, b),
                       _old_restrict(b - _old_apply(level, x)))
    assert torch.equal(mg.residual_restrict_plain(level, None, b),
                       _old_restrict(b - _old_apply(level, zero)))
    assert torch.equal(mg.coarse_plain(level, b, 6, OMEGA),
                       _old_sweeps(level, _old_sweeps(level, zero, b, 2), b, 4))


def _old_vcycle(gamma_f, grid, bc, cfg):
    """`make_mg_preconditioner`'s Jacobi V-cycle as it was before the
    fused kernels, its operations in their order."""
    levels = cfg.levels if cfg.levels > 0 else pr.mg_levels_for(grid)
    gammas, grids = [gamma_f], [grid]
    for _ in range(levels - 1):
        gammas.append(pr._coarsen_gamma_faces(gammas[-1]))
        grids.append(pr._coarsen_grid(grids[-1]))
    lv_ = [mg.MGLevel(g, gr, bc) for g, gr in zip(gammas, grids)]

    def smooth(lv, x, b, iters):
        for _ in range(iters):
            r = b - _old_apply(lv_[lv], x)
            x = x + cfg.omega * _old_inv_diag(lv_[lv]) * r
        return x

    def vcycle(lv, b):
        x = smooth(lv, torch.zeros_like(b), b, cfg.pre_smooth)
        if lv == levels - 1:
            return smooth(lv, x, b, cfg.coarse_iters)
        r = b - _old_apply(lv_[lv], x)
        x = x + _old_prolong(vcycle(lv + 1, _old_restrict(r)))
        return smooth(lv, x, b, cfg.post_smooth)

    return lambda r: vcycle(0, r)


@pytest.mark.parametrize("cfg", [
    pr.MGConfig(pre_smooth=4, post_smooth=4),
    pr.MGConfig(),
    pr.MGConfig(pre_smooth=0, post_smooth=0, coarse_iters=3),
    pr.MGConfig(levels=1, coarse_iters=2),
], ids=["bench_1m", "default", "no_smoothing", "one_level"])
@pytest.mark.parametrize("bc", list(BCS))
def test_whole_vcycle_is_unchanged_on_cpu(bc, cfg):
    """A whole V-cycle through the wrappers (3 levels at 16^3: 16, 8 and the
    4^3 coarse level; one level of 32 x 16 x 16, past the coarse kernel's
    size, by single sweeps) equals the V-cycle before the kernels,
    torch.equal, for every BC set."""
    shape = (32, 16, 16) if cfg.levels == 1 else (16, 16, 16)
    level = _level(shape, BCS[bc], seed=4)
    r = _field(shape, 5)
    new = pr.make_mg_preconditioner(level.gamma_f, level.grid, level.bc, cfg)(r)
    old = _old_vcycle(level.gamma_f, level.grid, level.bc, cfg)(r)
    assert torch.equal(new, old)


def _count_calls(monkeypatch):
    """Record each wrapper call's (name, level side); -> (the calls, the
    three wrappers' launches so far)."""
    calls, reals = [], [mg.jacobi, mg.residual_restrict, mg.coarse]
    for real in reals:
        monkeypatch.setattr(mg, real.__name__, lambda lv, *a, _f=real, **kw:
                            calls.append((_f.__name__, lv.grid.shape[0])) or _f(lv, *a, **kw))
    return calls, lambda: sum(LAUNCHES[k] for k in MG_ENTRIES)


@pytest.mark.parametrize("route", ["f32_jacobi", "f64", "bf16", "chebyshev", "inhomogeneous"])
def test_route(route, monkeypatch):
    """The float32 Jacobi V-cycle under homogeneous BCs takes the wrappers:
    per V-cycle pre + post sweeps and one residual-restrict on each level
    above the coarsest and one coarse call (the card's launches, 9 x 6 + 1 =
    55 at 256^3 with 4 + 4 sweeps); float64, bf16, Chebyshev and
    inhomogeneous BCs keep the plain route; CPU tensors count no launch."""
    calls, launches = _count_calls(monkeypatch)
    bc = BCS["channel"] if route != "inhomogeneous" else FieldBC.box(DIRICHLET, 1.0)
    level = _level((16, 16, 16), bc, seed=6)
    dtype = torch.float64 if route == "f64" else torch.float32
    cfg = pr.MGConfig(pre_smooth=4, post_smooth=4, bf16=route == "bf16",
                      smoother="chebyshev" if route == "chebyshev" else "jacobi")
    before = launches()
    out = pr.make_mg_preconditioner(tuple(g.to(dtype) for g in level.gamma_f), level.grid, bc,
                                    cfg)(_field((16, 16, 16), 7).to(dtype))
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert launches() == before
    if route != "f32_jacobi":
        assert calls == []
        return
    assert sorted(set(calls)) == [("coarse", 4), ("jacobi", 8), ("jacobi", 16),
                                  ("residual_restrict", 8), ("residual_restrict", 16)]
    assert len(calls) == 9 * 2 + 1


def test_params():
    """The host parameters: the shape, each face's ghost rule (0 periodic,
    1 repeat: zero-gradient and a scalar's slip, 2 negate: Dirichlet) and
    `poisson_diag` factor (1, 0 zero-gradient, 2 Dirichlet, 1 slip), 1/h and
    1/h^2 taken in double and rounded to float32, as PyTorch's CUDA
    division by a Python float takes them, omega, the coarse sweeps; an
    inhomogeneous Dirichlet face is refused."""
    bc = FieldBC(((P, FaceBC(NEUMANN)), (FaceBC(SLIP), FaceBC(DIRICHLET)),
                  (FaceBC(DIRICHLET), FaceBC(NEUMANN))))
    h = (0.001, 0.00125, 0.0015)
    ip, fp = mg._params((8, 10, 12), h, bc, 0.8, 24)
    assert ip.tolist() == [8, 10, 12, 0, 1, 1, 2, 2, 1, 24]
    assert fp.tolist() == [*(np.float32(1.0 / v) for v in h), *(np.float32(1.0 / v ** 2)
                                                                for v in h),
                           1.0, 0.0, 1.0, 2.0, 2.0, 0.0, np.float32(0.8)]
    assert fp[0] == np.float32(1000.0) != np.float32(1) / np.float32(0.001)
    assert not ip.flags.writeable and not fp.flags.writeable
    with pytest.raises(ValueError, match="homogeneous"):
        mg._params((8, 8, 8), h, FieldBC.box(DIRICHLET, 0.5), 0.8, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A device other than the CPU or CUDA, float64, a wrong shape, a
    non-contiguous face array, an odd side under restriction, and a plain
    call without the inverse diagonal are refused; on the CPU each wrapper
    is its plain version."""
    level = _level((8, 8, 8), BCS["channel"])
    b, x = _field((8, 8, 8), 1), _field((8, 8, 8), 2)
    ec = _field((4, 4, 4), 3)
    assert torch.equal(mg.jacobi(level, x, b, OMEGA, ec=ec),
                       mg.jacobi_plain(level, x, b, OMEGA, ec))
    assert torch.equal(mg.residual_restrict(level, x, b), mg.residual_restrict_plain(level, x, b))
    assert torch.equal(mg.coarse(level, b, 3, OMEGA), mg.coarse_plain(level, b, 3, OMEGA))
    with pytest.raises(ValueError, match="unsupported device"):
        mg.jacobi(level, None, b.to("meta"), OMEGA)
    with pytest.raises(ValueError, match="b must be a contiguous float32"):
        mg.jacobi(level, None, b.double(), OMEGA)
    with pytest.raises(ValueError, match="x must be"):
        mg.residual_restrict(level, x[:, :, :4], b)
    with pytest.raises(ValueError, match="ec must be"):
        mg.jacobi(level, x, b, OMEGA, ec=ec[:2])
    with pytest.raises(ValueError, match="gamma_y"):
        mg.coarse(level._replace(gamma_f=(level.gamma_f[0], level.gamma_f[1].transpose(0, 2)
                                          .contiguous().transpose(0, 2), level.gamma_f[2])),
                  b, 2, OMEGA)
    odd = _level((9, 8, 8), BCS["channel"])
    with pytest.raises(ValueError, match="even sides"):
        mg.residual_restrict(odd, None, _field((9, 8, 8), 4))
    with pytest.raises(ValueError, match="inv_diag"):
        mg.jacobi(level._replace(inv_diag=None), x, b, OMEGA)


def test_solve_pressure_is_unchanged_on_cpu(monkeypatch):
    """`solve_pressure` with mgpcg on the 1M configuration's V-cycle (4 + 4
    sweeps) at 16^3 under the channel's BCs: the same iterations and x, bit
    for bit, as with the V-cycle before the kernels."""
    level = _level((16, 16, 16), BCS["channel"], seed=8)
    rhs = _field((16, 16, 16), 9)
    cfg = pr.PressureSolverConfig(solver="mgpcg", tol=1e-5, maxiter=40,
                                  mg=pr.MGConfig(pre_smooth=4, post_smooth=4))
    args = (level.gamma_f, rhs, torch.zeros(16, 16, 16), level.grid, level.bc, cfg)
    new = pr.solve_pressure(*args)
    monkeypatch.setattr(pr, "make_mg_preconditioner",
                        lambda g, gr, bc, c, use_pallas=False: _old_vcycle(g, gr, bc, c))
    old = pr.solve_pressure(*args)
    assert int(new.iters) == int(old.iters) > 2
    assert torch.equal(new.x, old.x)


def test_mgconfig_fields_are_the_jax_packages():
    """MGConfig keeps its fields (no knob added for the kernels)."""
    assert [f.name for f in dataclasses.fields(pr.MGConfig)] == [
        "levels", "pre_smooth", "post_smooth", "coarse_iters", "omega", "smoother",
        "cheby_frac", "bf16"]
