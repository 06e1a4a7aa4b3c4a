"""Matrix-free pressure solvers (port of `yade_openfoam_coupling_tpu/ops/pressure.py`):
the variable-coefficient Poisson operator, preconditioned CG with the JAX
package's convergence, breakdown and divergence tests, and its three
preconditioners: Jacobi (``"pcg"``), the geometric multigrid V-cycle with a
Jacobi or Chebyshev smoother (``"mgpcg"``, OpenFOAM's GAMG), and the
spectral one (``"fftpcg"``, the exact inverse of the mean-coefficient
operator as six dense transform products, with the V-cycle where the BCs
have no trigonometric basis).

Under ``use_pallas`` every matvec on a grid whose sides are all at least 8
runs the fused kernel B2 (`fused_stencil.laplacian_facegamma_fused`), as
the JAX package runs its Pallas kernel there; smaller grids take the plain
stencil (B2 also takes bfloat16, for the V-cycle under ``MGConfig.bf16``).
CG's data-dependent exit is a host-side loop: the residual test reads one
scalar per iteration (one device sync, in a ``yofc:sync.cg_exit`` span).
With ``fixed_iters`` CG runs exactly that many iterations, the state
frozen once converged, and reads nothing on the host. `solve_pressure`
takes the masked-cell obstacles (``solid=``); `solve_helmholtz` solves
the implicit momentum-diffusion systems.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import annotate, host_tensor, spanned
from .fused_stencil import laplacian_facegamma_fused
from .grid import DIRICHLET, NEUMANN, PERIODIC, FieldBC, Grid, pad_scalar
from .stencil import Flux, laplacian_facegamma_padded

def default_pad(bc: FieldBC):
    return lambda f: pad_scalar(f, bc)


def _ident(x):
    return x


def poisson_apply(p: torch.Tensor, gamma_f: Flux, grid: Grid, pad,
                  use_pallas: bool = False) -> torch.Tensor:
    """A(p) = div(gamma_f grad p). With ``use_pallas`` and every side of p
    at least 8 (the JAX package's own rule, `pressure.py:69`) the matvec is
    kernel B2; otherwise the plain stencil."""
    pp = pad(p)
    if use_pallas and min(p.shape) >= 8:
        return laplacian_facegamma_fused(gamma_f, pp, grid)
    return laplacian_facegamma_padded(gamma_f, pp, grid)


def poisson_diag(gamma_f: Flux, grid: Grid, bc: Optional[FieldBC] = None) -> torch.Tensor:
    """Diagonal of the variable-coefficient Laplacian; at physical
    boundaries Neumann removes the face and Dirichlet doubles it."""
    nx = gamma_f[0].shape[0] - 1
    ny = gamma_f[1].shape[1] - 1
    nz = gamma_f[2].shape[2] - 1
    diag = torch.zeros((nx, ny, nz), dtype=gamma_f[0].dtype, device=gamma_f[0].device)
    for axis in range(3):
        g = gamma_f[axis]
        n = g.shape[axis]
        g_hi = g.narrow(axis, 1, n - 1)
        g_lo = g.narrow(axis, 0, n - 1)
        c_lo = torch.ones_like(g_lo)
        c_hi = torch.ones_like(g_hi)
        if bc is not None and not bc.is_periodic(axis):
            lo_bc, hi_bc = bc.faces[axis]
            factor = {NEUMANN: 0.0, DIRICHLET: 2.0}
            c_lo.narrow(axis, 0, 1).fill_(factor.get(lo_bc.kind, 1.0))
            c_hi.narrow(axis, n - 2, 1).fill_(factor.get(hi_bc.kind, 1.0))
        diag = diag - (c_lo * g_lo + c_hi * g_hi) / (grid.spacing[axis] ** 2)
    return diag


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor          # int32
    residual: torch.Tensor       # final |r|_2
    initial_residual: torch.Tensor


def pcg(apply_A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        x0: torch.Tensor, *, precond=None, reduce_sum=_ident, tol: float = 1e-6,
        atol: float = 1e-30, rel_tol: float = 0.0, maxiter: int = 500,
        fixed_iters: int = 0) -> CGResult:
    """Preconditioned CG with the JAX package's tests: converged when
    |r| <= tol * max(|r0|, |b|), |r| <= atol or |r| <= rel_tol * |r0|;
    stops on breakdown (pAp >= 0 for the negative semi-definite operator)
    and on divergence (|r| > 4x the best seen). The exit test reads one
    scalar per iteration on the host.

    ``fixed_iters > 0`` runs exactly that many iterations instead and
    reads nothing on the host: once converged (or broken down, or
    diverging) the state is frozen, alpha and beta masked to 0 and p, rz
    and |r| held, so x is the while loop's whenever it converges within
    the budget. ``done`` and the live-iteration count stay device tensors;
    the count reports live iterations only."""
    M_raw = precond if precond is not None else (lambda r: r)

    def M(r):
        with annotate("yofc:pressure.precond"):
            return M_raw(r)

    def gdot(a, bb):
        return reduce_sum(torch.sum(a * bb))

    r0 = b - apply_A(x0)
    z0 = M(r0)
    rz0 = gdot(r0, z0)
    rnorm0 = torch.sqrt(gdot(r0, r0))
    bnorm = torch.sqrt(gdot(b, b))
    ref = torch.maximum(rnorm0, bnorm)
    # f32 cannot realize relative residuals much below machine epsilon
    tol = max(tol, 3e-7) if b.dtype == torch.float32 else tol

    def converged(rnorm):
        ok = (rnorm <= tol * ref) | (rnorm <= atol)
        if rel_tol > 0.0:
            ok = ok | (rnorm <= rel_tol * rnorm0)
        return ok

    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def step(x, r, p, rz, frozen):
        """One CG iteration; ``frozen`` (a bool tensor, or None) masks the
        update of a converged state."""
        Ap = apply_A(p)
        pAp = gdot(p, Ap)
        breakdown = pAp >= -1e-30 * torch.clamp(gdot(p, p), min=1e-30)
        stop = breakdown if frozen is None else breakdown | frozen
        alpha = torch.where(stop, zero, rz / torch.where(pAp == 0.0, one, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = gdot(r, z)
        beta = torch.where(stop, zero, rz_new / torch.where(rz == 0.0, one, rz))
        p_new = z + beta * p
        rnorm = torch.sqrt(gdot(r, r))
        if frozen is not None:
            p_new = torch.where(frozen, p, p_new)
            rz_new = torch.where(frozen, rz, rz_new)
        return x, r, p_new, rz_new, rnorm, breakdown

    x, r, p, rz, rnorm, best = x0, r0, z0, rz0, rnorm0, rnorm0
    if fixed_iters > 0:
        done = converged(rnorm0)
        it = torch.zeros((), dtype=torch.int32, device=b.device)
        for _ in range(fixed_iters):
            live = ~done
            x, r, p, rz, rnorm_new, breakdown = step(x, r, p, rz, done)
            rnorm = torch.where(done, rnorm, rnorm_new)
            diverging = rnorm > 4.0 * best
            best = torch.minimum(best, rnorm)
            done = done | converged(rnorm) | breakdown | diverging
            it = it + live.to(torch.int32)
        return CGResult(x, it, rnorm, rnorm0)

    def exit_read(flag):
        with annotate("yofc:sync.cg_exit"):
            return bool(flag)

    it = 0
    done = exit_read(converged(rnorm0))
    while it < maxiter and not done:
        it += 1
        x, r, p, rz, rnorm, breakdown = step(x, r, p, rz, None)
        diverging = rnorm > 4.0 * best
        best = torch.minimum(best, rnorm)
        done = exit_read(converged(rnorm) | breakdown | diverging)
    iters = host_tensor(it, dtype=torch.int32, device=b.device)
    return CGResult(x, iters, rnorm, rnorm0)


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid V-cycle settings; same fields and defaults as the JAX
    package. ``bf16`` runs the V-cycle in bfloat16 (the residual cast in,
    the correction cast out); the outer CG stays float32."""

    levels: int = 0
    pre_smooth: int = 2
    post_smooth: int = 2
    coarse_iters: int = 20
    omega: float = 0.8
    smoother: str = "jacobi"
    cheby_frac: float = 4.0
    bf16: bool = False


def _restrict(f: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction: average 2x2x2 fine cells."""
    nx, ny, nz = f.shape
    return f.reshape(nx // 2, 2, ny // 2, 2, nz // 2, 2).mean(dim=(1, 3, 5))


def _prolong(c: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation (each coarse cell -> 2x2x2 fine), as
    one broadcast copy."""
    nx, ny, nz = c.shape
    return c[:, None, :, None, :, None].expand(nx, 2, ny, 2, nz, 2).reshape(
        2 * nx, 2 * ny, 2 * nz)


def _every_other(g: torch.Tensor, start: int, axis: int) -> torch.Tensor:
    idx = [slice(None)] * 3
    idx[axis] = slice(start, None, 2)
    return g[tuple(idx)]


def _coarsen_gamma_faces(gamma_f: Flux) -> Flux:
    """Average the 4 fine faces lying on each coarse face; keep every other
    face plane along the normal direction."""
    out = []
    for axis in range(3):
        g = _every_other(gamma_f[axis], 0, axis)
        for t in range(3):
            if t != axis:
                g = 0.5 * (_every_other(g, 0, t) + _every_other(g, 1, t))
        out.append(g)
    return tuple(out)


def _coarsen_grid(grid: Grid) -> Grid:
    return Grid(tuple(n // 2 for n in grid.shape), tuple(2.0 * h for h in grid.spacing),
                grid.origin)


def mg_levels_for(grid: Grid, min_size: int = 4) -> int:
    """How many coarsening levels the grid admits (incl. the fine level)."""
    lv = 1
    shape = list(grid.shape)
    while all(n % 2 == 0 and n // 2 >= min_size for n in shape):
        shape = [n // 2 for n in shape]
        lv += 1
    return lv


def make_mg_preconditioner(gamma_f: Flux, grid: Grid, bc: FieldBC,
                           cfg: MGConfig = MGConfig(),
                           use_pallas: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """A V-cycle M^-1 r for the face-gamma Poisson operator (the role of
    OpenFOAM's GAMG): damped-Jacobi or Chebyshev smoothing on every level,
    `coarse_iters` smoothing sweeps on the coarsest. Under ``cfg.bf16``
    the level coefficients and inverse diagonals are bfloat16 and the cycle
    runs on the residual cast to bfloat16, B2 included (its bfloat16
    entry); the correction returns in the residual's dtype."""
    levels = cfg.levels if cfg.levels > 0 else mg_levels_for(grid)
    gammas, grids = [gamma_f], [grid]
    for _ in range(levels - 1):
        gammas.append(_coarsen_gamma_faces(gammas[-1]))
        grids.append(_coarsen_grid(grids[-1]))
    pad = default_pad(bc)
    inv_diags = []
    for g, gr in zip(gammas, grids):
        d = poisson_diag(g, gr, bc)
        inv_diags.append(1.0 / torch.where(torch.abs(d) < 1e-30, -1.0, d))
    if cfg.bf16:
        bf = torch.bfloat16
        gammas = [tuple(g.to(bf) for g in gf) for gf in gammas]
        inv_diags = [d.to(bf) for d in inv_diags]

    def apply_lv(lv, v):
        return poisson_apply(v, gammas[lv], grids[lv], pad, use_pallas=use_pallas)

    def smooth_jacobi(lv, x, b, iters):
        for _ in range(iters):
            r = b - apply_lv(lv, x)
            x = x + cfg.omega * inv_diags[lv] * r
        return x

    def smooth_cheby(lv, x, b, iters):
        """Chebyshev(iters) smoothing of D^-1 A on [L/frac, L], L = 2 (the
        Gershgorin bound), by the 3-term d-recurrence: one matvec per
        iteration, as a Jacobi sweep."""
        if iters <= 0:
            return x
        L = 2.0
        lo = L / cfg.cheby_frac
        theta, delta = 0.5 * (L + lo), 0.5 * (L - lo)
        sigma = theta / delta
        r = b - apply_lv(lv, x)
        z = inv_diags[lv] * r
        d = z / theta
        x = x + d
        rho_old = 1.0 / sigma
        for _ in range(iters - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = r - apply_lv(lv, d)
            z = inv_diags[lv] * r
            d = (rho * rho_old) * d + (2.0 * rho / delta) * z
            x = x + d
            rho_old = rho
        return x

    if cfg.smoother == "chebyshev":
        smooth = smooth_cheby
    elif cfg.smoother == "jacobi":
        smooth = smooth_jacobi
    else:
        raise ValueError(f"unknown MG smoother {cfg.smoother!r}")

    names = [f"yofc:mg.L{lv}" for lv in range(levels)]

    def vcycle(lv, b):
        with annotate(names[lv]):
            x = smooth(lv, torch.zeros_like(b), b, cfg.pre_smooth)
            if lv == levels - 1:
                return smooth(lv, x, b, cfg.coarse_iters)
            r = b - apply_lv(lv, x)
            x = x + _prolong(vcycle(lv + 1, _restrict(r)))
            return smooth(lv, x, b, cfg.post_smooth)

    if cfg.bf16:
        return lambda r: vcycle(0, r.to(torch.bfloat16)).to(r.dtype)
    return lambda r: vcycle(0, r)


def _spectral_axis_basis(n: int, lo_kind: str, hi_kind: str, h: float):
    """Orthonormal eigenbasis Q (n, n) and eigenvalues lam (n,) of the 1-D
    cell-centred second difference under the ghost-cell BC convention of
    `pad_scalar` (the DCT/DST family on half-integer nodes). Built in
    float64 with numpy; returned as float32 arrays, or None when the BC
    pair has no trigonometric basis."""
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    periodic = lo_kind == PERIODIC and hi_kind == PERIODIC
    neu = (NEUMANN,)
    if periodic:
        cols = [np.full(n, 1.0 / np.sqrt(n))]
        lams = [0.0]
        for kk in range(1, (n - 1) // 2 + 1):
            t = 2.0 * np.pi * kk * j / n
            cols.append(np.cos(t) * np.sqrt(2.0 / n))
            cols.append(np.sin(t) * np.sqrt(2.0 / n))
            lams += [(2.0 * np.cos(2.0 * np.pi * kk / n) - 2.0) / h**2] * 2
        if n % 2 == 0:
            cols.append(np.cos(np.pi * j) / np.sqrt(n))
            lams.append(-4.0 / h**2)
        Q = np.stack(cols, axis=1)
        lam = np.asarray(lams)
    elif lo_kind in neu and hi_kind in neu:
        Q = np.cos(np.pi * k[None, :] * (j[:, None] + 0.5) / n)
        lam = (2.0 * np.cos(np.pi * k / n) - 2.0) / h**2
    elif lo_kind == DIRICHLET and hi_kind == DIRICHLET:
        Q = np.sin(np.pi * (k[None, :] + 1.0) * (j[:, None] + 0.5) / n)
        lam = (2.0 * np.cos(np.pi * (k + 1.0) / n) - 2.0) / h**2
    elif lo_kind in neu and hi_kind == DIRICHLET:
        Q = np.cos(np.pi * (k[None, :] + 0.5) * (j[:, None] + 0.5) / n)
        lam = (2.0 * np.cos(np.pi * (k + 0.5) / n) - 2.0) / h**2
    elif lo_kind == DIRICHLET and hi_kind in neu:
        Q = np.sin(np.pi * (k[None, :] + 0.5) * (j[:, None] + 0.5) / n)
        lam = (2.0 * np.cos(np.pi * (k + 0.5) / n) - 2.0) / h**2
    else:
        return None
    Q = Q / np.linalg.norm(Q, axis=0, keepdims=True)
    return Q.astype(np.float32), lam.astype(np.float32)


def make_spectral_preconditioner(gamma_f: Flux, grid: Grid, bc: FieldBC,
                                 nullspace_eps: float = 1e-12):
    """Exact inverse of the mean-coefficient Poisson operator: forward
    transform per axis, divide by the eigenvalues, inverse transform — six
    dense (n, n) products in full fp32. None when an axis BC pair has no
    trigonometric eigenbasis."""
    bases = []
    for axis in range(3):
        lo, hi = bc.faces[axis]
        qa = _spectral_axis_basis(grid.shape[axis], lo.kind, hi.kind,
                                  grid.spacing[axis])
        if qa is None:
            return None
        bases.append(qa)

    dev = gamma_f[0].device
    gbar = [torch.mean(gamma_f[a]) for a in range(3)]
    Qs = [host_tensor(Q, device=dev) for Q, _ in bases]
    lams = [host_tensor(lam, device=dev) for _, lam in bases]
    lam = (gbar[0] * lams[0][:, None, None]
           + gbar[1] * lams[1][None, :, None]
           + gbar[2] * lams[2][None, None, :])
    small = torch.abs(lam) < nullspace_eps
    inv = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, lam))

    def apply(r: torch.Tensor) -> torch.Tensor:
        t = torch.einsum("ia,iyz->ayz", Qs[0], r)
        t = torch.einsum("jb,ajz->abz", Qs[1], t)
        t = torch.einsum("kc,abk->abc", Qs[2], t)
        t = t * inv
        t = torch.einsum("kc,abc->abk", Qs[2], t)
        t = torch.einsum("jb,abz->ajz", Qs[1], t)
        return torch.einsum("ia,ayz->iyz", Qs[0], t)

    return apply


@dataclasses.dataclass(frozen=True)
class PressureSolverConfig:
    """The fvSolution `p` sub-dictionary; same fields and defaults as the
    JAX package. ``use_pallas`` runs the matvecs as kernel B2."""

    solver: str = "mgpcg"      # 'pcg' | 'mgpcg' | 'fftpcg'
    tol: float = 1e-6
    rel_tol: float = 0.0
    abs_tol: float = 1e-30
    maxiter: int = 200
    fixed_iters: int = 0
    mg: MGConfig = MGConfig()
    use_pallas: bool = False


def solve_helmholtz(a_diag: torch.Tensor, gamma_f: Flux, rhs: torch.Tensor,
                    x0: torch.Tensor, grid: Grid, bc: FieldBC,
                    cfg: Optional[PressureSolverConfig] = None, *, pad=None,
                    reduce_sum=_ident, precond_bc: Optional[FieldBC] = None) -> CGResult:
    """Solve a_diag * x - div(gamma_f grad x) = rhs (a_diag > 0): the
    implicit momentum-diffusion system (OpenFOAM's `fvm::laplacian(nuEff,
    U)` inside the momentum solve). Positive definite, so it is negated
    for `pcg`'s negative-definite guards; the nonzero-Dirichlet ghost
    constant is folded into the right-hand side; Jacobi-preconditioned
    (``cfg.solver`` is ignored). The matvec is B2 under ``cfg.use_pallas``,
    as in `solve_pressure`."""
    cfg = cfg if cfg is not None else PressureSolverConfig(solver="pcg")
    pad = pad if pad is not None else default_pad(bc)

    def op_affine(x):
        return a_diag * x - poisson_apply(x, gamma_f, grid, pad, use_pallas=cfg.use_pallas)

    bc_const = op_affine(torch.zeros_like(rhs))
    mgrid = Grid(tuple(rhs.shape), grid.spacing, grid.origin)
    pbc = precond_bc if precond_bc is not None else bc.homogeneous()
    d = poisson_diag(gamma_f, mgrid, pbc) - a_diag        # diagonal of -op, < 0
    inv_diag = 1.0 / torch.where(torch.abs(d) < 1e-30, -1.0, d)
    return pcg(lambda x: bc_const - op_affine(x), bc_const - rhs, x0,
               precond=lambda r: inv_diag * r, reduce_sum=reduce_sum,
               tol=cfg.tol, atol=cfg.abs_tol, rel_tol=cfg.rel_tol,
               maxiter=cfg.maxiter, fixed_iters=cfg.fixed_iters)


@spanned("yofc:pressure")
def solve_pressure(gamma_f: Flux, rhs: torch.Tensor, p0: torch.Tensor,
                   grid: Grid, bc: FieldBC,
                   cfg: PressureSolverConfig = PressureSolverConfig(), *,
                   pad=None, reduce_sum=_ident, nullspace: Optional[bool] = None,
                   precond_bc: Optional[FieldBC] = None, solid=None) -> CGResult:
    """Solve div(gamma_f grad p) = rhs. Without a Dirichlet face the
    operator has the constant nullspace: the mean of rhs is removed and the
    mean of p pinned (`pEqn.setReference`).

    ``solid`` (an `obstacle.ObstacleMasks`) is the masked-cell obstacle
    solve: gamma_f comes face-masked, so solid rows of the Laplacian are
    zero; they become a scaled identity -s p (s the interior diagonal
    magnitude), the RHS and p0 are zeroed there, the preconditioner acts
    on the fluid subspace, and the nullspace mean runs over fluid cells.
    The solve runs in a ``yofc:pressure`` span; everything before `pcg`
    (the BC constant, the nullspace means, the preconditioner's build) in
    ``yofc:pressure.setup``."""
    with annotate("yofc:pressure.setup"):
        pad = pad if pad is not None else default_pad(bc)
        if nullspace is None:
            nullspace = not any(f.kind == DIRICHLET for pair in bc.faces for f in pair)

        fluid_m = None
        if solid is not None:
            fluid_m = solid.fluid
            s_scale = sum(2.0 * torch.mean(gamma_f[a]) / grid.spacing[a] ** 2 for a in range(3))
            rhs = rhs * fluid_m
            p0 = p0 * fluid_m

        # fold the affine (nonzero-Dirichlet) ghost constant into the RHS
        bc_const = poisson_apply(torch.zeros_like(rhs), gamma_f, grid, pad,
                                 use_pallas=cfg.use_pallas)
        rhs = rhs - bc_const
        n_fluid = rhs.numel() - (solid.n_solid if solid is not None else 0)
        ncells = reduce_sum(host_tensor(float(n_fluid), dtype=rhs.dtype, device=rhs.device))

        def _mean(f):
            """The mean over fluid cells, spread over fluid cells."""
            if fluid_m is None:
                return reduce_sum(torch.sum(f)) / ncells
            return reduce_sum(torch.sum(f * fluid_m)) / ncells * fluid_m

        if nullspace:
            rhs = rhs - _mean(rhs)
            p0 = p0 - _mean(p0)

        def apply_A(p):
            out = poisson_apply(p, gamma_f, grid, pad, use_pallas=cfg.use_pallas) - bc_const
            return out if solid is None else out - s_scale * (solid.solid * p)

        mg_grid = Grid(tuple(rhs.shape), grid.spacing, grid.origin)
        pbc = precond_bc if precond_bc is not None else bc.homogeneous()
        if cfg.solver == "fftpcg":
            M = make_spectral_preconditioner(gamma_f, mg_grid, pbc)
            if M is None:       # no trigonometric basis for these BCs: V-cycle
                M = make_mg_preconditioner(gamma_f, mg_grid, pbc, cfg.mg,
                                           use_pallas=cfg.use_pallas)
        elif cfg.solver == "mgpcg":
            M = make_mg_preconditioner(gamma_f, mg_grid, pbc, cfg.mg, use_pallas=cfg.use_pallas)
        elif cfg.solver == "pcg":
            d = poisson_diag(gamma_f, mg_grid, pbc)
            inv_diag = 1.0 / torch.where(torch.abs(d) < 1e-30, -1.0, d)
            M = lambda r: inv_diag * r  # noqa: E731
        else:
            raise ValueError(f"unknown pressure solver {cfg.solver!r}")
        if solid is not None:
            # the unmasked preconditioner on the fluid subspace, the identity
            # rows inverted exactly
            M_fluid = M
            M = lambda r: fluid_m * M_fluid(fluid_m * r) - (solid.solid * r) / s_scale  # noqa: E731

    res = pcg(apply_A, rhs, p0, precond=M, reduce_sum=reduce_sum,
              tol=cfg.tol, atol=cfg.abs_tol, rel_tol=cfg.rel_tol,
              maxiter=cfg.maxiter, fixed_iters=cfg.fixed_iters)
    x = res.x
    if nullspace:
        x = x - _mean(x)
    if fluid_m is not None:
        x = x * fluid_m
    return CGResult(x, res.iters, res.residual, res.initial_residual)
