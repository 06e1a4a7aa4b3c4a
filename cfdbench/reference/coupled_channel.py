"""Plain reference of the four-way coupled channel: the Gaussian exchange,
the DEM substeps, the kEqn closure and the PIMPLE step with its pressure
solve, on a uniform grid periodic in x and y with no-slip walls in z.

Written for the benchmark in plain PyTorch, in any floating dtype (float64
by default), importing nothing of the program under test. It reads the
configuration's ``"case"`` dictionary and refuses a setting it does not
implement (`check_supported`). One exchange serves every Gaussian exchange
the program offers (sparse, window, planes): they compute the same
normalised Gaussian four-way exchange over the stencil; one pressure solve
serves every solver (fftpcg, mgpcg): they solve the same equation, here by
CG preconditioned with the exact inverse of the mean-coefficient operator
(FFT in x and y, a cosine transform in z), to a much tighter tolerance.
Contacts are found exactly every substep, from all pairs in neighbouring
cells, so no list capacity or skin applies. Positions are held in the
configuration's stated precision (``"precision"``, float32), and the cell
that holds a particle is the floor of its quotient in that precision, as
the program's state holds and locates them: a float64 position would put
the few particles that lie within an ulp of a cell face in the other cell,
each step, and move their share of the exchange by a cell. Two runs that
differ in the last bits of a position can still place a particle that sits
on a face in two cells; `run_chunk` lists such ties (`face_ties`) and can
locate one of them across its face (``shift``).

A state is a dict of tensors: u (3, nx, ny, nz), p, phi (3 face arrays),
alpha, k, nut, and pos, vel, angvel, radius, active, contact_f,
contact_t (particle arrays), with the float ``dt``. `run_chunk` returns the
state after n steps with the exchange's fields of the last step
(alpha_old, u_source, u_source_drag, u_particle). ``store`` (a dtype)
rounds every field and particle array the step writes to that dtype after
each stage, which is how the control computes in a lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GAUSS_RANGE_CELLS = 4.0
GAUSS_SIGMA_OVER_RANGE = 0.42460
U_BC = ("P", "P", "D")      # periodic x, y; no-slip (zero Dirichlet) z
P_BC = ("P", "P", "N")      # periodic x, y; zero gradient z
NEU = ("N", "N", "N")       # zero gradient on every face
PERIODIC = (True, True, False)
TIE_ULPS = 2                # how far a position may sit from a face and be a tie


def check_supported(config: dict) -> None:
    """Raise ValueError for a setting this reference does not implement."""
    c = config["case"]
    want = {
        ("solver",): "pimple", ("bcs",): "channel_z",
        ("coupling", "gaussian"): True, ("coupling", "lag_alpha"): True,
        ("coupling", "stencil_width"): 3, ("coupling", "use_added_mass"): False,
        ("coupling", "use_torque"): False,
        ("dem", "neighbor"): "cells", ("dem", "contact_mode"): "substep",
        ("dem", "carry_contact"): True, ("dem", "shear_history"): False,
        ("dem", "dynamic_substeps"): False, ("dem", "enforce_critical_dt"): False,
        ("dem", "cundall_damping"): 0.0, ("dem", "buoyancy"): False,
        ("dem", "list_reuse"): True, ("dem", "periodic"): [True, True, False],
        ("dem", "wall_axes"): [False, False, True],
        ("pimple", "n_outer"): 1, ("pimple", "momentum_predictor"): False,
        ("pimple", "convection_scheme"): "linear", ("pimple", "full_stress"): True,
        ("pimple", "relax_u"): 1.0, ("pimple", "relax_p"): 1.0,
        ("pimple", "p_extrapolate"): 0.0, ("pimple", "implicit_diffusion"): False,
        ("turbulence", "model"): "kEqn",
    }
    for path, value in want.items():
        got = c
        for key in path:
            got = got[key]
        if got != value:
            raise ValueError(f"reference: {'.'.join(path)} = {got!r} is not implemented "
                             f"(only {value!r})")
    if c["coupling"]["exchange"] not in ("sparse", "window", "planes"):
        raise ValueError(f"reference: exchange {c['coupling']['exchange']!r}")
    if c["coupling"]["stencil_shape"] not in ("cube", "sphere2"):
        raise ValueError(f"reference: stencil {c['coupling']['stencil_shape']!r}")
    if c["pimple"]["pressure"]["solver"] not in ("fftpcg", "mgpcg", "pcg"):
        raise ValueError(f"reference: pressure solver {c['pimple']['pressure']['solver']!r}")


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

class Grid:
    def __init__(self, c: dict, precision: str = "float32"):
        n, length = c["grid"]["cube"]
        self.store = getattr(torch, precision)
        self.shape = (int(n),) * 3
        self.h = (float(length) / int(n),) * 3
        self.lengths = (float(length),) * 3
        self.vc = self.h[0] * self.h[1] * self.h[2]
        self.ncells = int(n) ** 3


def _ax(f, axis):
    return f.dim() - 3 + axis


def _sl(f, axis, start, stop):
    ax = _ax(f, axis)
    return f.narrow(ax, start, stop - start)


def pad(f, kinds):
    """One ghost cell on each side of the three spatial (last) axes:
    P periodic, N zero gradient, D zero value."""
    for axis, kind in enumerate(kinds):
        n = f.shape[_ax(f, axis)]
        first, last = _sl(f, axis, 0, 1), _sl(f, axis, n - 1, n)
        lo, hi = {"P": (last, first), "N": (first, last), "D": (-first, -last)}[kind]
        f = torch.cat([lo, f, hi], dim=_ax(f, axis))
    return f


def _strip(fp, axis):
    """Drop the ghost cells of the two axes other than ``axis``."""
    idx = [slice(None)] * fp.dim()
    for a in range(3):
        if a != axis:
            idx[_ax(fp, a)] = slice(1, -1)
    return fp[tuple(idx)]


def _diff(f, axis):
    n = f.shape[_ax(f, axis)]
    return _sl(f, axis, 1, n) - _sl(f, axis, 0, n - 1)


def _avg(f, axis):
    n = f.shape[_ax(f, axis)]
    return 0.5 * (_sl(f, axis, 1, n) + _sl(f, axis, 0, n - 1))


def grad(fp, g: Grid):
    """Central-difference gradient of a padded field; a vector's is
    G[i, j] = d u_i / d x_j."""
    comps = []
    for a in range(3):
        s = _strip(fp, a)
        n = s.shape[_ax(s, a)]
        comps.append((_sl(s, a, 2, n) - _sl(s, a, 0, n - 2)) / (2.0 * g.h[a]))
    return torch.stack(comps, dim=fp.dim() - 3)


def faces(fp):
    """Linear face values of a padded scalar on the three face sets."""
    return tuple(_avg(_strip(fp, a), a) for a in range(3))


def face_grad(fp, g: Grid):
    return tuple(_diff(_strip(fp, a), a) / g.h[a] for a in range(3))


def div_faces(phi, g: Grid):
    return sum(_diff(phi[a], a) / g.h[a] for a in range(3))


def lap_faces(gamma, fp, g: Grid):
    """div(gamma grad f) with face coefficients, of a padded field."""
    return sum(_diff(gamma[a] * gf, a) / g.h[a] for a, gf in enumerate(face_grad(fp, g)))


def div_phi(phi, fp, g: Grid, upwind: bool):
    """Conservative convection div(phi f) of a padded field."""
    out = 0.0
    for a in range(3):
        s = _strip(fp, a)
        n = s.shape[_ax(s, a)]
        hi, lo = _sl(s, a, 1, n), _sl(s, a, 0, n - 1)
        face = torch.where(phi[a] >= 0.0, lo, hi) if upwind else 0.5 * (hi + lo)
        out = out + _diff(phi[a] * face, a) / g.h[a]
    return out


def reconstruct(fv):
    return torch.stack([_avg(fv[a], a) for a in range(3)])


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------

def stencil_offsets(shape: str) -> np.ndarray:
    o = np.arange(-1, 2)
    offs = np.stack(np.meshgrid(o, o, o, indexing="ij"), -1).reshape(-1, 3)
    if shape == "sphere2":
        offs = offs[(offs ** 2).sum(1) <= 2]
    return offs


def drag_coefficient(alpha_f, alpha_p, mag_ur, dia, nu, rho_f):
    """Wen-Yu above a fluid fraction of 0.8, Ergun below."""
    re = 1e-12 + mag_ur * dia / nu
    cd = torch.where(re < 1000.0, (24.0 / re) * (1.0 + 0.15 * re ** 0.687),
                     torch.full_like(re, 0.44))
    wen_yu = 0.75 * cd * alpha_f * alpha_p * rho_f * mag_ur * alpha_f ** (-2.65)
    ergun = (150.0 * (alpha_p * alpha_p / torch.clamp(alpha_f, min=1e-6)) * (nu * rho_f)
             / (dia * dia) + 1.75 * alpha_p * rho_f * mag_ur / dia)
    return torch.where(alpha_f > 0.8, wen_yu, ergun)


def exchange(c: dict, g: Grid, st: dict):
    """The Gaussian four-way exchange at the state's fluid and particles,
    with the volume fraction lagged one step. -> (force, torque, alpha,
    u_particle, u_source, u_source_drag)."""
    cc = c["coupling"]
    nu, rho_f = c["transport"]["nu"], c["transport"]["rho_f"]
    u, p, alpha = st["u"], st["p"], st["alpha"]
    pos, vel, radius, active = st["pos"], st["vel"], st["radius"], st["active"]
    dt_, dev = pos.dtype, pos.device

    up = pad(u, U_BC)
    grad_p = grad(pad(p, P_BC), g)
    alpha_f = faces(pad(alpha, NEU))
    div_tau = 2.0 * nu * lap_faces(alpha_f, up, g)

    # the support: the stencil around each particle's cell, normalised
    # Gaussian weights over the cells inside the box
    offs = torch.as_tensor(stencil_offsets(cc["stencil_shape"]), device=dev)
    n = torch.tensor(g.shape, device=dev)
    h = torch.tensor(g.h, dtype=dt_, device=dev)
    # the cell that holds a particle, as the stated precision of positions
    # decides it: a particle on a cell face lies in the cell above it when
    # its float32 quotient rounds up
    base = torch.floor(pos.to(g.store) / torch.tensor(g.h, dtype=g.store, device=dev))
    base = base.to(torch.int64)
    if st.get("cell_shift") is not None:
        i, axis, delta = st["cell_shift"]
        base[i, axis] += delta
    inside = torch.all((base >= 0) & (base < n), dim=-1)
    cells = base[:, None, :] + offs[None]                           # (N, S, 3)
    d2 = torch.sum(((cells.to(dt_) + 0.5) * h - pos[:, None, :]) ** 2, dim=-1)
    sigma = GAUSS_SIGMA_OVER_RANGE * GAUSS_RANGE_CELLS * g.vc ** (1.0 / 3.0)
    w = torch.exp(-d2 / (2.0 * sigma * sigma))
    ok = (active & inside)[:, None] & torch.all(
        ((cells >= 0) & (cells < n)) | torch.tensor(PERIODIC, device=dev), dim=-1)
    w = torch.where(ok, w, 0.0)
    wsum = w.sum(1, keepdim=True)
    w = w / torch.where(wsum > 0.0, wsum, 1.0)
    found = w.sum(1) > 0.0
    wc = torch.remainder(cells, n)
    flat = torch.where(ok, (wc[..., 0] * g.shape[1] + wc[..., 1]) * g.shape[2] + wc[..., 2],
                       g.ncells)

    fields = torch.cat([u, grad_p, div_tau, alpha[None]]).reshape(10, -1).T
    table = torch.cat([fields, fields.new_zeros((1, 10))])
    at = torch.einsum("nsc,ns->nc", table[flat], w)
    uf, pg, tau_p, alpha_p_f = at[:, 0:3], at[:, 3:6], at[:, 6:9], at[:, 9]

    vol = (4.0 / 3.0) * math.pi * radius ** 3
    dia = 2.0 * radius
    zero = torch.zeros((), dtype=dt_, device=dev)
    solid = torch.clamp(1.0 - alpha_p_f, 1e-6, 1.0)
    ur = uf - vel
    coeff = drag_coefficient(alpha_p_f, solid, torch.linalg.vector_norm(ur, dim=-1), dia,
                             nu, rho_f)
    coeff = torch.where(found, coeff, zero)
    f_drag = (vol * coeff / solid)[:, None] * ur
    f_arch = torch.where(found[:, None], vol[:, None] * rho_f * (tau_p - pg), zero)
    force = torch.where(found[:, None], f_drag + f_arch, zero)

    vals = torch.cat([vol[:, None], vol[:, None] * vel, -(coeff / rho_f)[:, None],
                      -f_arch / (g.vc * rho_f)], dim=-1)                 # (N, 8)
    grid8 = torch.zeros((g.ncells + 1, 8), dtype=dt_, device=dev)
    grid8.index_add_(0, flat.reshape(-1),
                     (w[..., None] * vals[:, None, :]).reshape(-1, 8))
    out = grid8[:g.ncells].T.reshape((8,) + g.shape)
    alpha_new = torch.clamp(1.0 - out[0] / g.vc, min=cc["alpha_min"])
    u_particle = out[1:4] / g.vc
    u_source_drag = out[4]
    u_source = u_source_drag[None] * u_particle + out[5:8]
    return force, torch.zeros_like(vel), alpha_new, u_particle, u_source, u_source_drag


# ---------------------------------------------------------------------------
# The DEM
# ---------------------------------------------------------------------------

def _damping_ratio(restitution: float) -> float:
    e = max(min(restitution, 0.999), 1e-4)
    return float(-np.log(e) / np.sqrt(np.pi ** 2 + np.log(e) ** 2))


def _min_image(d, lengths):
    out = []
    for a in range(3):
        da = d[..., a]
        if PERIODIC[a]:
            da = da - lengths[a] * torch.round(da / lengths[a])
        out.append(da)
    return torch.stack(out, -1)


def touching_pairs(pos, radius, active, g: Grid, r_max: float):
    """(i, j) index pairs, both orders, of distinct active particles that
    overlap: every particle's 27 neighbouring cells (at least 2 r_max
    wide) searched in full."""
    dev = pos.device
    dims = [max(1, int(np.floor(L / (2.0 * r_max)))) for L in g.lengths]
    size = torch.tensor([L / d for L, d in zip(g.lengths, dims)], dtype=pos.dtype,
                        device=dev)
    nvec = torch.tensor(dims, device=dev)
    ijk = torch.minimum(torch.clamp(torch.floor(pos / size).to(torch.int64), min=0), nvec - 1)
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    key = torch.where(active, key, -1)
    skey, order = torch.sort(key, stable=True)
    I, J = [], []
    per = torch.tensor(PERIODIC, device=dev)
    for o in stencil_offsets("cube"):
        nb = ijk + torch.as_tensor(o, device=dev)
        ok = active & torch.all(((nb >= 0) & (nb < nvec)) | per, dim=-1)
        nb = torch.remainder(nb, nvec)
        nkey = torch.where(ok, (nb[:, 0] * dims[1] + nb[:, 1]) * dims[2] + nb[:, 2], -2)
        lo = torch.searchsorted(skey, nkey, side="left")
        hi = torch.searchsorted(skey, nkey, side="right")
        most = int((hi - lo).max())
        for t in range(most):
            has = ok & (lo + t < hi)
            i = torch.nonzero(has).flatten()
            j = order[(lo + t)[i]]
            d = torch.linalg.vector_norm(_min_image(pos[i] - pos[j], g.lengths), dim=-1)
            hit = (i != j) & (d < radius[i] + radius[j]) & (d > 1e-12)
            I.append(i[hit])
            J.append(j[hit])
    return torch.cat(I), torch.cat(J)


def contact_forces(c: dict, g: Grid, pos, vel, angvel, radius, active):
    """Linear spring-dashpot contacts with Coulomb-capped viscous friction,
    between particles and against the walls of the non-periodic axes.
    -> (force, torque) on each particle."""
    prm = c["dem"]["params"]
    kn, rho_p = prm["kn"], prm["rho_p"]
    kt = prm["kt_over_kn"] * kn
    beta = _damping_ratio(prm["restitution"])
    mass = rho_p * (4.0 / 3.0) * math.pi * radius ** 3
    f = torch.zeros_like(pos)
    t = torch.zeros_like(pos)

    i, j = touching_pairs(pos, radius, active, g, c["r_max"])
    if i.numel():
        dx = _min_image(pos[i] - pos[j], g.lengths)
        dist = torch.linalg.vector_norm(dx, dim=-1)
        nrm = dx / dist[:, None]                                    # from j toward i
        ci, cj = -radius[i, None] * nrm, radius[j, None] * nrm
        v_rel = (vel[i] + torch.cross(angvel[i], ci, dim=-1)) \
            - (vel[j] + torch.cross(angvel[j], cj, dim=-1))
        v_n = torch.sum(v_rel * nrm, -1)
        v_t = v_rel - v_n[:, None] * nrm
        m_eff = mass[i] * mass[j] / (mass[i] + mass[j])
        f_n = torch.clamp(kn * (radius[i] + radius[j] - dist)
                          - 2.0 * beta * torch.sqrt(kn * m_eff) * v_n, min=0.0)
        f_t = -torch.sqrt(kt * m_eff)[:, None] * v_t
        f_t_mag = torch.linalg.vector_norm(f_t, dim=-1)
        scale = torch.where(f_t_mag > 1e-30, torch.clamp(
            prm["friction"] * f_n / torch.clamp(f_t_mag, min=1e-30), max=1.0), 0.0)
        f_t = f_t * scale[:, None]
        f.index_add_(0, i, f_n[:, None] * nrm + f_t)
        t.index_add_(0, i, torch.cross(ci, f_t, dim=-1))

    for axis in range(3):
        if not c["dem"]["wall_axes"][axis] or PERIODIC[axis]:
            continue
        x = pos[:, axis]
        at_lo = x <= g.lengths[axis] - x
        gap = torch.where(at_lo, x, g.lengths[axis] - x)
        sgn = torch.where(at_lo, 1.0, -1.0).to(pos.dtype)
        overlap = radius - gap
        touch = active & (overlap > 0.0)
        f_n = torch.where(touch, torch.clamp(
            kn * overlap - 2.0 * beta * torch.sqrt(kn * mass) * sgn * vel[:, axis], min=0.0), 0.0)
        n_vec = torch.zeros_like(pos)
        n_vec[:, axis] = sgn
        c_vec = -radius[:, None] * n_vec
        v_surf = vel + torch.cross(angvel, c_vec, dim=-1)
        v_t = v_surf - torch.sum(v_surf * n_vec, -1, keepdim=True) * n_vec
        f_t = -torch.sqrt(kt * mass)[:, None] * v_t
        f_t_mag = torch.linalg.vector_norm(f_t, dim=-1)
        scale = torch.where(f_t_mag > 1e-30, torch.clamp(
            prm["friction"] * f_n / torch.clamp(f_t_mag, min=1e-30), max=1.0), 0.0)
        f_t = f_t * torch.where(touch, scale, 0.0)[:, None]
        f = f + f_n[:, None] * n_vec + f_t
        t = t + torch.cross(c_vec, f_t, dim=-1)
    return f, t


def dem_substeps(c: dict, g: Grid, st: dict, hydro_f, hydro_t, dt: float, q):
    """Velocity-Verlet substeps under a constant hydrodynamic force, the
    contact force of each evaluation carried into the next substep (and
    the next step)."""
    pos, vel, angvel = st["pos"], st["vel"], st["angvel"]
    radius, active = st["radius"], st["active"]
    rho_p = c["dem"]["params"]["rho_p"]
    mass = rho_p * (4.0 / 3.0) * math.pi * radius ** 3
    inv_m = torch.where(active, 1.0 / mass, 0.0)[:, None]
    inv_i = torch.where(active, 1.0 / (0.4 * mass * radius ** 2), 0.0)[:, None]
    gvec = torch.tensor(c["dem"]["gravity"], dtype=pos.dtype, device=pos.device)
    f_ext = mass[:, None] * gvec + hydro_f
    L = torch.tensor(g.lengths, dtype=pos.dtype, device=pos.device)
    per = torch.tensor(PERIODIC, device=pos.device)
    n_sub = c["n_dem_substeps"]
    h = dt / n_sub
    fc, tc = st["contact_f"], st["contact_t"]
    a, aw = (fc + f_ext) * inv_m, (tc + hydro_t) * inv_i
    for _ in range(n_sub):
        vel_h = vel + 0.5 * h * a
        ang_h = angvel + 0.5 * h * aw
        moved = pos + h * vel_h
        r = torch.fmod(moved, L)
        # positions are held in the stated precision, as the program holds them
        pos = q(torch.where(per, torch.where(r < 0, r + L, r), moved).to(g.store).to(pos.dtype))
        fc, tc = contact_forces(c, g, pos, vel_h, ang_h, radius, active)
        fc, tc = q(fc), q(tc)
        a, aw = (fc + f_ext) * inv_m, (tc + hydro_t) * inv_i
        vel = q(vel_h + 0.5 * h * a)
        angvel = q(ang_h + 0.5 * h * aw)
    return pos, vel, angvel, fc, tc


# ---------------------------------------------------------------------------
# The fluid: kEqn and PIMPLE
# ---------------------------------------------------------------------------

def keqn(c: dict, g: Grid, st: dict, alpha, alpha_old, dt: float):
    """One explicit kEqn update with the Patankar sink; -> (k, nut)."""
    tc = c["turbulence"]
    nu = c["transport"]["nu"]
    u, phi = st["u"], st["phi"]
    G = grad(pad(u, U_BC), g)
    S = 0.5 * (G + G.transpose(0, 1))
    S2 = 2.0 * torch.sum(S * S, dim=(0, 1))
    alpha_f = faces(pad(alpha, NEU))
    phi_alpha = tuple(alpha_f[a] * phi[a] for a in range(3))
    delta = g.vc ** (1.0 / 3.0)
    k = torch.clamp(st["k"], min=tc["k_min"])
    nut = st["nut"]
    kp = pad(k, NEU)
    conv = div_phi(phi_alpha, kp, g, upwind=True)
    diff = lap_faces(faces(pad(alpha * (nu + nut), NEU)), kp, g)
    k_new = (alpha_old * k + dt * (alpha * nut * S2 - conv + diff)) / (
        torch.clamp(alpha, min=1e-3) * (1.0 + dt * tc["ce"] * torch.sqrt(k) / delta))
    k_new = torch.clamp(k_new, min=tc["k_min"])
    return k_new, torch.clamp(tc["ck"] * delta * torch.sqrt(k_new), 0.0, tc["nut_max"])


def _mean_inverse(gamma, g: Grid):
    """The exact inverse of div(gbar grad .) with each axis' mean face
    coefficient, periodic x and y (FFT) and zero-gradient z (orthonormal
    cosine transform); zero on the constant mode."""
    dev, dt_ = gamma[0].device, gamma[0].dtype
    nx, ny, nz = g.shape
    gbar = [float(torch.mean(gamma[a].double())) for a in range(3)]
    lam_x = (2.0 * np.cos(2.0 * np.pi * np.arange(nx) / nx) - 2.0) / g.h[0] ** 2
    lam_y = (2.0 * np.cos(2.0 * np.pi * np.arange(ny) / ny) - 2.0) / g.h[1] ** 2
    kz = np.arange(nz)
    lam_z = (2.0 * np.cos(np.pi * kz / nz) - 2.0) / g.h[2] ** 2
    qz = np.cos(np.pi * kz[None, :] * (np.arange(nz)[:, None] + 0.5) / nz)
    qz /= np.linalg.norm(qz, axis=0, keepdims=True)
    lam = (gbar[0] * lam_x[:, None, None] + gbar[1] * lam_y[None, :, None]
           + gbar[2] * lam_z[None, None, :])
    small = np.abs(lam) < 1e-12 * np.abs(lam).max()
    inv = torch.as_tensor(np.where(small, 0.0, 1.0 / np.where(small, 1.0, lam)), dtype=dt_,
                          device=dev)
    qz = torch.as_tensor(qz, dtype=dt_, device=dev)

    def apply(r):
        t = torch.fft.fft2(torch.einsum("xyz,zk->xyk", r, qz), dim=(0, 1))
        t = torch.fft.ifft2(t * inv, dim=(0, 1)).real
        return torch.einsum("xyk,zk->xyz", t, qz)

    return apply


def solve_pressure(gamma, rhs, p0, g: Grid, tol: float, maxiter: int = 500):
    """div(gamma grad p) = rhs with zero-gradient z walls: the mean of rhs
    removed, the mean of p pinned to 0. CG on the negated (positive
    semi-definite) system, preconditioned by the mean-coefficient inverse,
    the residual kept mean-free, until |r| <= tol |b|."""
    b = -(rhs - rhs.mean())
    x = p0 - p0.mean()
    M = _mean_inverse(gamma, g)

    def A(v):                          # the negated operator, positive
        return -lap_faces(gamma, pad(v, P_BC), g)

    r = b - A(x)
    r = r - r.mean()
    z = -M(r)
    d = z
    rz = torch.sum(r * z)
    bnorm = float(torch.linalg.vector_norm(b))
    for _ in range(maxiter):
        if float(torch.linalg.vector_norm(r)) <= tol * bnorm or not float(rz) > 0.0:
            break
        Ad = A(d)
        step = rz / torch.sum(d * Ad)
        x = x + step * d
        r = r - step * Ad
        r = r - r.mean()
        z = -M(r)
        rz_new = torch.sum(r * z)
        d = z + (rz_new / rz) * d
        rz = rz_new
    return x - x.mean()


def pimple(c: dict, g: Grid, st: dict, alpha, alpha_old, u_source, u_source_drag, nut,
           dt: float, tol: float, q):
    """One PIMPLE step (one outer loop, explicit convection and stress, the
    drag and continuity terms in the diagonal, body forces through the face
    flux). -> (u, p, phi)."""
    nu = c["transport"]["nu"]
    gvec = c["gravity_fluid"]
    u, p, phi = st["u"], st["p"], st["phi"]
    alpha_f = faces(pad(alpha, NEU))
    phi_alpha = tuple(alpha_f[a] * phi[a] for a in range(3))
    ddt_alpha = (alpha - alpha_old) / dt
    sp_cont = ddt_alpha + div_faces(phi_alpha, g)
    nu_eff = nu + nut
    up = pad(u, U_BC)
    conv = div_phi(phi_alpha, up, g, upwind=False)
    visc = lap_faces(faces(pad(alpha * nu_eff, NEU)), up, g)
    G = grad(up, g)
    div_u = G[0, 0] + G[1, 1] + G[2, 2]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)[:, :, None, None, None]
    C = (alpha * nu_eff) * (G.transpose(0, 1) - (2.0 / 3.0) * div_u * eye)
    visc = visc + torch.stack([sum(grad(pad(C[i, j], NEU), g)[j] for j in range(3))
                               for i in range(3)])
    A = alpha / dt - sp_cont - u_source_drag
    H = alpha_old * u / dt - conv + visc
    rAU = 1.0 / A
    rAU_f = faces(pad(rAU, NEU))
    force_flux = tuple(_avg(_strip(pad(rAU * u_source[a], NEU), a), a) for a in range(3))
    phic = tuple(force_flux[a] + rAU_f[a] * gvec[a] for a in range(3))
    HbyA = rAU[None] * H
    gamma_p = tuple(alpha_f[a] * rAU_f[a] for a in range(3))
    hp = pad(HbyA, U_BC)
    phi_h = [_avg(_strip(hp[a], a), a) + phic[a] for a in range(3)]
    for a in range(3):                  # no flux through the walls
        if not PERIODIC[a]:
            n = phi_h[a].shape[a]
            keep = torch.ones(n, dtype=u.dtype, device=u.device)
            keep[0] = keep[-1] = 0.0
            phi_h[a] = phi_h[a] * keep.reshape([-1 if i == a else 1 for i in range(3)])
    rhs = ddt_alpha + div_faces(tuple(alpha_f[a] * phi_h[a] for a in range(3)), g)
    for _ in range(c["pimple"]["n_correctors"]):
        p = q(solve_pressure(gamma_p, rhs, p, g, tol))
        pflux = tuple(rAU_f[a] * s for a, s in enumerate(face_grad(pad(p, P_BC), g)))
        phi = tuple(q(phi_h[a] - pflux[a]) for a in range(3))
        u = q(HbyA + rAU[None] * reconstruct(tuple((phic[a] - pflux[a]) / rAU_f[a]
                                                   for a in range(3))))
    return u, p, phi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _rounder(store):
    if store is None:
        return lambda x: x
    return lambda x: x.to(store).to(x.dtype)


def initial_fields(config: dict, pos, radius, dtype=torch.float64, store=None):
    """The start of a run from particles at rest in fluid at rest: the
    volume fraction and particle velocity field of the first exchange.
    -> dict."""
    check_supported(config)
    c = config["case"]
    g = Grid(c, config["precision"])
    q = _rounder(store)
    dev = pos.device
    n = pos.shape[0]
    st = {"u": torch.zeros((3,) + g.shape, dtype=dtype, device=dev),
          "p": torch.zeros(g.shape, dtype=dtype, device=dev),
          "alpha": torch.ones(g.shape, dtype=dtype, device=dev),
          "pos": q(pos.to(dtype)), "vel": torch.zeros((n, 3), dtype=dtype, device=dev),
          "radius": radius.to(dtype), "active": torch.ones(n, dtype=torch.bool, device=dev)}
    _, _, alpha, u_particle, _, _ = exchange(c, g, st)
    return {"alpha": q(alpha), "u_particle": q(u_particle)}


def face_ties(pos, g: Grid, ulps: int = TIE_ULPS):
    """The particles whose position, held in the stated precision, lies
    within ``ulps`` roundings of a cell face: a position that differs from
    this one in its last bits, as the program's may after a few steps, can
    lie in the neighbouring cell. -> (particle, axis, delta) int64 tensors,
    delta the shift of the cell that puts the particle across the face."""
    q = torch.tensor(g.h, dtype=g.store, device=pos.device)
    p = pos.to(g.store)
    base = torch.floor(p / q)
    lo, hi = p, p
    for _ in range(ulps):
        lo = torch.nextafter(lo, torch.full_like(lo, -math.inf))
        hi = torch.nextafter(hi, torch.full_like(hi, math.inf))
    below = torch.floor(lo / q) != base
    above = torch.floor(hi / q) != base
    i_b, a_b = torch.nonzero(below, as_tuple=True)
    i_a, a_a = torch.nonzero(above, as_tuple=True)
    return (torch.cat([i_b, i_a]), torch.cat([a_b, a_a]),
            torch.cat([torch.full_like(i_b, -1), torch.ones_like(i_a)]))


def run_chunk(config: dict, state: dict, n_steps: int, store=None, shift=None):
    """n_steps coupled steps from ``state`` (dict as in the module's
    docstring, every float tensor in one dtype): the exchange, the DEM
    substeps under its force, kEqn and PIMPLE, the pressure solved to a
    relative residual of 1e-10 in float64 (1e-6 otherwise). Returns a new
    dict, with ``"ties"``: for each step after the first, (step,
    `face_ties` of its exchange's positions). ``shift`` = (step, particle,
    axis, delta) locates that particle one cell over in that step's
    exchange, as a position one rounding across the face would."""
    check_supported(config)
    tol = 1e-10 if state["u"].dtype == torch.float64 else 1e-6
    c = config["case"]
    g = Grid(c, config["precision"])
    q = _rounder(store)
    st = {k: (q(v) if torch.is_tensor(v) and v.is_floating_point() else v)
          for k, v in state.items()}
    st["phi"] = tuple(q(f) for f in state["phi"])
    dt = float(state["dt"])
    ties = []
    for j in range(n_steps):
        if j > 0:
            ties.append((j,) + face_ties(st["pos"], g))
        here = shift[1:] if shift is not None and shift[0] == j else None
        force, torque, alpha, u_particle, u_source, u_source_drag = (
            q(x) for x in exchange(c, g, dict(st, cell_shift=here)))
        alpha_old = st["alpha"]
        pos, vel, angvel, fc, tc = dem_substeps(c, g, st, force, torque, dt, q)
        k, nut = (q(x) for x in keqn(c, g, st, alpha, alpha_old, dt))
        u, p, phi = pimple(c, g, st, alpha, alpha_old, u_source, u_source_drag, nut, dt,
                           tol, q)
        st = dict(st, u=u, p=p, phi=phi, alpha=alpha, alpha_old=alpha_old, k=k, nut=nut,
                  pos=pos, vel=vel, angvel=angvel, contact_f=fc, contact_t=tc,
                  u_particle=u_particle, u_source=u_source, u_source_drag=u_source_drag)
    st["ties"] = ties
    return st
