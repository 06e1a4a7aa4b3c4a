"""The coupled CFD-DEM time step (port of the main path of
`yade_openfoam_coupling_tpu/models/coupled.py`).

One coupled step: Courant number and adaptive dt, the coupling inputs,
the exchange (Gaussian: sparse, window, planes or slots, the sparse one
in particle chunks under ``particle_chunks > 1``, the planes one in
x-slabs under ``planes_chunks > 1``; or the point-force one), the DEM substeps (on
the frozen Verlet list, on a persistent list rebuilt when the drift since
its build eats the skin margin, on one list built per step, or on all
pairs; with the tangential spring history under ``shear_history``, and a
substep count that follows the Rayleigh critical dt under
``dynamic_substeps``, a zero-dt tail up to ``n_dem_substeps``), then the
fluid: PISO, or the turbulence correction (laminar, kEqn, Smagorinsky
or kEpsilon) and PIMPLE (explicit or implicit diffusion), both with the
masked-cell obstacles of ``CaseConfig.solid`` (their masks built once per
device); then the diagnostics. The adaptive fluid dt is capped by the
explicit-diffusion bound (not under implicit diffusion) and clamped to
``n_dem_substeps`` critical dts under ``enforce_critical_dt`` or
``dynamic_substeps``.
`make_step_fn` runs one step; `make_scan_fn` runs the steps as a Python
loop, in chunks of [one Verlet-list rebuild -> K frozen-list steps] under
``list_reuse``, and stacks the per-step diagnostics along a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import coupling as cp
from ..ops import dem as demod
from ..ops import obstacle as ob
from ..ops import stencil as st
from ..ops.coupling_planes import (
    gaussian_coupling_planes,
    gaussian_coupling_planes_chunked,
)
from ..ops.coupling_slots import gaussian_coupling_slots
from ..ops.coupling_window import gaussian_coupling_window
from ..ops.grid import FieldBC, Grid
from ..utils.diagnostics import (
    TimeControls,
    continuity_errors,
    courant,
    diffusive_dt_bound,
    new_dt,
)
from . import turbulence as turb_mod
from .fields import FluidState, ParticleState, SimState, StepDiagnostics, TurbulenceState
from .pimple import PIMPLEConfig, pimple_step
from .piso import FluidBCs, PISOConfig, piso_step

_NEU = FieldBC.uniform("neumann")


@dataclasses.dataclass(frozen=True)
class TransportProperties:
    """`transportProperties`: nu, particle and fluid densities."""

    nu: float = 1e-6
    rho_f: float = 1000.0
    rho_p: float = 2500.0


@dataclasses.dataclass(frozen=True)
class CaseConfig:
    """Full static configuration of a coupled case; same fields and
    defaults as the JAX package's `CaseConfig`."""

    grid: Grid
    bcs: FluidBCs
    transport: TransportProperties = TransportProperties()
    solver: str = "piso"
    coupling: cp.CouplingConfig = cp.CouplingConfig(gaussian=False)
    dem: demod.DEMConfig = demod.DEMConfig()
    piso: PISOConfig = PISOConfig()
    pimple: PIMPLEConfig = PIMPLEConfig()
    turbulence: turb_mod.TurbulenceConfig = turb_mod.TurbulenceConfig()
    time: TimeControls = TimeControls()
    n_dem_substeps: int = 10
    r_max: float = 1e-3
    gravity_fluid: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sampled_diagnostics: bool = False
    solid: object = dataclasses.field(default=None, compare=False)

    def periodic_axes(self):
        return self.bcs.periodic_axes()

    def obstacle_masks(self, device):
        """The ObstacleMasks of `solid` on ``device``, or None. They are
        built once per device and reused by every later call, as the JAX
        package folds them into its program once. They are kept in the
        instance's dict, beside its fields, so a config with another
        `solid` (``dataclasses.replace``) starts with none built. Edit no
        `solid` array in place after its first step."""
        if self.solid is None:
            return None
        built = self.__dict__.setdefault("_obstacle_masks", {})
        key = str(torch.device(device))
        if key not in built or built[key][0] is not self.solid:
            built[key] = (self.solid, ob.build_masks(self.solid, self.bcs.periodic_axes(), device))
        return built[key][1]

    def wall_layers(self, device, slab=None):
        """The kEpsilon wall functions' (mask, y) of `grid` and `bcs` on
        ``device`` (`turbulence.wall_layers`), built once per device and
        kept beside the fields, as `obstacle_masks` are. ``slab`` = (x
        start, planes) cuts them to one rank's x-slab; the entry is keyed
        by the slab too, so ranks that share a card never share it."""
        built = self.__dict__.setdefault("_wall_layers", {})
        key = (str(torch.device(device)), slab)
        if key not in built:
            mask, y = turb_mod.wall_layers(self.grid, self.bcs, device)
            if slab is not None:
                mask, y = mask[slab[0]:slab[0] + slab[1]], y[slab[0]:slab[0] + slab[1]]
            built[key] = (mask, y)
        return built[key]


def _slab_of(ctx, field: torch.Tensor):
    """(x start, planes) of this rank's slab under a sharded ctx, else None."""
    if ctx is None or ctx.mesh_axes[0] is None:
        return None
    n_loc = field.shape[0]
    return (ctx.shard_index(0) * n_loc, n_loc)


def _check_supported(cfg: CaseConfig) -> None:
    """Raise for configurations no step can run, before the first step."""
    if cfg.solver not in ("piso", "pimple"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    if cfg.coupling.gaussian and cfg.coupling.exchange not in (
            "sparse", "window", "planes", "slots"):
        raise ValueError(f"unknown coupling exchange {cfg.coupling.exchange!r}")


def _coupling_inputs(fs: FluidState, grid: Grid, bcs: FluidBCs, nu: float, dt,
                     ctx, ccfg: cp.CouplingConfig):
    """The derived grid fields the exchange consumes: grad p and the viscous
    term 2 nu div(alpha_f grad u) (plus curl u / material acceleration when
    torque / added mass are on)."""
    up = ctx.pad_v(fs.u, bcs.u)
    if ccfg.use_torque or not ccfg.gaussian:
        curl_u = st.curl_from_grad(st.grad_vector_padded(up, grid))
    else:
        curl_u = fs.u  # placeholder, never gathered
    grad_p = st.grad_scalar_padded(ctx.pad_s(fs.p, bcs.p), grid)
    alpha_f = st.face_interp_all_padded(ctx.pad_s(fs.alpha, _NEU))
    div_tau = 2.0 * nu * st.laplacian_gamma_vector_padded(alpha_f, up, grid)
    if ccfg.use_added_mass:
        conv = st.div_phi_vector_padded(fs.phi, up, grid)
        ddt_u = (fs.u - fs.u_old) / dt + conv
    else:
        ddt_u = fs.u  # placeholder, never gathered
    return curl_u, grad_p, div_tau, ddt_u


def exchange(fs: FluidState, ps: ParticleState, grid: Grid, bcs: FluidBCs,
             tp: TransportProperties, cfg: cp.CouplingConfig, dt,
             ctx=None) -> cp.CouplingResult:
    """One in-memory coupling exchange (`setParticleAction`), dispatched as
    in the JAX package."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    curl_u, grad_p, div_tau, ddt_u = _coupling_inputs(fs, grid, bcs, tp.nu, dt, ctx, cfg)
    pf = cp.ParticleFields(ps.pos, ps.vel, ps.angvel, ps.radius, ps.active)
    if not cfg.gaussian:
        return cp.point_force_coupling(pf, fs.u, curl_u, grid, bcs.periodic_axes(), tp.nu,
                                       tp.rho_f)
    if cfg.exchange == "planes":
        fn = (gaussian_coupling_planes_chunked if cfg.planes_chunks > 1
              else gaussian_coupling_planes)
    elif cfg.exchange == "window":
        fn = gaussian_coupling_window
    elif cfg.exchange == "slots":
        fn = gaussian_coupling_slots
    elif cfg.particle_chunks > 1:
        fn = cp.gaussian_coupling_chunked
    else:
        fn = cp.gaussian_coupling
    return fn(
        pf, fs.u, grad_p, div_tau, ddt_u, curl_u,
        grid, bcs.periodic_axes(), tp.nu, tp.rho_f, dt, cfg,
        prev_alpha=fs.alpha)


def _rebuild(particles: ParticleState, cfg: CaseConfig, return_overflow: bool = False):
    """Fresh Verlet list; its reference positions are a copy of pos, never
    an alias, so the staleness test reads the drift of later updates. With
    ``return_overflow`` also the build's drop count."""
    nbr, ov = demod.build_neighbor_list(particles.pos, particles.active, cfg.grid,
                                        cfg.dem, cfg.r_max, return_overflow=True)
    particles = particles._replace(nbr=nbr, nbr_ref_pos=particles.pos.clone())
    return (particles, ov) if return_overflow else particles


def initialize_state(fluid: FluidState, particles: ParticleState,
                     turb: TurbulenceState, cfg: CaseConfig, dt: float,
                     t0: float = 0.0) -> SimState:
    """A self-consistent initial SimState: the first Verlet list and carried
    contact force, and one exchange so that alpha and alpha_old reflect the
    initial particles."""
    _check_supported(cfg)
    dev = fluid.p.device
    dt_arr = torch.tensor(dt, dtype=torch.float32, device=dev)
    if cfg.solid is not None:
        # no velocity in solid cells, no flux through blocked faces: the
        # invariants every step keeps
        m = cfg.obstacle_masks(dev)
        fluid = fluid._replace(u=ob.mask_u(fluid.u, m), phi=ob.mask_flux(fluid.phi, m))
    if cfg.dem.shear_history and particles.shear_xi is None:
        # the springs ride the per-substep contact list: the refined
        # compaction's width when it is on
        d = cfg.dem
        m_eff = d.refined_neighbors if 0 < d.refined_neighbors < d.max_neighbors \
            else d.max_neighbors
        sh = demod.make_shear_state(particles.n_capacity, m_eff, dtype=particles.pos.dtype,
                                    device=dev)
        particles = particles._replace(shear_xi=sh.xi, shear_ids=sh.ids,
                                       shear_wall=sh.xi_wall)
    if cfg.dem.list_reuse and particles.nbr is None:
        if cfg.dem.neighbor != "cells":
            raise ValueError("list_reuse requires neighbor='cells'")
        particles = _rebuild(particles, cfg)
    if cfg.dem.carry_contact and particles.contact_f is None:
        if cfg.dem.contact_mode != "substep" or cfg.dem.shear_history:
            raise ValueError("carry_contact requires contact_mode='substep' and no "
                             "shear_history")
        fc0, tc0 = demod.contact_forces(
            particles.pos, particles.vel, particles.angvel, particles.radius,
            particles.active, cfg.grid, cfg.dem, cfg.r_max, nbr=particles.nbr)
        particles = particles._replace(contact_f=fc0, contact_t=tc0)
    cres = exchange(fluid, particles, cfg.grid, cfg.bcs, cfg.transport,
                    cfg.coupling, dt_arr)
    fluid = fluid._replace(alpha=cres.alpha, alpha_old=cres.alpha,
                           u_particle=cres.u_particle)
    if cfg.solver == "pimple" and cfg.pimple.p_extrapolate != 0.0 and fluid.p_prev is None:
        fluid = fluid._replace(p_prev=fluid.p)
    return SimState(
        fluid=fluid, particles=particles, turb=turb,
        t=torch.tensor(t0, dtype=torch.float32, device=dev), dt=dt_arr,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def coupled_step(state: SimState, cfg: CaseConfig, ctx=None, exchange_fn=None,
                 dem_fn=None, fluid_fn=None, frozen_list: bool = False,
                 lite_diag: bool = False) -> Tuple[SimState, StepDiagnostics]:
    """Advance the coupled system one fluid time step.

    ``ctx`` selects single-device or per-rank execution; ``exchange_fn(fs,
    ps, dt)`` replaces the coupling exchange, ``dem_fn(ps, hydro, dt_dem[,
    dt_seq])`` the DEM substeps (the slab-sharded path's owner-rank
    exchange and ghost-refreshing DEM, `parallel/sharded.py`) and
    ``fluid_fn(fs, dt)`` the fluid step. Under particle sharding the
    particle arrays hold only this rank's slab population.

    With a persistent Verlet list (``list_reuse``) and ``frozen_list``
    (`make_scan_fn` rebuilds it per chunk) the list is used as it is and
    particles that drifted past the skin margin since the rebuild count as
    contact overflow. Without ``frozen_list`` the list is rebuilt when the
    largest drift since its build reaches the margin (never with
    ``list_margin_factor < 0``): the JAX package decides that inside its
    program (`lax.cond`); here the decision is one host read, so the step
    synchronises with the card once."""
    from ..parallel.ctx import LOCAL
    ctx = ctx if ctx is not None else LOCAL
    _check_supported(cfg)
    grid, bcs, tp = cfg.grid, cfg.bcs, cfg.transport
    fs, ps, tb = state.fluid, state.particles, state.turb
    dev = fs.p.device
    zero = torch.zeros((), dtype=fs.p.dtype, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)

    # 1. Courant + adaptive dt
    if lite_diag and not cfg.time.adjust_time_step:
        co_mean = co_max = zero
    else:
        co_mean, co_max = courant(fs.phi, grid, state.dt, ctx)
    if cfg.time.adjust_time_step:
        if cfg.solver == "pimple" and cfg.pimple.implicit_diffusion:
            dt_diff = None      # implicit diffusion has no stability bound
        else:
            # PISO's momentum diffusion is laminar: no nut in its bound
            nut_max = ctx.max(torch.amax(tb.nut)) if cfg.solver == "pimple" else 0.0
            dt_diff = diffusive_dt_bound(grid, tp.nu, nut_max)
        dt = new_dt(co_max, state.dt, cfg.time, dt_diff=dt_diff)
        if cfg.dem.enforce_critical_dt or cfg.dem.dynamic_substeps:
            # DEM stability: dt / n_dem_substeps <= the Rayleigh critical dt
            # (with dynamic_substeps only the backstop past the static max)
            dt_c = ctx.min(demod.critical_dt_dynamic(ps.radius, ps.active, cfg.dem.params))
            dt = torch.minimum(dt, cfg.n_dem_substeps * dt_c)
    else:
        dt = state.dt

    # 2-3. coupling exchange
    if exchange_fn is None:
        cres = exchange(fs, ps, grid, bcs, tp, cfg.coupling, dt, ctx)
    else:
        cres = exchange_fn(fs, ps, dt)
    fs = fs._replace(alpha=cres.alpha, alpha_old=fs.alpha, u_source=cres.u_source,
                     u_source_drag=cres.u_source_drag, u_particle=cres.u_particle)

    # 4. DEM substeps under the hydro force of this exchange
    n_sub = cfg.n_dem_substeps
    if cfg.dem.dynamic_substeps:
        # n_eff = ceil(dt / dt_c) substeps of dt / n_eff, then a zero-dt tail
        # up to the static n_sub (no host read of n_eff)
        dt_c = ctx.min(demod.critical_dt_dynamic(ps.radius, ps.active, cfg.dem.params))
        n_eff = torch.clamp(torch.ceil(dt / dt_c).to(torch.int32), 1, n_sub)
        dt_dem = dt / n_eff.to(dt.dtype)
        dt_seq = torch.where(torch.arange(n_sub, device=dev) < n_eff, dt_dem, zero)
    else:
        n_eff = torch.tensor(n_sub, dtype=torch.int32, device=dev)
        dt_dem = dt / n_sub
        dt_seq = None
    hydro = demod.DEMForces(cres.force, cres.torque)
    nbr = None
    n_list_overflow = izero
    if dem_fn is None and cfg.dem.list_reuse:
        if cfg.dem.neighbor != "cells":
            raise ValueError("list_reuse requires neighbor='cells'")
        if ps.nbr is None:
            raise ValueError("initialize_state builds the first Verlet list")
        bin_size = demod.effective_bin_size(grid, cfg.dem, cfg.r_max)
        margin = cfg.dem.list_margin_factor * (bin_size - 2.0 * cfg.r_max)
        if not (margin > 0.0 or cfg.dem.list_margin_factor < 0):
            raise ValueError(f"list_reuse needs skin slack: effective bin size {bin_size:g} "
                             f"<= 2*r_max {2 * cfg.r_max:g}")
        if frozen_list:
            disp = demod.drift_since(ps.pos, ps.nbr_ref_pos, ps.active, grid,
                                     cfg.dem.periodic)
            n_list_overflow = torch.sum((disp >= margin).to(torch.int32))
        elif cfg.dem.list_margin_factor >= 0 and bool(torch.amax(demod.drift_since(
                ps.pos, ps.nbr_ref_pos, ps.active, grid, cfg.dem.periodic)) >= margin):
            ps, n_list_overflow = _rebuild(ps, cfg, return_overflow=True)
        nbr = ps.nbr
    if dem_fn is not None:
        # dt_seq only when dynamic: custom closures keep the 3-argument form
        extra = () if dt_seq is None else (dt_seq,)
        if cfg.dem.shear_history:
            pos, vel, angvel, n_overflow, sh = dem_fn(ps, hydro, dt_dem, *extra)
            ps = ps._replace(shear_xi=sh.xi, shear_ids=sh.ids, shear_wall=sh.xi_wall)
        else:
            pos, vel, angvel, n_overflow = dem_fn(ps, hydro, dt_dem, *extra)
    elif cfg.dem.shear_history:
        pos, vel, angvel, n_overflow, sh = demod.dem_substeps(
            ps.pos, ps.vel, ps.angvel, ps.radius, ps.active, hydro, grid,
            cfg.dem, dt_dem, n_sub, cfg.r_max,
            shear=demod.ShearState(ps.shear_xi, ps.shear_ids, ps.shear_wall),
            pid=ps.pid, nbr=nbr, dt_seq=dt_seq)
        ps = ps._replace(shear_xi=sh.xi, shear_ids=sh.ids, shear_wall=sh.xi_wall)
    elif cfg.dem.carry_contact and cfg.dem.contact_mode == "substep":
        carried = None if ps.contact_f is None else (ps.contact_f, ps.contact_t)
        pos, vel, angvel, n_overflow, fc, tc = demod.dem_substeps(
            ps.pos, ps.vel, ps.angvel, ps.radius, ps.active, hydro, grid,
            cfg.dem, dt_dem, n_sub, cfg.r_max, nbr=nbr, carried=carried, dt_seq=dt_seq)
        ps = ps._replace(contact_f=fc, contact_t=tc)
    else:
        pos, vel, angvel, n_overflow = demod.dem_substeps(
            ps.pos, ps.vel, ps.angvel, ps.radius, ps.active, hydro, grid,
            cfg.dem, dt_dem, n_sub, cfg.r_max, nbr=nbr, dt_seq=dt_seq)
    n_overflow = n_overflow + n_list_overflow
    ps = ps._replace(pos=pos, vel=vel, angvel=angvel)

    # 5. fluid step
    u_prev = fs.u
    masks = cfg.obstacle_masks(dev)
    if fluid_fn is not None:
        fs2, info = fluid_fn(fs, dt)
        tb2 = tb
    elif cfg.solver == "piso":
        fs2, info = piso_step(fs, grid, bcs, tp.nu, dt, cfg.piso, ctx=ctx, masks=masks)
        tb2 = tb
    else:
        tc = cfg.turbulence
        walls = (cfg.wall_layers(dev, _slab_of(ctx, fs.p)) if tc.model == "kEpsilon"
                 and tc.wall_functions else None)
        tb2 = turb_mod.correct(tb, fs, grid, bcs, tp.nu, dt, tc, ctx=ctx, walls=walls)
        g = torch.tensor(cfg.gravity_fluid, dtype=fs.u.dtype, device=dev)
        fs2, info = pimple_step(fs, grid, bcs, tp.nu, tb2.nut, g, dt, cfg.pimple, ctx=ctx,
                                masks=masks)
    fs2 = fs2._replace(u_old=u_prev)
    if fs.p_prev is not None:
        fs2 = fs2._replace(p_prev=fs.p)

    if lite_diag:
        cont_local = cont_global = max_speed = zero
    else:
        cont_local, cont_global = continuity_errors(
            fs2.phi, fs2.alpha, fs2.alpha_old, grid, dt, ctx)
        max_speed = ctx.max(torch.amax(torch.where(
            ps.active, demod._norm3(ps.vel), zero)))
    diag = StepDiagnostics(
        co_mean=co_mean,
        co_max=co_max,
        cont_err_local=cont_local,
        cont_err_global=cont_global,
        p_iters=info.iters,
        p_initial_residual=info.initial_residual,
        p_final_residual=info.final_residual,
        n_found=ctx.sum(torch.sum(cres.found.to(torch.int32))),
        max_particle_speed=max_speed,
        n_contact_overflow=ctx.sum(n_overflow).to(torch.int32),
        n_coupling_overflow=ctx.sum(torch.as_tensor(cres.n_overflow, dtype=torch.int32,
                                                     device=dev)),
        n_shard_overflow=izero,
        n_dem_sub=n_eff,
    )
    new_state = SimState(fluid=fs2, particles=ps, turb=tb2, t=state.t + dt,
                         dt=dt, step=state.step + 1)
    return new_state, diag


def make_step_fn(cfg: CaseConfig):
    """A callable running one coupled step: state -> (state, diags)."""
    _check_supported(cfg)
    return lambda state: coupled_step(state, cfg)


def _stack_diags(diags) -> StepDiagnostics:
    return StepDiagnostics(*[torch.stack(list(xs)) for xs in zip(*diags)])


def make_scan_fn(cfg: CaseConfig, n_steps: int, donate: bool = False):
    """A callable running n_steps coupled steps: state -> (state, diags),
    the diagnostics stacked along a leading step axis. With
    ``dem.list_rebuild_steps = K > 0`` and ``list_reuse`` the steps run in
    chunks of [one Verlet-list rebuild -> K frozen-list steps]; the shear
    springs, like the rest of the particle state, carry from chunk to
    chunk. ``donate`` has no counterpart in eager PyTorch and is accepted
    and ignored."""
    _check_supported(cfg)
    K = cfg.dem.list_rebuild_steps
    chunked = cfg.dem.list_reuse and K > 0 and cfg.dem.neighbor == "cells"
    if chunked:
        n_chunks, rem = divmod(n_steps, K)
        sizes = [K] * n_chunks + ([rem] if rem else [])
    else:
        sizes = [n_steps]

    def run(state: SimState):
        diags = []
        for sz in sizes:
            if chunked:
                state = state._replace(particles=_rebuild(state.particles, cfg))
            for j in range(sz):
                lite = (chunked and cfg.sampled_diagnostics and sz > 1
                        and j < sz - 1)
                state, d = coupled_step(state, cfg, frozen_list=chunked,
                                        lite_diag=lite)
                diags.append(d)
        return state, _stack_diags(diags)

    return run
