"""The port's icoFoam path against the JAX package's: the PISO builders
(`settling_sphere`, `sedimentation_cloud`) and the slice that `icofoam
<case>` builds, each run 4 steps by both packages from the same initial
numpy state; `icofoam` on the port's copy of `example_icoFoamYade`; and the
Stokes terminal velocity of the settling sphere on the port alone."""

import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu import cases as jcases
from yade_openfoam_coupling_tpu import cli as jcli
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops import dem as jdem
from yade_openfoam_coupling_tpu.ops import obstacle as job
from yade_openfoam_coupling_tpu.utils import config as jconfig
from yade_openfoam_coupling_tpu_torch import cases as tcases
from yade_openfoam_coupling_tpu_torch import cli
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.utils import checkpoint as tckpt

CPU = torch.device("cpu")
EXAMPLE = Path(tcases.__file__).parent / "example_icoFoamYade"
BUILDS = {"settling_sphere": dict(n=8), "sedimentation_cloud": dict(n_particles=60, n=12)}


def _close(name, out, ref, rel, atol=1e-30):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + atol, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


def _steps_match(ref_cfg, ref_state, n_found):
    """4 steps of make_scan_fn in both packages from the JAX package's
    state: counters equal step by step, the state within 1e-4 of its scale
    (angular velocities also within 1e-9 rad/s: from rest they are f32
    rounding noise of the curl), continuity errors at rounding level."""
    ref_s, ref_d = jcd.make_scan_fn(ref_cfg, 4)(ref_state)
    out_s, out_d = tcd.make_scan_fn(case_config_from(ref_cfg), 4)(
        state_from_numpy(jax.tree.map(np.asarray, ref_state), CPU))
    for name in ("p_iters", "n_contact_overflow", "n_coupling_overflow", "n_found",
                 "n_dem_sub"):
        np.testing.assert_array_equal(getattr(out_d, name).numpy(),
                                      np.asarray(getattr(ref_d, name)), err_msg=name)
    assert np.all(out_d.n_found.numpy() == n_found)
    ref, out = jax.tree.map(np.asarray, ref_s), state_to_numpy(out_s)
    for name in ("u", "p", "u_source"):
        _close(name, getattr(out.fluid, name), getattr(ref.fluid, name), 1e-4)
    for a in range(3):
        _close(f"phi[{a}]", out.fluid.phi[a], ref.fluid.phi[a], 1e-4)
    for name in ("pos", "vel"):
        _close(name, getattr(out.particles, name), getattr(ref.particles, name), 1e-4)
    _close("angvel", out.particles.angvel, ref.particles.angvel, 1e-4, atol=1e-9)
    assert float(out_d.cont_err_local.max()) < 1e-10 and float(ref_d.cont_err_local.max()) < 1e-10


@pytest.mark.parametrize("name", list(BUILDS))
def test_piso_builder_steps_match_jax(name):
    """The builder's config and initial state equal the JAX package's; 4
    coupled steps of each agree."""
    ref_cfg, ref_state, ref_dt = getattr(jcases, name)(**BUILDS[name])
    cfg, state, dt = getattr(tcases, name)(**BUILDS[name], device=CPU)
    assert case_config_from(ref_cfg) == cfg and dt == ref_dt and cfg.solver == "piso"
    ref, out = jax.tree.map(np.asarray, ref_state), state_to_numpy(state)
    np.testing.assert_array_equal(out.particles.pos, ref.particles.pos)
    np.testing.assert_array_equal(out.fluid.alpha, ref.fluid.alpha)
    assert out.fluid.p_prev is None
    _steps_match(ref_cfg, ref_state, int(ref.particles.active.sum()))


def test_settling_sphere_with_obstacle_steps_match_jax():
    """`settling_sphere(n=8)` with a solid block below the sphere: the
    initial state masked as the JAX package masks it, `solid` carried by
    `case_config_from`, then 4 coupled steps of each agree."""
    ref_cfg, _, ref_dt = jcases.settling_sphere(n=8)
    ref_cfg = dataclasses.replace(ref_cfg, solid=job.box_solid(ref_cfg.grid.shape, (2, 2, 1),
                                                               (6, 6, 3)))
    ref_state = jcd.initialize_state(
        make_fluid_state(ref_cfg.grid), make_particle_state(pos=[[4e-3, 4e-3, 6e-3]],
                                                            radius=50e-6, capacity=4),
        make_turbulence_state(ref_cfg.grid), ref_cfg, dt=ref_dt)
    assert case_config_from(ref_cfg).solid is ref_cfg.solid
    _steps_match(ref_cfg, ref_state, 1)


def _write_box_case(d: Path, n=8, length=0.008):
    """A closed box with no 0/ directory (no-slip walls, zero-gradient p),
    PISO 2 correctors with the momentum predictor, GAMG to tolerance 0."""
    for sub in ("system", "constant"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    L = length
    v = [(0, 0, 0), (L, 0, 0), (L, L, 0), (0, L, 0), (0, 0, L), (L, 0, L), (L, L, L), (0, L, L)]
    (d / "system/blockMeshDict").write_text(
        "convertToMeters 1; vertices ( " + " ".join(f"({a} {b} {c})" for a, b, c in v)
        + f" ); blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} {n}) simpleGrading (1 1 1) );")
    (d / "constant/transportProperties").write_text(
        "nu nu [0 2 -1 0 0 0 0] 1e-06; partDensity 2500; fluidDensity 1000;")
    (d / "system/controlDict").write_text("deltaT 5e-05; endTime 1000; writeInterval 1000;")
    (d / "system/fvSolution").write_text(
        "solvers { p { solver GAMG; tolerance 0; relTol 0; maxIter 200; } }"
        " PISO { nCorrectors 2; momentumPredictor yes; }")
    return d


def test_cli_piso_slice_matches_jax(tmp_path):
    """`icofoam`'s set-up (the JAX package's CLI builds the same config
    inline): point-force coupling with buoyancy, no fluid gravity, PISO
    with mgpcg; then 4 steps of it in both packages with 120 random
    particles (all-pairs DEM)."""
    case = _write_box_case(tmp_path)
    args = cli.build_parser().parse_args(
        ["icofoam", str(case), "--device", "cpu", "--random-particles", "120", "--radius",
         "2e-4", "--kn", "100", "--dem-substeps", "4"])
    cfg, state, rc = cli.setup(args, "piso")
    ref_cfg, ref_rc = jconfig.load_case(
        case, solver="piso", coupling=jcp.CouplingConfig(gaussian=False),
        dem_cfg=jdem.DEMConfig(params=jdem.ContactParams(kn=100.0, rho_p=2500.0),
                               gravity=(0.0, 0.0, -9.81), buoyancy=True, neighbor="allpairs"),
        n_dem_substeps=4, r_max=2e-4)
    ref_cfg = dataclasses.replace(ref_cfg, dem=dataclasses.replace(
        ref_cfg.dem, params=dataclasses.replace(ref_cfg.dem.params,
                                                rho_p=ref_cfg.transport.rho_p),
        rho_f=ref_cfg.transport.rho_f, periodic=ref_cfg.periodic_axes(),
        wall_axes=tuple(not p for p in ref_cfg.periodic_axes())))
    assert case_config_from(ref_cfg) == cfg and config_from(ref_rc) == rc
    assert cfg.gravity_fluid == (0.0, 0.0, 0.0) and cfg.piso.n_correctors == 2
    assert cfg.piso.pressure.solver == "mgpcg" and cfg.bcs == tcd.FluidBCs.box_noslip()
    assert int(state.particles.active.sum()) == 120
    pos = jcli._load_particles(args, ref_cfg.grid)
    ref_state = jcd.initialize_state(make_fluid_state(ref_cfg.grid),
                                     make_particle_state(pos=pos, radius=2e-4),
                                     make_turbulence_state(ref_cfg.grid, k0=1e-6),
                                     ref_cfg, dt=rc.dt)
    _steps_match(ref_cfg, ref_state, 120)


def test_icofoam_example_case_on_the_cpu(tmp_path, capsys):
    """`icofoam` on the port's copy of example_icoFoamYade: rc 0, `End`,
    the time directory and the checkpoint written."""
    case = Path(shutil.copytree(EXAMPLE, tmp_path / "case"))
    base = ["icofoam", str(case), "--device", "cpu", "--radius", "5e-5", "--chunk", "11",
            "--max-steps", "22"]
    assert cli.main(base + ["--write", "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    assert "End (22 steps" in capsys.readouterr().out
    assert [p.name for p in case.glob("0.*")] == ["0.0044"]
    assert (case / "0.0044" / "U").exists() and (case / "constant/polyMesh/owner").exists()
    assert tckpt.latest_step(tmp_path / "ck") == 22


def test_settling_sphere_terminal_velocity():
    """The settling sphere on the port alone at 16^3, 60 steps: its
    velocity within 5% of Stokes' v_t = (rho_p - rho_f) V g / (3 pi d mu)
    (as tests/test_coupled.py holds the JAX package), found every step, a
    downward wake in the fluid."""
    cfg, state, _ = tcases.settling_sphere(device=CPU)
    state, diags = tcd.make_scan_fn(cfg, 60)(state)
    r, tp = 50e-6, cfg.transport
    v_t = (tp.rho_p - tp.rho_f) * (4.0 / 3.0 * np.pi * r ** 3) * 9.81 / (
        3 * np.pi * 2 * r * tp.nu * tp.rho_f)
    np.testing.assert_allclose(-float(state.particles.vel[0, 2]), v_t, rtol=0.05)
    assert bool((diags.n_found == 1).all())
    assert bool(torch.isfinite(state.fluid.u).all()) and float(state.fluid.u[2].min()) < 0.0
