"""The port's front door against the JAX package's: the foamdict parser,
`load_case` on a case directory, the slice the `pimplefoam` CLI builds
(sparse exchange, mgpcg, all-pairs or per-step Verlet DEM) run 4 steps
by both packages from the same initial numpy state, the time-directory
writer, checkpoints and the CLI itself (on the CPU)."""

import dataclasses
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu import cli as jcli
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.fields import (
    SimState,
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
)
from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops import dem as jdem
from yade_openfoam_coupling_tpu.utils import checkpoint as jckpt
from yade_openfoam_coupling_tpu.utils import config as jconfig
from yade_openfoam_coupling_tpu.utils import foamdict as jfd
from yade_openfoam_coupling_tpu_torch import cli
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.utils import checkpoint as tckpt
from yade_openfoam_coupling_tpu_torch.utils import config as tconfig
from yade_openfoam_coupling_tpu_torch.utils import foamdict as tfd

DICTS = [
    """// a comment
    FoamFile { version 2.0; format ascii; object controlDict; }
    application icoFoamYade;   /* inline */
    deltaT 1e-05; endTime 0.5; adjustTimeStep yes; maxCo 0.8; writeInterval 20;""",
    """nu              nu [ 0 2 -1 0 0 0 0 ] 1e-06;
    partDensity     partDensity [1 -3 0 0 0 0 0] 2650.0;
    g               (0 0 -9.81);
    value           uniform (1 2 3);""",
    """solvers { p { solver GAMG; tolerance 1e-06; relTol 0.05; } U { solver smoothSolver; } }
    PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; }""",
    """vertices ( (0 0 0) (0.008 0 0) (0.008 0.008 0) (0 0.008 0)
     (0 0 0.008) (0.008 0 0.008) (0.008 0.008 0.008) (0 0.008 0.008) );
     blocks ( hex (0 1 2 3 4 5 6 7) (8 8 8) simpleGrading (1 1 1) );""",
    """boundaryField { top { type fixedValue; value uniform (0 0 0); }
     bottom { type noSlip; } left { type cyclic; } right { type cyclic; } }""",
    "simulationType RAS; RAS { RASModel kEpsilon; turbulence on; }",
]


@pytest.mark.parametrize("i", range(len(DICTS)))
def test_foamdict_parse_matches_jax(i):
    text = textwrap.dedent(DICTS[i])
    assert tfd.parse(text) == jfd.parse(text)
    assert tfd.tokenize(text) == jfd.tokenize(text)


def write_case(d: Path, n=16, length=0.016, solver="GAMG", turbulence="LES",
               write_interval=1000):
    """A channel case directory: one hex block, cyclic x/y, no-slip z walls
    (zero-gradient p there), gravity -z, PIMPLE 1 outer x 2 correctors."""
    for sub in ("system", "constant", "0"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    L = length
    v = [(0, 0, 0), (L, 0, 0), (L, L, 0), (0, L, 0), (0, 0, L), (L, 0, L), (L, L, L), (0, L, L)]
    (d / "system/blockMeshDict").write_text(
        "convertToMeters 1; vertices ( " + " ".join(f"({a} {b} {c})" for a, b, c in v)
        + f" ); blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} {n}) simpleGrading (1 1 1) );")
    cyc = " ".join(f"{p} {{ type cyclic; }}" for p in ("left", "right", "front", "back"))
    (d / "0/U").write_text(f"boundaryField {{ {cyc} bottom {{ type noSlip; }} "
                           "top { type noSlip; } }")
    (d / "0/p").write_text(f"boundaryField {{ {cyc} bottom {{ type zeroGradient; }} "
                           "top { type zeroGradient; } }")
    (d / "constant/transportProperties").write_text(
        "nu nu [0 2 -1 0 0 0 0] 1e-06; partDensity 2500; fluidDensity 1000;")
    (d / "constant/g").write_text("dimensions [0 1 -2 0 0 0 0]; value (0 0 -9.81);")
    (d / "constant/turbulenceProperties").write_text(
        "simulationType LES; LES { LESModel kEqn; }" if turbulence == "LES"
        else "simulationType RAS; RAS { RASModel kEpsilon; turbulence on; }")
    (d / "system/controlDict").write_text(
        f"deltaT 5e-05; endTime 1000; writeInterval {write_interval}; maxCo 0.5;")
    (d / "system/fvSolution").write_text(
        f"solvers {{ p {{ solver {solver}; tolerance 0; relTol 0; maxIter 200; }} }}"
        " PIMPLE { nOuterCorrectors 1; nCorrectors 2; }"
        " relaxationFactors { equations { \"U.*\" 0.7; } fields { p 0.3; } }")
    return d


@pytest.mark.parametrize("solver,turbulence", [("GAMG", "LES"), ("PCG", "RAS"),
                                               ("FFTPCG", "LES")])
def test_load_case_matches_jax(tmp_path, solver, turbulence):
    """config_from(the JAX package's load_case) equals the port's, for the
    run controls and for the whole CaseConfig."""
    case = write_case(tmp_path, solver=solver, turbulence=turbulence)
    for s in ("pimple", "piso"):
        ref_cfg, ref_rc = jconfig.load_case(case, solver=s)
        cfg, rc = tconfig.load_case(case, solver=s)
        assert config_from(ref_rc) == rc
        assert case_config_from(ref_cfg) == cfg
    assert cfg.pimple.pressure.solver == {"GAMG": "mgpcg", "PCG": "pcg",
                                          "FFTPCG": "fftpcg"}[solver]


CLI_ARGS = ["--random-particles", "200", "--radius", "4e-4", "--kn", "100",
            "--dem-substeps", "4", "--chunk", "4"]


def _jax_cli_config(args):
    """The JAX package's CLI configuration for `pimplefoam` without --fast
    (cli.py:55-97, which builds it inline)."""
    dem_cfg = jdem.DEMConfig(
        params=jdem.ContactParams(kn=args.kn, restitution=args.restitution,
                                  friction=args.friction, rho_p=2500.0),
        gravity=(0.0, 0.0, -9.81), buoyancy=False,
        neighbor="cells" if (args.random_particles or 0) > 4000 else "allpairs")
    cfg, rc = jconfig.load_case(args.case, solver="pimple",
                                coupling=jcp.CouplingConfig(gaussian=True), dem_cfg=dem_cfg,
                                n_dem_substeps=args.dem_substeps, r_max=args.radius)
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, params=dataclasses.replace(cfg.dem.params, rho_p=cfg.transport.rho_p),
        rho_f=cfg.transport.rho_f, periodic=cfg.periodic_axes(),
        wall_axes=tuple(not p for p in cfg.periodic_axes())))
    return cfg, rc


def _close(name, out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= rel * scale + 1e-30, (
        name, np.abs(out - ref).max() / max(scale, 1e-30))


@pytest.fixture(scope="module")
def cli_slices(tmp_path_factory):
    """The slice the CLI builds on a 16^3 channel with 200 random particles
    (all-pairs DEM), and the same configuration with neighbor="cells" (one
    Verlet list per step), each run 4 steps by both packages from the same
    initial numpy state."""
    case = write_case(tmp_path_factory.mktemp("case"))
    args = cli.build_parser().parse_args(["pimplefoam", str(case), "--device", "cpu", *CLI_ARGS])
    cfg, state, rc = cli.setup(args, "pimple")
    ref_cfg, ref_rc = _jax_cli_config(args)
    out = {"config": (cfg, rc, ref_cfg, ref_rc)}
    pos = jcli._load_particles(args, ref_cfg.grid)
    for neighbor in ("allpairs", "cells"):
        jc = dataclasses.replace(ref_cfg, dem=dataclasses.replace(ref_cfg.dem,
                                                                  neighbor=neighbor))
        parts = (make_fluid_state(jc.grid), make_particle_state(pos=pos, radius=args.radius),
                 make_turbulence_state(jc.grid, k0=1e-6))
        s0 = jcd.initialize_state(*parts, jc, dt=rc.dt)
        raw = jax.tree.map(np.asarray, SimState(*parts, t=np.float32(0),
                                                dt=np.float32(rc.dt), step=np.int32(0)))
        t = state_from_numpy(raw, torch.device("cpu"))
        tc = case_config_from(jc)
        t0 = tcd.initialize_state(t.fluid, t.particles, t.turb, tc, dt=rc.dt)
        ref_s, ref_d = jcd.make_scan_fn(jc, 4)(s0)
        out_s, out_d = tcd.make_scan_fn(tc, 4)(t0)
        out[neighbor] = (jax.tree.map(np.asarray, ref_s), jax.tree.map(np.asarray, ref_d),
                         state_to_numpy(out_s), {k: v.numpy() for k, v in
                                                 out_d._asdict().items()})
    out["cli_state"] = state
    return out


def test_cli_setup_builds_the_jax_cli_config(cli_slices):
    cfg, rc, ref_cfg, ref_rc = cli_slices["config"]
    assert case_config_from(ref_cfg) == cfg
    assert config_from(ref_rc) == rc
    assert cfg.coupling.exchange == "sparse" and cfg.dem.neighbor == "allpairs"
    assert cfg.pimple.pressure.solver == "mgpcg"
    assert int(cli_slices["cli_state"].particles.active.sum()) == 200


@pytest.mark.parametrize("neighbor", ["allpairs", "cells"])
def test_cli_slice_matches_jax(cli_slices, neighbor):
    """Counters equal step by step (pressure iterations, overflows, found);
    the state and diagnostics within 1e-4 of their scale after 4 steps."""
    ref_s, ref_d, out_s, out_d = cli_slices[neighbor]
    for name in ("p_iters", "n_contact_overflow", "n_coupling_overflow", "n_found",
                 "n_dem_sub"):
        np.testing.assert_array_equal(out_d[name], np.asarray(getattr(ref_d, name)),
                                      err_msg=name)
    assert np.all(out_d["n_found"] == 200)
    for name in ("u", "p", "alpha", "alpha_old", "u_source", "u_source_drag", "u_particle"):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), 1e-4)
    for a in range(3):
        _close(f"phi[{a}]", out_s.fluid.phi[a], ref_s.fluid.phi[a], 1e-4)
    for name in ("pos", "vel", "angvel"):
        _close(name, getattr(out_s.particles, name), getattr(ref_s.particles, name), 1e-4)
    for name in ("k", "nut"):
        _close(name, getattr(out_s.turb, name), getattr(ref_s.turb, name), 1e-4)
    for name in ("co_max", "p_initial_residual", "max_particle_speed"):
        _close(name, out_d[name], np.asarray(getattr(ref_d, name)), 1e-3)


CLOSURES = {"kEpsilon": "simulationType RAS; RAS { RASModel kEpsilon; turbulence on; }",
            "Smagorinsky": "simulationType LES; LES { LESModel Smagorinsky; }"}


@pytest.mark.parametrize("model", ["kEpsilon", "Smagorinsky"])
def test_cli_closures_match_jax(tmp_path, model):
    """A RAS kEpsilon and an LES Smagorinsky case with adjustTimeStep yes
    (16^3, 200 random particles): the port's `pimplefoam` runs 4 steps on
    the CPU (rc 0), and the configuration the CLI builds, run 4 steps by
    both packages from the same initial numpy state, gives the same dt
    sequence (within 1e-6) and pressure iterations, and the state within
    1e-4 of its scale. kEpsilon starts from k = 1e-6, eps = 0 (clamped to
    1e-12): nut = 0.09 m^2/s after the first correction, whose explicit
    PIMPLE step is unstable (the fluid's state agrees to 1e-2 of its scale
    after it); its dt falls to the explicit-diffusion bound h^2/(6 nu_eff)
    from the second step on, in both packages."""
    case = write_case(tmp_path / "case")
    (case / "constant/turbulenceProperties").write_text(CLOSURES[model])
    (case / "system/controlDict").write_text(
        "deltaT 5e-05; endTime 1000; writeInterval 1000; adjustTimeStep yes; maxCo 0.5;")
    argv = ["pimplefoam", str(case), "--device", "cpu", *CLI_ARGS]
    assert cli.main(argv + ["--max-steps", "4"]) == 0
    args = cli.build_parser().parse_args(argv)
    cfg, _, rc = cli.setup(args, "pimple")
    ref_cfg, ref_rc = _jax_cli_config(args)
    assert case_config_from(ref_cfg) == cfg
    assert cfg.turbulence.model == model and cfg.time.adjust_time_step
    pos = jcli._load_particles(args, ref_cfg.grid)
    parts = (make_fluid_state(ref_cfg.grid), make_particle_state(pos=pos, radius=args.radius),
             make_turbulence_state(ref_cfg.grid, k0=1e-6))
    s0 = jcd.initialize_state(*parts, ref_cfg, dt=ref_rc.dt)
    raw = jax.tree.map(np.asarray, SimState(*parts, t=np.float32(0), dt=np.float32(ref_rc.dt),
                                            step=np.int32(0)))
    t = state_from_numpy(raw, torch.device("cpu"))
    t0 = tcd.initialize_state(t.fluid, t.particles, t.turb, cfg, dt=rc.dt)
    dts = {"ref": [], "out": []}
    ref_s, out_s = s0, t0
    for _ in range(4):
        ref_s, ref_d = jcd.make_step_fn(ref_cfg)(ref_s)
        out_s, out_d = tcd.make_step_fn(cfg)(out_s)
        dts["ref"].append(float(ref_s.dt))
        dts["out"].append(float(out_s.dt))
        assert int(out_d.p_iters) == int(ref_d.p_iters)
    np.testing.assert_allclose(dts["out"], dts["ref"], rtol=1e-6)
    if model == "kEpsilon":
        nut = float(out_s.turb.nut.max())
        assert dts["out"][-1] <= 1.05 * (1e-3 ** 2) / (6 * (1e-6 + nut))
    ref_s, out_s = jax.tree.map(np.asarray, ref_s), state_to_numpy(out_s)
    # the first kEpsilon step is explicit at nu_eff dt / h^2 ~ 4.5 per axis:
    # it amplifies the fluid's last-bit differences, and u grows past 1 m/s
    # in both packages
    rel = 1e-2 if model == "kEpsilon" else 1e-4
    if model == "kEpsilon":
        assert np.abs(ref_s.fluid.u).max() > 1.0 and np.abs(out_s.fluid.u).max() > 1.0
    for name in ("u", "p", "alpha"):
        _close(name, getattr(out_s.fluid, name), getattr(ref_s.fluid, name), rel)
    for name in ("k", "nut") + (("epsilon",) if model == "kEpsilon" else ()):
        _close(name, getattr(out_s.turb, name), getattr(ref_s.turb, name), rel)


def _np_state(seed=0):
    """A small numpy SimState with every optional field the runs carry."""
    from yade_openfoam_coupling_tpu.ops.grid import Grid
    grid = Grid.box((6, 5, 4), (0.006, 0.005, 0.004))
    rng = np.random.RandomState(seed)
    ps = make_particle_state(pos=rng.uniform(0, 0.004, (7, 3)), radius=4e-4, capacity=9)
    ps = ps._replace(nbr=np.arange(36, dtype=np.int32).reshape(9, 4),
                     nbr_ref_pos=np.asarray(ps.pos) + 1.0)
    fs = make_fluid_state(grid)
    fs = fs._replace(u=rng.randn(3, 6, 5, 4).astype(np.float32),
                     p=rng.randn(6, 5, 4).astype(np.float32), p_prev=fs.p,
                     alpha=rng.rand(6, 5, 4).astype(np.float32))
    state = SimState(fs, ps, make_turbulence_state(grid, k0=1e-6), t=np.float32(0.25),
                     dt=np.float32(5e-5), step=np.int32(3))
    return grid, jax.tree.map(np.asarray, state)


def test_write_time_dir_matches_jax(tmp_path):
    """The same state gives byte-identical time-directory and polyMesh
    files."""
    grid, tree = _np_state()
    ref_dir = Path(jckpt.write_time_dir(tmp_path / "ref", tree, grid=grid))
    port = state_from_numpy(tree, torch.device("cpu"))
    out_dir = Path(tckpt.write_time_dir(tmp_path / "port", port, grid=config_from(grid)))
    assert out_dir.name == ref_dir.name == "0.25"
    files = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*")
                   if p.is_file())
    assert len(files) >= 10
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel


def test_checkpoint_round_trip(tmp_path):
    """save / latest_step / restore: every field back exactly, by name, in
    the template's dtype and device; fields that are None stay None."""
    _, tree = _np_state()
    state = state_from_numpy(tree, torch.device("cpu"))
    snap = tckpt.save(tmp_path / "ck", state)
    assert Path(snap).name == "step_0000000003" and tckpt.latest_step(tmp_path / "ck") == 3
    zero = lambda t: None if t is None else tuple(map(zero, t)) if isinstance(t, tuple) \
        else torch.zeros_like(t)  # noqa: E731
    template = type(state)(*[type(x)(*map(zero, x)) if isinstance(x, tuple) else zero(x)
                             for x in state])
    back = tckpt.restore(tmp_path / "ck", template)
    a, b = state_to_numpy(back), state_to_numpy(state)
    assert back.particles.shear_xi is None and back.particles.contact_f is None
    assert back.particles.active.dtype == torch.bool
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    """`pimplefoam` on the CPU, with the sparse exchange and, with --fast,
    the planes exchange: rc 0 and `End`, time directories and checkpoints
    written; `icofoam` (PISO, point-force exchange) on the same case: rc 0."""
    case = write_case(tmp_path / "case", n=8, length=0.008, write_interval=1e-4)
    base = ["pimplefoam", str(case), "--device", "cpu", "--random-particles", "8",
            "--radius", "1e-4", "--chunk", "2", "--max-steps", "4", "--dem-substeps", "2"]
    assert cli.main(base + ["--write", "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    assert "End (4 steps" in capsys.readouterr().out
    # t = 1e-4 in float32 lies just below the first write time, as in JAX
    assert sorted(p.name for p in case.glob("0.*")) == ["0.0002"]
    assert (case / "0.0002" / "U").exists() and (case / "constant/polyMesh/owner").exists()
    assert tckpt.latest_step(tmp_path / "ck") == 4
    assert cli.main(base + ["--fast"]) == 0
    assert "End (4 steps" in capsys.readouterr().out
    assert cli.main(["icofoam", str(case), "--device", "cpu", "--random-particles", "4",
                     "--radius", "1e-4", "--chunk", "2", "--max-steps", "2"]) == 0
    assert "End (2 steps" in capsys.readouterr().out
