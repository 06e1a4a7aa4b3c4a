"""The port's bench entry points (`bench.py` of the port, the CLI's
`bench`, `scripts/bench_1m.py`, `bench_ladder.py`, `profile_1m.py`,
`bench_sharded1.py`, `profile_sharded1.py`) against the JAX package's
bench scripts: every full-size configuration field for field after
conversion (the reference `scripts/bench_1m.py` builds its own, with its
state builders stubbed; bench.py, the ladder overlay and the sharded
scripts build theirs inline, so the JAX side here copies their literals),
the initial lattices from the same seed, the box helpers of `ops/grid.py`,
the scripts' refusal without a card, and both CLIs' overflow reports on a
crowded random cloud. The case paths' coupled steps are held against the
JAX package in `test_torch_bench_paths.py`."""

import dataclasses
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import yade_openfoam_coupling_tpu.models.coupled as jcd_mod
import yade_openfoam_coupling_tpu.models.fields as jfields
from yade_openfoam_coupling_tpu import cli as jcli
from yade_openfoam_coupling_tpu.cases import builders as jb
from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models.pimple import PIMPLEConfig
from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.models.turbulence import TurbulenceConfig
from yade_openfoam_coupling_tpu.ops import coupling as cp
from yade_openfoam_coupling_tpu.ops import dem
from yade_openfoam_coupling_tpu.ops import grid as jgrid
from yade_openfoam_coupling_tpu.ops import pressure as pr
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu_torch import bench, cli
from yade_openfoam_coupling_tpu_torch.convert import case_config_from, config_from
from yade_openfoam_coupling_tpu_torch.ops import grid as tgrid
from yade_openfoam_coupling_tpu_torch.scripts import (
    bench_1m,
    bench_ladder,
    bench_sharded1,
    profile_1m,
    profile_sharded1,
)

from test_torch_front_door import write_case

REPO = Path(__file__).resolve().parents[1]


def _load_reference(rel):
    spec = importlib.util.spec_from_file_location("ref_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_bench_1m(argv, monkeypatch):
    """(cfg, lattice positions) that `scripts/bench_1m.py:build_case` builds,
    with the state builders stubbed (no 1M-particle state) and its
    compilation-cache setting skipped."""
    ref = _load_reference("scripts/bench_1m.py")
    seen = {}
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jfields, "make_fluid_state", lambda grid: None)
    monkeypatch.setattr(jfields, "make_turbulence_state", lambda grid, k0: None)
    monkeypatch.setattr(jfields, "make_particle_state",
                        lambda pos, radius: seen.setdefault("pos", pos))
    monkeypatch.setattr(jcd_mod, "initialize_state", lambda fs, ps, ts, cfg, dt: cfg)
    cfg, same = ref.build_case(argv)
    assert same is cfg
    return cfg, seen["pos"]


def bench_py_config(nx, yade_physics=False, n_correctors=2):
    """bench.py's CaseConfig, its literals (bench.py:59-179) copied."""
    return jcd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx),
        bcs=FluidBCs.channel_z(),
        transport=jcd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                   exchange="window", slot_capacity=4, dy_in_kernel=True,
                                   planes_window=0, window_dynamic=True),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0),
            gravity=(0.0, 0.0, -9.81), rho_f=1000.0,
            periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, refined_neighbors=4,
            sorted_fetch=True, list_reuse=True, list_rebuild_steps=10,
            carry_contact=not yade_physics, shear_history=yade_physics,
            dynamic_substeps=yade_physics, substep_unroll=True,
            pair_layout=("rows" if yade_physics else "channels")),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=n_correctors,
                            pressure=pr.PressureSolverConfig(
                                solver="fftpcg", tol=1e-5, maxiter=40,
                                mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=8 if yade_physics else 4,
        r_max=4e-4,
    )


def ladder3_overlay(cfg):
    """`scripts/bench_ladder.py:52-72`'s overlay, its literals copied."""
    return dataclasses.replace(
        cfg,
        coupling=dataclasses.replace(cfg.coupling, lag_alpha=True, exchange="window",
                                     stencil_shape="sphere2", slot_capacity=6,
                                     dy_in_kernel=True),
        dem=dataclasses.replace(cfg.dem, list_reuse=True, list_rebuild_steps=10,
                                refined_neighbors=4, carry_contact=True),
        pimple=dataclasses.replace(
            cfg.pimple, pressure=dataclasses.replace(cfg.pimple.pressure, solver="fftpcg")))


def sharded1_config(exchange="window", rows=False, no_dynamic=False):
    """`scripts/bench_sharded1.py:46-88`'s CaseConfig, its literals copied."""
    return jcd.CaseConfig(
        grid=Grid.cube(128, 0.128), bcs=FluidBCs.channel_z(),
        transport=jcd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                   exchange=exchange, slot_capacity=4, packed_bin="col",
                                   dy_in_kernel=True, window_dynamic=not no_dynamic),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0),
            gravity=(0.0, 0.0, -9.81), rho_f=1000.0,
            periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, refined_neighbors=4,
            list_reuse=True, list_rebuild_steps=10, substep_unroll=True,
            pair_layout=("rows" if rows else "channels")),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="fftpcg", tol=1e-5, maxiter=40, mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4, r_max=4e-4,
    )


def profile_sharded1_config(nx):
    """`scripts/profile_sharded1.py:57-86`'s CaseConfig, its literals copied."""
    return jcd.CaseConfig(
        grid=Grid.cube(nx, 1e-3 * nx), bcs=FluidBCs.channel_z(),
        transport=jcd.TransportProperties(nu=1e-6, rho_f=1000.0, rho_p=2500.0),
        solver="pimple",
        coupling=cp.CouplingConfig(gaussian=True, lag_alpha=True, stencil_shape="sphere2",
                                   exchange="window", slot_capacity=4, packed_bin="col",
                                   dy_in_kernel=True),
        dem=dem.DEMConfig(
            params=dem.ContactParams(kn=100.0, rho_p=2500.0),
            gravity=(0.0, 0.0, -9.81), rho_f=1000.0,
            periodic=(True, True, False), wall_axes=(False, False, True),
            neighbor="cells", cell_capacity=4, max_neighbors=8, refined_neighbors=4),
        pimple=PIMPLEConfig(n_outer=1, n_correctors=1, pressure=pr.PressureSolverConfig(
            solver="fftpcg", tol=1e-5, maxiter=40, mg=pr.MGConfig(pre_smooth=4, post_smooth=4))),
        turbulence=TurbulenceConfig(model="kEqn"),
        gravity_fluid=(0.0, 0.0, -9.81),
        n_dem_substeps=4, r_max=4e-4,
    )


BENCH_CASES = {
    # name: (the port's config, bench.py's)
    "128": (lambda: bench.bench_config(128), lambda: bench_py_config(128)),
    "small": (lambda: bench.bench_config(64), lambda: bench_py_config(64)),
    "yade_physics": (lambda: bench.bench_config(128, yade_physics=True),
                     lambda: bench_py_config(128, yade_physics=True)),
    "correctors_1": (lambda: bench.bench_config(128, n_correctors=1),
                     lambda: bench_py_config(128, n_correctors=1)),
}


@pytest.mark.parametrize("case", list(BENCH_CASES))
def test_bench_config_matches_bench_py(case):
    port, ref = BENCH_CASES[case]
    assert port() == case_config_from(ref())


def test_bench_parser_takes_bench_py_flags():
    """bench.py's flags select the cases above: --small (64^3/10k),
    --yade-physics, --correctors=1."""
    args = bench.build_parser().parse_args(["--small", "--yade-physics", "--correctors=1"])
    assert (args.small, args.yade_physics, args.correctors, args.device) == (True, True, 1,
                                                                              "cuda")
    assert (bench.SMALL_NX, bench.SMALL_N, bench.NX, bench.N_PARTICLES) == (64, 10_000, 128,
                                                                            100_000)


BENCH_1M_ARGV = {
    "default": [],
    "fast": ["--fast"],
    "fast_knobs": ["--fast", "--no-dynamic", "--unbin-gather", "--no-unroll", "--rows"],
    "default_knobs": ["--no-donate", "--rows"],
}


@pytest.mark.parametrize("case", list(BENCH_1M_ARGV))
def test_bench_1m_config_matches_reference(case, monkeypatch):
    """The port's `bench_1m` configuration for each set of flags equals the
    reference script's at full size (1M on 256^3), and so does its
    lattice, from the same seed, for the default flags."""
    argv = BENCH_1M_ARGV[case]
    ref_cfg, ref_pos = reference_bench_1m(argv, monkeypatch)
    port = bench_1m.case_config(bench_1m.build_parser().parse_args(argv))
    assert port == case_config_from(ref_cfg)
    assert port.grid.shape == (256, 256, 256) and len(ref_pos) == bench_1m.N_PARTICLES
    if case == "default":
        np.testing.assert_array_equal(
            bench.lattice_positions(bench_1m.N_PARTICLES, port.grid.lengths[0]), ref_pos)


def test_bench_1m_rows_is_validated():
    """`--rows` reaches `pair_layout`, which the DEM validates: the rows
    layout is accepted, an unknown one is refused."""
    cfg = bench_1m.case_config(bench_1m.build_parser().parse_args(["--rows"]))
    assert cfg.dem.pair_layout == "rows"
    from yade_openfoam_coupling_tpu_torch.ops import dem as tdem
    with pytest.raises(ValueError):
        tdem.DEMConfig(pair_layout="columns")


def test_profile_1m_config_is_the_fast_case(monkeypatch):
    """profile_1m's configuration is the reference profile's: bench_1m
    `--fast` with window_dynamic only under --dynamic."""
    ref_cfg, _ = reference_bench_1m(["--fast", "--no-dynamic"], monkeypatch)
    args = profile_1m.build_parser().parse_args([])
    assert profile_1m.case_config(args, 256) == case_config_from(ref_cfg)
    args = profile_1m.build_parser().parse_args(["--dynamic"])
    assert profile_1m.case_config(args, 256).coupling.window_dynamic
    assert profile_1m.build_parser().parse_args(["--only=exbins,exkern"]).only == "exbins,exkern"


def test_ladder3_overlay_matches_reference():
    """bench_ladder's overlay of the fluidized bed equals the reference's
    on the full-size (24 x 24 x 48) bed configuration."""
    jcfg, _, _ = jb.fluidized_bed(n_particles=50)
    port = bench_ladder.fluidized_bed_config(case_config_from(jcfg))
    assert port == case_config_from(ladder3_overlay(jcfg))
    assert port.grid.shape == (24, 24, 48) and port.coupling.slot_capacity == 6


@pytest.mark.parametrize("flags", [[], ["--exchange=planes", "--rows", "--no-dynamic"]])
def test_sharded_configs_match_reference(flags):
    """bench_sharded1's configuration equals the reference script's, and
    profile_sharded1's the reference profile's (at 128^3 and --small's
    32^3)."""
    args = bench_sharded1.build_parser().parse_args(flags)
    ref = sharded1_config(args.exchange, args.rows, args.no_dynamic)
    assert bench_sharded1.case_config(args, 128) == case_config_from(ref)
    if not flags:
        pargs = profile_sharded1.build_parser().parse_args([])
        for nx in (128, 32):
            assert profile_sharded1.case_config(pargs, nx) == case_config_from(
                profile_sharded1_config(nx))


@pytest.mark.parametrize("n,length", [(1000, 0.128), (10_000, 0.064), (343, 0.016)])
def test_lattices_match_reference(n, length):
    """bench.py's jittered lattice (bench.py:166-175, copied) and
    bench_sharded1's uniform cloud (`scripts/bench_sharded1.py:87`) from
    seed 0, exactly, at reduced counts."""
    rng = np.random.RandomState(0)
    k = int(np.ceil(n ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.linspace(0.1 * length, 0.9 * length, k)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    ref = g + rng.uniform(-0.2 * length / k, 0.2 * length / k, g.shape)
    np.testing.assert_array_equal(bench.lattice_positions(n, length), ref)
    cloud = np.random.RandomState(0).uniform(0.1 * length, 0.9 * length, (n, 3))
    np.testing.assert_array_equal(bench_sharded1.uniform_cloud(n, length), cloud)


def test_box_helpers_match_jax():
    assert tgrid.noslip_box_U() == config_from(jgrid.noslip_box_U())
    assert tgrid.zerograd_box_p() == config_from(jgrid.zerograd_box_p())
    assert tgrid.noslip_box_U().faces[0][0].kind == tgrid.DIRICHLET
    assert tgrid.zerograd_box_p().faces[2][1].kind == tgrid.NEUMANN


def test_cli_bench_help(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--small", "--yade-physics", "--correctors", "--device"):
        assert flag in out


ENTRY_POINTS = {
    "cli bench": lambda: cli.main(["bench", "--device", "cuda"]),
    "cli bench --small": lambda: cli.main(["bench", "--small"]),
    "bench": lambda: bench.main([]),
    "bench_1m": lambda: bench_1m.main(["--fast"]),
    "bench_ladder": lambda: bench_ladder.main([]),
    "profile_1m": lambda: profile_1m.main(["--only=exkern"]),
    "bench_sharded1": lambda: bench_sharded1.main([]),
    "profile_sharded1": lambda: profile_sharded1.main(["--small"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_a_card(name, monkeypatch, capsys):
    """Each entry point defaults to the card and, without one, exits 2 with
    a message, before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ENTRY_POINTS[name]() == 2
    assert "no CUDA device" in capsys.readouterr().err


def _overflow_reports(text):
    return [int(m) for m in re.findall(r"WARNING: (\d+) DEM neighbor-list overflows", text)]


def test_cli_random_particle_overflows_match_jax(tmp_path, capsys):
    """Both CLIs' `pimplefoam` on a 16^3 channel with 5,000 random
    particles from seed 0 (the cell list, as at 100k: a random cloud this
    dense overlaps) report the same DEM list overflows at every logged
    step: the overflows are the reference's behaviour, not the port's."""
    case = write_case(tmp_path / "case")
    argv = ["pimplefoam", str(case), "--random-particles", "5000", "--radius", "4e-4",
            "--kn", "100", "--dem-substeps", "2", "--chunk", "1", "--max-steps", "2"]
    assert jcli.main(argv) == 0
    ref = _overflow_reports(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _overflow_reports(capsys.readouterr().out)
    assert len(ref) == 2 and min(ref) > 0
    assert out == ref


def test_bench_protocol_on_the_cpu():
    """`bench.measure` runs bench.py's protocol (a warm-up chunk, timed
    chunks) and checks; `bench_checks` refuses an unconverged pressure
    solve, a continuity error and an overflow, as bench.py's assertions
    do."""
    good = {"p_final_residual": np.array([1e-6]), "p_initial_residual": np.array([1.0]),
            "cont_err_local": np.array([1e-9]), "n_contact_overflow": np.array([0]),
            "n_coupling_overflow": np.array([0])}
    assert bench.bench_checks(good) == (1e-6, 1e-9)
    for key, bad in (("p_final_residual", 1e-4), ("cont_err_local", 2e-5),
                     ("n_contact_overflow", 1), ("n_coupling_overflow", 3)):
        with pytest.raises(AssertionError):
            bench.bench_checks({**good, key: np.array([bad])})
    cfg = dataclasses.replace(bench.bench_config(16), pimple=dataclasses.replace(
        bench.bench_config(16).pimple, pressure=dataclasses.replace(
            bench.bench_config(16).pimple.pressure, tol=1e-9)))
    device = torch.device("cpu")
    sps, rep_ms, p_final, cont, state = bench.measure(
        cfg, bench.initial_state(cfg, 200, device), device, steps=2, reps=2)
    assert sps > 0 and len(rep_ms) == 2 and cont < 1e-5
    assert int(state.step) == 6


def test_bench_1m_measure_on_the_cpu():
    """`bench_1m.measure` at 16^3 with 300 particles, both exchanges: the
    reference's JSON keys, no overflow, every particle found, the warm-up
    and the timed call."""
    device = torch.device("cpu")
    for argv in ([], ["--fast"]):
        cfg, state = bench_1m.build_case(argv, device, nx=16, n=300)
        res, out = bench_1m.measure(cfg, state, device)
        assert res["overflows"] == [0, 0, 0] and res["n_found"] == 300
        assert len(res["p_iters"]) == bench_1m.N_STEPS and res["peak_mb"] is None
        assert int(out.step) == 2 * bench_1m.N_STEPS
        assert "vs_baseline" not in res
