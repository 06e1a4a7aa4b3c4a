"""The PyTorch port as a package: its config dataclasses mirror the JAX
package's field for field, it imports no jax, and state crosses between
the packages exactly."""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models import coupled as jcd
from yade_openfoam_coupling_tpu.models import pimple as jpm
from yade_openfoam_coupling_tpu.models import piso as jps
from yade_openfoam_coupling_tpu.models import turbulence as jtb
from yade_openfoam_coupling_tpu.models.fields import (
    make_fluid_state,
    make_particle_state,
    make_turbulence_state,
    SimState,
)
from yade_openfoam_coupling_tpu.ops import coupling as jcp
from yade_openfoam_coupling_tpu.ops import dem as jdem
from yade_openfoam_coupling_tpu.ops import pressure as jpr
from yade_openfoam_coupling_tpu.ops.grid import Grid
from yade_openfoam_coupling_tpu.utils import diagnostics as jdg
from yade_openfoam_coupling_tpu_torch import kernels
from yade_openfoam_coupling_tpu_torch.convert import (
    case_config_from,
    state_from_numpy,
    state_to_numpy,
)
from yade_openfoam_coupling_tpu_torch.models import coupled as tcd
from yade_openfoam_coupling_tpu_torch.models import pimple as tpm
from yade_openfoam_coupling_tpu_torch.models import piso as tps
from yade_openfoam_coupling_tpu_torch.models import turbulence as ttb
from yade_openfoam_coupling_tpu_torch.native import bindings as tnb
from yade_openfoam_coupling_tpu_torch.ops import coupling as tcp
from yade_openfoam_coupling_tpu_torch.ops import dem as tdem
from yade_openfoam_coupling_tpu_torch.ops import pressure as tpr
from yade_openfoam_coupling_tpu_torch.utils import diagnostics as tdg

REPO = Path(__file__).resolve().parents[1]

CONFIG_PAIRS = {
    "CouplingConfig": (jcp.CouplingConfig, tcp.CouplingConfig),
    "DEMConfig": (jdem.DEMConfig, tdem.DEMConfig),
    "ContactParams": (jdem.ContactParams, tdem.ContactParams),
    "PressureSolverConfig": (jpr.PressureSolverConfig, tpr.PressureSolverConfig),
    "MGConfig": (jpr.MGConfig, tpr.MGConfig),
    "PIMPLEConfig": (jpm.PIMPLEConfig, tpm.PIMPLEConfig),
    "PISOConfig": (jps.PISOConfig, tps.PISOConfig),
    "TurbulenceConfig": (jtb.TurbulenceConfig, ttb.TurbulenceConfig),
    "TimeControls": (jdg.TimeControls, tdg.TimeControls),
    "TransportProperties": (jcd.TransportProperties, tcd.TransportProperties),
    "CaseConfig": (jcd.CaseConfig, tcd.CaseConfig),
}


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


def _plain(v):
    """A config value reduced to plain data (nested dataclasses to dicts)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("name", list(CONFIG_PAIRS))
def test_config_fields_and_defaults_match(name):
    ref_cls, port_cls = CONFIG_PAIRS[name]
    ref = dataclasses.fields(ref_cls)
    port = dataclasses.fields(port_cls)
    assert [f.name for f in port] == [f.name for f in ref]
    for fr, fp in zip(ref, port):
        assert _plain(_default(fp)) == _plain(_default(fr)), fr.name


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package (checked in a fresh interpreter), the front door's modules, the
    copied foamdict/foammesh, the obstacles, the B7 script, the bench and
    the bench and profile scripts, and the k-d tree locator included."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import yade_openfoam_coupling_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'yade_openfoam_coupling_tpu'\n"
        "       or m.startswith('yade_openfoam_coupling_tpu.')]\n"
        "mods = sorted(m for m in sys.modules if m.startswith('yade_openfoam_coupling_tpu_torch'))\n"
        "print(len(mods), bad, ' '.join(mods))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20
    mods = set(proc.stdout.split())
    for name in ("utils.foamdict", "utils.foammesh", "utils.config", "utils.checkpoint",
                 "utils.logging", "models.runner", "cli", "cases.builders", "ops.rolls",
                 "ops.fused_stencil", "ops.obstacle", "models.piso",
                 "scripts.proto_dynwin", "bench", "scripts.bench_1m", "scripts.bench_ladder",
                 "scripts.profile_1m", "scripts.bench_sharded1", "scripts.profile_sharded1",
                 "native.bindings", "scripts.meshtree_timing"):
        assert f"yade_openfoam_coupling_tpu_torch.{name}" in mods, name


def test_state_round_trip_exact():
    grid = Grid.box((6, 5, 4), (0.006, 0.005, 0.004))
    rng = np.random.RandomState(0)
    ps = make_particle_state(pos=rng.uniform(0, 0.004, (7, 3)), radius=4e-4, capacity=9)
    ps = ps._replace(nbr=np.arange(9 * 4, dtype=np.int32).reshape(9, 4),
                     nbr_ref_pos=np.asarray(ps.pos) + 1.0)
    fs = make_fluid_state(grid)
    fs = fs._replace(u=rng.randn(3, 6, 5, 4).astype(np.float32), p_prev=fs.p)
    state = SimState(fs, ps, make_turbulence_state(grid, k0=1e-6),
                     t=np.float32(0.25), dt=np.float32(5e-5), step=np.int32(3))
    tree = jax.tree.map(np.asarray, state)
    port = state_from_numpy(tree, torch.device("cpu"))
    assert port.particles.pos.dtype == torch.float32
    assert port.particles.active.dtype == torch.bool
    assert port.particles.pid.dtype == torch.int32
    back = state_to_numpy(port)
    leaves_ref, tdef_ref = jax.tree.flatten(tree)
    leaves_out, tdef_out = jax.tree.flatten(
        SimState(*[type(getattr(tree, k))(*v) if k in ("fluid", "particles", "turb") else v
                   for k, v in back._asdict().items()]))
    assert tdef_out == tdef_ref
    for a, b in zip(leaves_out, leaves_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_case_config_from_and_unported_options_raise():
    """case_config_from mirrors a CaseConfig field for field; the options
    that once raised in the port (implicit diffusion, the slots exchange,
    the Smagorinsky and kEpsilon closures) now run one coupled step that
    matches the JAX package's from the same numpy state: the pressure
    iterations equal, u and p within 1e-4 of their scale (8^3 channel, 20
    particles, the sparse exchange as the base)."""
    cfg = jcd.CaseConfig(grid=Grid.cube(8, 0.008), bcs=jps.FluidBCs.channel_z(),
                         solver="pimple",
                         coupling=jcp.CouplingConfig(exchange="window", lag_alpha=True),
                         dem=jdem.DEMConfig(neighbor="cells", periodic=(True, True, False)))
    port = case_config_from(cfg)
    assert isinstance(port, tcd.CaseConfig)
    assert isinstance(port.dem.params, tdem.ContactParams)
    assert _plain(port) == _plain(cfg)
    base = dataclasses.replace(
        cfg, coupling=jcp.CouplingConfig(exchange="sparse", lag_alpha=True),
        pimple=jpm.PIMPLEConfig(n_outer=1, n_correctors=1, pressure=jpr.PressureSolverConfig(
            solver="pcg", tol=1e-5, maxiter=200)),
        n_dem_substeps=2, r_max=4e-4)
    variants = (
        dataclasses.replace(base, pimple=dataclasses.replace(
            base.pimple, implicit_diffusion=True, full_stress=False)),
        dataclasses.replace(base, coupling=jcp.CouplingConfig(exchange="slots", lag_alpha=True)),
        dataclasses.replace(base, turbulence=jtb.TurbulenceConfig(model="Smagorinsky")),
        dataclasses.replace(base, turbulence=jtb.TurbulenceConfig(model="kEpsilon")))
    rng = np.random.RandomState(0)
    pos = rng.uniform(0.001, 0.007, (20, 3)).astype(np.float32)
    vel = (1e-2 * rng.randn(20, 3)).astype(np.float32)
    for jcfg in variants:
        parts = (make_fluid_state(jcfg.grid), make_particle_state(pos=pos, vel=vel, radius=4e-4),
                 make_turbulence_state(jcfg.grid, k0=1e-6))
        s0 = jcd.initialize_state(*parts, jcfg, dt=5e-5)
        ref, rdiag = jcd.make_step_fn(jcfg)(s0)
        raw = jax.tree.map(np.asarray, SimState(*parts, t=np.float32(0), dt=np.float32(5e-5),
                                                step=np.int32(0)))
        t = state_from_numpy(raw, torch.device("cpu"))
        tcfg = case_config_from(jcfg)
        t0 = tcd.initialize_state(t.fluid, t.particles, t.turb, tcfg, dt=5e-5)
        out, odiag = tcd.make_step_fn(tcfg)(t0)
        assert int(odiag.p_iters) == int(rdiag.p_iters)
        for name in ("u", "p"):
            o, r = getattr(out.fluid, name).numpy(), np.asarray(getattr(ref.fluid, name))
            assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max(), (name, jcfg)


def test_launch_route_by_device():
    """`kernels.on_cpu`: a CPU device runs the plain version, a CUDA device
    launches, any other device raises (no card needed to name one)."""
    assert kernels.on_cpu("k kernel", torch.device("cpu")) is True
    assert kernels.on_cpu("k kernel", torch.device("cuda")) is False
    with pytest.raises(ValueError, match="k kernel: unsupported device meta"):
        kernels.on_cpu("k kernel", torch.device("meta"))


REQUIRE_FAULTS = {
    "dtype": (torch.zeros((2, 3), dtype=torch.float64), False,
              r"x must be a contiguous float32 tensor of shape \(2, 3\) on cpu; "
              r"got torch.float64"),
    "shape": (torch.zeros((3, 2)), False, r"x must be .* shape \(2, 3\) .*; got \S+ \(3, 2\)"),
    "device": (torch.zeros((2, 3), device="meta"), False, r"x must be .* on cpu; got .* on meta"),
    "contiguity": (torch.zeros((3, 2)).t(), False, r"x must be a contiguous .*strides \(1, 2\)"),
    "inner stride": (torch.zeros((2, 6))[:, ::2], True,
                     r"x must be a rows of unit stride float32 .*strides \(6, 2\)"),
}


@pytest.mark.parametrize("fault", list(REQUIRE_FAULTS))
def test_require_names_the_argument_and_the_fault(fault):
    t, rows, message = REQUIRE_FAULTS[fault]
    with pytest.raises(ValueError, match="^k kernel: " + message):
        kernels.require("k kernel", torch.device("cpu"), ("ok", None, (9,), torch.int32, False),
                        ("x", t, (2, 3), torch.float32, rows))


def test_require_passes_what_the_kernel_takes():
    """Contiguous tensors, rows of unit stride where allowed (a padded row
    view), None arguments, a 0-d tensor: no error."""
    padded = torch.zeros((2, 4))[:, :3]
    cpu, f32 = torch.device("cpu"), torch.float32
    kernels.require("k kernel", cpu, ("a", torch.zeros((2, 3)), (2, 3), f32, False),
                    ("b", padded, (2, 3), f32, True), ("c", None, (5,), torch.bool, False),
                    ("d", torch.zeros((), dtype=torch.int32), (), torch.int32, False))
    with pytest.raises(ValueError, match="b must be a contiguous"):
        kernels.require("k kernel", cpu, ("b", padded, (2, 3), f32, False))


def test_call_counts_each_launch_that_reports_no_error(monkeypatch):
    """`kernels.call` counts a launch by its entry point only once the
    entry point returns 0; a CUDA error raises and counts nothing."""
    codes = iter((0, 0, 700))
    lib = types.SimpleNamespace(yofc_probe=lambda *ptrs: next(codes))
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(kernels.LAUNCHES, "yofc_probe", 0)
    before = dict(kernels.LAUNCHES)
    for _ in range(2):
        kernels.call("probe", "yofc_probe", "probe kernel", torch.zeros(1), None,
                     device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="probe kernel launch failed: CUDA error 700"):
        kernels.call("probe", "yofc_probe", "probe kernel", device=torch.device("cuda"))
    assert dict(kernels.LAUNCHES) == {**before, "yofc_probe": 2}


def test_native_queries_raise_for_an_unsupported_device():
    """A query tensor on neither the CPU nor a CUDA device is refused by
    the keys wrapper itself (it once went on to the card's library)."""
    q = torch.empty((4, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meshtree keys kernel: unsupported device meta"):
        tnb.morton_keys(q, np.zeros(6))
