"""The plain reference against the port at a small size, and what the
harness and the reference load."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from cfdbench import case, cloud, correctness, harness
from cfdbench.reference import coupled_channel as ref

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "yade_openfoam_coupling_tpu"}


def program_chunk(workload, nx, n, steps_before, seed=3):
    """(config, K, program state before a chunk, after it) on the CPU."""
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)
    _, _, config, traffic, _ = harness.load_cell(workload)
    config = case.shrink(config, nx, n)
    cfg = case.build(config)
    dev = torch.device("cpu")
    pos = cloud.positions(traffic, config, seed, dev)
    state = cd.initialize_state(
        make_fluid_state(cfg.grid, dev), make_particle_state(pos.numpy(), dev,
                                                             radius=config["radius"]),
        make_turbulence_state(cfg.grid, dev, k0=config["k0"]), cfg, dt=config["dt"])
    K = cfg.dem.list_rebuild_steps
    run = cd.make_scan_fn(cfg, K)
    for _ in range(steps_before):
        state, _ = run(state)
    prev = state
    state, _ = run(state)
    return config, K, pos, prev, state


def test_config_files_build_the_bench_scripts_cases():
    from yade_openfoam_coupling_tpu_torch.bench import bench_config
    from yade_openfoam_coupling_tpu_torch.scripts.bench_1m import build_parser, case_config
    c100k = case.load(ROOT / "cfdbench/configs/channel_100k_128.json")
    c1m = case.load(ROOT / "cfdbench/configs/channel_1m_256.json")
    assert case.build(c100k) == bench_config(128)
    assert case.build(c1m) == case_config(build_parser().parse_args([]))


def test_reference_follows_the_port():
    """One chunk of each configuration at 24^3: every gap at float32's
    level, far below the bfloat16 control's (tenths)."""
    for workload in ("channel_100k_128.dilute", "channel_1m_256.lattice"):
        config, K, pos, prev, final = program_chunk(workload, 24, 400, 2)
        start = correctness.program_state(prev)
        out = ref.run_chunk(config, start, K)
        gaps = correctness.chunk_readings(config, start, correctness.program_outputs(final), out)
        assert max(v for k, v in gaps.items() if k != "dpos") < 2e-3, gaps
        # float32 positions: the displacement of a chunk spans few ulps
        assert gaps["dpos"] < 2e-2, gaps


def test_reference_initial_fields():
    config, _, pos, prev, _ = program_chunk("channel_100k_128.dilute", 16, 300, 0)
    init = ref.initial_fields(config, pos.double(),
                              torch.full((pos.shape[0],), config["radius"], dtype=torch.float64))
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)
    cfg = case.build(config)
    st = cd.initialize_state(make_fluid_state(cfg.grid, "cpu"),
                             make_particle_state(pos.numpy(), "cpu", radius=config["radius"]),
                             make_turbulence_state(cfg.grid, "cpu"), cfg, dt=config["dt"])
    assert correctness.rel_gap(1 - st.fluid.alpha, 1 - init["alpha"]) < 1e-5


def test_face_ties():
    """A float32 position whose cell changes within two roundings up or
    down is a tie, with the shift that rounding makes; positions a few
    roundings either side of a face, checked one rounding at a time."""
    g = ref.Grid({"grid": {"cube": [8, 0.008]}})
    h = torch.tensor(1e-3, dtype=torch.float32)

    def steps(x, k, to):
        for _ in range(k):
            x = torch.nextafter(x, torch.tensor(to, dtype=torch.float32))
        return x
    face = torch.tensor(3e-3, dtype=torch.float32)
    xs = [steps(face, k, 0.0) for k in range(5, 0, -1)] + [steps(face, k, 1.0) for k in range(5)]
    mid = torch.tensor(4.5e-3, dtype=torch.float32)
    pos = torch.stack([torch.stack([x, mid, mid]) for x in xs])
    i, axis, delta = ref.face_ties(pos, g)
    got = sorted(zip(i.tolist(), axis.tolist(), delta.tolist()))
    want = []
    for n, x in enumerate(xs):
        cell = torch.floor(x / h)
        if any(torch.floor(steps(x, k, 0.0) / h) != cell for k in (1, 2)):
            want.append((n, 0, -1))
        if any(torch.floor(steps(x, k, 1.0) / h) != cell for k in (1, 2)):
            want.append((n, 0, 1))
    assert got == sorted(want)
    assert {d for _, _, d in got} == {-1, 1} and len({n for n, _, _ in got}) < len(xs) - 4


def test_a_tie_is_resolved_and_a_fault_is_not():
    """A program that located one particle across its face at one step (a
    tie, as differing last bits cause) reads past the limits against the
    reference as it ran, and within them once the reference locates the
    particle so too; the same with a source altered 5% stays past them."""
    config, K, _, prev, _ = program_chunk("channel_100k_128.dilute", 16, 300, 1)
    limits = harness.load_cell("channel_100k_128.dilute")[4]
    start = correctness.program_state(prev)
    plain = ref.run_chunk(config, start, K)
    tie = (K - 1, 7, 2, 1)
    plain["ties"] = plain["ties"][:-1] + [(K - 1, torch.tensor([7]), torch.tensor([2]),
                                           torch.tensor([1]))]
    program = ref.run_chunk(config, start, K, shift=tie)
    before = correctness.chunk_readings(config, start, program, plain)
    assert not correctness.judge(dict(before, alpha_p_init=0.0), limits), before
    after, found = correctness.resolve_tie(config, start, program, K, plain,
                                           dict(before, alpha_p_init=0.0), limits)
    assert found == list(tie) and correctness.judge(after, limits), after
    faulty = dict(program, u_source=program["u_source"] * 1.05)
    bad = dict(correctness.chunk_readings(config, start, faulty, plain), alpha_p_init=0.0)
    assert correctness.resolve_tie(config, start, faulty, K, plain, bad, limits)[1] is None


def test_touching_pairs_are_all_pairs():
    """The reference's contact search against all pairs, on a crowded cloud."""
    c = {"grid": {"cube": [8, 0.008]}}
    g = ref.Grid(c)
    gen = torch.Generator().manual_seed(0)
    pos = torch.rand((400, 3), generator=gen, dtype=torch.float64) * 0.008
    radius = torch.full((400,), 4e-4, dtype=torch.float64)
    active = torch.ones(400, dtype=torch.bool)
    i, j = ref.touching_pairs(pos, radius, active, g, 4e-4)
    d = ref._min_image(pos[:, None] - pos[None], g.lengths).norm(dim=-1)
    want = torch.nonzero((d < 8e-4) & ~torch.eye(400, dtype=torch.bool))
    got = torch.stack([i, j], 1)
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, want.tolist()))


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _modules_after(
        "import time, torch\nfrom cfdbench import harness\n"
        "harness.run_cell('channel_100k_128.dilute', 5, 0.2, 1, time.perf_counter(),\n"
        "                 device=torch.device('cpu'), shrink=(16, 300))")
    assert "yade_openfoam_coupling_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _modules_after(
        "import torch\nfrom cfdbench.reference import coupled_channel as r\n"
        "from cfdbench import correctness, case\n"
        "config = case.shrink(case.load('cfdbench/configs/channel_1m_256.json'), 16, 50)\n"
        "pos = torch.rand((50, 3), dtype=torch.float64) * 0.008 + 0.004\n"
        "r.initial_fields(config, pos, torch.full((50,), 4e-4, dtype=torch.float64))")
    assert not names & (FORBIDDEN | {"yade_openfoam_coupling_tpu_torch"}), names
