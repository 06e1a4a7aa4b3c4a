"""One run of one cell: set-up, the measured (or traced) window, the
counts, the comparison with the plain reference, one result line.

    python3 cfdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration's file, ``traffic/<mix>.json``, ``limits/<cell>.json`` and,
in a traced run, ``metrics/<metric>.py`` for each per-layer metric.

Set-up (``setup_s``, from process start): the program's CaseConfig from
the configuration's file, its kernels loaded (built on a checkout's first
run), the cloud from the seed, `initialize_state`, one warm-up chunk.
Window: `make_scan_fn(cfg, K)`'s ``run``, one chunk (a Verlet rebuild and
K coupled steps) a call, until ``--seconds`` have passed, with no host
read in between; one synchronisation closes it. A traced run times
`TRACE_CHUNKS` whole chunks untraced, then runs as many under the
profiler, with each layer's entry wrapped in a range. Then the peak device
memory, the per-step counters, and the reference's comparison of the last
chunk.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from cfdbench import case, cloud, correctness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_CHUNKS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "yade_openfoam_coupling_tpu")


class NoDevice(RuntimeError):
    pass


def load_cell(workload: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic, its limits)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = case.load(ROOT / entry["file"])
    traffic = case.load(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = case.load(HERE / "limits" / f"{workload}.json")
    return bench, cell, config, traffic, limits


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The metric entries of one kind ("end_to_end" or "per_layer") that
    this cell reports: those whose ``workloads`` list names it, and every
    one without that key."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def step_failures(d: dict, limits: dict) -> np.ndarray:
    """Per step: whether it broke a stated guarantee (the pressure solve
    not converged, the continuity error, a capacity overflow, a
    non-finite counter)."""
    p_ok = d["p_final_residual"] <= np.maximum(limits["p_rel"] * d["p_initial_residual"],
                                               limits["p_floor"])
    cont_ok = np.abs(d["cont_err_local"]) < limits["continuity"]
    over_ok = (d["n_contact_overflow"] + d["n_coupling_overflow"]) <= limits["overflows"]
    finite = np.all([np.isfinite(v) for v in d.values()], axis=0)
    return ~(p_ok & cont_ok & over_ok & finite)


def run_cell(workload: str, seed: int, seconds: float, trace: int, t0: float,
             device=None, shrink=None, control: bool = False):
    """One run. ``device`` None takes CUDA device 0 and raises NoDevice
    without enough cards; the tests pass a CPU device and ``shrink`` =
    (nx, n_particles). ``control`` adds the control's numbers from the
    same chunk (``result["control"]``). -> (result dict, check lines)."""
    entered = time.perf_counter()
    import torch

    bench, cell, config, traffic, limits = load_cell(workload)
    if shrink is not None:
        config = case.shrink(config, *shrink)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"

    from yade_openfoam_coupling_tpu_torch import kernels
    from yade_openfoam_coupling_tpu_torch.models import coupled as cd
    from yade_openfoam_coupling_tpu_torch.models.fields import (
        make_fluid_state, make_particle_state, make_turbulence_state)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # set-up in parts (s), each closed by a synchronisation; "imports" holds torch's
    split = {"imports": entered - t0, "port": time.perf_counter() - entered}

    def mark(part):
        sync()
        now = time.perf_counter()
        split[part] = now - t0 - sum(split.values())
        return now

    cfg = case.build(config)
    if on_card:
        kernels.build()
    mark("kernels")
    torch.empty(1, device=device)
    mark("context")
    pos0 = cloud.positions(traffic, config, seed, device).cpu()
    mark("cloud")
    state = cd.initialize_state(
        make_fluid_state(cfg.grid, device),
        make_particle_state(pos0.numpy(), device, radius=config["radius"]),
        make_turbulence_state(cfg.grid, device, k0=config["k0"]), cfg, dt=config["dt"])
    alpha0 = state.fluid.alpha.cpu()
    mark("state")
    K = cfg.dem.list_rebuild_steps
    run = cd.make_scan_fn(cfg, K)
    state, _ = run(state)
    setup_s = mark("warmup") - t0

    per_layer = cell_metrics(bench, workload, "per_layer")
    if trace:
        from cfdbench import tracing
        readers = {m["name"]: importlib.import_module(f"cfdbench.metrics.{m['name']}")
                   for m in per_layer}
        targets = [t for r in readers.values() for t in r.WRAPS]
        start = time.perf_counter()
        for _ in range(TRACE_CHUNKS):
            state, _ = run(state)
        sync()
        untraced_s = time.perf_counter() - start
        prev, state, diags, window, ranges, device_ops = tracing.traced_chunks(
            run, state, TRACE_CHUNKS, targets, device)
        window_s = (window[1] - window[0]) / 1e6
    else:
        diags = []
        start = time.perf_counter()
        while True:
            prev = state
            state, d = run(state)
            diags.append(d)
            if time.perf_counter() - start >= seconds:
                break
        sync()
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    d = {k: np.concatenate([np.asarray(getattr(x, k).detach().cpu(), dtype=np.float64)
                            .reshape(-1) for x in diags]) for k in diags[0]._fields}
    del diags
    fails = step_failures(d, config["guarantee_limits"])
    finite = all(bool(torch.isfinite(t).all()) for t in (
        state.fluid.u, state.fluid.p, state.particles.pos, state.particles.vel))
    if not finite:
        fails[-K:] = True
    steps = len(fails)

    values, ctl, tie = correctness.readings(config, K, pos0, config["radius"], alpha0, prev,
                                            state, limits, control)
    del prev, state
    correct = correctness.judge(values, limits)

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        tr = tracing.Trace(window=window, steps=steps, ranges=ranges, device_ops=device_ops,
                           untraced_step_us=untraced_s * 1e6 / steps, diags=d, config=config,
                           n_particles=cloud.n_particles(traffic, config))
        metrics = {}
        for name, reader in readers.items():
            v = reader.read(tr)
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        got = {"setup_s": setup_s, "steps_per_s": steps / window_s, "peak_mem_gb": peak / 1e9}
        metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")}

    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct) and finite, "attempted": steps,
              "failed": int(fails.sum()), "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tr.busy_us() / 1e6
        dev_info["window_s"] = window_s
        result["breakdown"] = tr.breakdown()
    if ctl is not None:
        result["control"] = ctl
    result["setup_split_s"] = split
    result["tie"] = tie
    result["checks"] = {k: [values[k], limits[k]] for k in correctness.NAMES}
    lines = [f"card: {card_name() if on_card else 'none'}",
             "setup_s parts: " + ", ".join(f"{k} {v!r}" for k, v in split.items()),
             f"tie resolved (step, particle, axis, cell shift): {tie}"] + [
        f"check {k}: {values[k]!r} limit {limits[k]!r}" for k in correctness.NAMES]
    return result, lines


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="cfdbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds, args.trace, t0)
    except NoDevice as e:
        print(f"cfdbench: {e}", file=sys.stderr)
        return 2
    return emit(result, lines)


def emit(result: dict, lines) -> int:
    """Refuse a process that loaded JAX or the JAX package (exit 3, no
    result); else the check lines last on stderr and the result line last
    on stdout."""
    bad = forbidden_modules()
    if bad:
        print(f"cfdbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
