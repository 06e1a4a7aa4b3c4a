"""The benchmark end to end on the CPU at a tiny size, with the kernels'
plain versions, and its refusals.

    python -m pytest cfdbench/tests

The `cuda` cases run a cell's real command on a card and skip without one.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cfdbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = (16, 300)
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2 ** 31 + 12345


def run_tiny(workload, trace, capsys, seed=SEED):
    res, lines = harness.run_cell(workload, seed, 0.5, trace, time.perf_counter(),
                                  device=torch.device("cpu"), shrink=TINY)
    assert harness.emit(res, lines) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err.strip().splitlines()


@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(workload, capsys):
    line, err = run_tiny(workload, 0, capsys)
    assert set(line) == KEYS | {"setup_split_s", "tie", "checks"} and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 5 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == {"setup_s", "steps_per_s", "peak_mem_gb"}
    assert sum(line["setup_split_s"].values()) == pytest.approx(
        line["metrics"]["setup_s"]["value"], rel=1e-9)
    assert err[-len(line["checks"]):] == [
        f"check {k}: {v[0]!r} limit {v[1]!r}" for k, v in line["checks"].items()]


def test_traced_run(capsys):
    line, _ = run_tiny(CELLS[0], 1, capsys)
    assert set(line) == KEYS | {"setup_split_s", "tie", "checks", "breakdown"}
    # no device on the CPU: the host ranges and the counters only
    assert set(line["metrics"]) == {"exchange_ms", "dem_ms", "list_build_ms", "fluid_ms",
                                    "p_iters"}
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0.0


def _command(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "cfdbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_paths_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cfdbench", tmp_path / "cfdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _command(tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(card, workload):
    p = subprocess.run([sys.executable, "cfdbench/run.py", "--workload", workload,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
