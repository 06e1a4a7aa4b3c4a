"""`correct` has to come out false for the control and for each fault a
cell can have, with the rest of a run driven as the benchmark drives it
(on the CPU at a tiny size: the look for a card is skipped)."""

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cfdbench import correctness, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = (16, 300)


def tiny_run(workload, **kw):
    res, _ = harness.run_cell(workload, 99, 0.5, 0, time.perf_counter(),
                              device=torch.device("cpu"), shrink=TINY, **kw)
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    """The reference in float32 with bfloat16 storage, in the program's
    place, reads past the cell's limits."""
    res = tiny_run(workload, control=True)
    limits = harness.load_cell(workload)[4]
    assert res["correct"] is True
    assert not correctness.judge(res["control"], limits), res["control"]


def _unchanged(monkeypatch):
    from yade_openfoam_coupling_tpu_torch.models import coupled
    real = coupled.coupled_step

    def step(state, cfg, **kw):
        _, diag = real(state, cfg, **kw)
        return state, diag
    monkeypatch.setattr(coupled, "coupled_step", step)


def _half_left_out(monkeypatch):
    from yade_openfoam_coupling_tpu_torch.ops import dem
    real = dem.dem_substeps

    def substeps(pos, vel, angvel, *a, **kw):
        out = real(pos, vel, angvel, *a, **kw)
        half = pos.shape[0] // 2
        moved = [torch.cat([x0[:half], x1[half:]]) for x0, x1 in zip((pos, vel, angvel), out)]
        return (*moved, *out[3:])
    monkeypatch.setattr(dem, "dem_substeps", substeps)


def _source_scaled(monkeypatch, factor):
    from yade_openfoam_coupling_tpu_torch.models import coupled
    real = coupled.exchange

    def exchange(*a, **kw):
        res = real(*a, **kw)
        return res._replace(u_source=res.u_source * factor)
    monkeypatch.setattr(coupled, "exchange", exchange)


def _answer_altered(monkeypatch):
    _source_scaled(monkeypatch, 1.05)


def _source_off_1pct(monkeypatch):
    _source_scaled(monkeypatch, 1.01)


def _row_dropped(monkeypatch):
    """One particle left out of every exchange, as a window that overflows
    leaves its rows past capacity uncoupled."""
    from yade_openfoam_coupling_tpu_torch.models import coupled
    real = coupled.exchange

    def exchange(fs, ps, *a, **kw):
        active = ps.active.clone()
        active[0] = False
        return real(fs, ps._replace(active=active), *a, **kw)
    monkeypatch.setattr(coupled, "exchange", exchange)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered,
                                   _source_off_1pct, _row_dropped])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert tiny_run(workload)["correct"] is False


def test_traffic_file_found_by_name(tmp_path):
    """A new traffic mix is one data file (and a cell naming it): a copy of
    the benchmark with a file added runs it, with no code changed."""
    shutil.copytree(ROOT / "cfdbench", tmp_path / "cfdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "cfdbench/traffic/dilute.json").read_text())
    traffic.update(particle_share=0.5, jitter=0.1, lo=0.2, hi=0.8)
    (tmp_path / "cfdbench/traffic/half_tight.json").write_text(json.dumps(traffic))
    cell = dict(bench["workloads"][0], name="channel_100k_128.half_tight",
                config="channel_100k_128", traffic="half_tight")
    bench["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / f"cfdbench/limits/{bench['workloads'][0]['name']}.json",
                tmp_path / f"cfdbench/limits/{cell['name']}.json")
    code = ("import sys, time, json, torch\n"
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from cfdbench import harness, cloud\n"
            "assert harness.__file__.startswith(sys.path[0])\n"
            "_, cell, config, traffic, _ = harness.load_cell('channel_100k_128.half_tight')\n"
            "res, _ = harness.run_cell(cell['name'], 4, 0.2, 0, time.perf_counter(),\n"
            "                          device=torch.device('cpu'), shrink=(16, 600))\n"
            "print(json.dumps([traffic['particle_share'], res['attempted']]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    share, attempted = json.loads(p.stdout.strip().splitlines()[-1])
    assert share == 0.5 and attempted > 0


def test_cloud_from_seed():
    _, _, config, traffic, _ = harness.load_cell(CELLS[0])
    from cfdbench import cloud
    a = cloud.positions(traffic, config, 2 ** 33 + 7, "cpu")
    b = cloud.positions(traffic, config, 2 ** 33 + 7, "cpu")
    c = cloud.positions(traffic, config, 2 ** 33 + 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (cloud.n_particles(traffic, config), 3)
    assert dataclasses.is_dataclass(harness.case.build(config))
