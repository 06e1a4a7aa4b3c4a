"""The 1-D mesh of the slab decomposition, and a launcher for its ranks
(port of `yade_openfoam_coupling_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh` of devices in one
program. Here every rank is a process that owns one x-slab and one
device: `make_mesh` returns this process's view of the ring (process
group, rank, world size, device), and `launch` starts the ranks of a
function on one host, with the ``spawn`` start method and a ``file://``
rendezvous in a temporary directory. Every process group is created with
a timeout, every rank is joined with a deadline, and a rank that fails or
outlives the deadline stops the launch with that rank's traceback.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXIS = "x"   # grid axis 0 is sharded over this mesh axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of the 1-D mesh: its process group (None = the
    default group), its rank, the world size, its device and the name of
    the mesh axis. ``shape[axis_name]`` is the shard count, as on a JAX
    mesh."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_name: str = AXIS

    @property
    def shape(self):
        return {self.axis_name: self.size}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def default_device(rank: int) -> torch.device:
    """The card of this rank on its host: ``cuda:<LOCAL_RANK>`` (or the rank
    modulo the card count when LOCAL_RANK is unset)."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = AXIS, *,
              device=None, group=None) -> Mesh:
    """The 1-D mesh over the ranks of ``group`` (the default process group
    by default; `torch.distributed` must be initialised). ``n_devices``,
    when given, must equal the group's size. ``device`` is this rank's
    device: its card (`default_device`) unless the caller asks for another,
    e.g. ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(start the ranks with launch() or init_process_group)")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the group has {size} ranks")
    rank = dist.get_rank(group)
    dev = default_device(rank) if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, dev, axis_name)


def _rank_main(fn: Callable, rank: int, n_ranks: int, backend: str, device: str,
               init_method: str, timeout_s: float, args: Sequence, out_dir: str) -> None:
    """One spawned rank: join the group, run fn(mesh, *args), write its
    result (or its traceback, then fail) into out_dir."""
    out = Path(out_dir)
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        elif dev.index is None:
            dev = default_device(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"result_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


class RankFailed(RuntimeError):
    """A rank of a launch exited non-zero or outlived the deadline."""


def launch(fn: Callable, n_ranks: int, backend: str = "nccl", device: str = "cuda",
           args: Sequence = (), *, timeout: float = 120.0,
           deadline: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned processes and return
    their results, by rank (each must pickle: return numpy arrays or CPU
    tensors). ``fn`` must be importable by name in a child process.

    ``backend`` is the process group's ("nccl", the default, or "gloo");
    ``device`` each rank's device: "cuda" (the default: rank r on card r
    modulo the card count), one card for every rank ("cuda:0") or "cpu"
    (with gloo). Collectives wait at most
    ``timeout`` seconds; the whole launch at most ``deadline`` seconds
    (2 x timeout + 60 by default). A rank that exits non-zero stops the
    others at once, and `RankFailed` carries its traceback; so does a
    launch past its deadline, naming the ranks still running."""
    deadline = 2 * timeout + 60.0 if deadline is None else deadline
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="yofc_launch_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_ranks, backend, str(device), init_method, timeout,
                               tuple(args), tmp))
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        t_end = time.monotonic() + deadline
        failed = None
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                break
            time.sleep(0.05)
        running = [r for r, p in enumerate(procs) if p.exitcode is None]
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(10.0)
        if failed is not None or running:
            msgs = []
            for r in range(n_ranks):
                err = Path(tmp) / f"error_{r}.txt"
                if err.exists():
                    msgs.append(f"--- rank {r} ---\n{err.read_text()}")
            what = (f"rank(s) {failed} exited with codes "
                    f"{[procs[r].exitcode for r in failed]}" if failed is not None
                    else f"rank(s) {running} still running after {deadline:.0f} s")
            raise RankFailed(f"launch of {getattr(fn, '__name__', fn)} on {n_ranks} "
                             f"{backend} ranks: {what}\n" + "\n".join(msgs))
        results = []
        for r in range(n_ranks):
            with open(Path(tmp) / f"result_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
