"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, all of them
at once, at first use, into ``_build/`` beside this file. The libraries'
names carry a hash of every file under ``csrc/`` (sources and the headers
they include) and of the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import time;
a failed build raises with the compiler's output.

It also holds the launch contract every kernel wrapper of the port keeps:
a CPU tensor runs the wrapper's plain version and a CUDA tensor launches
the kernel (`on_cpu`), after the wrapper's tensor arguments pass
`require`; `call` counts each launch in `LAUNCHES` by its entry point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# every library's C entry points and their argument counts (all pointers)
ENTRY_POINTS = {
    "window_exchange": {"yofc_param_counts": 3, "yofc_scratch_layout": 2,
                        "yofc_window_exchange": 9},
    "planes_exchange": {"yofc_param_counts": 3, "yofc_scratch_layout": 2,
                        "yofc_planes_fused": 8, "yofc_planes_interp": 7,
                        "yofc_planes_deposit": 7},
    "rolls_deposit": {"yofc_rolls_deposit": 4},
    "laplacian": {"yofc_laplacian": 8, "yofc_laplacian_bf16": 8},
    "dynwin_staging": {"yofc_dynwin_staging": 5},
    "meshtree": {"yofc_tree_keys": 5, "yofc_tree_nearest": 7, "yofc_tree_range": 8},
    "mg_vcycle": {"yofc_mg_jacobi": 10, "yofc_mg_residual_restrict": 9, "yofc_mg_coarse": 8},
    "dem_substep": {"yofc_dem_pack_drift": 14, "yofc_dem_substep": 14},
}

_libs: Dict[str, ctypes.CDLL] = {}

# launches that reported no error, by entry point (e.g. "yofc_mg_jacobi")
LAUNCHES: Counter = Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_digest(flags, files, root: Path) -> str:
    """16 hex digits of a hash of the compiler flags and of each file's path
    (relative to ``root``) and bytes: a library named by it is rebuilt when
    a flag or a source changes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def compile_shared(jobs: Dict[Path, list]) -> None:
    """Run each compiler command (all but its ``-o``) whose library does not
    exist yet, all started together, each into a temporary file in
    ``_build/`` that then replaces its library at once (a concurrent build
    never sees half a file); the compiler's report is kept beside the
    library with the suffix .log. Raise with every failed command's
    output."""
    todo = {out: cmd for out, cmd in jobs.items() if not out.exists()}
    if not todo:
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for out, cmd in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [*cmd, "-o", tmp]
        procs[out] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for out, (cmd, tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{report}")
            continue
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current sources
    lives (built or not)."""
    files = sorted(p for p in CSRC.rglob("*") if p.is_file())
    return BUILD / f"lib{name}_{source_digest(NVCC_FLAGS, files, CSRC)}.so"


def build() -> Dict[str, Path]:
    """Compile every source that has no library for the current sources
    yet, one nvcc per source, all started together; return the library
    paths by name. Each compiler report (registers, spills per kernel) is
    kept beside its library with the suffix .log."""
    outs = {name: library_path(name) for name in ENTRY_POINTS}
    if not all(out.exists() for out in outs.values()):
        nvcc = _nvcc()
        compile_shared({out: [nvcc, *NVCC_FLAGS, str(CSRC / f"{name}.cu")]
                        for name, out in outs.items()})
    return outs


def call(name: str, fn: str, kernel: str, *args, device) -> None:
    """Call entry point ``fn`` of library ``name`` on the current stream of
    ``device``: tensors pass their data pointers, numpy arrays their host
    pointers, None a null pointer. Raise if the entry point reports a CUDA
    error (a launch that was refused never runs, and no synchronize would
    report it)."""
    ptrs = [None if a is None else a.ctypes.data if hasattr(a, "ctypes") else a.data_ptr()
            for a in args]
    err = getattr(library(name), fn)(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1


def on_cpu(kernel: str, device: torch.device) -> bool:
    """True for a CPU device (the wrapper runs its plain version), False for
    a CUDA device (it launches the kernel); raise for any other."""
    kind = device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")
    return False


Spec = Tuple[str, Optional[torch.Tensor], tuple, torch.dtype, bool]


def require(kernel: str, device: torch.device, *specs: Spec) -> None:
    """Raise unless each (name, tensor, shape, dtype, rows) of ``specs``
    whose tensor is not None lies on ``device`` with that shape (a tuple)
    and dtype, contiguous, or with ``rows`` only its last axis of unit
    stride."""
    for name, t, shape, dtype, rows in specs:
        if t is not None and (t.dtype != dtype or t.shape != shape or t.device != device
                              or not (t.stride(-1) == 1 if rows else t.is_contiguous())):
            layout = "rows of unit stride" if rows else "contiguous"
            raise ValueError(
                f"{kernel}: {name} must be a {layout} {str(dtype).removeprefix('torch.')} "
                f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (strides {t.stride()})")


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, every library built on
    first use, with its entry points' argument types declared."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, n_args in ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * n_args
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
