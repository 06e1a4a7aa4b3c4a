"""Where B2's bf16 entry (`yofc_laplacian_bf16` of `csrc/laplacian.cu`)
spends its time, on one CUDA device.

    python yade_openfoam_coupling_tpu_torch/scripts/laplacian_diagnose.py [--root DIR ...]

Builds each DIR's `csrc/laplacian.cu` (default: the checkout that holds
this file) with the package's nvcc flags and prints, for each kernel of
the library, the instruction counts of its SASS (`cuobjdump -sass`; the
whole listing into ``--sass-dir``): all instructions, conversions (F2FP),
bf16x2 arithmetic (HADD2, HFMA2, HMUL2), global loads and stores, calls,
integer and float arithmetic. Where the source has the one-thread-per-cell bf16
kernel (a flat thread index split into (i, j, k) by 64-bit division and
remainder), it also builds two stripped variants of that kernel, each
wrong and each only a measurement:

  * ``index3d``: (i, j, k) from a 3D grid of 64-thread blocks (blockIdx.z =
    i, blockIdx.y = j), no division;
  * ``noround``: no rounding to bf16 between the operations (the store
    still rounds),

and ``index3d+noround``. ``--sweep`` times this checkout's bf16 entry
through `fused_stencil` at the V-cycle's 128^3 and 64^3 levels for a few
launch geometries of the tiled kernel (threads a block, blocks an SM), in
turns. With two builds or more it then times the bf16 entry of every
build at those levels, in turns, each handed this checkout's parameter
arrays (an entry that reads only the shape ignores the launch geometry
after it), and says whether each output equals the first build's. Every
time is the card's alone (CUDA events with the card kept busy while the
host enqueues). Prints one JSON line per measurement, each with the
card's name and power limit. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_PKG.parent))

# the one-thread-per-cell indexing and launch of the bf16 kernel, and what
# the index3d variant puts in their place
_FLAT_INDEX = """  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ncell = (long long)nx * ny * nz;
  if (t >= ncell) return;
  int k = (int)(t % nz);
  int j = (int)((t / nz) % ny);
  int i = (int)(t / ((long long)ny * nz));"""
_GRID_INDEX = """  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nz) return;
  int j = blockIdx.y, i = blockIdx.z;
  long long t = ((long long)i * ny + j) * nz + k;"""
_FLAT_LAUNCH = "laplacian_bf16_kernel<<<blocks, kThreads"
_GRID_LAUNCH = "laplacian_bf16_kernel<<<dim3((nz + 63) / 64, ny, nx), 64"
_ROUND = "return __bfloat162float(__float2bfloat16_rn(v));"
_NO_ROUND = "return v;"
OPCODES = ("F2FP", "HADD2", "HFMA2", "HMUL2", "LDG", "STG", "CALL", "IMAD", "IADD3", "LOP3",
           "SHF", "PRMT", "FADD", "FMUL", "I2F", "MUFU")


def variants(src: str) -> dict:
    """The sources to build: the checkout's own, and the stripped variants
    where its bf16 kernel has the flat index."""
    out = {"as is": src}
    cut = src.find("laplacian_bf16_kernel(")
    if cut < 0 or _FLAT_INDEX not in src[cut:] or _FLAT_LAUNCH not in src:
        return out
    head, tail = src[:cut], src[cut:]
    idx3d = head + tail.replace(_FLAT_INDEX, _GRID_INDEX, 1)
    idx3d = idx3d.replace(_FLAT_LAUNCH, _GRID_LAUNCH, 1)
    out["index3d"] = idx3d
    out["noround"] = src.replace(_ROUND, _NO_ROUND, 1)
    out["index3d+noround"] = idx3d.replace(_ROUND, _NO_ROUND, 1)
    return out


def sass_counts(lib: Path, dump: Path = None) -> dict:
    """{kernel name: Counter of opcodes (and 'all')} from cuobjdump -sass;
    the listing is also written to `dump` when given."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and m and m.group(1) != "NOP":
            op = m.group(1)
            counts[name]["all"] += 1
            for key in OPCODES:
                if op.startswith(key):
                    counts[name][key] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="checkout whose csrc/laplacian.cu is built (repeatable; default: "
                         "this one)")
    ap.add_argument("--sass-dir", help="write each build's SASS listing here")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout's bf16 entry at several launch geometries")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("laplacian_diagnose: no CUDA device", file=sys.stderr)
        return 2
    from yade_openfoam_coupling_tpu_torch import kernels
    from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
    from yade_openfoam_coupling_tpu_torch.scripts.exchange_timing import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    roots = args.root or [str(_PKG.parent)]
    work = Path(tempfile.mkdtemp(prefix="laplacian_diagnose_"))
    procs = {}
    for root in roots:
        src = (Path(root) / "yade_openfoam_coupling_tpu_torch/csrc/laplacian.cu").read_text()
        for variant, text in variants(src).items():
            label = variant if len(roots) == 1 else f"{Path(root).resolve().name}: {variant}"
            cu = work / f"{len(procs)}.cu"
            cu.write_text(text)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                   str(cu)]
            procs[label] = (cu.with_suffix(".so"), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n_lib, (label, (so, proc)) in enumerate(procs.items()):
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{report}")
        libs[label] = so
        dump = Path(args.sass_dir) / f"{n_lib}.sass" if args.sass_dir else None
        for fn, c in sass_counts(so, dump).items():
            print(json.dumps({"variant": label, "kernel": fn, "sass": dict(c), "card": card}),
                  flush=True)

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    if args.sweep:
        sweep(dev, card, args.reps, cuda_ms)
    if len(libs) == 1:
        return 0
    for n in (128, 64):
        gen = torch.Generator(device=dev).manual_seed(4)
        pp = torch.randn((n + 2,) * 3, generator=gen, device=dev).to(bf)
        g = [(0.5 + torch.rand(s, generator=gen, device=dev)).to(bf)
             for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
        out = torch.empty((n,) * 3, dtype=bf, device=dev)
        ip, fp = fs._params((n,) * 3, (1e-3,) * 3, kernels.sm_count(dev))
        ref = None
        fns = {}
        for label, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.yofc_laplacian_bf16
            fn.argtypes = [ctypes.c_void_p] * 8
            fn.restype = ctypes.c_int
            ptrs = [ip.ctypes.data, fp.ctypes.data, pp.data_ptr(), *(t.data_ptr() for t in g),
                    out.data_ptr()]

            def call(fn=fn, ptrs=ptrs):
                err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            fns[label] = (call, bool(torch.equal(out, ref)))
            out.fill_(float("nan"))
        order = list(fns) + list(fns)[::-1]
        times = {label: [] for label in fns}
        for label in order:
            times[label].append(cuda_ms(fns[label][0], args.reps, device_only=True))
        for label, ts in times.items():
            print(json.dumps({"variant": label, "shape": [n] * 3, "device_ms": ts,
                              "equal_to_first": fns[label][1], "card": card}), flush=True)
    return 0


def sweep(dev, card, reps, cuda_ms):
    """Device-only ms of the checkout's bf16 entry at 128^3 and 64^3 for
    each (threads a block, blocks an SM) of its geometry, in turns."""
    import torch
    from yade_openfoam_coupling_tpu_torch import kernels
    from yade_openfoam_coupling_tpu_torch.ops import fused_stencil as fs
    from yade_openfoam_coupling_tpu_torch.ops.grid import Grid
    variants = [(t, b) for t in (128, 256) for b in (2, 4, 8, 16)]
    default = (fs.BF16_THREADS, fs.BF16_BLOCKS_PER_SM)
    for n in (128, 64):
        grid = Grid.cube(n, 1e-3 * n)
        gen = torch.Generator(device=dev).manual_seed(4)
        pp = torch.randn((n + 2,) * 3, generator=gen, device=dev).to(torch.bfloat16)
        g = tuple((0.5 + torch.rand(s, generator=gen, device=dev)).to(torch.bfloat16)
                  for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            fs.BF16_THREADS, fs.BF16_BLOCKS_PER_SM = v
            fs._params.cache_clear()
            times[v].append(cuda_ms(lambda: fs.laplacian_facegamma_fused(g, pp, grid), reps,
                                    device_only=True))
        for (t, b), ts in times.items():
            fs.BF16_THREADS, fs.BF16_BLOCKS_PER_SM = t, b
            print(json.dumps({"threads": t, "blocks_per_sm": b, "shape": [n] * 3,
                              "geometry": fs.bf16_geometry((n,) * 3, kernels.sm_count(dev)),
                              "device_ms": ts, "card": card}), flush=True)
    fs.BF16_THREADS, fs.BF16_BLOCKS_PER_SM = default
    fs._params.cache_clear()


if __name__ == "__main__":
    sys.exit(main())
