"""Time the window slice of `chip_smoke.py` (bench.py's case at 100k/128^3,
as its `slice_phase` and `stage_phase` run it: steps/s over 2 chunks of 10
steps after a warm-up chunk, then the synchronised stage split) in the
checkout at ``--root``, on one CUDA device.

    python yade_openfoam_coupling_tpu_torch/scripts/slice_timing.py [--root DIR] [--tag T]

Run it by file path, once per checkout and in turns (parent, change,
change, parent), to compare two trees' slices on one card. Exits 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose chip_smoke.py and package are timed")
    ap.add_argument("--tag", default="", help="label for the printed lines")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("slice_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = cs.bench_config(cs.NX)
    dev = torch.device("cuda", 0)
    label = f"window slice [{args.tag or args.root}]"
    cs.slice_phase(cfg, dev, card, label, ["window_exchange"])
    cs.stage_phase(cfg, dev, card, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
