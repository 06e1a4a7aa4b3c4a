"""Readings that the limits of `correct` are set from: for each seed, one
run of a cell as the benchmark runs it, with the program's numbers and
the control's from the same chunk (the reference in float32 with every
array it writes stored in bfloat16, put in the program's place). One
process for all seeds, so the set-up that later seeds share is paid once.

    python3 cfdbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "correct", "failed", "program":
{name: gap}, "control": {name: gap}}.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

from cfdbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfdbench/control.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            res, _ = harness.run_cell(args.workload, seed, args.seconds, 0, t0, control=True)
        except harness.NoDevice as e:
            print(f"control: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"seed": seed, "correct": res["correct"], "failed": res["failed"],
                          "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "program": {k: v[0] for k, v in res["checks"].items()},
                          "control": res["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
