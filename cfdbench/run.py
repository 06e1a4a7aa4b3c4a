"""Run one cell of the benchmark once and print its result line:

    python3 cfdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see cfdbench/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".cfdbench_cache"
# every compiler cache a library might use, at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# Python's own compile cache too: where the installed packages come without
# bytecode and the environment forbids writing it, every process would
# compile torch's sources again (seconds of host time, swinging with the host)
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CACHE / "pyc")
sys.path.insert(0, str(ROOT))

from cfdbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
