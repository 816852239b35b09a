"""Runs one cell of the benchmark of sppark_tpu_torch once, from the root
of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells are BENCHMARK.json's `workloads`; see benchmark/core/harness.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
# every build and kernel cache inside the checkout, at fixed paths; no
# library the program uses may load JAX
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
