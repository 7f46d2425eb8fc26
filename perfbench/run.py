#!/usr/bin/env python3
"""Entry point of the benchmark of trlx_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Kernel builds stay inside the checkout
(``build/``): the program's nvcc builds in ``build/kernels`` and any
Triton or extension cache in ``build/perfbench-cache``.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench-cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

from perfbench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(t_start=T_START))
