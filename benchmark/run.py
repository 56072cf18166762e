"""Run one cell of the benchmark once and print its result line:

    python3 benchmark/run.py --workload cli.replay --seed 7 --seconds 10 \
        --trace 0

Needs a CUDA card (``--device cpu`` rehearses the cell at a tiny size).
The last line of standard output is the result's JSON object; the last
lines of standard error are each compared number beside its limit.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run writes stays inside the checkout, at fixed paths
for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T0))
