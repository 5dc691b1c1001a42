"""The benchmark of ``centermask2_tpu_torch`` on the card: one run of one
cell (``benchmark/README.md``).

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout. The build and kernel caches of the run
stay inside the checkout, at fixed paths: the program's ``_build/``
(nvcc and g++ libraries) and ``.bench_cache/`` (PyTorch's extension and
Triton caches). The process keeps to two OpenMP threads (the native s2d
pack's) and two PyTorch threads, so that the requests' host path and the
thread that waits on the card do not contend with a worker on every
core of the machine.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["OMP_NUM_THREADS"] = "2"
sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], root=ROOT, t_start=T_START))
