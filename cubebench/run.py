"""Run one cell of the benchmark once on this machine's card and print
its result as the last line of standard output.

    python cubebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout.  It exits with 2, printing no
result, where CUDA is missing or the cell wants more cards than there
are; with 3 where the run loaded JAX or the JAX package.  The builds and
kernel caches of the program stay inside the checkout."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    cache = ROOT / ".cubebench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from cubebench.harness import main
    sys.exit(main(sys.argv[1:], ROOT, T_START))
