"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared are the last lines of standard error.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# caches of the toolchains inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
