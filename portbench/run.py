"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are read by name from BENCHMARK.json and the files under
portbench/. The last line of standard output is the result as one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error.
"""

import time

STARTED = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")
# the program's and its libraries' caches: fixed directories in the checkout
for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[key] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, BENCH)
sys.path.insert(1, os.getcwd())

from harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
