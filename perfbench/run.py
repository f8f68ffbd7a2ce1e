"""The benchmark of the PyTorch/CUDA port: run one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on this machine's card (it exits with an error where there is none),
from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the plain reference
are the last lines of standard error, each beside its limit. Build and
kernel caches stay inside the checkout, under build/.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "perfbench"

os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from harness.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
