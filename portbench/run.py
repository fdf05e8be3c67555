"""Run one benchmark cell once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (one JSON object) and the compared numbers beside their
limits as the last lines of standard error. ``--quick`` rehearses a cell
on the CPU at the files' small sizes; it measures nothing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout: the port's
# nvcc build goes to build/repro_torch/<hash> by itself; Triton's and
# PyTorch's extension caches, should anything use them, go beside it.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
# One process with few threads: host math libraries single-threaded, so
# that their idle spinning never competes with the serve loop's thread.
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
