"""Run one cell of the benchmark of ``pcrcg_tpu_torch`` once, from the root
of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``core/harness.py``.  Exits non-zero, with no result, without a CUDA
card, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = (str(CHECKOUT / "build" / "torch_extensions"))
os.environ["TRITON_CACHE_DIR"] = (str(CHECKOUT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(CHECKOUT))

from perfbench.core.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(t0=T0))
