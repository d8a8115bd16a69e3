"""Run one cell of the benchmark once and print its result line.

    python3 pibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The program's kernel builds and any
compiler caches go under ``build/pibench/`` inside the checkout, at
fixed paths, so only a checkout's first run builds.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "pibench"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# The script's own directory would shadow standard modules (trace,
# spec): import the harness as the package it is, and the program from
# the checkout's sources.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from pibench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
