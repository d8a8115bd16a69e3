"""Shared fixtures of the harness's tests (CPU; the card where marked)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from pibench import spec  # noqa: E402

torch.set_num_threads(2)

TINY_ROWS = 20_000


def tiny_cell(name: str, headroom: float = 3.0, **traffic):
    """``name`` at a size a test run holds: 20,000 rows, the simulated
    time per tuple scaled so that a full scan still costs 10 ms (the
    tuner's cycles fire as often per scan as at 10M rows)."""
    cell = spec.load_cell(name)
    cell.config.update(n_rows=TINY_ROWS, headroom=headroom,
                       time_per_unit_ms=1e-6 * 10_000_000 / TINY_ROWS)
    cell.traffic.update(warmup_statements=100, **traffic)
    return cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
