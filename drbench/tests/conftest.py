"""Shared helpers of the benchmark's CPU tests: runs of a cell at a size
the CPU holds, through the harness with the card's check skipped."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each configuration cut to a size a test run holds
TINY = {"stencil1d-1g": {"n": 1 << 14},
        "tpch-sf30": {"customers": 3000, "orders": 30000, "parts": 4000}}
SEED = 2 ** 31 + 11


@pytest.fixture
def run_cpu():
    """``run_cpu(cell, seconds=0.5, trace=False, control=False)``: one
    run of ``cell`` on the CPU at its tiny size; returns the result."""
    from drbench import harness

    def go(cell, seconds=0.5, trace=False, control=False, seed=SEED):
        return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                           device="cpu", control=control,
                           config_override=TINY[cell.split(".")[0]])
    return go
