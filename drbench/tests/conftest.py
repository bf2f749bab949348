"""Shared helpers of the benchmark's CPU tests: runs of a cell at a size
the CPU holds, through the harness with the card's check skipped.

Each configuration's CPU size is a file of its own,
``tiny/<config>.json``: the keys of the configuration it overrides.  A
new configuration brings its file; nothing here names one.
"""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DIR = Path(__file__).resolve().parent / "tiny"
#: each configuration cut to a size a test run holds, by its name
TINY = {p.stem: json.loads(p.read_text())
        for p in sorted(TINY_DIR.glob("*.json"))}
SEED = 2 ** 31 + 11


@pytest.fixture
def run_cpu():
    """``run_cpu(cell, seconds=0.5, trace=False, control=False)``: one
    run of ``cell`` on the CPU at its tiny size; returns the result."""
    from drbench import harness
    man = harness.manifest(ROOT)

    def go(cell, seconds=0.5, trace=False, control=False, seed=SEED):
        config = harness.cell(man, cell)[0]["config"]
        return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                           device="cpu", control=control,
                           config_override=TINY[config])
    return go
