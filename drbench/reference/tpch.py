"""Plain reference of the TPC-H family, in PyTorch: the state the op
references (``reference/tpch/<op>.py``) share.

A call reads only the tables, so one call's reference stands for every
call (``REPLAY = "once"``).  The state holds the tables (the same
tensors the program got) and a frame of plain tensors under the
program's names.  Its precision is ``"f32"`` for the reference and
the traffic's ``control_precision`` (``"bf16"``) for the control: float
columns rounded to bfloat16 where the ops compute, and sums kept in
bfloat16.  It imports nothing of the
program and reads the program's outputs only to judge them.
"""

import torch

REPLAY = "once"


class State:
    def __init__(self, cfg, traffic, inputs, precision):
        self.cfg, self.traffic = cfg, traffic
        self.tables = inputs
        self.precision = precision
        self.frame = {}
        self.calls = 0

    def low(self, t):
        """``t`` at the state's precision (floats only)."""
        if self.precision == "bf16" and t.is_floating_point():
            return t.to(torch.bfloat16)
        return t

    def acc(self):
        """The accumulator of a sum: float64, or bfloat16 in the
        control."""
        return torch.bfloat16 if self.precision == "bf16" else torch.float64


def start(cfg, traffic, inputs, control=False):
    return State(cfg, traffic, inputs,
                 traffic["control_precision"] if control else "f32")


def outputs(state):
    return {}


def check(state, got, limits, sample):
    return []


def bad(got, want):
    """Positions that differ, plus the difference in length."""
    m = min(got.numel(), want.numel())
    return (int((got[:m].to(want.dtype) != want[:m]).sum())
            + abs(got.numel() - want.numel()))


def rel_gap(got, want):
    """The largest relative gap over the positions both have (the counts
    are judged apart)."""
    m = min(got.numel(), want.numel())
    if m == 0:
        return 0.0
    w = want[:m].double()
    return float(((got[:m].double() - w).abs() / w.abs().clamp_min(
        1e-300)).max())


def count_gap(counts, want):
    return max(abs(c - want) for c in counts)
