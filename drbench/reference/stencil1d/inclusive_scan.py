"""``inclusive_scan``'s reference: the float64 cumsum of the program's
final field (the scan's own stage: the field is judged by
``field_drift``).

Compared: ``scan_gap``, the largest gap of the program's prefix sums
from it, over the largest prefix.
"""

import torch

from drbench.reference.stencil1d import rounded


def outputs(state, op, sample):
    prec = state.prec["inclusive_scan"]
    return {"scan": torch.cumsum(rounded(state.field, prec).double(),
                                 0).float()}


def check(state, op, got, limits, sample):
    cs = torch.cumsum(state.got, 0)
    top = float(cs.abs().max())
    return [("scan_gap", float((got["scan"].double() - cs).abs().max()) / top,
             limits["scan_gap"])]
