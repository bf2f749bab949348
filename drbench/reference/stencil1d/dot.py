"""``dot``'s reference: the field's ``sum x^2`` where the call reads it.

Compared: ``dot_drift``, the largest relative gap of a dot product from
Parseval's over the steps before it, over the sampled calls (the field's
drift per step, as ``field_drift``); ``last_dot_gap``, the relative gap
of the last call's dot product from the float64 dot of the program's
final field, where that field is its input (the dot's own stage: the
field is judged by ``field_drift``).
"""

import torch

from drbench.reference.stencil1d import rounded


def expect(state, op):
    state.mark("dot")


def outputs(state, op, sample):
    """The control's dot products: the sampled ones in closed form over
    the rounded passes, the last one of the final field rounded to the
    op's precision."""
    marks = state.marks["dot"]
    values = [None] * len(marks)
    for i in sample:
        e = sum(2.0 * c * state.logs[k] for k, c in marks[i][1].items())
        values[i] = (float((state.P * torch.exp(e)).sum()) if marks[i][1]
                     else float(state.P.sum()))
    xr = rounded(state.field, state.prec["dot"]).double()
    values[-1] = float(xr @ xr)
    return {"values": values}


def check(state, op, got, limits, sample):
    marks, values = state.marks["dot"], got["values"]
    worst = 0.0
    for i in sample:
        exact = state.exact_dot(marks[i][0])
        worst = max(worst, abs(values[i] - exact) / abs(exact)
                    / max(marks[i][0], 1))
    res = [("dot_drift", worst, limits["dot_drift"])]
    if marks[-1][0] == state.steps:
        exact = float(state.got @ state.got)
        res.append(("last_dot_gap", abs(values[-1] - exact) / exact,
                    limits["last_dot_gap"]))
    return res
