"""``top_k``'s reference: the ``k`` largest values, ties to the smaller
position, and the ``carry`` columns at those positions.

Compared: ``<as>_value_gap``, the largest relative gap of a value;
``<as>_rows_bad``, the carried cells that differ (exact).
"""

import torch

from drbench.reference.tpch import bad, rel_gap


def expect(state, op):
    f = state.frame
    v = f[op["values"]]
    pick = torch.argsort(v, descending=True, stable=True)[:op["k"]]
    f[f"{op['as']}.value"] = v[pick]
    for col in op["carry"]:
        f[f"{op['as']}.{col}"] = f[col][pick]


def outputs(state, op, sample):
    a = op["as"]
    return {"value": state.frame[f"{a}.value"],
            **{c: state.frame[f"{a}.{c}"] for c in op["carry"]}}


def check(state, op, got, limits, sample):
    a = op["as"]
    f = state.frame
    return [(f"{a}_value_gap", rel_gap(got["value"], f[f"{a}.value"]),
             limits[f"{a}_value_gap"]),
            (f"{a}_rows_bad", sum(bad(got[c], f[f"{a}.{c}"])
                                  for c in op["carry"]),
             limits[f"{a}_rows_bad"])]
