"""``groupby``'s reference: ascending distinct keys and their ``sum``
(float64; bfloat16 in the control), ``max`` or ``min``.

Compared: ``<as>_count_gap`` (every call's group count), ``<as>_keys_bad``
(exact) and ``<as>_value_gap``, the largest relative gap of a group's
value from the reference's.
"""

import torch

from drbench.reference.tpch import bad, count_gap, rel_gap


def groupby(keys, vals, agg, acc):
    order = torch.argsort(keys, stable=True)
    uk, inv = torch.unique_consecutive(keys[order], return_inverse=True)
    v = vals[order]
    if agg == "sum":
        out = torch.zeros(uk.numel(), dtype=acc, device=keys.device)
        return uk, out.index_add_(0, inv, v.to(acc))
    if agg in ("max", "min"):
        out = torch.empty(uk.numel(), dtype=v.dtype, device=keys.device)
        return uk, out.scatter_reduce_(0, inv, v, "a" + agg,
                                       include_self=False)
    raise ValueError(f"tpch reference: agg {agg!r} is not written")


def expect(state, op):
    f = state.frame
    vals = state.low(f[op["values"]])
    uk, uv = groupby(f[op["keys"]], vals, op["agg"], state.acc())
    f[f"{op['as']}.key"], f[f"{op['as']}.value"] = uk, uv


def outputs(state, op, sample):
    a = op["as"]
    key = state.frame[f"{a}.key"]
    return {"counts": [key.numel()] * state.calls, "key": key,
            "value": state.frame[f"{a}.value"]}


def check(state, op, got, limits, sample):
    a = op["as"]
    key, value = state.frame[f"{a}.key"], state.frame[f"{a}.value"]
    return [(f"{a}_count_gap", count_gap(got["counts"], key.numel()),
             limits[f"{a}_count_gap"]),
            (f"{a}_keys_bad", bad(got["key"], key), limits[f"{a}_keys_bad"]),
            (f"{a}_value_gap", rel_gap(got["value"], value),
             limits[f"{a}_value_gap"])]
