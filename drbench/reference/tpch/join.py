"""``join``'s reference: a sort-merge inner join written afresh, its
rows in (key, left position, right position) order.

Compared: ``<as>_count_gap``, the largest gap of a call's row count
(every call); ``<as>_rows_bad``, the keys and values of the last call's
rows that differ (exact: a join moves values, it computes none).
"""

import torch

from drbench.reference.tpch import bad, count_gap


def join(lk, lv, rk, rv):
    """Inner join rows ``(keys, left values, right values)``."""
    lo = torch.argsort(lk, stable=True)
    ro = torch.argsort(rk, stable=True)
    slk, srk = lk[lo], rk[ro]
    start = torch.searchsorted(srk, slk, side="left")
    cnt = torch.searchsorted(srk, slk, side="right") - start
    li = torch.repeat_interleave(torch.arange(lk.numel(), device=lk.device),
                                 cnt)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(li.numel(), device=lk.device) - first[li]
    ri = ro[start[li] + off]
    return slk[li], lv[lo[li]], rv[ri]


def expect(state, op):
    f = state.frame
    (lk, lv), (rk, rv) = op["left"], op["right"]
    for part, t in zip(("key", "left", "right"),
                       join(f[lk], f[lv], f[rk], f[rv])):
        f[f"{op['as']}.{part}"] = t


def outputs(state, op, sample):
    a = op["as"]
    out = {p: state.frame[f"{a}.{p}"] for p in ("key", "left", "right")}
    out["counts"] = [out["key"].numel()] * state.calls
    return out


def check(state, op, got, limits, sample):
    a = op["as"]
    want = {p: state.frame[f"{a}.{p}"] for p in ("key", "left", "right")}
    rows_bad = sum(bad(got[p], want[p]) for p in want)
    return [(f"{a}_count_gap", count_gap(got["counts"], want["key"].numel()),
             limits[f"{a}_count_gap"]),
            (f"{a}_rows_bad", rows_bad, limits[f"{a}_rows_bad"])]
