"""``top_k``: the port's ``top_k`` of the ``k`` largest ``values`` (ties
to the smaller position) into ``<as>.value`` and ``<as>.index``, then
the result's rows: each of the frame columns ``carry`` at those
positions, as ``<as>.<column>`` (the user's own gather)."""

import torch


def run(prog, op):
    dt = prog.dt
    k = op["k"]
    tv = dt.distributed_vector(k, prog.dtype(op["values"]))
    ti = dt.distributed_vector(k, torch.int32)
    dt.top_k(prog.vector(op["values"]), tv, ti)
    prog.put(f"{op['as']}.value", tv, k)
    prog.put(f"{op['as']}.index", ti, k)
    idx = ti.to_array().long()
    for col in op["carry"]:
        prog.put(f"{op['as']}.{col}", prog.tensor(col)[idx])
    return {}


def outputs(prog, op):
    a = op["as"]
    return {"value": prog.tensor(f"{a}.value"),
            **{c: prog.tensor(f"{a}.{c}") for c in op["carry"]}}
