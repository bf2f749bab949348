"""``groupby``: the port's ``groupby_aggregate`` (``agg``) of the frame's
``values`` by ``keys`` into ``<as>.key`` and ``<as>.value``, sized for
one group a row; every call's group count is recorded."""


def run(prog, op):
    dt = prog.dt
    cap = max(1, prog.count(op["keys"]))
    dv = dt.distributed_vector
    gk = dv(cap, prog.dtype(op["keys"]))
    gv = dv(cap, prog.dtype(op["values"]))
    g = int(dt.groupby_aggregate(prog.vector(op["keys"]),
                                 prog.vector(op["values"]), gk, gv,
                                 agg=op["agg"]))
    prog.put(f"{op['as']}.key", gk, g)
    prog.put(f"{op['as']}.value", gv, g)
    prog.record(op, g)
    return {}


def outputs(prog, op):
    a = op["as"]
    return {"counts": prog.rec[a], "key": prog.tensor(f"{a}.key"),
            "value": prog.tensor(f"{a}.value")}
