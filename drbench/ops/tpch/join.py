"""``join``: the port's inner ``join`` of ``left`` ``[key, value]``
against ``right`` ``[key, value]`` (frame names) into ``<as>.key``,
``<as>.left``, ``<as>.right``, sized for one row a left row (the right
key is a primary key); every call's row count is recorded."""


def run(prog, op):
    dt = prog.dt
    lk, lv = op["left"]
    rk, rv = op["right"]
    cap = max(1, prog.count(lk))
    dv = dt.distributed_vector
    outs = (dv(cap, prog.dtype(lk)), dv(cap, prog.dtype(lv)),
            dv(cap, prog.dtype(rv)))
    m = int(dt.join(prog.vector(lk), prog.vector(lv), prog.vector(rk),
                    prog.vector(rv), *outs, how=op.get("how", "inner")))
    for part, v in zip(("key", "left", "right"), outs):
        prog.put(f"{op['as']}.{part}", v, m)
    prog.record(op, m)
    return {}


def outputs(prog, op):
    a = op["as"]
    return {"counts": prog.rec[a],
            **{p: prog.tensor(f"{a}.{p}") for p in ("key", "left", "right")}}
