"""``dot``: ``dot(a, a)`` of the field, a host scalar (K3), kept for
every call."""


def run(prog, op):
    prog.rec.setdefault("dot", []).append(prog.dt.dot(prog.a, prog.a))
    return {}


def outputs(prog, op):
    return {"values": prog.rec["dot"]}
