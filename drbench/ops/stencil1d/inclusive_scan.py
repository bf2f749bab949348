"""``inclusive_scan``: the field's prefix sums into a second vector
(K4)."""


def run(prog, op):
    prog.dt.inclusive_scan(prog.a, prog.vector("scan"))
    return {}


def outputs(prog, op):
    return {"scan": prog.vector("scan").to_array()}
