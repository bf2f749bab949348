"""``discount``: ``price * (1 - discount)`` of two frame columns into
``as``, in their dtype (TPC-H's ``l_extendedprice * (1 -
l_discount)``); the user's own torch code."""


def run(prog, op):
    p, d = prog.tensor(op["price"]), prog.tensor(op["discount"])
    prog.put(op["as"], p * (1 - d))
    return {}
