"""``stencil_iterate_matmul`` (``steps``, ``k_block``): K1's composed
passes over the field."""


def run(prog, op):
    prog.dt.stencil_iterate_matmul(prog.a, prog.w, op["steps"],
                                   k_block=op["k_block"])
    return {"cells": prog.n * op["steps"]}
