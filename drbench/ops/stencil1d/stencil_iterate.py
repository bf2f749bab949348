"""``stencil_iterate`` (``steps``): the plain step, double-buffered
through a second vector."""


def run(prog, op):
    prog.dt.stencil_iterate(prog.a, prog.vector("b"), prog.w, op["steps"])
    return {"cells": prog.n * op["steps"]}
