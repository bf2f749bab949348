"""``stencil_iterate_blocked`` (``steps``, ``time_block``): K2's passes
over the field."""


def run(prog, op):
    prog.dt.stencil_iterate_blocked(prog.a, prog.w, op["steps"],
                                    time_block=op["time_block"])
    return {"cells": prog.n * op["steps"]}
