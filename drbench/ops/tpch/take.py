"""``take``: the rows of the frame's table ``table`` at the positions in
``index``, for the columns ``keep``, as ``<as>.<column>``; the user's
own torch gather."""


def run(prog, op):
    idx = prog.tensor(op["index"]).long()
    for col in op["keep"]:
        prog.put(f"{op['as']}.{col}", prog.tensor(f"{op['table']}.{col}")[idx])
    return {}
