"""Billions of cell updates a second: n x steps of every call completed
in the window, over the window's seconds."""


def read(ctx):
    cells = ctx.work.get("cells")
    return cells / ctx.window_s / 1e9 if cells else None
