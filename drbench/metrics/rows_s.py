"""Millions of lineitem rows a second: the left rows of every call
completed in the window, over the window's seconds."""


def read(ctx):
    rows = ctx.work.get("rows")
    return rows / ctx.window_s / 1e6 if rows else None
