"""Milliseconds on the card a traced call of the joins' sorts: the work
launched under the port's ``relational.join.sort_left`` and
``relational.join.sort_right`` ranges (scratch copies and sorts)."""

from drbench.metrics_spans import device_ms

SORTS = ("relational.join.sort_left", "relational.join.sort_right")


def read(ctx):
    return device_ms(ctx, lambda n: n in SORTS, "join_sort_ms.q3")
