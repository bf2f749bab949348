"""Milliseconds on the card a traced call of the joins' merges: the work
launched under the port's ``relational.join.partition_plan`` and
``relational.join.merge`` ranges (the broadcast route plans inside its
merge)."""

from drbench.metrics_spans import device_ms

MERGE = ("relational.join.partition_plan", "relational.join.merge")


def read(ctx):
    return device_ms(ctx, lambda n: n in MERGE, "join_merge_ms.q3")
