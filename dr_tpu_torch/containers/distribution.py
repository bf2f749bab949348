"""Distribution policies for ``distributed_vector`` (counterpart of
``dr_tpu/containers/distribution.py``, kept as the port's own copy).

A ``block_distribution`` gives every rank an explicit owned size (zeros
allowed).  The physical layout stays one padded row per rank of equal
capacity; the distribution only changes the logical metadata, which
every algorithm reads through ``algorithms._common.layout_geometry``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["block_distribution", "even_sizes"]


def even_sizes(n: int, nshards: int) -> Tuple[int, ...]:
    """The default ceil-division block sizes: seg = ceil(n/p), short tail."""
    seg = -(-n // nshards) if n else 1
    sizes = []
    left = n
    for _ in range(nshards):
        take = min(seg, left)
        sizes.append(take)
        left -= take
    return tuple(sizes)


class block_distribution:
    """Explicit per-rank owned sizes: rank r owns logical
    ``[starts[r], starts[r] + sizes[r])``."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = tuple(int(s) for s in sizes)
        if any(s < 0 for s in self.sizes):
            raise ValueError("block sizes must be >= 0")

    @property
    def n(self) -> int:
        return sum(self.sizes)

    def layout_entry(self):
        """``layout[1]``: the int segment size for the uniform
        ceil-division layout, else the tagged size tuple."""
        nshards = len(self.sizes)
        if self.sizes == even_sizes(self.n, nshards):
            return -(-self.n // nshards) if self.n else 1
        return ("b",) + self.sizes

    def __repr__(self):
        return f"block_distribution({list(self.sizes)})"

    def __eq__(self, other):
        return (isinstance(other, block_distribution)
                and self.sizes == other.sizes)

    def __hash__(self):
        return hash(self.sizes)
