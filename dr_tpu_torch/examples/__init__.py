"""The JAX package's ``examples/`` scripts on ``dr_tpu_torch``.

One module a script, under the same name, each with the script's
arguments, defaults, oracle and printed line, and a
``main(argv=None) -> int`` that returns 0 only when its oracle passes::

    python -m dr_tpu_torch.examples.dot_product -n 1048576
    python -m dr_tpu_torch.examples.sort_example --cpu 8
    python -m dr_tpu_torch.examples.windows_example --ranks 4

Every module takes the same device arguments (:func:`device_args`):
none gives the visible CUDA devices, one rank each (``dt.init()``,
which raises without one); ``--cpu N`` N CPU ranks; ``--ranks P`` P
logical ranks on ``cuda:0``.  No example falls back to the CPU.
"""

from __future__ import annotations

import argparse

__all__ = ["NAMES", "device_args", "init", "expect"]

#: the examples, one module each
NAMES = ("conjugate_gradient", "dot_product", "gemv_example", "heat_2d",
         "inclusive_scan_example", "matrix_example",
         "ring_attention_example", "sort_example", "spmm_example",
         "stencil_1d", "top_k", "transpose", "vector_add", "views_example",
         "windows_example")


def device_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Add ``--cpu N`` and ``--ranks P`` (one of them) to ``ap``."""
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on N CPU ranks")
    g.add_argument("--ranks", type=int, default=0, metavar="P",
                   help="run on P logical ranks of cuda:0")
    return ap


def init(args):
    """Initialise the runtime the device arguments name; returns it."""
    import dr_tpu_torch as dt
    if args.cpu:
        return dt.init(["cpu"] * args.cpu)
    if args.ranks:
        return dt.init(["cuda:0"] * args.ranks)
    return dt.init()


def expect(ok, what: str) -> None:
    """An oracle's check: raises ``AssertionError(what)`` unless ``ok``
    (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(what)
