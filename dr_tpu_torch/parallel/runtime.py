"""Runtime: the rank -> device list of the port.

Counterpart of ``dr_tpu/parallel/runtime.py``.  Where the JAX package
owns a ``jax.sharding.Mesh``, the port owns a plain list of
``torch.device``s, one entry per logical rank.  The list may repeat a
device: that is how the tests run 8 ranks on ``cpu`` and how one card
hosts several ranks (``get_duplicated_devices``, the reference's
``shp/util.hpp:119-136``).

``init()`` with no arguments takes the visible CUDA devices and raises
when there are none; the CPU is used only when the caller names it.
``init()`` fires the ``runtime.init`` fault site first, then touches
every CUDA device of the list once under ``with_deadline``
(:data:`INIT_DEADLINE_S`): a failed or hung first touch raises
classified under the site ``runtime.init``, and nothing switches to the
CPU instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import faults as _faults
from ..utils import resilience as _res

__all__ = ["Runtime", "init", "final", "finalize", "runtime",
           "is_initialized", "nprocs", "devices", "barrier", "fence",
           "get_duplicated_devices"]


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Runtime:
    """One entry of ``devices`` per rank; ``nprocs`` ranks."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [_as_device(d) for d in devices]

    @property
    def nprocs(self) -> int:
        return len(self.devices)

    def fence(self) -> None:
        """Wait for all work queued on the runtime's CUDA devices (CPU
        work is synchronous already); a recording deferred plan flushes
        first."""
        from ..plan import flush_reads
        flush_reads("fence")
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def barrier(self) -> None:
        # one process drives every rank: program order plus a fence is
        # the rendezvous
        self.fence()

    def __repr__(self):
        return f"Runtime(nprocs={self.nprocs}, devices={self.devices})"


_runtime: Optional[Runtime] = None


def _cuda_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "dr_tpu_torch.init(): no CUDA device is visible; pass the "
            "devices explicitly (e.g. init(['cpu'] * 8)) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_duplicated_devices(n: int, devices: Optional[Sequence] = None):
    """Pad the device list by repetition to ``n`` entries (reference
    ``shp/util.hpp:119-136``): several ranks then share one device."""
    devs = [_as_device(d) for d in
            (devices if devices is not None else _cuda_devices())]
    if not devs:
        raise RuntimeError("no devices to duplicate")
    return [devs[i % len(devs)] for i in range(n)]


#: seconds the first touch of the cards may take before ``init()`` gives
#: up (a context creation takes well under one)
INIT_DEADLINE_S = 300.0


def _first_touch(devs) -> None:
    """Allocate on, and wait for, every distinct CUDA device of ``devs``
    under a watchdog; any failure raises classified (site
    ``runtime.init``)."""
    cuda = [d for d in dict.fromkeys(devs) if d.type == "cuda"]
    if not cuda:
        return

    def touch():
        for d in cuda:
            torch.empty(1, device=d)
            torch.cuda.synchronize(d)

    try:
        _res.with_deadline(touch, INIT_DEADLINE_S, site="runtime.init")
    except Exception as e:
        ce = _res.classified(e, site="runtime.init")
        if ce is e:
            raise
        raise ce from e


def init(devices: Optional[Sequence] = None, *,
         nprocs: Optional[int] = None) -> Runtime:
    """Initialize the global runtime.  ``devices``: one entry per rank
    (repeats allowed); default all visible CUDA devices.  ``nprocs``
    keeps the first ``nprocs`` entries."""
    global _runtime
    _faults.fire("runtime.init")
    devs = [_as_device(d) for d in
            (devices if devices is not None else _cuda_devices())]
    if nprocs is not None:
        if nprocs > len(devs):
            raise ValueError(f"nprocs={nprocs} exceeds the {len(devs)} "
                             "devices given; repeat devices with "
                             "get_duplicated_devices")
        devs = devs[:nprocs]
    if not devs:
        raise ValueError("empty device list")
    _first_touch(devs)
    _runtime = Runtime(devs)
    return _runtime


def runtime() -> Runtime:
    if _runtime is None:
        init()
    return _runtime  # type: ignore[return-value]


def is_initialized() -> bool:
    return _runtime is not None


def final() -> None:
    global _runtime
    if _runtime is not None:
        _runtime.fence()
    _runtime = None


finalize = final


def nprocs() -> int:
    return runtime().nprocs


def devices():
    return runtime().devices


def barrier() -> None:
    runtime().barrier()


def fence() -> None:
    runtime().fence()
