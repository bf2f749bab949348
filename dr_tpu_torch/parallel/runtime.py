"""Runtime: the rank -> device list of the port.

Counterpart of ``dr_tpu/parallel/runtime.py``.  Where the JAX package
owns a ``jax.sharding.Mesh``, the port owns a plain list of
``torch.device``s, one entry per logical rank.  The list may repeat a
device: that is how the tests run 8 ranks on ``cpu`` and how one card
hosts several ranks (``get_duplicated_devices``, the reference's
``shp/util.hpp:119-136``).

``init()`` with no arguments takes the visible CUDA devices and raises
when there are none; the CPU is used only when the caller names it.

Elastic bookkeeping (``utils/elastic.py``).  Containers register with
their runtime at creation (:meth:`Runtime.register`, a weak set), so a
shrink or a grow can walk the live ones.  Because ranks may repeat a
device, a lost rank is a rank slot, never a ``torch.device``: each
runtime keeps its rank slots (``slots``: one id a rank, the position the
rank had in the list ``init()`` first admitted) and the slots earlier
shrinks dropped (``dropped``: ``(slot, device)`` pairs).
:func:`probe_recovered` answers from ``dropped``.  On one card a real
device loss kills every rank at once, so only an injected
``device.lost`` (or a failure pinned on a rank by
``elastic.attribute``) leaves surviving ranks; a shrink over ranks that
share a card moves state between ranks of the same card.
``init()`` fires the ``runtime.init`` fault site first, then touches
every CUDA device of the list once under ``with_deadline``
(:data:`INIT_DEADLINE_S`): a failed or hung first touch raises
classified under the site ``runtime.init``, and nothing switches to the
CPU instead.

Two execution modes.  Single controller (``init()``): one process drives
every rank.  Multi-process (``collectives.init_distributed``, the
counterpart of the JAX package's ``jax.distributed`` runtime): every
process runs the same program and owns the ranks whose ``owners`` entry
is its ``process_index`` (one rank a process).  ``devices[r]`` is then
the device this process holds rank r's values on: its own device for a
rank it owns, and the device a value received from a rank it does not
own lands on.  A container holds rows only for :attr:`Runtime.local_ranks`,
and the collectives move values across the process boundary through
``torch.distributed``.  :func:`require_single_process` is the entry
check of every path that has no multi-process form yet.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import torch

from ..utils import faults as _faults
from ..utils import resilience as _res

__all__ = ["Runtime", "init", "final", "finalize", "runtime",
           "is_initialized", "nprocs", "devices", "barrier", "fence",
           "get_duplicated_devices", "probe_recovered",
           "mp_runtime", "require_single_process"]


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Runtime:
    """One entry of ``devices`` per rank; ``nprocs`` ranks.  ``slots``
    and ``dropped`` are the elastic layer's rank-slot bookkeeping (see
    the module docstring)."""

    def __init__(self, devices: Sequence[torch.device], *,
                 process_index: int = 0, process_count: int = 1,
                 owners: Optional[Sequence[int]] = None):
        self.devices = [_as_device(d) for d in devices]
        self.slots = list(range(len(self.devices)))
        self.dropped: list = []
        self._live = weakref.WeakSet()
        #: the process that owns each rank (all 0 for one controller)
        self.owners = list(owners) if owners is not None \
            else [0] * len(self.devices)
        if len(self.owners) != len(self.devices):
            raise ValueError("one owner a rank")
        self.process_index = process_index
        self.process_count = process_count
        #: the ranks this process holds rows for, in rank order
        self.local_ranks = [r for r, o in enumerate(self.owners)
                            if o == process_index]

    @property
    def multi_process(self) -> bool:
        return self.process_count > 1

    def is_local(self, r: int) -> bool:
        return self.owners[r] == self.process_index

    @property
    def home(self) -> torch.device:
        """Where a value every rank contributes to (a reduction, a
        gathered array) lands in this process: rank 0's device for one
        controller, the first local rank's device for a process of a
        multi-process runtime."""
        return self.devices[self.local_ranks[0]]

    def register(self, container) -> None:
        """Track ``container`` (weakly) as living on this runtime."""
        self._live.add(container)

    def live_containers(self) -> list:
        """The registered containers still alive: the population an
        elastic shrink or grow walks."""
        return list(self._live)

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
        """A fence; in a multi-process runtime also a rendezvous of the
        processes (``torch.distributed.barrier``), so host effects (a
        checkpoint write, a log line) are ordered across them.  With one
        controller, program order plus the fence is the rendezvous."""
        self.fence()
        if self.multi_process:
            import torch.distributed as dist
            dist.barrier()

    def __repr__(self):
        if self.multi_process:
            return (f"Runtime(nprocs={self.nprocs}, process "
                    f"{self.process_index} of {self.process_count}, "
                    f"local_ranks={self.local_ranks}, "
                    f"devices={self.devices})")
        return f"Runtime(nprocs={self.nprocs}, devices={self.devices})"


#: the multi-process slice still to come (ROADMAP.md): the ``slice_`` a
#: :func:`require_single_process` call names
HOST_LAYERS = "deferred plans, elastic, tuning and serve"


def mp_runtime() -> Optional[Runtime]:
    """The initialised runtime when it spans several processes, else
    None."""
    rt = _runtime
    return rt if rt is not None and rt.multi_process else None


def require_single_process(what: str, slice_: str) -> None:
    """The entry check of a path that has no multi-process form yet: in
    a multi-process runtime it raises a classified ``ProgramError``
    naming the slice that brings it, before any row is read, so the path
    never runs on a partial set of rows."""
    rt = mp_runtime()
    if rt is not None:
        raise _res.ProgramError(
            f"{what} does not run in a multi-process runtime yet "
            f"(process {rt.process_index} of {rt.process_count}); it "
            f"comes with the multi-process slice of {slice_}",
            site="runtime.multi_process")


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


def _init_processes(device: torch.device, process_index: int,
                    process_count: int) -> Runtime:
    """The multi-process runtime of ``collectives.init_distributed``:
    ``process_count`` ranks, rank r owned by process r, every rank's
    values held on ``device`` in this process."""
    global _runtime
    _faults.fire("runtime.init")
    dev = _as_device(device)
    _first_touch([dev])
    _runtime = Runtime([dev] * process_count,
                       process_index=process_index,
                       process_count=process_count,
                       owners=range(process_count))
    return _runtime


def probe_recovered(timeout_s: float = 30.0):
    """The devices of the rank slots a shrink dropped that answer now:
    the grow-back candidates (``utils/elastic.grow_session``), in slot
    order.  Fires the ``device.recover`` site first.  A CPU slot always
    answers; a CUDA slot answers when its index is below
    ``torch.cuda.device_count()`` and a one-element allocation there
    completes.  The whole probe runs under ``with_deadline``, so a
    wedged card costs at most ``timeout_s``.  ``[]`` before ``init()``
    or when no slot was dropped."""
    _faults.fire("device.recover")
    if _runtime is None or not _runtime.dropped:
        return []
    cand = [d for _slot, d in _runtime.dropped]

    def answer():
        out = []
        for d in cand:
            if d.type == "cuda":
                if d.index >= torch.cuda.device_count():
                    continue
                try:
                    torch.empty(1, device=d)
                    torch.cuda.synchronize(d)
                except RuntimeError:
                    continue
            out.append(d)
        return out

    return _res.with_deadline(answer, timeout_s, site="device.recover",
                              dump=False)


def runtime() -> Runtime:
    if _runtime is None:
        init()
    return _runtime  # type: ignore[return-value]


def is_initialized() -> bool:
    return _runtime is not None


def final() -> None:
    """Drop the runtime; a multi-process runtime also leaves its process
    group (``torch.distributed.destroy_process_group``)."""
    global _runtime
    rt = _runtime
    if rt is not None:
        rt.fence()
    _runtime = None
    if rt is not None and rt.multi_process:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


finalize = final


def nprocs() -> int:
    return runtime().nprocs


def devices():
    return runtime().devices


def barrier() -> None:
    runtime().barrier()


def fence() -> None:
    runtime().fence()
