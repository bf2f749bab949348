"""dr_tpu_torch.serve — one resident device claim, crash-safe
multi-client serving (counterpart of ``dr_tpu/serve``).

A long-lived daemon (:class:`Server`) claims the card's ranks once and
multiplexes request streams from many thin :class:`Client` processes
over a local Unix-domain socket: a length-prefixed JSON/npy wire
protocol (``protocol``), admission control and weighted-fair tenant
scheduling (``queue``), request batching into one deferred-plan flush,
classified error serialization, a shared-memory arena for bulk bytes
(``arena``), per-tenant resident containers (``resident`` +
:class:`Ref`), a crash-safe resident journal (``journal``), and N
replicas behind a consistent-hash router (``router``: :class:`Router`
starts the fleet, in process or spawned, :class:`RouterClient` is the
tenant-facing front).  ``python -m dr_tpu_torch.serve`` runs one daemon
foreground.
Environment: ``DR_GPU_SERVE_*`` (the JAX package reads
``DR_TPU_SERVE_*``).
"""

from .arena import Arena, ClientArena
from .client import (Client, Ref, reset_retry_budget,
                     shared_retry_budget)
from .daemon import (OPS, Server, daemon_alive, default_socket_path,
                     reset_state)
from .journal import Journal
from .queue import AdmissionQueue, Request
from .resident import ResidentCache
from .router import CircuitBreaker, HashRing, Router, RouterClient

__all__ = ["Server", "Client", "Ref", "AdmissionQueue", "Request",
           "OPS", "Arena", "ClientArena", "ResidentCache", "HashRing",
           "Router", "RouterClient", "CircuitBreaker", "Journal",
           "daemon_alive", "default_socket_path",
           "shared_retry_budget", "reset"]


def reset() -> None:
    """Stop any live in-process servers AND spawned fleets, clear the
    serve env markers, drop the shared retry budget, and unlink the
    journal files this process touched (the tests' between-test hook)."""
    from . import journal as _journal
    from . import router as _router
    _router.reset_state()  # fleets first: their daemons die with them
    reset_state()
    reset_retry_budget()
    _journal.reset_state()
