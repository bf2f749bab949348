"""Spawning helpers shared by the port's multi-process test files
(``test_torch_multiprocess*.py``): each of those files is its own
worker, started once a process with ``python <file> <pid> <nproc>
<port> <out> [device] [args...]``.  Imports neither
``jax`` nor ``dr_tpu``."""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(script, nproc, out, device="cpu", deadline_s=120.0, args=(),
          exits=None):
    """Run ``nproc`` copies of the worker ``script`` with their ranks on
    ``device`` (``args`` follow it on each command line); they have
    ``deadline_s`` together, and a failed or hung one gets its peers
    killed so every worker's output is reported.  Each worker must print
    ``MP-OK`` and write ``<out>.<pid>.npz``, except a pid of ``exits``,
    which must end with the exit code given there (a worker that kills
    itself) and writes nothing.  Returns the files' contents in process
    order (None for a pid of ``exits``)."""
    exits = exits or {}
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(nproc), str(port), out,
         device] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for pid in range(nproc)]
    outs = [None] * nproc

    def drain(i, p):
        outs[i], _ = p.communicate()

    threads = [threading.Thread(target=drain, args=(i, p))
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            break
        if any(p.poll() not in (None, exits.get(i, 0))
               for i, p in enumerate(procs)):
            time.sleep(1)  # let the peers fail and flush on their own
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for t in threads:
        t.join(timeout=30)
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if pid in exits:
            assert p.returncode == exits[pid], \
                f"process {pid} of {nproc} ended with {p.returncode}, " \
                f"not {exits[pid]}:\n{(o or '')[-3000:]}"
            continue
        assert p.returncode == 0 and "MP-OK" in (o or ""), \
            f"process {pid} of {nproc} failed ({p.returncode}):\n" \
            f"{(o or '')[-3000:]}"
    return [None if pid in exits else dict(np.load(f"{out}.{pid}.npz"))
            for pid in range(nproc)]


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()
