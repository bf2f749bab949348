"""Profiling and timing helpers (counterpart of
``dr_tpu/utils/profiling.py``).

- ``trace(logdir, activities=None)``: a context manager over
  ``torch.profiler.profile`` that records host activity, and the card's
  kernels and copies (CUPTI) when CUDA activity is asked for, and writes
  a Chrome trace into ``logdir``; ``annotate(name)`` is
  ``torch.profiler.record_function``, a named range inside it.
- ``device_timer(run_sync, r1, r2, samples)``: the marginal method, the
  per-op seconds of a fused ``*_n``-style callable with the per-call
  constant cancelled.
- ``marginal(...)``: the adaptive variant, which widens the loop count
  until the measured difference dominates the jitter and raises
  :class:`JitterError` instead of returning noise.
- ``profile_phases(make_run, names)``: the per-phase breakdown of a
  program from prefix-truncated variants (the sort's ``stop_after``,
  ``algorithms/sort.py``'s ``sort_phases_n``): ``make_run(i)`` returns a
  ``run_sync`` for the prefix ending at ``names[i]``, each prefix is
  timed by :func:`marginal`, and phase ``i`` costs the difference of
  consecutive prefixes.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np

__all__ = ["trace", "annotate", "device_timer", "marginal",
           "JitterError", "PhaseBreakdown", "profile_phases"]

#: the Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _runtime_activities():
    """The activities the current runtime's devices call for: the host
    always, CUDA when a rank lives on a card."""
    from torch.profiler import ProfilerActivity
    from ..parallel import runtime as _rt
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in _rt.runtime().devices):
        acts.append(ProfilerActivity.CUDA)
    return acts


def _device_events(path: str) -> int:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return sum(1 for e in doc.get("traceEvents", ())
               if e.get("cat") in DEVICE_CATS)


@contextlib.contextmanager
def trace(logdir: str, activities=None):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``logdir/dr_tpu_torch_<pid>_<ns>.pt.trace.json``
    (Perfetto or ``chrome://tracing`` open it).  ``activities`` (a list
    of ``torch.profiler.ProfilerActivity``) defaults to those of the
    current runtime's devices.  Yields the ``profile`` object.

    A trace that asks for CUDA activity records it or raises: without a
    card or CUPTI it raises before the block runs, and a block that ends
    with no kernel, copy or memset on the card raises after the trace is
    written."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    acts = list(_runtime_activities() if activities is None
                else activities)
    cuda = ProfilerActivity.CUDA in acts
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("profiling.trace: CUDA activity asked for, but "
                           "no CUDA device is visible")
    if cuda and ProfilerActivity.CUDA not in supported_activities():
        raise RuntimeError("profiling.trace: CUDA activity asked for, but "
                           "this torch's profiler cannot record it (no "
                           "CUPTI)")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"dr_tpu_torch_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    if cuda and not _device_events(path):
        raise RuntimeError(f"profiling.trace: CUDA activity asked for, but "
                           f"{path} holds no event of the card")


def annotate(name: str):
    """Named region inside a :func:`trace` capture."""
    import torch
    return torch.profiler.record_function(name)


def _interleaved_delta(run_sync, ra: int, rb: int,
                       samples: int) -> float:
    """The marginal method's core: interleave ``samples`` timings of the
    ra-round and rb-round loops and divide the median difference by
    rb - ra (the per-call constant cancels)."""
    t1s, t2s = [], []
    for _ in range(samples):
        t0 = time.perf_counter()
        run_sync(ra)
        t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_sync(rb)
        t2s.append(time.perf_counter() - t0)
    return (float(np.median(t2s)) - float(np.median(t1s))) / (rb - ra)


def device_timer(run_sync, r1: int = 4, r2: int = 36,
                 samples: int = 5) -> float:
    """Per-op device seconds of a loop callable by the marginal method:
    ``run_sync(r)`` must run ``r`` chained ops and wait for the device
    (read a device scalar).  The host's per-call constant cancels in the
    r2 - r1 difference.  The ``*_n`` family (``dot_n``,
    ``inclusive_scan_n``, ``ring_attention_n``, ``gemv_n``,
    ``span_halo.exchange_n``) gives such loops.  For the adaptive variant
    use :func:`marginal`."""
    for r in (r1, r2):
        run_sync(r)  # warm
    return _interleaved_delta(run_sync, r1, r2, samples)


class JitterError(RuntimeError):
    """Measurement (not kernel) failure of :func:`marginal`: the widened
    difference still drowned in the per-call jitter."""


def marginal(run_sync, r1: int = 4, r2: int = 36, samples: int = 5,
             min_spread: float = 0.3, rmax: int = 4096) -> float:
    """Per-op device seconds by the marginal method: time a loop of r1
    ops and one of r2 ops (each called once and synced once),
    interleaved, and divide the median difference by r2 - r1.

    Adaptive: the difference means something only once it dominates the
    jitter.  After a pilot estimate, if (r2 - r1) * dt falls under
    ``min_spread`` seconds the loop count is widened until it would not;
    a difference that still stays an order of magnitude under the
    threshold raises :class:`JitterError`.  ``min_spread <= 0`` turns the
    widening off."""
    def once(ra, rb):
        return _interleaved_delta(run_sync, ra, rb, samples)

    run_sync(r1)  # warm
    run_sync(r2)
    dt = once(r1, r2)
    if min_spread > 0 and (r2 - r1) * dt < min_spread:
        # the pilot was noise-level (possibly <= 0): widen so the true
        # difference would exceed min_spread even if the op is ~10x faster
        # than the pilot suggests; t_warm / r2 overestimates the per-op
        # time (it holds the per-call constant), so the ~3 s cap it
        # implies is conservative
        t0 = time.perf_counter()
        run_sync(r2)
        t_warm = time.perf_counter() - t0
        per = max(dt, min_spread / 10.0 / rmax)
        cap = max(r2, int(3.0 * r2 / max(t_warm, 1e-3)))
        r2w = min(rmax, cap, r1 + max(2 * (r2 - r1),
                                      int(np.ceil(min_spread / per))))
        if r2w > r2:
            run_sync(r2w)  # warm the widened loop
            dt = once(r1, r2w)
            r2 = r2w
    if dt <= 0 or (r2 - r1) * dt < min_spread / 10.0:
        raise JitterError("marginal measurement drowned in dispatch "
                          f"jitter (dt={dt:.3e} s/op over "
                          f"{r2 - r1} ops)")
    return dt


class PhaseBreakdown:
    """Per-phase seconds of a program from cumulative prefix timings
    (:func:`profile_phases`).  ``seconds`` maps a phase to its marginal
    cost (clamped at 0: noise can order two near-equal prefixes
    backwards); ``total`` is the last prefix's cumulative per-op time
    (the whole program)."""

    def __init__(self, names, cumulative):
        assert len(names) == len(cumulative) and names
        self.names = tuple(names)
        self.cumulative = tuple(float(c) for c in cumulative)
        per = []
        prev = 0.0
        for c in self.cumulative:
            per.append(max(0.0, c - prev))
            prev = max(prev, c)
        self.seconds = dict(zip(self.names, per))
        self.total = self.cumulative[-1]

    @property
    def dominant(self) -> str:
        """The costliest phase's name."""
        return max(self.names, key=lambda nm: self.seconds[nm])

    def fractions(self) -> dict:
        """Phase share of the total (0 when the total itself is 0)."""
        tot = sum(self.seconds.values())
        return {nm: (self.seconds[nm] / tot if tot > 0 else 0.0)
                for nm in self.names}

    def detail(self, bytes_per_op: float, digits: int = 3) -> dict:
        """Per-phase effective giga-units/s for a program moving
        ``bytes_per_op`` units an iteration (bytes give GB/s, FLOPs
        GFLOP/s); a phase that measured ~0 reports 0.0, not inf."""
        out = {}
        for nm in self.names:
            s = self.seconds[nm]
            out[nm] = round(bytes_per_op / s / 1e9, digits) if s > 0 \
                else 0.0
        return out

    def table(self, bytes_per_op: float = None,
              unit: str = "GB/s") -> str:
        """Human-readable per-phase table; ``unit`` labels the rate
        column."""
        tot = sum(self.seconds.values()) or 1.0
        lines = []
        for nm in self.names:
            s = self.seconds[nm]
            line = f"  {nm:<12s} {s * 1e3:9.3f} ms  {s / tot:6.1%}"
            if bytes_per_op is not None and s > 0:
                line += f"  {bytes_per_op / s / 1e9:8.2f} {unit}"
            lines.append(line)
        lines.append(f"  {'total':<12s} {self.total * 1e3:9.3f} ms")
        return "\n".join(lines)


def profile_phases(make_run, names, r1: int = 2, r2: int = 10,
                   samples: int = 5, min_spread: float = 0.3,
                   rmax: int = 4096) -> PhaseBreakdown:
    """Phase breakdown of a program from prefix truncations.

    ``make_run(i)`` returns a ``run_sync(r)`` running ``r`` iterations
    of the program cut after phase ``names[i]`` (the last name being the
    whole program) and waiting for the device.  Each prefix is timed by
    :func:`marginal`; a phase costs the difference of consecutive
    prefixes.  A prefix whose measurement drowns in jitter
    (:class:`JitterError`) is recorded at its predecessor's cumulative
    time (phase cost 0) rather than failing the breakdown."""
    cum = []
    for i in range(len(names)):
        run = make_run(i)
        try:
            dt = marginal(run, r1=r1, r2=r2, samples=samples,
                          min_spread=min_spread, rmax=rmax)
        except JitterError:
            dt = cum[-1] if cum else 0.0
        cum.append(dt)
    return PhaseBreakdown(names, cum)
