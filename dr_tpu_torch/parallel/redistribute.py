"""Collective redistribution: a vector's re-layout on the ring
(counterpart of ``dr_tpu/parallel/redistribute.py``; the recipe of
"Memory-efficient array redistribution through portable collective
communication", arXiv:2112.01075).

* :func:`plan_moves` is the static diff of the source and target block
  layouts: for each hop distance ``t``, the overlap of source rank r's
  owned window with target rank ``(r + t) % p``'s window.  Hops that move
  nothing are dropped.  It is host arithmetic, the JAX package's.
* The exchange builds the target rows from zeros, copies hop 0 (each
  rank's own overlap) in place, then runs one
  :func:`~.pipeline.ring_exchange` hop a nonzero distance.  Both windows
  of a hop are contiguous, so a hop is a slice copy from rank r's source
  row into rank ``(r + t) % p``'s target row: no mask over whole rows, no
  gather, and no device memory beyond the target rows and one hop's
  buckets (views, where the ranks share a device).  Pad, halo and tail
  cells stay zero, as the host-staged route leaves them, so the two
  routes give the same rows bit for bit.
* :func:`redistribute_vector` routes a re-layout: the collective
  exchange when source and target share the device list, else the
  host-staged route (the logical value through the host, then
  ``_rebind``, then ``assign_array``).  A failed collective exchange
  rolls the vector back to its old layout and rows.
* While tracing is armed (``dr_tpu_torch.obs``), a re-layout is a
  ``redistribute`` span with its route as ``impl`` (``collective`` or
  ``host``) and ``redistribute.phase`` children: ``plan``, ``exchange``
  and ``rebind`` on the collective route, which also adds the bytes that
  change rank to the ``redistribute.bytes_moved`` counter, and
  ``host_staged`` on the other.

Not carried over yet: the ``DR_TPU_REDISTRIBUTE`` override, the fault
sites, the deferred-plan recording (ROADMAP queue 1 item 3) and
``reshard_copy``, which nothing in the port calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs as _obs
from ..algorithms._common import layout_geometry
from .pipeline import ring_exchange

__all__ = ["plan_moves", "redistribute_vector"]


def plan_moves(src_layout, dst_layout):
    """Static src -> dst diff: ``(steps, moved)`` where ``steps`` is a list
    of ``(t, B_t, send_lo, send_len)`` hops: at distance ``t`` rank r
    sends logical window ``[send_lo[r], send_lo[r] + send_len[r])`` (its
    source overlap with target rank ``(r + t) % p``), ``B_t`` the widest
    window; hops of width 0 are dropped.  ``moved`` counts the elements
    that change rank."""
    p, s_cap, s_prev, s_nxt, n, s_starts, s_sizes = \
        layout_geometry(src_layout)
    dp, d_cap, d_prev, d_nxt, dn, d_starts, d_sizes = \
        layout_geometry(dst_layout)
    assert p == dp and n == dn, "redistribute: src/dst shard counts " \
        "and logical sizes must match on one mesh"
    steps = []
    moved = 0
    for t in range(1, p):
        lo = np.empty(p, np.int64)
        ln = np.empty(p, np.int64)
        for r in range(p):
            d = (r + t) % p
            a = max(int(s_starts[r]), int(d_starts[d]))
            b = min(int(s_starts[r]) + int(s_sizes[r]),
                    int(d_starts[d]) + int(d_sizes[d]))
            lo[r] = a
            ln[r] = max(0, b - a)
        bt = int(ln.max(initial=0))
        if bt > 0:
            steps.append((t, bt, lo, ln))
            moved += int(ln.sum())
    return steps, moved


def exchange_rows(src_rows, devices, src_layout, dst_layout, dtype):
    """The target layout's rows, each on its rank's device, holding the
    source rows' logical values; every other cell is zero."""
    p, _, s_prev, _, n, s_starts, s_sizes = layout_geometry(src_layout)
    _, d_cap, d_prev, d_nxt, _, d_starts, d_sizes = \
        layout_geometry(dst_layout)
    d_ends = np.minimum(d_starts + d_sizes, n)  # the owned cells only
    rows = [torch.zeros((1, d_prev + d_cap + d_nxt), dtype=dtype, device=d)
            for d in devices]

    def src_window(r, lo, ln):
        c = s_prev + lo - int(s_starts[r])
        return src_rows[r][0, c:c + ln]

    def place(r, row, lo, ln, values):
        c = d_prev + lo - int(d_starts[r])
        row[0, c:c + ln] = values

    def clipped(lo, ln, r):
        """[lo, lo + ln) cut to target rank r's owned cells."""
        hi = min(lo + ln, int(d_ends[r]))
        return lo, max(0, hi - lo)

    for r in range(p):  # hop 0: each rank's own overlap, no transfer
        a = max(int(s_starts[r]), int(d_starts[r]))
        b = min(int(s_starts[r]) + int(s_sizes[r]), int(d_ends[r]))
        if b > a:
            place(r, rows[r], a, b - a, src_window(r, a, b - a))
    steps, _ = plan_moves(src_layout, dst_layout)
    if not steps:
        return rows
    windows = {t: (lo, ln) for t, _, lo, ln in steps}

    def make_bucket(t, r):
        lo, ln = windows[t]
        a, k = clipped(int(lo[r]), int(ln[r]), (r + t) % p)
        return src_window(r, a, k)

    def consume(t, r, row, bucket):
        lo, ln = windows[t]
        s = (r - t) % p
        a, k = clipped(int(lo[s]), int(ln[s]), r)
        if k:
            place(r, row, a, k, bucket)
        return row

    return ring_exchange(devices, rows, make_bucket, consume,
                         steps=[t for t, _, _, _ in steps])


def _host_staged(cont, new_dist, rt):
    """Through the host: the logical value to the host, the layout
    re-planned onto ``rt``, the value scattered back."""
    t0 = _obs.now()
    values = cont.to_array().cpu()
    cont._rebind(rt, new_dist)
    cont.assign_array(values)
    _obs.complete("redistribute.phase", t0, cat="redistribute",
                  phase="host_staged", n=len(cont))
    return cont


def _collective(cont, new_dist, rt):
    """On the devices: the layout rebind first (validated, and rolled
    back on failure), then the exchange, then the new rows."""
    src_rt = cont.runtime
    src_dist = cont.distribution
    src_layout = cont.layout
    old = cont._rows
    t0 = _obs.now()
    cont._rebind(rt, new_dist, _rows=old)
    dst_layout = cont.layout
    try:
        _obs.complete("redistribute.phase", t0, cat="redistribute",
                      phase="plan")
        t1 = _obs.now()
        new = exchange_rows(old, rt.devices, src_layout, dst_layout,
                            cont.dtype)
        _obs.complete("redistribute.phase", t1, cat="redistribute",
                      phase="exchange")
        t2 = _obs.now()
        cont._rows = new
        _obs.complete("redistribute.phase", t2, cat="redistribute",
                      phase="rebind")
        if _obs.armed():
            _, moved = plan_moves(src_layout, dst_layout)
            _obs.count("redistribute.bytes_moved",
                       moved * cont.dtype.itemsize)
        return cont
    except BaseException:
        cont._rebind(src_rt, src_dist, _rows=old)
        raise


def redistribute_vector(cont, new_dist, rt):
    """Re-lay one ``distributed_vector`` out under ``new_dist`` on
    ``rt``: the collective exchange when the source and target share the
    device list, the host-staged route otherwise."""
    collective = cont.runtime.devices == rt.devices
    sid = _obs.begin("redistribute", cat="redistribute",
                     impl="collective" if collective else "host",
                     n=len(cont), nshards=rt.nprocs)
    try:
        if collective:
            return _collective(cont, new_dist, rt)
        return _host_staged(cont, new_dist, rt)
    finally:
        _obs.end(sid)
