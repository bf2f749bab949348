"""Distributed sort: regular-sample sort over rank rows (counterpart of
``dr_tpu/algorithms/sort.py``).

One eager function over the rank rows runs the JAX package's program,
phase for phase:

1. local sort of each rank's owned (or window) cells as monotone order
   keys, padded to the widest rank ``S`` with the pad key; with a
   payload, the global index rides along as a tiebreak channel (the pair
   order is total).  The blocks of the ranks that share a device are
   one ``(b, S)`` batch and one call: K6 (``ops/sort_pallas.py``) for
   blocks of up to 2^15 keys, ``torch.sort`` (the JAX package's
   ``lax.sort``) for larger ones;
2. regular samples: ``p-1`` evenly spaced keys of each rank's run,
   gathered, sorted, and every ``p-1``-th taken as the ``p-1`` splitters;
3. bucket exchange: each destination's keys are one contiguous run of
   the sorted block, sent as a front-aligned ``(p, S)`` matrix padded
   with the pad key through one ``all_to_all``; one ``all_gather`` of
   the ``(p,)`` counts gives every merged length and offset;
4. merge: one ``torch.sort`` of the received ``(p, S)`` matrix;
5. rebalance into the destination windows by masked-sum assembly (each
   global position is covered by exactly one source); descending order
   maps element ``g`` to position ``n-1-g``;
6. (key-value) the rebalanced index channel is the permutation: each
   payload moves once, one ``all_gather`` of the request indices and one
   masked ``all_to_all``.

The ``(p, S)`` matrices, counts and offsets stay on the devices: a sort
never waits for the host.  The geometry (per-rank starts, widths and
columns) is static numpy over the layout, so uneven distributions with
empty "team" ranks and subrange windows run the same phases in window
coordinates, and only the window's cells are written.

Keys: floats map to the order keys of ``ops/order_keys.py`` (bf16/f16
widened exactly to f32 first, f64 in 64 bits), the JAX package's uint32
key with its sign bit flipped, so the order and the decoded bits are the
same; every NaN becomes ``INT32_MAX - 1`` (after
+inf, numpy's order) and the pad is ``INT32_MAX``.  Integer keys are the
values (int64 keys stay 64-bit; narrower ones widen to int32).  Keys-only
``sort`` keeps -0.0 before +0.0 (a bit-exact permutation); ``sort_by_key``
and ``is_sorted`` give both zeros one key.  The payload moves as raw bits,
so a -0.0 payload stays -0.0.

Every entry point is a deferred-plan barrier: inside ``dt.deferred()``
the plan flushes (``plan.barrier``) before the sort runs eagerly.

Not carried over: the ``DR_TPU_SORT_STABLE`` comparator knob (the output
is the same either way, every channel set being a total order).
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import effective_sizes, window_geometry, working_geometry
from .elementwise import _apply_ops, _out_chain, _resolve, copy as _copy, \
    iota
from ..ops import order_keys, sort_pallas
from ..parallel import collectives
from .elementwise import _prog_cache, _traced_op_key
from ..core.pinning import pinned_id
from ..utils.spmd_guard import dtype_name

__all__ = ["sort", "sort_by_key", "argsort", "is_sorted", "sort_n",
           "sort_by_key_n", "sort_phases_n", "sort_by_key_phases_n",
           "SORT_PHASES", "SORTKV_PHASES"]

_I32_MAX = torch.iinfo(torch.int32).max
_I64_MAX = torch.iinfo(torch.int64).max
GMAX = _I32_MAX  # the gid channel's pad

# program phases, in order; the last name is the full program.  A one-rank
# runtime has no collective phases: every truncation after local_sort
# sorts the keys in full (and leaves a payload untouched).
SORT_PHASES = ("local_sort", "splitter", "exchange", "merge", "rebalance")
SORTKV_PHASES = ("local_sort", "splitter", "exchange", "merge",
                 "rebalance", "payload")

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _encode(x: torch.Tensor, distinct_zeros: bool = False):
    """(signed monotone order key, pad key) of a 1-D tensor; see the
    module docstring."""
    if x.is_floating_point():
        big = torch.iinfo(order_keys.key_dtype(x.dtype)).max
        k = order_keys.to_keys(x, big - 1)
        if not distinct_zeros:
            k = torch.where(x == 0, 0, k)
        return k, big
    if x.dtype == torch.int64:
        return x, _I64_MAX
    return x.to(torch.int32), _I32_MAX


def _decode(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_encode` (NaN canonicalized)."""
    if not dtype.is_floating_point:
        return k.to(dtype)
    return order_keys.from_keys(k, dtype, torch.iinfo(k.dtype).max - 1)


def _plan_barrier(what: str) -> None:
    """Sort-family ops do not fuse: a recording plan flushes first."""
    from ..plan import barrier
    barrier(what)


def _const(values, dev) -> torch.Tensor:
    """A small host array of the static geometry on ``dev``, copied from
    pinned memory without waiting for the device."""
    t = torch.as_tensor(np.asarray(values))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def _local_sort(geo, with_gid: bool, distinct_zeros: bool):
    """Phase 1: every rank's cells as order keys (and, ``with_gid``, their
    global indices), padded to the widest rank ``S`` with the pad key (and
    GMAX), the ranks of one device written into one ``(b, S)`` batch and
    sorted by one call: K6 where eligible.  Returns the per-rank rows of
    keys and gids (None without ``with_gid``, and for a rank another
    process owns), and the pad key."""
    p, S, rt = geo.p, geo.S, geo.cont.runtime
    devs = rt.devices
    groups = {}
    for r in rt.local_ranks:
        groups.setdefault(devs[r], []).append(r)
    xs, gs, big = [None] * p, [None] * p, None
    for dev, ranks in groups.items():
        keys = [_encode(geo.cells(r), distinct_zeros) for r in ranks]
        big = keys[0][1]
        kb = torch.full((len(ranks), S), big, dtype=keys[0][0].dtype,
                        device=dev)
        gb = torch.full((len(ranks), S), GMAX, dtype=torch.int32,
                        device=dev) if with_gid else None
        for i, (r, (k, _)) in enumerate(zip(ranks, keys)):
            nv = int(geo.nvalid[r])
            kb[i, :nv] = k
            if with_gid:
                g0 = int(geo.starts[r])
                gb[i, :nv] = torch.arange(g0, g0 + nv, dtype=torch.int32,
                                          device=dev)
        if len(ranks) == 1:  # one block: torch.sort's 1-D path, not (1, S)
            kb, gb = kb[0], (gb[0] if with_gid else None)
        k6 = sort_pallas.eligible(S, kb.dtype)
        if with_gid:
            x, g = (sort_pallas.sort_kv if k6
                    else sort_pallas.plain_sort_kv)(kb, gb)
        else:
            x, g = (sort_pallas.sort_keys if k6
                    else sort_pallas.plain_sort_keys)(kb), None
        if len(ranks) == 1:
            x, g = x[None], (g[None] if with_gid else None)
        for i, r in enumerate(ranks):
            xs[r] = x[i]
            gs[r] = g[i] if with_gid else None
    return xs, gs, big


class _Geo:
    """Static geometry of a chain: rank r's cells are row columns
    ``[col0[r], col0[r] + nvalid[r])`` and its logical window starts at
    ``starts[r]`` (window coordinates for a subrange); ``S`` is the
    widest rank."""

    def __init__(self, chain):
        cont = chain.cont
        if chain.off == 0 and chain.n == len(cont):
            p, S, _, prev, _, n, starts, sizes = \
                working_geometry(cont.layout)
            wstart = np.zeros(p, np.int64)
        else:
            p, S, _, prev, _, n, starts, sizes, wstart = \
                window_geometry(cont.layout, chain.off, chain.n)
        self.cont, self.p, self.S, self.n = cont, p, S, n
        self.starts = np.asarray(starts, np.int64)
        self.nvalid = effective_sizes(starts, sizes, n).astype(np.int64)
        self.col0 = prev + np.asarray(wstart, np.int64)

    def cells(self, r):
        c0 = int(self.col0[r])
        return self.cont._rows[r][0, c0:c0 + int(self.nvalid[r])]


def _padded(t, width, fill):
    """``t`` followed by ``fill`` up to ``width`` elements."""
    out = torch.full((width,), fill, dtype=t.dtype, device=t.device)
    out[:t.numel()] = t
    return out


def _rebalance(ms, geo_src, dgeo, descending, offs, cnts):
    """Phase 5: every rank's merged run ``ms[r]`` into the destination
    windows of ``dgeo`` by masked-sum assembly (None where another
    process owns the rank)."""
    p, devs = geo_src.p, geo_src.cont.runtime.devices
    Sd = dgeo.S
    sends = [None] * p
    for r in geo_src.cont.runtime.local_ranks:
        dev = devs[r]
        ar = torch.arange(Sd, device=dev)
        gpos = _const(dgeo.starts, dev)[:, None] + ar
        dest_ok = ar < _const(dgeo.nvalid, dev)[:, None]
        want = (geo_src.n - 1 - gpos) if descending else gpos
        idx = want - offs[r]
        ok = dest_ok & (idx >= 0) & (idx < cnts[r])
        m = ms[r]
        sends[r] = torch.where(ok, m[idx.clamp(0, m.numel() - 1)],
                               torch.zeros((), dtype=m.dtype, device=dev))
    dtype = collectives.present(sends).dtype
    return [None if blk is None else blk.sum(0, dtype=blk.dtype)
            for blk in collectives.all_to_all(sends, devs,
                                               like=((Sd,), dtype))]


def _pay_gather(pgeo, perms):
    """Phase 6: rank r's payload window slot i takes the payload cell at
    window position ``perms[r][i]``, moved as raw bits."""
    p, rt = pgeo.p, pgeo.cont.runtime
    devs = rt.devices
    Sp = pgeo.S
    ity = _BITS[pgeo.cont.dtype.itemsize]
    bits = [_padded(pgeo.cells(r).view(ity), Sp, 0) if rt.is_local(r)
            else None for r in range(p)]
    if p == 1:
        ok = torch.arange(Sp, device=devs[0]) < int(pgeo.nvalid[0])
        return [torch.where(ok, bits[0][perms[0].long().clamp(0, Sp - 1)],
                            0)]
    Gs = collectives.all_gather_each(perms, devs)           # (p, Sp) each
    sends = [None] * p
    for r in rt.local_ranks:
        dev = devs[r]
        idxl = Gs[r].to(torch.int64) - int(pgeo.starts[r])
        dest_ok = torch.arange(Sp, device=dev) < \
            _const(pgeo.nvalid, dev)[:, None]
        own = dest_ok & (idxl >= 0) & (idxl < int(pgeo.nvalid[r]))
        sends[r] = torch.where(own, bits[r][idxl.clamp(0, Sp - 1)], 0)
    return [None if blk is None else blk.sum(0, dtype=blk.dtype)
            for blk in collectives.all_to_all(sends, devs,
                                              like=((Sp,), ity))]


def _write(geo, r, vals):
    """Rank r's window cells from the first ``nvalid[r]`` of ``vals``
    (nothing where another process owns rank r)."""
    nv = int(geo.nvalid[r])
    if nv and vals is not None:
        c0 = int(geo.col0[r])
        row = geo.cont._rows[r]
        row[0, c0:c0 + nv] = vals[:nv]


def _sort_chains(kc, vc, descending, stop_after=None):
    """The sample sort of chain ``kc`` (keys), carrying chain ``vc``
    (payload, same rank list, or None) along; ``stop_after`` truncates
    after that phase of :data:`SORT_PHASES` / :data:`SORTKV_PHASES`."""
    phases = SORTKV_PHASES if vc is not None else SORT_PHASES
    if stop_after is not None and stop_after not in phases:
        raise ValueError(f"stop_after must be one of {phases}")
    if stop_after == phases[-1]:
        stop_after = None
    geo = _Geo(kc)
    pgeo = _Geo(vc) if vc is not None else None
    p, S, rt = geo.p, geo.S, geo.cont.runtime
    devs, local = rt.devices, rt.local_ranks
    dtype = geo.cont.dtype

    def finish(keys, perms=None):
        # payload bits first (they read the original rows), then the key
        # cells, then the payload cells: on windows of one container the
        # payload is written last and wins where they overlap
        pay = _pay_gather(pgeo, perms) if perms is not None else None
        for r in local:
            _write(geo, r, _decode(keys[r][:int(geo.nvalid[r])], dtype))
        if pay is not None:
            pdt = pgeo.cont.dtype
            for r in local:
                _write(pgeo, r, pay[r].view(pdt))

    # --- phase 1: local sort of the order keys (+ the gid channel).  A
    # truncated program writes the keys of its last phase back and
    # leaves the payload alone.
    xs, gs, big = _local_sort(geo, vc is not None, distinct_zeros=vc is None)
    if stop_after == "local_sort":
        return finish(xs)

    if p == 1:
        nv = int(geo.nvalid[0])
        if descending:  # reverse, then rotate the pads back to the tail
            xs = [torch.roll(xs[0].flip(0), nv - S)]
            if vc is not None:
                gs = [torch.roll(gs[0].flip(0), nv - S)]
        if vc is None or stop_after is not None:
            return finish(xs)
        return finish(xs, gs)

    # --- phase 2: regular samples -> the p-1 global splitters
    samps = [None] * p
    for r in local:
        samps[r] = xs[r][_const(np.arange(1, p) * geo.nvalid[r] // p,
                                devs[r])]
    pick = np.arange(1, p) * (p - 1) - 1
    spls = [None if g is None else
            torch.sort(g.reshape(-1)).values[_const(pick, devs[r])]
            for r, g in enumerate(collectives.all_gather_each(samps, devs))]
    if stop_after == "splitter":
        return finish(xs)

    # --- phase 3: contiguous-run bucket exchange
    sends, gsends, cnts = [None] * p, [None] * p, [None] * p
    for r in local:
        dev, x, nv = devs[r], xs[r], int(geo.nvalid[r])
        bucket = torch.searchsorted(spls[r], x, right=True)     # (S,)
        dd = torch.arange(p, device=dev)
        lo = torch.searchsorted(bucket, dd).clamp(max=nv)
        hi = torch.searchsorted(bucket, dd, right=True).clamp(max=nv)
        cnt = (hi - lo).to(torch.int32)                          # (p,)
        ar = torch.arange(S, device=dev)
        sidx = (lo[:, None] + ar).clamp(0, S - 1)
        in_run = ar < cnt[:, None]
        sends[r] = torch.where(in_run, x[sidx], big)
        if vc is not None:
            gsends[r] = torch.where(in_run, gs[r][sidx], GMAX)
        cnts[r] = cnt
    kty = collectives.present(sends).dtype
    recv = collectives.all_to_all(sends, devs, like=((S,), kty))  # (p, S)
    grecv = collectives.all_to_all(gsends, devs, like=((S,), torch.int32)) \
        if vc is not None else None
    Cs = collectives.all_gather_each(cnts, devs)                  # (p, p)
    mine = [None if c is None else c[:, r].sum() for r, c in enumerate(Cs)]
    if stop_after == "exchange":
        return finish(xs)

    # --- phase 4: merge of the received runs
    merged, gm = [None] * p, [None] * p
    for r in local:
        if vc is None:
            merged[r] = torch.sort(recv[r].reshape(-1)).values
        else:
            merged[r], gm[r] = sort_pallas.plain_sort_kv(
                recv[r].reshape(-1), grecv[r].reshape(-1))
    if stop_after == "merge":
        return finish([None if m is None else m[::p] for m in merged])

    # --- phase 5: rebalance into the destination windows
    offs = [None if c is None else c.sum(0)[:r].sum()
            for r, c in enumerate(Cs)]
    kreb = _rebalance(merged, geo, geo, descending, offs, mine)
    if vc is None:
        return finish(kreb)
    gperm = _rebalance(gm, geo, pgeo, descending, offs, mine)
    if stop_after == "rebalance":
        return finish(kreb)
    # --- phase 6: the single payload move
    return finish(kreb, gperm)


def _same_ranks(a, b) -> bool:
    return a.runtime.devices == b.runtime.devices


def _window(chain):
    """A chain's window, None for the whole container (the JAX key's)."""
    whole = chain.off == 0 and chain.n == len(chain.cont)
    return None if whole else (chain.off, chain.n)


def _sort_tap(kc, vc, descending) -> None:
    """The dispatch tap of one sort, with the JAX package's key."""
    cont = kc.cont
    _prog_cache.tap((
        "sort", pinned_id(cont.runtime), cont.layout, dtype_name(cont.dtype),
        bool(descending), vc.cont.layout if vc is not None else None,
        dtype_name(vc.cont.dtype) if vc is not None else None,
        _window(kc), _window(vc) if vc is not None else None,
        vc is not None and vc.cont is cont, None))


def _n_tap(tag, kc, vc, iters, stop_after=None) -> None:
    """The dispatch tap of a chained ``*_n`` sort."""
    key = (tag, pinned_id(kc.cont.runtime), kc.cont.layout,
           dtype_name(kc.cont.dtype))
    if vc is not None:
        key += (vc.cont.layout, dtype_name(vc.cont.dtype))
    if stop_after is not None:
        key += (stop_after,)
    _prog_cache.tap(key + (int(iters),))


def sort(r, *, descending: bool = False):
    """Sort a ``distributed_vector`` or a subrange window over one in
    place, ascending by default.  Keys-only: the result is a bit-exact
    permutation of the input (-0.0 before +0.0, NaNs last)."""
    _plan_barrier("sort")
    chain = _out_chain(r)
    if chain.n:
        _sort_tap(chain, None, descending)
        _sort_chains(chain, None, descending)
    return r


def sort_by_key(keys, values, *, descending: bool = False):
    """Stable key-value sort, both in place: ties keep their original
    order, and ``descending`` reverses the whole ascending order, ties
    included.  Containers or windows of equal length, of any
    distributions and dtypes; two windows of one container may overlap,
    and then the payload's value wins.  A payload on another rank list
    is copied onto the keys' ranks, sorted there and copied back."""
    _plan_barrier("sort_by_key")
    kc, vc = _out_chain(keys), _out_chain(values)
    if kc.n != vc.n:
        raise ValueError(
            f"keys and values must have equal length ({kc.n} != {vc.n})")
    if kc.n == 0:
        return keys, values
    if kc.cont is vc.cont and kc.off == vc.off:
        # the keys are the values: a plain sort reorders both
        return sort(keys, descending=descending), values
    if not _same_ranks(kc.cont, vc.cont):
        from ..containers.distributed_vector import distributed_vector
        scratch = distributed_vector(vc.n, dtype=vc.cont.dtype,
                                     runtime=kc.cont.runtime)
        _copy(values, scratch)
        sort_by_key(keys, scratch, descending=descending)
        _copy(scratch, values)
        return keys, values
    _sort_tap(kc, vc, descending)
    _sort_chains(kc, vc, descending)
    return keys, values


def _whole(r):
    chain = _out_chain(r)
    if chain.off != 0 or chain.n != len(chain.cont):
        raise ValueError("takes a whole container")
    return chain


def _whole_pair(keys, values):
    kc, vc = _whole(keys), _whole(values)
    if kc.n != vc.n or not _same_ranks(kc.cont, vc.cont):
        raise ValueError("takes two whole containers of one length on one "
                         "rank list")
    return kc, vc


def sort_n(v, iters: int):
    """``iters`` chained whole-container sorts (a timing aid: after the
    first round the data is sorted; the result is the sorted input)."""
    _plan_barrier("sort_n")
    chain = _whole(v)
    _n_tap("sort_n", chain, None, iters)
    for _ in range(iters):
        if chain.n:
            _sort_chains(chain, None, False)
    return v


def sort_by_key_n(keys, values, iters: int):
    """``iters`` chained key-value sorts of two whole containers."""
    _plan_barrier("sort_by_key_n")
    kc, vc = _whole_pair(keys, values)
    _n_tap("sortkv_n", kc, vc, iters)
    for _ in range(iters):
        if kc.n:
            _sort_chains(kc, vc, False)
    return keys, values


def sort_phases_n(v, stop_after, iters: int):
    """``iters`` keys-only sorts truncated after phase ``stop_after`` of
    :data:`SORT_PHASES` (a profiling aid: the container then holds a
    phase-dependent mix of values, not a sorted range; use scratch
    data)."""
    _plan_barrier("sort_phases_n")
    chain = _whole(v)
    _n_tap("sortph_n", chain, None, iters, stop_after)
    for _ in range(iters):
        if chain.n:
            _sort_chains(chain, None, False, stop_after)
    return v


def sort_by_key_phases_n(keys, values, stop_after, iters: int):
    """Key-value twin of :func:`sort_phases_n` over
    :data:`SORTKV_PHASES`; truncations before ``"payload"`` leave the
    payload container untouched."""
    _plan_barrier("sort_by_key_phases_n")
    kc, vc = _whole_pair(keys, values)
    _n_tap("sortkvph_n", kc, vc, iters, stop_after)
    for _ in range(iters):
        if kc.n:
            _sort_chains(kc, vc, False, stop_after)
    return keys, values


def argsort(r, *, descending: bool = False):
    """The stable sort permutation of ``r`` as a new int32
    ``distributed_vector``: element i holds the original position of the
    i-th element of the sorted order.  ``r`` is read only (transform
    views are accepted: the copy applies them)."""
    _plan_barrier("argsort")
    from ..containers.distributed_vector import distributed_vector
    res = _resolve(r)
    if res is None or len(res) != 1:
        raise TypeError("argsort takes a single distributed range")
    chain = res[0]
    rt = chain.cont.runtime
    scratch = distributed_vector(chain.n, dtype=chain.cont.dtype, runtime=rt)
    _copy(r, scratch)
    idx = distributed_vector(chain.n, dtype=np.int32, runtime=rt)
    iota(idx, 0)
    sort_by_key(scratch, idx, descending=descending)
    return idx


def is_sorted(r) -> bool:
    """True when the range is ascending (NaNs count as largest, numpy's
    order; -0.0 and +0.0 are equal).  Read only; windows and transform
    views run in place: each rank checks its cells into (nonempty, first
    key, last key, violation), the ranks' four-tuples are gathered in
    rank order onto the home device (across processes too), and each
    nonempty rank's first key is held against the largest last key of
    the nonempty ranks before it.  One host read at the end, the same
    answer on every process."""
    _plan_barrier("is_sorted")
    res = _resolve(r)
    if res is None:
        raise TypeError("is_sorted takes a distributed range")
    if len(res) != 1:
        raise TypeError("is_sorted takes a single-component range")
    chain = res[0]
    if chain.n == 0:
        return True
    _prog_cache.tap(("is_sorted", pinned_id(chain.cont.runtime),
                     chain.cont.layout, dtype_name(chain.cont.dtype),
                     _window(chain),
                     tuple(_traced_op_key(f) for f in chain.ops)))
    geo = _Geo(chain)
    rt = geo.cont.runtime
    stats = [None] * geo.p
    for rk in rt.local_ranks:
        dev = rt.devices[rk]
        if not geo.nvalid[rk]:  # an empty rank constrains nothing
            stats[rk] = torch.zeros(4, dtype=torch.int64, device=dev)
            continue
        k, _ = _encode(_apply_ops(geo.cells(rk), chain.ops))
        ends = k[[0, -1]].to(torch.int64)
        stats[rk] = torch.cat([torch.ones_like(ends[:1]), ends,
                               (k[:-1] > k[1:]).any().to(torch.int64)
                               .reshape(1)])
    st = collectives.all_gather(stats, rt.home)                  # (p, 4)
    ne = st[:, 0] > 0
    low = torch.iinfo(torch.int64).min
    prevmax = torch.cummax(torch.where(ne, st[:, 2], low), 0).values
    bad = (ne & (st[:, 3] > 0)).any() | \
        (ne[1:] & (prevmax[:-1] > st[1:, 1])).any()
    return not bool(bad)
