"""Relational analytics on the sort backbone: distributed ``join`` /
``groupby_aggregate`` / ``unique`` / ``histogram`` / ``top_k`` and the
``*_auto`` tier (counterpart of ``dr_tpu/algorithms/relational.py``).

Each op is one eager function over the rank rows that runs the JAX
package's program phase for phase, with the same results bit for bit
(float sums and means within rounding):

* ``groupby_aggregate`` copies keys (and values) into fresh uniform
  scratch containers and ``sort_by_key``\\ s them (``unique``: ``sort``),
  so a rank of at most 2^15 keys sorts locally on K6.  Boundary flags
  (each rank also reads its predecessor's last key) number the runs of
  equal keys; a segmented reduce folds each rank's runs; one masked
  ``all_to_all`` and a per-column monoid combine re-home the run partials
  into the output distributions (a group split over ranks merges there;
  the key rides a min channel).  The segmented reduce is K7
  (``ops/segred_pallas.py``) when a rank's scratch holds at most 32767
  keys (``nseg = S + 1 <= 2^15``), no column is 8 bytes wide and no
  float is summed; otherwise it is torch ops (float sums as a segmented
  scan by doubling over the sorted runs, the same bits every call;
  ``segred_pallas.plain_segmented``'s ``scatter_reduce_`` for the rest),
  as the JAX package then runs XLA's ``segment_*``.  That
  is the reference's own routing by size and type, not a fallback: at
  the pipeline's sizes (millions of rows a rank) a groupby runs the
  torch ops.
* ``join`` sorts both sides into scratch and merges them by one of two
  routes with the same rows: the **broadcast** merge gathers both sorted
  sides (once per device), counts each left row's matches with two
  ``searchsorted``\\ s on the order keys, prefix-sums the counts and lets
  every rank build its own window of the expanded rows; above
  ``DR_GPU_JOIN_BROADCAST_MAX`` combined rows (default 2^18; 0 forces
  it) on more than one rank the **partition** merge keeps the left side
  in place, sizes each rank's right partition by one probe, rotates the
  right blocks once around the ring (``parallel/pipeline.ring_pipeline``)
  and assembles the out windows producer-side through one masked
  ``all_to_all`` per channel.  ``how="outer"`` adds the unmatched right
  rows as a second emitter stream in (key, source, position) order.
* ``histogram`` buckets each rank's window cells by the JAX package's
  rule and counts them with K8 (``ops/hist_pallas.py``) when
  ``bins <= 2^15``, else ``index_add_``; the per-rank counts are summed.
* ``top_k`` sorts each rank's (order key, index) pairs, gathers the
  ``k`` best of every rank and sorts them once more (ties go to the
  smaller index).
* ``join_auto`` / ``groupby_auto`` / ``unique_auto`` sort once, probe
  the exact result count (or take a capacity hint: see Tuning below),
  allocate pow2-sized outputs and run the op.

Keys compare by the sort family's order keys (``sort._encode``): -0.0
equals +0.0 and every NaN is one key.  The host reads only what the
JAX package's host reads: the row or group count after an op, the
partition probe's sizes, and the count of an auto op's probe.

While tracing is armed (``dr_tpu_torch.obs``), each op is a span
(``relational.join`` with ``how``, ``n_left``, ``n_right`` and the
``rows`` it made; ``relational.groupby`` with ``agg``, ``n`` and
``groups``; ``relational.histogram`` with ``n`` and ``bins``;
``relational.top_k`` with ``n``, ``k``, ``largest`` and ``merge``;
``auto=True`` on the auto tier) with ``relational.phase`` children named
as the JAX package names them: ``sort`` / ``sort_left`` /
``sort_right`` (the scratch sorts), ``aggregate``, ``partition_plan``,
``merge`` (with its ``route``), ``cap_probe`` and ``empty``.

In a multi-process runtime (``collectives.init_distributed``) every
process runs the same op on its own ranks' rows and gets the single
controller's bits: the scratch rides the multi-process sort, a rank
reads its predecessor's last key through a one-element
``collectives.ring_shift``, the run counts, the partition bounds, the
per-rank row counts, the top_k candidates and the histogram counts are
gathered (or summed in rank order by ``psum``) once a process, the
``all_to_all`` sends and the kernels (K6 in the sorts, K7 in the
groupby, K8 in the histogram) run for local ranks only, and the
broadcast merge gathers both sorted sides onto every process.  Every
host read (row and group counts, the partition probe, the route) is
the same on every process, and so is every tuning answer the pickers
read (``tuning.lookup`` hands every process process 0's).

Each op looks up the algorithm layer's dispatch cache (the
``spmd_guard`` tap) with the JAX package's tag (``relgb``, ``reljoin``,
``reljoinpart``, ``reljoincnt``, ``relgbcnt``, ``relhist``,
``reltopk``); the partition merge fires ``collectives.ppermute`` before
its ring.

Inside ``dt.deferred()``, ``histogram`` and ``top_k`` (static output
shapes) record FUSIBLE (``Plan.record_histogram`` / ``record_top_k``,
which run :func:`_histogram_rows` / :func:`_top_k_rows` at the flush),
and ``join``, ``groupby_aggregate``, ``unique`` and the auto tier record
OPAQUE (run through their eager path at the flush) and return a lazy
:class:`DeferredCount` (an :class:`AutoResult` that resolves on first
use).  Their input views stay in the opaque item's ``meta``, which the
plan's pushdown pass may rewrite.

Tuning: with ``DR_GPU_JOIN_BROADCAST_MAX`` unset and the ``joinroute``
pass armed, a ``join.broadcast_max`` entry of the tuning DB
(``dr_tpu_torch/tuning.py``) replaces the route threshold's default.
With the ``capinfer`` pass armed (``DR_GPU_PLAN_OPT=all``), the auto
tier sizes its outputs from a ``relational.cap_ratio_<kind>`` hint (the
ratio the last auto run of that kind noted in the session overlay, or
a DB entry) and skips the count probe; a hint that undershoots runs the
op again at the exact count.  Without a hint, and whenever the pass is
off, the auto tier probes the exact count (``cap_probe``): the JAX
package's pass-off guess (``4 * (nl + nr)`` rows for a join, ``n`` for
a groupby) would allocate up to four times the memory on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs as _obs
from ._common import owned_window_mask, window_cols, working_geometry
from .elementwise import _apply_chain_ops, _chain_scalars, _out_chain, \
    _plan_active, _resolve, copy as _copy, fill as _fill, \
    to_numpy as _to_numpy
from .sort import _const, _decode, _encode, sort as _sort, \
    sort_by_key as _sort_by_key
from ..containers.distributed_vector import distributed_vector
from ..ops import hist_pallas, segred_pallas
from ..parallel import collectives
from ..parallel.collectives import ordered_maximum, ordered_minimum
from ..parallel.pipeline import fire_ppermute, ring_pipeline
from .elementwise import _prog_cache, _traced_op_key
from ..core.pinning import pinned_id
from ..utils.spmd_guard import dtype_name
from ..utils.env import env_int, env_raw
from ..utils.resilience import ProgramError
from ..views import views as _v

__all__ = ["join", "groupby_aggregate", "unique", "histogram", "top_k",
           "join_auto", "groupby_auto", "unique_auto", "AutoResult",
           "DeferredCount", "AGGS", "JOIN_HOWS", "last_join_route"]

#: supported groupby aggregations
AGGS = ("sum", "min", "max", "count", "mean")
#: supported join flavors
JOIN_HOWS = ("inner", "left", "right", "outer")

_GMAX = torch.iinfo(torch.int32).max


class DeferredCount:
    """Lazy result count of a relational op recorded in a deferred region
    (``join`` / ``groupby_aggregate`` / ``unique``).  Resolving it
    (``item()`` / ``int()`` / ``float()`` / ``bool()`` / ``==``) flushes
    the owning plan if still pending; a count whose flush was dropped
    raises instead of returning a stale number."""

    __slots__ = ("_plan", "_box")

    def __init__(self, plan, box):
        self._plan = plan
        self._box = box

    def item(self) -> int:
        if not self._box:
            self._plan.flush("relational count read")
        if not self._box:
            raise RuntimeError(
                "deferred relational count was discarded before it "
                "resolved (faulted flush or abandoned region)")
        return int(self._box[-1])

    def __int__(self):
        return self.item()

    def __index__(self):
        return self.item()

    def __float__(self):
        return float(self.item())

    def __bool__(self):
        return bool(self.item())

    def __eq__(self, other):
        if isinstance(other, DeferredCount):
            other = other.item()
        return self.item() == other

    # hashing would be a hidden flush
    __hash__ = None

    def __repr__(self):
        state = repr(self._box[-1]) if self._box else "pending"
        return f"DeferredCount({state})"


def _opaque_meta(kind: str, inputs: dict, outs) -> dict:
    """The record a deferred relational op leaves on its opaque item:
    ``inputs`` maps a channel name to its view (the thunk re-reads this
    dict at the flush, so the pushdown pass may rewrite it), ``chains``
    summarizes each channel as ``(container, off, n, plain)``, and
    ``outs`` are the containers the op rebuilds whole."""
    chains = {}
    for name, view in inputs.items():
        ch = _single_chain(view, kind)
        chains[name] = (ch.cont, ch.off, ch.n, not ch.ops)
    return {"kind": kind, "inputs": dict(inputs), "chains": chains,
            "outs": tuple(outs)}


def _meta_footprint(meta):
    """(reads, writes): every input chain's container is read, every out
    container rebuilt whole."""
    reads = []
    for _name, ch in meta["chains"].items():
        if ch[0] not in reads:
            reads.append(ch[0])
    return tuple(reads), tuple((c, True) for c in meta["outs"])


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

class _InChain:
    """A resolved input chain with the original range object (``view``),
    which the scratch copy reads."""

    __slots__ = ("cont", "off", "n", "ops", "view")

    def __init__(self, chain, view):
        self.cont = chain.cont
        self.off = chain.off
        self.n = chain.n
        self.ops = chain.ops
        self.view = view


def _single_chain(r, what: str):
    """Resolve ``r`` into ONE distributed container chain or raise."""
    chains = _resolve(r) if not isinstance(r, _v.zip_view) else None
    if chains is None or len(chains) != 1:
        raise TypeError(
            f"{what} takes a single distributed range (a "
            "distributed_vector or a view chain over one)")
    return chains[0]


def _in_chain(r, what: str) -> _InChain:
    return _InChain(_single_chain(r, what), r)


def _whole_out(out, what: str):
    """Output containers must be whole non-empty distributed_vectors (the
    ops rebuild their full padded rows)."""
    chain = _out_chain(out)
    if chain.off != 0 or chain.n != len(chain.cont):
        raise TypeError(f"{what}: output must be a whole "
                        "distributed_vector (windows are not supported)")
    if chain.n == 0:
        raise TypeError(f"{what}: output container must be non-empty")
    return chain


def _same_ranks(a, b) -> bool:
    return a.runtime.devices == b.runtime.devices


def _worst(dtype, largest: bool):
    """The dtype's FINITE worst value in the requested order: top_k's
    empty-slot sentinel."""
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.min if largest else info.max


def _slots(layout, r, dev):
    """Result positions of rank r's output slots, ``starts[r] + t`` for
    t < S (slots past the rank's size are dropped by the packing)."""
    _, So, *_rest, starts, _sizes = working_geometry(layout)
    s0 = int(starts[r])
    return torch.arange(s0, s0 + So, device=dev)


def _all_slots(layout, dev):
    """``(p, S)`` result positions of every rank's output slots."""
    _, So, *_rest, starts, _sizes = working_geometry(layout)
    return _const(starts, dev)[:, None] + torch.arange(So, device=dev)


def _slot_ok(layout, dev):
    """``(p, S)``: slot t of rank d exists (t < sizes[d])."""
    _, So, *_rest, sizes = working_geometry(layout)
    return torch.arange(So, device=dev) < _const(sizes, dev)[:, None]


def _pack_out_row(vals, live, layout, r):
    """Rank r's full padded row: its slots' ``vals`` where ``live``,
    zero elsewhere (pad and halo cells included)."""
    _, _, cap, prev, nxt, _, _, sizes = working_geometry(layout)
    row = torch.zeros((1, prev + cap + nxt), dtype=vals.dtype,
                      device=vals.device)
    sz = int(sizes[r])
    row[0, prev:prev + sz] = torch.where(live[:sz], vals[:sz], 0)
    return row


def _sorted_scratch(chain: _InChain, vchain=None, *, sid=0,
                    phase="sort"):
    """Copy key (and value) chains into fresh uniform scratch containers
    on the key runtime and stable-sort by key: the non-mutating step
    every relational op starts from, recorded as ``phase`` under span
    ``sid``.  Returns ``(skeys, svals_or_None, n)``; for ``n == 0`` the
    scratch is one cell, masked off."""
    t0 = _obs.now()
    n = chain.n
    rt = chain.cont.runtime
    cap = max(n, 1)
    sk = distributed_vector(cap, dtype=chain.cont.dtype, runtime=rt)
    sv = None if vchain is None else \
        distributed_vector(cap, dtype=vchain.cont.dtype, runtime=rt)
    if n:
        _copy(chain.view, sk)
        if sv is not None:
            _copy(vchain.view, sv)
            _sort_by_key(sk, sv)
        else:
            _sort(sk)
    _obs.complete("relational.phase", t0, cat="relational", parent=sid,
                  phase=phase, n=n)
    return sk, sv, n


def _raise_capacity(what: str, need: int, cap: int) -> None:
    raise ProgramError(
        f"{what}: result has {need} rows but the output containers "
        f"hold only {cap} — the first {cap} rows are valid; size the "
        "outputs for the worst case or pre-aggregate")


def _masked_keys(x, nvalid):
    """Order keys of ``x`` with cells at and past ``nvalid`` set to the
    pad key: ``(keys, pad)``."""
    k, big = _encode(x)
    valid = torch.arange(x.numel(), device=x.device) < nvalid
    return torch.where(valid, k, big), big


def _nvalid(n, r, S) -> int:
    """Real cells of rank r of a uniform scratch of n elements."""
    return min(max(n - r * S, 0), S)


def _rows_of(cont):
    """Rank rows of a halo-free scratch container, as 1-D tensors (None
    for a rank another process owns)."""
    return [None if row is None else row[0] for row in cont._rows]


def _local(values):
    """``(rank, value)`` for each value this process holds."""
    return [(r, v) for r, v in enumerate(values) if v is not None]


def _home_each(t, rt):
    """``t`` (a value every process holds alike, on the home device) on
    each of this process's ranks' devices; None for the others."""
    return [t.to(d) if rt.is_local(r) else None
            for r, d in enumerate(rt.devices)]


# ---------------------------------------------------------------------------
# groupby_aggregate / unique
# ---------------------------------------------------------------------------

def _acc_dtype(vdtype):
    """Aggregation accumulator dtype: low-precision floats accumulate in
    f32; everything else keeps its own."""
    if vdtype.is_floating_point:
        return torch.promote_types(vdtype, torch.float32)
    return vdtype


def _key_dtype(dtype):
    """The dtype of ``sort._encode``'s keys for values of ``dtype``."""
    return torch.int64 if dtype in (torch.float64, torch.int64) \
        else torch.int32


def _runs(sk, n):
    """Boundary flags over the sorted scratch: per rank ``(keys, valid,
    segid, m)`` with the keys masked to the pad key past the real cells,
    ``segid`` numbering the runs of equal keys (0 = a run continued from
    the previous rank) and ``m`` the rank's run count; and the pad key.
    Uniform scratch has only trailing short ranks, so a nonempty rank's
    predecessor is full and its last real key sits at S - 1."""
    p, S, cap, prev, nxt, *_ = working_geometry(sk.layout)
    assert prev == 0 and nxt == 0 and cap == S, \
        "the relational scratch is a fresh halo-free uniform container"
    keys, valids = [None] * p, [None] * p
    for r, x in _local(_rows_of(sk)):
        keys[r], big = _masked_keys(x, _nvalid(n, r, S))
        valids[r] = torch.arange(S, device=x.device) < _nvalid(n, r, S)
    # each rank's predecessor's last key: a one-element shift, across
    # processes too
    prevs = collectives.ring_shift(
        [None if k is None else k[S - 1:] for k in keys],
        sk.runtime.devices, +1, periodic=False,
        like=((1,), collectives.present(keys).dtype))
    out = [None] * p
    for r, k in _local(keys):
        valid = valids[r]
        first = valid[:1]
        if r:
            first = first & (k[:1] != prevs[r])
        flags = torch.cat([first, valid[1:] & (k[1:] != k[:-1])])
        segid = torch.cumsum(flags, 0, dtype=torch.int32)
        out[r] = (k, valid, segid, segid[S - 1])
    return out, big


def _run_sums(v, segid, nseg):
    """Per-run sums of ``v`` (``segid`` nondecreasing: the runs of the
    sorted keys) in an order fixed by the runs: a segmented inclusive
    scan by doubling, ``ceil(log2(L))`` passes for the longest run L
    (pass d adds the partial sum d cells back when that cell is in the
    same run), read at each run's last cell.  The same bits on every
    call, where ``index_add_``'s atomics on the card are not; the final
    ``+ 0.0`` makes an empty run, or a run of negative zeros, ``+0.0``,
    as a sum from zero does."""
    ends = torch.searchsorted(segid, torch.arange(
        1, nseg + 1, dtype=segid.dtype, device=segid.device))
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    x, d, longest = v.clone(), 1, int(lengths.max())
    while d < longest:
        # the right side is read whole before the in-place add
        x[d:] += torch.where(segid[d:] == segid[:-d], x[:-d], 0)
        d *= 2
    return torch.where(lengths > 0, x[(ends - 1).clamp(min=0)], 0) + 0.0


def _segment(segid, nseg, cols, kernel):
    """Per-run partials of every ``(values, op)`` column: K7 when
    ``kernel``, else torch ops (the reference's XLA ``segment_*``): a
    float sum by :func:`_run_sums`, the rest by
    ``segred_pallas.plain_segmented``'s ``scatter_reduce_``."""
    if kernel:
        return segred_pallas.segmented(segid, nseg, cols)
    out = []
    for v, op in cols:
        if op == "sum" and v.is_floating_point():
            out.append(_run_sums(v, segid, nseg))
        else:
            out.append(segred_pallas.plain_segmented(segid, nseg,
                                                     ((v, op),))[0])
    return out


def _combine(kind, x):
    """Monoid fold over axis 0 of the received ``(p, S)`` partials (min
    and max with XLA's signed-zero and NaN order)."""
    if kind == "sum":
        return x.sum(0, dtype=x.dtype)
    if not x.is_floating_point():
        return x.amin(0) if kind == "min" else x.amax(0)
    fold = ordered_minimum if kind == "min" else ordered_maximum
    acc = x[0]
    for row in x[1:]:
        acc = fold(acc, row)
    return acc


def _groupby_sorted(sid, sk, sv, n, ok_cont, ov_cont, agg) -> int:
    """The aggregate half of a groupby over the already-sorted scratch
    (shared with the auto tier); rebuilds the out containers' rows and
    returns the group count.  Capacity enforcement stays with the
    caller."""
    t0 = _obs.now()
    p, S, *_ = working_geometry(sk.layout)
    rt = sk.runtime
    devs = rt.devices
    kdtype = sk.dtype
    acc = _acc_dtype(sv.dtype) if sv is not None else torch.int32
    nseg = S + 1
    vop = None
    cols_dt = [(_key_dtype(kdtype), "min"), (torch.int32, "sum")]
    if sv is not None and agg != "count":
        vop = "sum" if agg in ("sum", "mean") else agg
        cols_dt.append((acc, vop))
    # K7 takes columns of at most 4 bytes and no float sum (float
    # addition depends on the combine order)
    kernel = segred_pallas.eligible(S, nseg, cols_dt) and all(
        dt in segred_pallas.KERNEL_DTYPES for dt, _ in cols_dt)

    runs, big = _runs(sk, n)
    ms = [None if run is None else run[3] for run in runs]
    svals = _rows_of(sv) if sv is not None else None
    # every rank's run count: one gather a process
    counts = collectives.all_gather_each(ms, devs)             # (p,)
    pkey, pcnt, pval = [None] * p, [None] * p, [None] * p
    gid_off, ngs = [None] * p, [None] * p
    for r, (k, valid, segid, _m) in _local(runs):
        gid_off[r] = counts[r][:r].sum()
        ngs[r] = counts[r].sum()
        cols = [(k, "min"), (valid.to(torch.int32), "sum")]
        if vop is not None:
            ident = 0 if vop == "sum" else segred_pallas.identity(vop, acc)
            cols.append((torch.where(valid, svals[r].to(acc), ident), vop))
        res = _segment(segid, nseg, cols, kernel)
        pkey[r], pcnt[r] = res[0], res[1]
        pval[r] = res[2] if vop is not None else None
    local = rt.local_ranks

    def assemble(layout, partials, ident, kind):
        """Re-home per-run partials into ``layout``'s windows: rank r's
        segment j holds global group gid_off[r] - 1 + j."""
        So = working_geometry(layout)[1]
        sends = [None] * p
        for r in local:
            dev = devs[r]
            idx = _all_slots(layout, dev) - (gid_off[r] - 1)
            have = _slot_ok(layout, dev) & (idx >= 0) & (idx <= ms[r])
            sends[r] = torch.where(
                have, partials[r][idx.clamp(0, nseg - 1)], ident)
        like = ((So,), collectives.present(sends).dtype)
        return [None if x is None else _combine(kind, x)
                for x in collectives.all_to_all(sends, devs, like)]

    def live(layout, r):
        return _slots(layout, r, devs[r]) < ngs[r]

    akey = assemble(ok_cont.layout, pkey, big, "min")
    # decode through the KEY dtype, then cast to the out dtype
    krows = {r: _pack_out_row(_decode(akey[r], kdtype).to(ok_cont.dtype),
                              live(ok_cont.layout, r), ok_cont.layout, r)
             for r in local}
    vrows = None
    if ov_cont is not None:
        ol = ov_cont.layout
        acnt = assemble(ol, pcnt, 0, "sum")
        if agg == "count":
            av = acnt
        elif agg in ("min", "max"):
            av = assemble(ol, pval, segred_pallas.identity(agg, acc), agg)
        else:
            av = assemble(ol, pval, 0, "sum")
            if agg == "mean":
                av = [None if a is None else a / c.clamp(min=1).to(a.dtype)
                      for a, c in zip(av, acnt)]
        vrows = {r: _pack_out_row(av[r].to(ov_cont.dtype), live(ol, r), ol,
                                  r) for r in local}
    for r in local:
        ok_cont._rows[r] = krows[r]
        if vrows is not None:
            ov_cont._rows[r] = vrows[r]
    # the gathered counts are the same on every process
    ng = int(ngs[local[0]])
    _obs.complete("relational.phase", t0, cat="relational", parent=sid,
                  phase="aggregate", groups=ng)
    return ng


def _group_count(sk, n) -> int:
    """The distinct-key count of the sorted scratch (the auto tier's
    probe): the boundary flags' run counts, summed."""
    runs, _ = _runs(sk, n)
    return int(collectives.psum([None if run is None else run[3]
                                 for run in runs], sk.runtime.home))


def _check_groupby(keys, values, out_keys, out_values):
    kc = _in_chain(keys, "groupby_aggregate")
    vc = _in_chain(values, "groupby_aggregate") \
        if values is not None else None
    okc = _whole_out(out_keys, "groupby_aggregate")
    ovc = _whole_out(out_values, "groupby_aggregate") \
        if out_values is not None else None
    if vc is not None and vc.n != kc.n:
        raise ValueError(
            f"groupby_aggregate: keys and values must have equal "
            f"length ({kc.n} != {vc.n})")
    if ovc is not None and ovc.n != okc.n:
        # unequal capacities would let the smaller side silently drop
        # rows the returned count claims exist
        raise ValueError(
            f"groupby_aggregate: out_keys and out_values must share "
            f"one capacity ({okc.n} != {ovc.n})")
    for oc, nm in ((okc, "out_keys"), (ovc, "out_values")):
        if oc is not None and not _same_ranks(oc.cont, kc.cont):
            raise TypeError(
                f"groupby_aggregate: {nm} must live on the keys' ranks")
    return kc, vc, okc, ovc


def _check_agg(values, agg):
    if agg not in AGGS:
        raise ValueError(f"groupby_aggregate: unknown agg {agg!r} "
                         f"(known: {', '.join(AGGS)})")
    if values is None and agg != "count":
        raise ValueError(
            f"groupby_aggregate: agg {agg!r} needs values "
            "(only 'count' accepts values=None)")


def _chain_key(c):
    """A chain's part of a relational key: layout, dtype, window, ops."""
    if c is None:
        return None
    return (c.cont.layout, dtype_name(c.cont.dtype), c.off, c.n,
            tuple(_traced_op_key(f) for f in c.ops))


def _rel_tap(tag, rt, *parts) -> None:
    """The dispatch tap of a relational op, with the JAX package's tag."""
    _prog_cache.tap((tag, pinned_id(rt)) + parts)


def _groupby_eager(keys, values, out_keys, out_values, agg) -> int:
    kc, vc, okc, ovc = _check_groupby(keys, values, out_keys, out_values)
    _rel_tap("relgb", kc.cont.runtime, _chain_key(kc), _chain_key(vc),
             okc.cont.layout, ovc.cont.layout if ovc is not None else None,
             agg)
    sid = _obs.begin("relational.groupby", cat="relational", agg=agg,
                     n=kc.n)
    ng = -1
    try:
        sk, sv, n = _sorted_scratch(kc, vc, sid=sid)
        ng = _groupby_sorted(sid, sk, sv, n, okc.cont,
                             ovc.cont if ovc is not None else None, agg)
        if ng > okc.n:
            _raise_capacity("unique" if ovc is None else f"groupby[{agg}]",
                            ng, okc.n)
        return ng
    finally:
        _obs.end(sid, groups=ng)


def groupby_aggregate(keys, values, out_keys, out_values,
                      agg: str = "sum") -> int:
    """Distributed group-by: aggregate ``values`` per distinct key.

    Non-mutating in ``keys``/``values``.  The distinct keys land in
    ``out_keys[0:ngroups]`` in sorted order with the aggregate at the
    matching ``out_values`` position (both whole distributed_vectors of
    one capacity; positions ``>= ngroups`` are zero); returns
    ``ngroups``.  ``agg`` is one of ``sum`` / ``min`` / ``max`` /
    ``count`` / ``mean`` (``count`` accepts ``values=None``).  A result
    larger than the capacity raises ``ProgramError`` after the op ran
    (the first ``len(out_keys)`` groups are valid)."""
    _check_agg(values, agg)
    _kc, _vc, okc, ovc = _check_groupby(keys, values, out_keys,
                                        out_values)
    p = _plan_active()
    if p is not None:
        box: list = []
        inputs = {"keys": keys}
        if values is not None:
            inputs["values"] = values
        meta = _opaque_meta(
            "groupby", inputs,
            (okc.cont,) + ((ovc.cont,) if ovc is not None else ()))
        reads, writes = _meta_footprint(meta)
        p.record_opaque(
            "groupby_aggregate",
            lambda m=meta: box.append(_groupby_eager(
                m["inputs"]["keys"], m["inputs"].get("values"), out_keys,
                out_values, agg)),
            reads=reads, writes=writes, meta=meta)
        return DeferredCount(p, box)
    return _groupby_eager(keys, values, out_keys, out_values, agg)


def unique(r, out) -> int:
    """Sorted distinct values of ``r`` into ``out[0:count]`` (a whole
    distributed_vector; positions ``>= count`` are zero); returns the
    distinct count.  The keys-only groupby."""
    _in_chain(r, "unique")
    okc = _whole_out(out, "unique")
    p = _plan_active()
    if p is not None:
        box: list = []
        meta = _opaque_meta("unique", {"r": r}, (okc.cont,))
        reads, writes = _meta_footprint(meta)
        p.record_opaque(
            "unique",
            lambda m=meta: box.append(_groupby_eager(
                m["inputs"]["r"], None, out, None, "count")),
            reads=reads, writes=writes, meta=meta)
        return DeferredCount(p, box)
    return _groupby_eager(r, None, out, None, "count")


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

class _Emitters:
    """The rows a merge emits, in output order: emitter e emits ``ec[e]``
    rows starting at row ``coffs[e] - ec[e]``.  Emitters are the left rows
    (a match expansion, or one fill row for a left/outer join) and, for
    ``how="outer"``, the unmatched right rows.  ``keys`` (outer only) are
    the order keys of the left rows followed by the right rows: that
    concatenation is in (source, position) order, so one stable sort by
    key gives the reference's (key, source, position) emitter order."""

    def __init__(self, rows, rrows=None, keys=None):
        if rrows is None:
            self.ec, self.src, self.pidx = rows, None, None
        else:
            nl = rows.numel()
            order = torch.sort(keys, stable=True).indices
            self.ec = torch.cat([rows, rrows])[order]
            self.src = order >= nl
            self.pidx = torch.where(self.src, order - nl, order)
        self.coffs = torch.cumsum(self.ec, 0)
        self.total = self.coffs[-1]

    def locate(self, j):
        """(from the right?, emitter position, row within its group) of
        output rows ``j`` (any shape)."""
        e = torch.searchsorted(self.coffs, j, right=True) \
            .clamp(0, self.coffs.numel() - 1)
        q = j - (self.coffs[e] - self.ec[e])
        if self.src is None:
            return None, e, q
        return self.src[e], self.pidx[e], q


def _counts(kl, kr, nvl, nvr, left_outer):
    """Match range ``[lo, lo + cnt)`` of each left key in the sorted right
    keys, and its emitted row count.  Clamping to the real right rows
    keeps an integer key equal to the pad key from matching pads."""
    lvalid = torch.arange(kl.numel(), device=kl.device) < nvl
    lo = torch.clamp(torch.searchsorted(kr, kl), max=nvr)
    hi = torch.clamp(torch.searchsorted(kr, kl, right=True), max=nvr)
    cnt = torch.where(lvalid, hi - lo, 0)
    rows = torch.where(lvalid, cnt.clamp(min=1), 0) if left_outer else cnt
    return lo, cnt, rows


def _unmatched(kl, kr, nvl, live):
    """1 for each right row in ``live`` whose key no real left row has."""
    lo = torch.clamp(torch.searchsorted(kl, kr), max=nvl)
    hi = torch.clamp(torch.searchsorted(kl, kr, right=True), max=nvl)
    return (live & (hi == lo)).to(torch.int64)


def _emit_rows(em, j, lo, cnt, nlim, rlim, left, right, dtype):
    """Values of output rows ``j``: ``left(i, rpos, matched)`` for a left
    emitter's row, ``right(pos)`` for an unmatched right row."""
    src, pi, q = em.locate(j)
    i = pi.clamp(0, nlim - 1)
    rpos = (lo[i] + q).clamp(0, rlim - 1)
    vals = left(i, rpos, cnt[i] > 0).to(dtype)
    if src is not None:
        vals = torch.where(src, right(pi.clamp(0, rlim - 1)).to(dtype),
                           vals)
    return vals


def _channels(outs, lkeys, lvals, rkeys, rvals, fillv):
    """``(container, left, right)`` producers of the three out channels:
    the key (raw, not decoded), the left value (the fill, cast to the left
    dtype, on an unmatched right row) and the right value (the fill on an
    unmatched left row)."""
    ok, ol, orr = outs
    return (
        (ok, lambda i, rp, mt: lkeys[i], lambda jr: rkeys[jr]),
        (ol, lambda i, rp, mt: lvals[i], lambda jr: fillv.to(ol.dtype)),
        (orr, lambda i, rp, mt: torch.where(mt, rvals[rp].to(orr.dtype),
                                             fillv),
         lambda jr: rvals[jr]))


def _gather_side(cont, dev):
    """One sorted scratch side, all ranks' rows concatenated on ``dev``
    (on every process)."""
    return collectives.all_gather(_rows_of(cont), dev).reshape(-1)


def _broadcast_plan(LK, RK, nl, nr, left_outer, right_outer):
    """The broadcast merge's row arithmetic on the gathered sorted key
    sides' device: match counts, emitters."""
    dev = LK.device
    kl, _ = _masked_keys(LK, nl)
    kr, _ = _masked_keys(RK, nr)
    lo, cnt, rows = _counts(kl, kr, nl, nr, left_outer)
    if right_outer:
        rvalid = torch.arange(kr.numel(), device=dev) < nr
        em = _Emitters(rows, _unmatched(kl, kr, nl, rvalid),
                       torch.cat([kl, kr]))
    else:
        em = _Emitters(rows)
    return lo, cnt, em


def _merge_broadcast(slk, slv, nl, srk, srv, nr, outs, left_outer,
                     right_outer, fillv):
    """Both sorted sides are gathered once a process (onto its home
    device), the row arithmetic runs once a device, and every rank
    builds its own window of the expanded rows."""
    rt = slk.runtime
    home = rt.home
    LK0, LV0 = _gather_side(slk, home), _gather_side(slv, home)
    RK0, RV0 = _gather_side(srk, home), _gather_side(srv, home)
    plans = {}
    for r in rt.local_ranks:
        dev = rt.devices[r]
        if dev not in plans:
            LK, LV, RK, RV = (t.to(dev) for t in (LK0, LV0, RK0, RV0))
            lo, cnt, em = _broadcast_plan(LK, RK, nl, nr, left_outer,
                                          right_outer)
            plans[dev] = (em, lo, cnt, LK.numel(), RK.numel(), _channels(
                outs, LK, LV, RK, RV, fillv.to(dev)))
        em, lo, cnt, NL, NR, chans = plans[dev]
        for cont, left, right in chans:
            j = _slots(cont.layout, r, dev)
            vals = _emit_rows(em, j, lo, cnt, NL, NR, left, right,
                              cont.dtype)
            cont._rows[r] = _pack_out_row(vals, j < em.total, cont.layout,
                                          r)
    return int(plans[home][0].total)


def _tuned(domain: str, param: str):
    """``tuning.lookup(domain, param)`` for the relational pickers (in a
    multi-process runtime process 0's answer on every process, so every
    process takes the same route)."""
    from .. import tuning as _tuning
    return _tuning.lookup(domain, param)


def _broadcast_max() -> int:
    """``DR_GPU_JOIN_BROADCAST_MAX``: the combined sorted-side row count
    up to which ``join`` keeps the broadcast merge (per-device memory
    O(nl + nr)); above it, with more than one rank and both sides
    non-empty, the merge takes the partition route.  ``0`` forces the
    partition route; a malformed value reads as the default, 2^18.

    With the variable unset and the plan optimizer's ``joinroute`` pass
    armed, a ``join.broadcast_max`` entry of the tuning DB
    (``dr_tpu_torch/tuning.py``, matched on this runtime's context)
    replaces the default; a value that is not an integer is ignored."""
    if env_raw("DR_GPU_JOIN_BROADCAST_MAX") is None:
        from ..plan import opt as _opt
        if _opt.enabled("joinroute"):
            v = _tuned("join", "broadcast_max")
            if v is not None and not isinstance(v, bool):
                try:
                    return max(0, int(v))
                except (TypeError, ValueError):
                    pass
    return env_int("DR_GPU_JOIN_BROADCAST_MAX", 1 << 18, floor=0)


#: how the last join routed; read through :func:`last_join_route`
_LAST_JOIN_ROUTE: dict = {}


def last_join_route() -> dict:
    """Copy of the last join's routing record: ``impl`` (``broadcast`` /
    ``partition``), the side sizes, ``nshards`` and the rows each device
    holds of the gathered channels: both full sides for ``broadcast``,
    the local left block plus the ``rcap``-bounded right partition for
    ``partition``."""
    return dict(_LAST_JOIN_ROUTE)


def _set_join_route(**kw) -> None:
    _LAST_JOIN_ROUTE.clear()
    _LAST_JOIN_ROUTE.update(kw)


def _partition_bounds(kl, krows, nvr, p, rt, outer, nl, Sl):
    """Per rank, the contiguous global slice ``[starts[d], ends[d])`` of
    the sorted right side that rank d's partition holds, from each rank's
    left key range ``[firsts[d], lasts[d]]`` (its block's first and last
    real keys): two searchsorteds per rank on its own right block and a
    sum.  ``outer`` extends the windows so every real right key has
    exactly one owning rank: the gap below rank d's range belongs to d
    (above ``lasts[d-1]``), everything above the last real left key to
    the last nonempty left rank; empty left ranks (trailing) own nothing.
    Returns per-rank ``(firsts, lasts, starts, ends)`` lists (None for a
    rank another process owns: each gather and sum runs once a process)
    and ``(last_ne, ne)``."""
    devs = rt.devices
    firsts = collectives.all_gather_each(
        [None if k is None else k[0] for k in kl], devs)
    lasts = collectives.all_gather_each(
        [None if k is None else k[-1] for k in kl], devs)
    nvls = np.minimum(np.maximum(nl - np.arange(p) * Sl, 0), Sl)
    last_ne = int(np.nonzero(nvls)[0].max())
    ne = nvls > 0
    below, thru = [None] * p, [None] * p
    for r, kr in _local(krows):
        f, la = firsts[r], lasts[r]
        lo = torch.clamp(torch.searchsorted(kr, f), max=nvr[r])
        hi = torch.clamp(torch.searchsorted(kr, la, right=True), max=nvr[r])
        if outer:
            lastprev = torch.cat([la[:1], la[:-1]])
            lo = torch.minimum(lo, torch.clamp(
                torch.searchsorted(kr, lastprev, right=True), max=nvr[r]))
            lo[0] = 0
            hi[last_ne] = nvr[r]
            nev = torch.as_tensor(ne, device=kr.device)
            lo, hi = torch.where(nev, lo, 0), torch.where(nev, hi, 0)
        below[r], thru[r] = lo, hi
    starts = _home_each(collectives.psum(below, rt.home), rt)
    ends = _home_each(collectives.psum(thru, rt.home), rt)
    return firsts, lasts, starts, ends, last_ne, ne


def _merge_partition(sid, slk, slv, nl, srk, srv, nr, outs, left_outer,
                     right_outer, fillv):
    """The repartition merge: the sorted left side stays where it is,
    each rank's right partition (at most ``rcap`` rows, sized by one host
    read of the probe) arrives over one ring rotation of the right blocks
    (one block in flight a hop), each rank merges its own partition, and
    the out windows are assembled producer-side through one masked
    ``all_to_all`` per channel (each slot selects its one producer).
    Rows and count are those of the broadcast merge, bit for bit.
    Records the ``partition_plan`` and ``merge`` phases under span
    ``sid``.  Returns ``(count, rcap)``."""
    fire_ppermute(what="join.partition")
    _rel_tap("reljoinpart", slk.runtime, slk.layout, dtype_name(slk.dtype),
             srk.layout, dtype_name(srv.dtype), left_outer, right_outer)
    t0 = _obs.now()
    p, Sl, *_ = working_geometry(slk.layout)
    _, Sr, *_ = working_geometry(srk.layout)
    rt = slk.runtime
    devs, local = rt.devices, rt.local_ranks
    lraw, rraw = _rows_of(slk), _rows_of(srk)
    nvl = [_nvalid(nl, r, Sl) for r in range(p)]
    nvr = [_nvalid(nr, r, Sr) for r in range(p)]
    klq, kl, krows = [None] * p, [None] * p, [None] * p
    for r in local:
        kq, _ = _masked_keys(lraw[r], nvl[r])
        klq[r] = kq
        # the range row ends at the last REAL key, not the pad key
        k = kq.clone()
        k[Sl - 1] = kq[max(nvl[r] - 1, 0)]
        kl[r] = k
        krows[r], bigr = _masked_keys(rraw[r], nvr[r])
    firsts, lasts, starts, ends, last_ne, ne = _partition_bounds(
        kl, krows, nvr, p, rt, right_outer, nl, Sl)
    # the planner's one host read: the widest partition (the summed
    # bounds are the same on every process)
    h = local[0]
    mx = max(int((ends[h] - starts[h]).max()), 1)
    rcap = min(1 << (mx - 1).bit_length(), p * Sr)
    _obs.complete("relational.phase", t0, cat="relational", parent=sid,
                  phase="partition_plan", rcap=rcap)
    t0 = _obs.now()

    # rotate the right blocks; each rank scatters the rows of its slice
    # at their offset into rcap-sized buffers (a trash slot at rcap takes
    # the rest): positions are unique, so the result is schedule-free
    def scatter(t, r, carry, blocks):
        s = (r - t) % p
        g = torch.arange(s * Sr, (s + 1) * Sr, device=devs[r])
        s0 = starts[r][r]
        if right_outer:
            inr = (g < nr) & (g >= s0) & (g < ends[r][r])
        else:
            inr = (g < nr) & (blocks[0] >= firsts[r][r]) \
                & (blocks[0] <= lasts[r][r])
        idx = torch.where(inr, g - s0, rcap)
        for buf, blk in zip(carry, blocks):
            buf.scatter_(0, idx, blk)
        return carry

    carry, blocks = [None] * p, [None] * p
    rvals, lvals = _rows_of(srv), _rows_of(slv)
    for r in local:
        dev = devs[r]
        carry[r] = (torch.full((rcap + 1,), bigr, dtype=krows[r].dtype,
                               device=dev),
                    torch.zeros(rcap + 1, dtype=srv.dtype, device=dev),
                    torch.zeros(rcap + 1, dtype=srk.dtype, device=dev))
        blocks[r] = (krows[r], rvals[r], rraw[r])
    parts = ring_pipeline(devs, carry, blocks, scatter)

    ems, los, cnts, chans = [None] * p, [None] * p, [None] * p, [None] * p
    for r in local:
        dev = devs[r]
        rbk, rbv, rbraw = (b[:rcap] for b in parts[r])
        size_me = ends[r][r] - starts[r][r]
        lo, cnt, rows = _counts(kl[r], rbk, nvl[r], size_me, left_outer)
        if right_outer:
            # an owned key inside my left range is in my partition iff it
            # is present at all; one outside it matches nowhere
            owned = torch.arange(rcap, device=dev) < size_me
            if not ne[r]:
                owned = torch.zeros_like(owned)
            if r:
                owned = owned & (rbk > lasts[r][r - 1])
            if r != last_ne:
                owned = owned & (rbk <= lasts[r][r])
            em = _Emitters(rows, _unmatched(klq[r], rbk, nvl[r], owned),
                           torch.cat([klq[r], rbk]))
        else:
            em = _Emitters(rows)
        ems[r], los[r], cnts[r] = em, lo, cnt
        chans[r] = _channels(outs, lraw[r], lvals[r], rbraw, rbv,
                             fillv.to(dev))
    # every rank's row count: one gather a process
    ctots = [None if g is None else torch.cumsum(g, 0)
             for g in collectives.all_gather_each(
                 [None if em is None else em.total for em in ems], devs)]
    bases = {r: ctots[r][r] - ems[r].total for r in local}

    for c in range(3):
        cont = outs[c]
        So = working_geometry(cont.layout)[1]
        sends = [None] * p
        for r in local:
            _, left, right = chans[r][c]
            jl = _all_slots(cont.layout, devs[r]) - bases[r]
            mine = (jl >= 0) & (jl < ems[r].total)
            vals = _emit_rows(ems[r], jl, los[r], cnts[r], Sl, rcap, left,
                              right, cont.dtype)
            sends[r] = torch.where(mine, vals, 0)
        for r, recv in _local(collectives.all_to_all(
                sends, devs, ((So,), cont.dtype))):
            jt = _slots(cont.layout, r, devs[r])
            ps = torch.searchsorted(ctots[r], jt, right=True) \
                .clamp(0, p - 1)
            got = recv.gather(0, ps[None])[0]
            cont._rows[r] = _pack_out_row(got, jt < ctots[r][-1],
                                          cont.layout, r)
    m = int(ctots[h][-1])
    _obs.complete("relational.phase", t0, cat="relational", parent=sid,
                  phase="merge", rows=m, route="partition")
    return m, rcap


def _check_join_sides(lk, lv, rk, rv):
    lkc = _in_chain(lk, "join")
    lvc = _in_chain(lv, "join")
    rkc = _in_chain(rk, "join")
    rvc = _in_chain(rv, "join")
    if lkc.n != lvc.n or rkc.n != rvc.n:
        raise ValueError(
            f"join: keys and values must have equal length per side "
            f"({lkc.n} != {lvc.n} or {rkc.n} != {rvc.n})")
    if lkc.cont.dtype != rkc.cont.dtype:
        raise TypeError(
            f"join: key dtypes must match ({lkc.cont.dtype} != "
            f"{rkc.cont.dtype})")
    if not _same_ranks(rkc.cont, lkc.cont):
        raise TypeError("join: right keys must live on the left keys' "
                        "ranks")
    return lkc, lvc, rkc, rvc


def _check_join(lk, lv, rk, rv, out_keys, out_lv, out_rv):
    lkc, lvc, rkc, rvc = _check_join_sides(lk, lv, rk, rv)
    okc = _whole_out(out_keys, "join")
    olc = _whole_out(out_lv, "join")
    orc = _whole_out(out_rv, "join")
    if olc.n != okc.n or orc.n != okc.n:
        raise ValueError("join: the three output containers must "
                         "share one capacity")
    for c, nm in ((okc, "out_keys"), (olc, "out_left"), (orc, "out_right")):
        if not _same_ranks(c.cont, lkc.cont):
            raise TypeError(f"join: {nm} must live on the left keys' "
                            "ranks")
    return lkc, lvc, rkc, rvc, okc, olc, orc


def _no_rows(how, nl, nr) -> bool:
    """No left rows (unless an outer join has right rows), or an inner
    join against an empty right side: the result is empty."""
    return (nl == 0 and not (how == "outer" and nr > 0)) \
        or (how == "inner" and nr == 0)


def _merge_sorted(sid, slk, slv, nl, srk, srv, nr, outs, how,
                  fill) -> int:
    """The merge half of a join over the already-sorted sides: routes,
    rebuilds the out containers' rows and returns the row count."""
    p, Sl, *_ = working_geometry(slk.layout)
    _, Sr, *_ = working_geometry(srk.layout)
    left_outer = how in ("left", "outer")
    right_outer = how == "outer"
    # the fill in the right value's dtype (the left fill casts from it)
    fillv = torch.tensor(fill, dtype=outs[2].dtype)
    if p > 1 and nl > 0 and nr > 0 and nl + nr > _broadcast_max():
        m, rcap = _merge_partition(sid, slk, slv, nl, srk, srv, nr, outs,
                                   left_outer, right_outer, fillv)
        _set_join_route(impl="partition", nl=nl, nr=nr, nshards=p,
                        rcap=rcap, gathered_rows_per_device=Sl + rcap)
        return m
    t0 = _obs.now()
    m = _merge_broadcast(slk, slv, nl, srk, srv, nr, outs, left_outer,
                         right_outer, fillv)
    _set_join_route(impl="broadcast", nl=nl, nr=nr, nshards=p,
                    gathered_rows_per_device=p * (Sl + Sr))
    _obs.complete("relational.phase", t0, cat="relational", parent=sid,
                  phase="merge", rows=m, route="broadcast")
    return m


def _join_eager(lk, lv, rk, rv, out_keys, out_lv, out_rv, how,
                fill) -> int:
    if how == "right":
        # the left join with the sides swapped: the keys follow the right
        # side's order and the fill lands on the left value column
        return _join_eager(rk, rv, lk, lv, out_keys, out_rv, out_lv,
                           "left", fill)
    lkc, lvc, rkc, rvc, okc, olc, orc = _check_join(
        lk, lv, rk, rv, out_keys, out_lv, out_rv)
    _rel_tap("reljoin", lkc.cont.runtime, _chain_key(lkc), _chain_key(lvc),
             _chain_key(rkc), _chain_key(rvc), okc.cont.layout, how)
    sid = _obs.begin("relational.join", cat="relational", how=how,
                     n_left=lkc.n, n_right=rkc.n)
    m = -1
    try:
        if _no_rows(how, lkc.n, rkc.n):
            t0 = _obs.now()
            for oc in (out_keys, out_lv, out_rv):
                _fill(oc, 0)
            m = 0
            _obs.complete("relational.phase", t0, cat="relational",
                          parent=sid, phase="empty")
            return 0
        slk, slv, nl = _sorted_scratch(lkc, lvc, sid=sid, phase="sort_left")
        srk, srv, nr = _sorted_scratch(rkc, rvc, sid=sid,
                                       phase="sort_right")
        m = _merge_sorted(sid, slk, slv, nl, srk, srv, nr,
                          (okc.cont, olc.cont, orc.cont), how, fill)
        if m > okc.n:
            _raise_capacity(f"join[{how}]", m, okc.n)
        return m
    finally:
        _obs.end(sid, rows=m)


def _check_how(how):
    if how not in JOIN_HOWS:
        raise ValueError(f"join: unknown how {how!r} "
                         f"(known: {', '.join(JOIN_HOWS)})")


def join(left_keys, left_values, right_keys, right_values, out_keys,
         out_left, out_right, *, how: str = "inner", fill=0) -> int:
    """Distributed sort-merge join.

    Matches ``left_keys`` against ``right_keys`` (one key dtype, the sort
    family's key equality) and writes one row per match pair:
    ``out_keys[i]`` the key, ``out_left[i]`` / ``out_right[i]`` the two
    sides' values, ordered by (key, left position, right position).
    Duplicate keys expand many-to-many.  ``how="left"`` / ``"right"``
    also emit every unmatched row of that side with ``fill`` on the
    missing value column; ``how="outer"`` emits the union, interleaved in
    key order.  Non-mutating in the inputs; the three whole-container
    outputs share one capacity, positions ``>= count`` are zero.  Returns
    the row count; a result beyond the capacity raises ``ProgramError``
    after the op ran (the first ``capacity`` rows are valid)."""
    _check_how(how)
    *_sides, okc, olc, orc = _check_join(left_keys, left_values, right_keys,
                                         right_values, out_keys, out_left,
                                         out_right)
    p = _plan_active()
    if p is not None:
        box: list = []
        meta = _opaque_meta(
            "join", {"lk": left_keys, "lv": left_values,
                     "rk": right_keys, "rv": right_values},
            (okc.cont, olc.cont, orc.cont))
        reads, writes = _meta_footprint(meta)
        p.record_opaque(
            "join",
            lambda m=meta: box.append(_join_eager(
                m["inputs"]["lk"], m["inputs"]["lv"], m["inputs"]["rk"],
                m["inputs"]["rv"], out_keys, out_left, out_right, how,
                fill)),
            reads=reads, writes=writes, meta=meta)
        return DeferredCount(p, box)
    return _join_eager(left_keys, left_values, right_keys, right_values,
                       out_keys, out_left, out_right, how, fill)


# ---------------------------------------------------------------------------
# the auto tier: inferred output capacity
# ---------------------------------------------------------------------------

def _pow2_cap(n: int) -> int:
    """Pow2-quantized output capacity."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


class AutoResult:
    """Result of an auto-capacity relational op: the output containers
    (allocated from the probed count, pow2-sized) and the row count.
    Recorded in a deferred region it is pending until first use, which
    flushes the plan; one whose flush was dropped raises."""

    __slots__ = ("_plan", "_box")

    def __init__(self, containers, count, *, plan=None, box=None):
        self._plan = plan
        self._box = box if box is not None \
            else [(tuple(containers), int(count))]

    def _get(self):
        if not self._box:
            self._plan.flush("relational count read")
        if not self._box:
            raise RuntimeError(
                "deferred auto-capacity result was discarded before it "
                "resolved (faulted flush or abandoned region)")
        return self._box[-1]

    @property
    def count(self) -> int:
        return int(self._get()[1])

    @property
    def containers(self) -> tuple:
        """The allocated output containers (capacity-padded)."""
        return tuple(self._get()[0])

    def arrays(self):
        """Materialized outputs trimmed to the real row count."""
        conts, m = self._get()
        return [_to_numpy(c)[:int(m)] for c in conts]

    def __int__(self):
        return self.count

    def __repr__(self):
        state = self._box[-1][1] if self._box else "pending"
        return f"AutoResult(count={state})"


def _auto(name, meta, run):
    """An auto op: recorded opaque (pending :class:`AutoResult`) inside a
    deferred region, else run now.  ``run(inputs)`` gives (containers,
    count)."""
    p = _plan_active()
    if p is None:
        return AutoResult(*run(meta["inputs"]))
    box: list = []
    reads, _w = _meta_footprint(meta)
    p.record_opaque(name, lambda: box.append(run(meta["inputs"])),
                    reads=reads, writes=(), meta=meta)
    return AutoResult(None, None, plan=p, box=box)


def _fresh_outs(rt, dtypes, cap):
    return tuple(distributed_vector(cap, dtype=dt, runtime=rt)
                 for dt in dtypes)


def _capinfer_enabled() -> bool:
    from ..plan import opt as _opt
    return _opt.enabled("capinfer")


def _cap_hint(kind: str, base: int):
    """The capacity hint of an auto op while the ``capinfer`` pass is
    armed: the rows/input ratio of ``relational.cap_ratio_<kind>`` (the
    session overlay the last auto run noted, else the tuning DB) times
    ``base``, widened by 1.25.  None (no hint, or a value that is not a
    number): the caller probes the exact count."""
    if base <= 0:
        return None
    r = _tuned("relational", "cap_ratio_" + kind)
    if isinstance(r, bool):
        return None
    try:
        r = float(r) if r is not None else None
    except (TypeError, ValueError):
        return None
    if r is None or not np.isfinite(r) or r <= 0:
        return None
    return max(1, int(np.ceil(r * base * 1.25)))


def _note_ratio(kind: str, base: int, m: int) -> None:
    """Note the observed rows/input ratio in the session overlay, so the
    next auto op of this kind skips its probe (``base`` and ``m`` are
    global counts: every process notes the same ratio)."""
    if base > 0:
        from .. import tuning as _tuning
        _tuning.note("relational", "cap_ratio_" + kind, max(m, 1) / base)


def _join_auto_eager(lk, lv, rk, rv, how, fill):
    if how == "right":
        conts, m = _join_auto_eager(rk, rv, lk, lv, "left", fill)
        ok, orr, ol = conts  # swap the value channels back
        return (ok, ol, orr), m
    lkc, lvc, rkc, rvc = _check_join_sides(lk, lv, rk, rv)
    rt = lkc.cont.runtime
    _rel_tap("reljoincnt", rt, _chain_key(lkc), _chain_key(lvc),
             _chain_key(rkc), _chain_key(rvc), how)
    dtypes = (lkc.cont.dtype, lvc.cont.dtype, rvc.cont.dtype)
    sid = _obs.begin("relational.join", cat="relational", how=how,
                     auto=True, n_left=lkc.n, n_right=rkc.n)
    m = -1
    try:
        if _no_rows(how, lkc.n, rkc.n):
            m = 0
            return _fresh_outs(rt, dtypes, 1), 0
        slk, slv, nl = _sorted_scratch(lkc, lvc, sid=sid, phase="sort_left")
        srk, srv, nr = _sorted_scratch(rkc, rvc, sid=sid,
                                       phase="sort_right")
        base = nl + nr
        cap = _cap_hint("join_" + how, base) if _capinfer_enabled() \
            else None
        if cap is None:
            # the exact count: the broadcast merge's row arithmetic on
            # one device
            t0 = _obs.now()
            cap = int(_broadcast_plan(
                _gather_side(slk, rt.home), _gather_side(srk, rt.home), nl,
                nr, how in ("left", "outer"), how == "outer")[-1].total)
            _obs.complete("relational.phase", t0, cat="relational",
                          parent=sid, phase="cap_probe", rows=cap)
        cap = _pow2_cap(cap)
        conts = _fresh_outs(rt, dtypes, cap)
        m = _merge_sorted(sid, slk, slv, nl, srk, srv, nr, conts, how, fill)
        if m > cap:
            # a hinted capacity undershot: merge again at the exact
            # count, never a capacity error on the auto tier
            conts = _fresh_outs(rt, dtypes, _pow2_cap(m))
            m2 = _merge_sorted(sid, slk, slv, nl, srk, srv, nr, conts, how,
                               fill)
            assert m2 == m, "join count drifted between merges"
        _note_ratio("join_" + how, base, m)
        return conts, m
    finally:
        _obs.end(sid, rows=m)


def _groupby_auto_eager(keys, values, agg, keys_only=False):
    kc = _in_chain(keys, "groupby_aggregate")
    vc = _in_chain(values, "groupby_aggregate") \
        if values is not None else None
    if vc is not None and vc.n != kc.n:
        raise ValueError(
            f"groupby_aggregate: keys and values must have equal "
            f"length ({kc.n} != {vc.n})")
    rt = kc.cont.runtime
    if vc is None:
        vdt = torch.int32                    # the count channel
    elif agg == "mean":
        vdt = _acc_dtype(vc.cont.dtype)
    else:
        vdt = vc.cont.dtype
    _rel_tap("relgbcnt", rt, _chain_key(kc), _chain_key(vc), agg)
    sid = _obs.begin("relational.groupby", cat="relational", agg=agg,
                     auto=True, n=kc.n)
    ng = -1
    try:
        sk, sv, n = _sorted_scratch(kc, vc, sid=sid)
        cap = _cap_hint("groupby", n) if _capinfer_enabled() else None
        if cap is None:
            t0 = _obs.now()
            cap = _group_count(sk, n)
            _obs.complete("relational.phase", t0, cat="relational",
                          parent=sid, phase="cap_probe", groups=cap)
        cap = _pow2_cap(min(cap, max(n, 1)))
        while True:
            ok = _fresh_outs(rt, (kc.cont.dtype,), cap)[0]
            ov = None if keys_only else _fresh_outs(rt, (vdt,), cap)[0]
            ng = _groupby_sorted(sid, sk, sv, n, ok, ov, agg)
            if ng <= cap:
                break
            cap = _pow2_cap(ng)  # a hinted capacity undershot
        _note_ratio("groupby", n, ng)
        return ((ok,) if ov is None else (ok, ov)), ng
    finally:
        _obs.end(sid, groups=ng)


def join_auto(left_keys, left_values, right_keys, right_values, *,
              how: str = "inner", fill=0) -> AutoResult:
    """:func:`join` with inferred output capacity: after the sides are
    sorted, a count-only probe gives the exact row count and the outputs
    are allocated at its pow2 ceiling.  Returns an :class:`AutoResult`
    over ``(out_keys, out_left, out_right)``."""
    _check_how(how)
    _check_join_sides(left_keys, left_values, right_keys, right_values)
    meta = _opaque_meta("join", {"lk": left_keys, "lv": left_values,
                                 "rk": right_keys, "rv": right_values}, ())
    return _auto("join(auto)", meta, lambda i: _join_auto_eager(
        i["lk"], i["lv"], i["rk"], i["rv"], how, fill))


def groupby_auto(keys, values, agg: str = "sum") -> AutoResult:
    """:func:`groupby_aggregate` with inferred output capacity (the
    distinct-key count probe).  Returns an :class:`AutoResult` over
    ``(out_keys, out_values)``."""
    _check_agg(values, agg)
    kc = _in_chain(keys, "groupby_aggregate")
    inputs = {"keys": keys}
    if values is not None:
        vc = _in_chain(values, "groupby_aggregate")
        if vc.n != kc.n:
            raise ValueError(
                f"groupby_aggregate: keys and values must have equal "
                f"length ({kc.n} != {vc.n})")
        inputs["values"] = values
    meta = _opaque_meta("groupby", inputs, ())
    return _auto("groupby(auto)", meta, lambda i: _groupby_auto_eager(
        i["keys"], i.get("values"), agg))


def unique_auto(r) -> AutoResult:
    """:func:`unique` with inferred output capacity.  Returns an
    :class:`AutoResult` over ``(out,)``."""
    _in_chain(r, "unique")
    meta = _opaque_meta("unique", {"r": r}, ())
    return _auto("unique(auto)", meta, lambda i: _groupby_auto_eager(
        i["r"], None, "count", keys_only=True))


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def _bound(v, pt, dev):
    """A histogram edge as the JAX package receives it: an f32 scalar,
    then cast to the working dtype ``pt``."""
    return torch.full((), float(v), dtype=torch.float32,
                      device=dev).to(pt)


def histogram(r, out, lo, hi):
    """Fixed-bin histogram of a distributed range: ``bins = len(out)``
    equal buckets over ``[lo, hi]`` (right edge inclusive in the last
    bucket, numpy's rule; out-of-range values are dropped), counts cast
    to ``out``'s dtype.  Input view chains fuse.  Returns ``out``.

    Bucket rule, as the JAX package evaluates it: the input promoted to
    ``promote_types(dtype, float32)``, ``lo``/``hi`` rounded to f32 and
    cast to it, then ``floor((x - lo) * bins / (hi - lo))`` as separate
    operations in that order, to int32."""
    if isinstance(lo, (int, float, np.number)) \
            and isinstance(hi, (int, float, np.number)) \
            and not (float(hi) > float(lo)):
        raise ValueError(f"histogram: need hi > lo (got [{lo}, {hi}])")
    chain = _single_chain(r, "histogram")
    oc = _whole_out(out, "histogram")
    if not _same_ranks(oc.cont, chain.cont):
        raise TypeError("histogram: out must live on the input's ranks")
    p = _plan_active()
    if p is not None:
        p.record_histogram(chain, oc, lo, hi)
        return out
    _rel_tap("relhist", chain.cont.runtime, _chain_key(chain), oc.n,
             dtype_name(oc.cont.dtype))
    sid = _obs.begin("relational.histogram", cat="relational", n=chain.n,
                     bins=oc.n)
    try:
        oc.cont._rows = _histogram_rows(
            chain.cont._rows, chain.cont.layout, chain.off, chain.n,
            chain.ops, _chain_scalars([chain]), oc.cont.layout,
            oc.cont.dtype, oc.n, lo, hi)
        return out
    finally:
        _obs.end(sid)


def _histogram_rows(in_rows, in_layout, off, n, ops, chain_sc, out_layout,
                    out_dtype, bins, lo, hi) -> list:
    """Bucket each rank's window cells, count them (K8 or
    ``index_add_``), sum the counts in rank order (``psum``, once a
    process): the out container's new rows (None for a rank another
    process owns)."""
    local = [None] * len(in_rows)
    for rk, row in _local(in_rows):
        dev = row.device
        c0, c1 = window_cols(in_layout, off, n, rk)
        x = _apply_chain_ops(row[0, c0:c1], ops, iter(chain_sc))
        pt = torch.promote_types(x.dtype, torch.float32)
        xv = x.to(pt)
        lov, hiv = _bound(lo, pt, dev), _bound(hi, pt, dev)
        b = torch.floor((xv - lov) * bins / (hiv - lov)).to(torch.int32)
        inr = (xv >= lov) & (xv <= hiv)
        bc = torch.where(inr, b, 0).clamp(0, bins - 1)
        cnt = inr.to(torch.int32)
        if hist_pallas.eligible(bc.numel(), bins):
            local[rk] = hist_pallas.bincount(bc, cnt, bins)
        else:
            local[rk] = torch.zeros(bins, dtype=torch.int32,
                                    device=dev).index_add_(0, bc, cnt)
    total = collectives.psum(local, collectives.present(in_rows).device)
    new = [None] * len(in_rows)
    for rk, row in _local(in_rows):
        dev = row.device
        t = _slots(out_layout, rk, dev)
        vals = total.to(dev)[t.clamp(0, bins - 1)].to(out_dtype)
        new[rk] = _pack_out_row(vals, t < bins, out_layout, rk)
    return new


# ---------------------------------------------------------------------------
# top_k
# ---------------------------------------------------------------------------

def _order_of(vals, largest):
    """Ascending order = best first: the order keys, bit-inverted for
    ``largest`` (a monotone reversal of signed keys)."""
    enc, _ = _encode(vals)
    return ~enc if largest else enc


def _sort_perm2(a, b):
    """The permutation sorting by ``(a, b)``: one sort of the pair packed
    into int64 where both are int32, else two stable sorts, ``b``
    first."""
    if a.dtype == torch.int32 and b.dtype == torch.int32:
        packed = (a.to(torch.int64) << 32) + (b.to(torch.int64) + 2 ** 31)
        return torch.sort(packed).indices
    p1 = torch.sort(b, stable=True).indices
    return p1[torch.sort(a[p1], stable=True).indices]


def _top_k_chains(r, out_vals, out_idx):
    chain = _single_chain(r, "top_k")
    ovc = _whole_out(out_vals, "top_k")
    oic = _whole_out(out_idx, "top_k") if out_idx is not None else None
    k = ovc.n
    if oic is not None:
        if oic.n != k:
            raise ValueError(
                f"top_k: out_idx length {oic.n} != k ({k})")
        if oic.cont.dtype != torch.int32:
            raise TypeError("top_k: out_idx must be int32")
    for oc, nm in ((ovc, "out_vals"), (oic, "out_idx")):
        if oc is not None and not _same_ranks(oc.cont, chain.cont):
            raise TypeError(f"top_k: {nm} must live on the input's ranks")
    return chain, ovc, oic


def top_k(r, out_vals, out_idx=None, *, largest: bool = True,
          merge: bool = False):
    """The ``k = len(out_vals)`` best elements of a distributed range,
    best first (descending for ``largest=True``; ties keep the smaller
    index).  ``out_idx`` (optional, int32, length k) receives each
    element's position within ``r`` (window-local for subranges).  When
    fewer than k elements exist, trailing slots hold the dtype's finite
    worst value and index ``INT32_MAX``.

    ``merge=True`` folds the current ``out_vals``/``out_idx`` contents
    into the candidate pool, so chained calls over successive windows
    stream a running top-k.  Returns ``out_vals``."""
    chain, ovc, oic = _top_k_chains(r, out_vals, out_idx)
    if merge and oic is not None \
            and oic.cont.layout != ovc.cont.layout:
        # the merged pool pairs each current value with its index by slot
        raise TypeError(
            "top_k: merge=True needs out_vals and out_idx on ONE "
            "layout (their current contents pair by slot)")
    p = _plan_active()
    if p is not None:
        p.record_top_k(chain, ovc, oic, largest, merge)
        return out_vals
    _rel_tap("reltopk", chain.cont.runtime, _chain_key(chain), ovc.n,
             dtype_name(ovc.cont.dtype), oic is not None, largest, merge)
    sid = _obs.begin("relational.top_k", cat="relational", n=chain.n,
                     k=ovc.n, largest=largest, merge=merge)
    try:
        new_v, new_i = _top_k_rows(
            chain.cont._rows, chain.cont.layout, chain.off, chain.n,
            chain.ops, _chain_scalars([chain]), ovc.cont._rows,
            ovc.cont.layout, ovc.cont.dtype,
            oic.cont._rows if oic is not None else None,
            oic.cont.layout if oic is not None else None, ovc.n, largest,
            merge)
        ovc.cont._rows = new_v
        if oic is not None:
            oic.cont._rows = new_i
        return out_vals
    finally:
        _obs.end(sid)


def _top_k_rows(in_rows, in_layout, off, n, ops, chain_sc, ov_rows,
                ov_layout, ov_dtype, oi_rows, oi_layout, k, largest,
                merge):
    """Each rank's k best (order key, index) pairs, gathered once a
    process and sorted once more: the new rows of the value (and index)
    container (None for a rank another process owns)."""
    p = len(in_rows)
    sentinel = _worst(ov_dtype, largest)
    cands = [None] * p
    for rk, row in _local(in_rows):
        dev = row.device
        x = _apply_chain_ops(row[0], ops, iter(chain_sc))
        mask, gid = owned_window_mask(in_layout, off, n, rk, dev)
        xv = torch.where(mask, x.to(ov_dtype), sentinel)
        gv = torch.where(mask, (gid - off).to(torch.int32), _GMAX)
        if merge:
            omask, _ = owned_window_mask(ov_layout, 0, k, rk, dev)
            mv = torch.where(omask, ov_rows[rk][0], sentinel)
            mg = torch.where(omask, oi_rows[rk][0], _GMAX) \
                if oi_rows is not None else torch.full_like(
                    mv, _GMAX, dtype=torch.int32)
            xv, gv = torch.cat([xv, mv]), torch.cat([gv, mg])
        order = _order_of(xv, largest)
        kk = min(k, xv.numel())
        best = _sort_perm2(order, gv)[:kk]
        cands[rk] = (order[best], gv[best], xv[best])
    home = collectives.present(in_rows).device
    Go, Gg, Gv = (collectives.all_gather(
        [None if c is None else c[i] for c in cands], home).reshape(-1)
        for i in range(3))
    if Go.numel() < k:
        pad = k - Go.numel()
        Go = torch.cat([Go, Go.new_full((pad,), torch.iinfo(Go.dtype).max)])
        Gg = torch.cat([Gg, Gg.new_full((pad,), _GMAX)])
        Gv = torch.cat([Gv, Gv.new_full((pad,), sentinel)])
    best = _sort_perm2(Go, Gg)[:k]
    res_v0, res_g0 = Gv[best], Gg[best]
    new_v, new_i = [None] * p, [None] * p
    for rk, row in _local(in_rows):
        dev = row.device
        res_v, res_g = res_v0.to(dev), res_g0.to(dev)
        t = _slots(ov_layout, rk, dev)
        live = t < k
        new_v[rk] = _pack_out_row(
            torch.where(live, res_v[t.clamp(0, k - 1)], sentinel), live,
            ov_layout, rk)
        if oi_rows is not None:
            ti = _slots(oi_layout, rk, dev)
            ilive = ti < k
            new_i[rk] = _pack_out_row(
                torch.where(ilive, res_g[ti.clamp(0, k - 1)], _GMAX),
                ilive, oi_layout, rk)
    return new_v, (new_i if oi_rows is not None else None)
