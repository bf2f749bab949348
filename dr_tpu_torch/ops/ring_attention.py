"""Ring attention: sequence-parallel attention over the rank ring.

Counterpart of ``dr_tpu/ops/ring_attention.py``.  Q/K/V ``(B, S, h, d)``
are split over the sequence into ``P`` contiguous rank blocks on the
runtime's devices; each rank attends its q block to the K/V block it
currently holds while the K/V blocks rotate one hop a step on the shared
ring schedule (``parallel/pipeline.py``).  The online softmax (running
max and denominator) keeps memory at O(block) whatever the total length,
and the causal mask uses GLOBAL positions (at ring step t rank ``my``
holds the block of rank ``(my - t) % P``, whose first position is
``src * s``), so the result matches single-device attention.  The output
is one ``(B, S, h, d)`` tensor on the runtime's home device.

In a multi-process runtime (``collectives.init_distributed``) every
process is given the same q/k/v, keeps its own ranks' blocks, runs the
ring steps of those ranks (K/V rotate across processes on the ring's
``ppermute``, one shape a block, so no header) and gathers every rank's
output block in rank order (``collectives.gather_ranks``): the whole
output on every process, as with one controller.  The JAX package
returns a global array there, whose local shard is this output's block
of the process's rank.

Two routes, as in the JAX package (``_flash_viable``):

* bf16 inputs with ``d % 128 == 0`` and a block length ``s % 128 == 0``
  and no ``q_chunk``: the flash ring.  Each step is one
  :func:`~dr_tpu_torch.ops.flash_attention.flash_update` (K9 on a CUDA
  tensor) per rank, ``P * P`` launches per call, the causal steps whose
  block lies wholly in the future included (the JAX program runs its
  kernel there with an empty K loop too).  The ``(m, l, acc)`` state is
  the carry and the normalization ``acc / where(l > 0, l, 1)`` happens
  once, cast to the input dtype.  Grouped-query K/V (``hkv < h``) ride
  the ring with ``hkv`` heads only.
* everything else: the blockwise ring in plain PyTorch at full f32 (TF32
  matmuls must stay off, PyTorch's default), the q block in chunks that
  bound the ``(B, h, qc, s)`` logits (``_pick_q_chunk``), GQA heads
  repeated just in time.  The JAX package has no Pallas kernel here.

State carried across: the flash route's ``(m, l, acc)`` has the JAX
package's layout, so ``torch.from_numpy`` of JAX's carries feeds
``flash_update`` with no conversion, and ``ring_self_attention`` takes
the same ``(e, h, d)`` projection arrays.  There are no other
parameters on this path.

Each call fires the ``collectives.ppermute`` fault site
(``pipeline.fire_ppermute``) and looks up ``_cache``, the dispatch tap,
with the JAX package's key, before any tensor is sharded.

Not carried over: ``DR_TPU_RING_IMPL`` (forcing or refusing the kernel)
and the TPU tile picks in the JAX key.  ``schedule=`` picks the ring's
issue order (default ``DR_GPU_RING_SCHEDULE``); both give the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.pinning import pinned_id
from ..parallel import collectives
from ..parallel import pipeline as _pl
from ..parallel import runtime as _rt
from ..utils.spmd_guard import TappedCache, dtype_name
from . import flash_attention as _fa

__all__ = ["ring_attention", "ring_attention_n", "ring_self_attention"]

_NEG_INF = float("-inf")

#: ring attention's dispatch cache (the JAX package's ring programs)
_cache: dict = TappedCache()


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _shard(x, devices, s, rt=None):
    """The contiguous sequence block of every rank, on its device; with
    ``rt``, None for a rank another process owns."""
    return [x[:, r * s:(r + 1) * s].to(dev, non_blocking=True)
            if rt is None or rt.is_local(r) else None
            for r, dev in enumerate(devices)]


def _flash_viable(shape, dtype) -> bool:
    """The flash route: bf16 and the kernel's shape rule.  float32 keeps
    the full-precision blockwise route: the kernel computes in bf16."""
    B, s, h, d = shape
    return dtype == torch.bfloat16 and _fa.kernel_shape_ok(d, s)


def _flash_ring(qs, ks, vs, devices, shape, causal, dtype, hkv=None,
                schedule=None):
    """The ring with :func:`flash_update` as the per-step compute;
    returns every rank's ``(B, s, h, d)`` output in ``dtype``."""
    B, s, h, d = shape
    hkv = h if hkv is None else hkv
    BH = B * h
    nshards = len(devices)

    def head_major(x, heads):
        return x.permute(0, 2, 1, 3).reshape(B * heads, s, d).to(
            torch.bfloat16).contiguous()

    qh = [None if q is None else head_major(q, h) for q in qs]
    blocks = [None if k is None else (head_major(k, hkv), head_major(v, hkv))
              for k, v in zip(ks, vs)]
    carry = [None if q is None else
             (torch.full((BH, s, 1), _NEG_INF, device=dev),
              torch.zeros((BH, s, 1), device=dev),
              torch.zeros((BH, s, d), device=dev))
             for q, dev in zip(qs, devices)]

    def step(t, r, state, blk):
        src = (r - t) % nshards
        return _fa.flash_update(qh[r], blk[0], blk[1], *state, r * s,
                                src * s, causal=causal)

    carry = _pl.ring_pipeline(devices, carry, blocks, step,
                              schedule=schedule)

    def finish(state):
        m, l, acc = state
        out = (acc / torch.where(l > 0, l, 1.0)).to(dtype)
        return out.reshape(B, h, s, d).permute(0, 2, 1, 3)

    return [None if c is None else finish(c) for c in carry]


def _pick_q_chunk(B, s, h, budget_bytes=512 * 2 ** 20):
    """Largest q-chunk whose (B, h, qc, s) f32 logits fit the budget.
    The floor stays at 128 so high batch*heads configs keep an
    enforceable memory bound."""
    qc = s
    # halve only while the RESULT stays >= 128, so the floor holds even
    # when s is not a power of two (e.g. s=384 -> 192, not 96)
    while qc % 2 == 0 and qc >= 256 and B * h * qc * s * 4 > budget_bytes:
        qc //= 2
    return qc


def _blockwise_ring(qs, ks, vs, devices, shape, causal, dtype, q_chunk=None,
                    hkv=None, schedule=None):
    """The blockwise online-softmax ring in f32; returns every rank's
    ``(B, s, h, d)`` output in ``dtype``."""
    B, s, h, d = shape
    group = 1 if hkv is None else h // hkv
    scale = 1.0 / math.sqrt(d)
    qc = min(q_chunk or _pick_q_chunk(B, s, h), s)
    while s % qc:
        qc -= 1  # honor the bound: largest divisor of s <= requested
    nqc = s // qc
    nshards = len(devices)
    # q chunked along seq, head-major: (nqc, B, h, qc, d)
    q_ch = [None if q is None else q.float().reshape(B, nqc, qc, h, d)
            .permute(1, 0, 3, 2, 4) for q in qs]
    q_pos = [(r * s + torch.arange(s, device=dev)).reshape(nqc, qc)
             for r, dev in enumerate(devices)]
    carry = [None if q is None else
             (torch.full((nqc, B, h, qc), _NEG_INF, device=dev),
              torch.zeros((nqc, B, h, qc), device=dev),
              torch.zeros((nqc, B, h, qc, d), device=dev))
             for q, dev in zip(qs, devices)]
    # head-major ONCE; the ring carries the (B, hkv, s, d) blocks
    blocks = [None if k is None else
              (k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
              for k, v in zip(ks, vs)]

    def one_chunk(q_c, qp, m_c, l_c, acc_c, kT, vT, k_pos):
        logits = torch.einsum("bhqd,bhkd->bhqk", q_c, kT) * scale
        if causal:
            logits = torch.where(qp[:, None] >= k_pos[None, :], logits,
                                 _NEG_INF)
        new_m = torch.maximum(m_c, logits.amax(-1))
        # guard fully-masked rows (new_m == -inf)
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        corr = torch.where(torch.isfinite(m_c), torch.exp(m_c - safe_m), 0.0)
        l_c = l_c * corr + p.sum(-1)
        acc_c = acc_c * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                       p, vT)
        return new_m, l_c, acc_c

    def step(t, r, state, blk):
        m, l, acc = state
        src = (r - t) % nshards  # whose block rank r holds this round
        k_pos = src * s + torch.arange(s, device=devices[r])
        kT, vT = blk[0].float(), blk[1].float()
        if group > 1:
            # GQA: expand the shared heads to the q head count just in
            # time (q head b reads kv head b // group)
            kT = kT.repeat_interleave(group, dim=1)
            vT = vT.repeat_interleave(group, dim=1)
        parts = [one_chunk(q_ch[r][c], q_pos[r][c], m[c], l[c], acc[c],
                           kT, vT, k_pos) for c in range(nqc)]
        return tuple(torch.stack(x) for x in zip(*parts))

    carry = _pl.ring_pipeline(devices, carry, blocks, step,
                              schedule=schedule)

    def finish(state):
        m, l, acc = state
        out = (acc / torch.where(l > 0, l, 1.0)[..., None]).to(dtype)
        out = out.permute(1, 2, 0, 3, 4).reshape(B, h, s, d)
        return out.permute(0, 2, 1, 3)

    return [None if c is None else finish(c) for c in carry]


def _gather(outs, rt, shape, dtype):
    """Every rank's ``shape`` output block, in rank order, concatenated
    along the sequence on the home device (on every process)."""
    return torch.cat(collectives.gather_ranks(outs, rt.home,
                                              like=(shape, dtype)), dim=1)


def ring_attention(q, k, v, *, causal: bool = False, runtime=None,
                   q_chunk: int = None, schedule: str = None):
    """Sequence-parallel attention.

    q/k/v: ``(batch, seq, heads, head_dim)`` tensors (or arrays); ``seq``
    is split over the runtime's ranks.  K/V may have fewer heads than q
    (grouped-query).  Returns the ``(batch, seq, heads, head_dim)``
    output on the runtime's home device (on every process).
    ``q_chunk`` bounds the per-round logits to (batch, heads, q_chunk,
    block) on the blockwise route (and selects it); ``schedule`` is the
    ring's issue order."""
    rt = runtime or _rt.runtime()
    q, k, v = (_as_tensor(x) for x in (q, k, v))
    B, S, h, d = q.shape
    hkv = k.shape[2]
    assert h % hkv == 0 and v.shape[2] == hkv, \
        "q heads must be a multiple of the (shared) kv heads"
    nshards = rt.nprocs
    assert S % nshards == 0, "seq length must divide the mesh"
    shape = (B, S // nshards, h, d)
    devs = rt.devices
    flash = q_chunk is None and _flash_viable(shape, q.dtype)
    sched = _pl._resolve(schedule)
    _pl.fire_ppermute(op="ring_attention")
    _cache.tap(("ringattn", pinned_id(rt), shape, hkv, causal,
                dtype_name(q.dtype), q_chunk, flash, sched))
    qs, ks, vs = (_shard(x, devs, shape[1], rt) for x in (q, k, v))
    if flash:
        outs = _flash_ring(qs, ks, vs, devs, shape, causal, q.dtype,
                           hkv=hkv, schedule=schedule)
    else:
        outs = _blockwise_ring(qs, ks, vs, devs, shape, causal, q.dtype,
                               q_chunk, hkv=hkv, schedule=schedule)
    return _gather(outs, rt, shape, q.dtype)


def ring_attention_n(q, k, v, iters: int, *, causal: bool = False,
                     runtime=None, schedule: str = None):
    """``iters`` chained ring-attention steps (v := attn(q, k, v) each
    round, the output staying split over the ranks) — the measurement
    analog of ``span_halo.exchange_n``.  Returns the final output."""
    rt = runtime or _rt.runtime()
    q, k, v = (_as_tensor(x) for x in (q, k, v))
    B, S, h, d = q.shape
    assert k.shape[2] == h and v.shape[2] == h, \
        "ring_attention_n chains v through the output: heads must match"
    nshards = rt.nprocs
    assert S % nshards == 0, "seq length must divide the mesh"
    shape = (B, S // nshards, h, d)
    devs = rt.devices
    flash = _flash_viable(shape, q.dtype)
    ring = _flash_ring if flash else _blockwise_ring
    sched = _pl._resolve(schedule)
    _pl.fire_ppermute(op="ring_attention_n")
    _cache.tap(("ringattn_n", pinned_id(rt), shape, causal,
                dtype_name(q.dtype), flash, int(iters), sched))
    qs, ks, vs = (_shard(x, devs, shape[1], rt) for x in (q, k, v))
    for _ in range(iters):
        vs = ring(qs, ks, vs, devs, shape, causal, q.dtype,
                  schedule=schedule)
    return _gather(vs, rt, shape, collectives.present(vs).dtype)


def ring_self_attention(x, wq, wk, wv, *, causal: bool = False,
                        runtime=None):
    """Convenience: project + ring-attend.  x: ``(B, S, h*d)``; the
    projections ``(e, h, d)`` run as one einsum each on the runtime's
    home device (every process projects the whole sequence)."""
    rt = runtime or _rt.runtime()
    x = _as_tensor(x).to(rt.home)

    def proj(w):
        w = _as_tensor(w).to(rt.home)
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.einsum("bse,ehd->bshd", x.to(dt), w.to(dt))

    return ring_attention(proj(wq), proj(wk), proj(wv), causal=causal,
                          runtime=rt)
