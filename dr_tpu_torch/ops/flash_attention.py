"""K9: one ring step's flash-attention update of the running
``(m, l, acc)`` state.

Counterpart of ``dr_tpu/ops/flash_attention.py``.  ``flash_update``
attends a q shard to the K/V block a ring step holds and folds the
result into the carried online-softmax state; the final normalization
(``acc / l``) happens once, in ``ops/ring_attention.py``.  Layouts are
the JAX package's: q ``(BH, s, d)`` bf16, k/v ``(BHkv, skv, d)`` bf16
with ``BH % BHkv == 0`` (grouped-query: q head b reads K/V head
``b // group``), m/l ``(BH, s, 1)`` f32 and acc ``(BH, s, d)`` f32.
``q_off``/``k_off`` are the GLOBAL sequence offsets of the q shard and of
the K/V block; the causal mask is ``q_off + row >= k_off + col``.

Routes: CUDA tensors take ``csrc/flash_attention.cu`` and raise on what
the kernel does not take; CPU tensors take :func:`plain_flash_update`,
the same update in plain PyTorch over the kernel's key tiles.  At
``d = 128`` and ``256`` the kernel is a persistent, warp-specialised
Hopper kernel: TMA loads of K/V tiles into a two-stage ring behind
mbarriers, both products on ``wgmma`` (``bf16(p) V`` with p from
registers), 128-row q tiles and any number of heads.  Larger
``d % 128 == 0`` take an ``mma.sync`` kernel that stages Q and K 128
columns of d at a time; one C entry point picks by d, and either is one
launch of ``flash_update``.  Together they are the counterpart of both
the resident ``_build`` and the streaming ``_build_streaming`` TPU
kernels.  The kernel allocates new outputs; the inputs are left as they
were.

Not carried over: ``pick_blocks``, ``resident_fits``, ``use_streaming``
and the ``DR_TPU_FLASH_BQ``/``_BK``/``DR_TPU_FLASH_STREAM`` knobs, which
are TPU VMEM tiling rules; the kernel picks its own tiles.  The shape
rule the JAX package's kernel path accepts stays: ``d % 128 == 0`` and
``skv % 128 == 0`` (:func:`kernel_shape_ok`).
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["flash_update", "plain_flash_update", "kernel_shape_ok",
           "causal_computed_flops", "tiles", "BLOCK_Q", "BLOCK_K"]

#: the kernel's q-row and key tiles at d = 128 (csrc/flash_attention.cu
#: HBQ and Tiles<128>::BK)
BLOCK_Q = 128
BLOCK_K = 128
_NEG_INF = float("-inf")


def kernel_shape_ok(d: int, skv: int) -> bool:
    """The kernel path's shape rule (the JAX package's ``pick_blocks``
    gate): lane-aligned head dim and K/V length."""
    return d % 128 == 0 and skv % 128 == 0


def tiles(d: int) -> tuple:
    """The kernel's ``(q rows, keys)`` tile at head dim ``d``: the wgmma
    kernel's 128 x 128 at d = 128 and 128 x 64 at d = 256, the mma.sync
    kernel's 64 x 64 above."""
    if d == 128:
        return BLOCK_Q, BLOCK_K
    return (128, 64) if d == 256 else (64, 64)


def causal_computed_flops(s: int, skv: int, d: int, bq: int, bk: int,
                          q_off: int = 0, k_off: int = 0) -> int:
    """EXACT matmul flops a block-skipping kernel with ``(bq, bk)`` tiles
    executes for one causal update of a ``s``-long q shard against a
    ``skv``-long K/V block, per (B*h) slice: a (bq, bk) cell runs fully
    when any of its rows can attend (skip rule ``k_lo <= q_lo + bq - 1``).
    Copied from the JAX package."""
    nk = skv // bk
    cells = 0
    for iq in range(s // bq):
        q_hi = q_off + iq * bq + bq - 1     # last q row of the tile
        if q_hi < k_off:
            continue
        cells += min(nk, (q_hi - k_off) // bk + 1)
    return cells * 2 * 2 * bq * bk * d      # two matmuls per cell


def _check(q, k, v, m, l, acc):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be (BH, s, d) and k/v (BHkv, skv, d)")
    BH, s, d = q.shape
    if v.shape != k.shape:
        raise ValueError("k and v must share (heads, skv, d)")
    if k.shape[2] != d or k.shape[0] == 0 or BH % k.shape[0]:
        raise ValueError("q heads must be a multiple of the kv heads, "
                         "with one head dim")
    if m.shape != (BH, s, 1) or l.shape != (BH, s, 1) \
            or acc.shape != (BH, s, d):
        raise ValueError("m/l must be (BH, s, 1) and acc (BH, s, d)")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or \
            any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise ValueError("flash_update takes bf16 q/k/v and an f32 "
                         "(m, l, acc) state")
    return BH, s, d, k.shape[1], BH // k.shape[0]


def plain_flash_update(q, k, v, m, l, acc, q_off: int, k_off: int, *,
                       causal: bool, block_k: int | None = None):
    """Plain PyTorch version of :func:`flash_update`: the JAX package's
    ``_block_update`` over ``block_k``-key tiles (by default the kernel's,
    :func:`tiles`), with the
    bf16 inputs upcast (exactly) to f32 for f32 matmuls, ``p`` rounded to
    bf16 for the PV product, and the tiles wholly in the future of every
    q row skipped (a fully masked tile leaves the state unchanged)."""
    BH, s, d, skv, group = _check(q, k, v, m, l, acc)
    BHkv = BH // group
    block_k = block_k or tiles(d)[1]
    scale = 1.0 / (d ** 0.5)
    # q head b reads kv head b // group: fold the group into the rows
    qf = q.float().reshape(BHkv, group * s, d)
    kf, vf = k.float(), v.float()
    nk = -(-skv // block_k)
    hi = nk
    if causal:
        hi = min(nk, max(0, (q_off + s - 1 - k_off) // block_k + 1))
    qpos = q_off + torch.arange(s, device=q.device)
    for ik in range(hi):
        lo = ik * block_k
        kb, vb = kf[:, lo:lo + block_k], vf[:, lo:lo + block_k]
        logits = (torch.matmul(qf, kb.transpose(1, 2)) * scale).reshape(
            BH, s, -1)
        if causal:
            kpos = k_off + lo + torch.arange(kb.shape[1], device=q.device)
            logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                        _NEG_INF)
        blk_max = logits.amax(-1, keepdim=True)
        new_m = torch.maximum(m, blk_max)
        # new_m = -inf only when every k so far is masked; exp(x - safe_m)
        # then sees x = -inf and yields 0 rows on its own
        safe_m = torch.where(new_m > _NEG_INF, new_m, 0.0)
        p = torch.exp(logits - safe_m)              # masked -> 0
        corr = torch.exp(m - safe_m)                # m = -inf -> 0
        pv = torch.matmul(
            p.to(torch.bfloat16).float().reshape(BHkv, group * s, -1),
            vb).reshape(BH, s, d)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv
        m = new_m
    return m, l, acc


def _kernel_flash_update(q, k, v, m, l, acc, q_off, k_off, causal):
    BH, s, d, skv, group = _check(q, k, v, m, l, acc)
    if not kernel_shape_ok(d, skv):
        raise ValueError(f"the K9 kernel takes d % 128 == 0 and "
                         f"skv % 128 == 0, not d={d}, skv={skv}")
    ts = (q, k, v, m, l, acc)
    dev = q.device
    if any(t.device != dev or not t.is_contiguous() or t.data_ptr() % 16
           for t in ts):
        raise ValueError("K9 operands must be contiguous, 16-byte aligned "
                         "and on one device")
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    acc_out = torch.empty_like(acc)
    kernels.launch("flash_update", "dr_flash_update", dev,
                   *(t.data_ptr() for t in ts), m_out.data_ptr(),
                   l_out.data_ptr(), acc_out.data_ptr(), BH, s, skv, d,
                   group, int(q_off), int(k_off), int(bool(causal)),
                   kernels.stream_of(q))
    return m_out, l_out, acc_out


def flash_update(q, k, v, m, l, acc, q_off: int, k_off: int, *,
                 causal: bool):
    """One ring step's flash update; returns the new ``(m, l, acc)``."""
    if kernels.on_cuda(q, k, v, m, l, acc):
        return _kernel_flash_update(q, k, v, m, l, acc, q_off, k_off,
                                    causal)
    return plain_flash_update(q, k, v, m, l, acc, q_off, k_off,
                              causal=causal)
