"""Sequence-parallel ring attention over the ranks' ring
(``examples/ring_attention_example.py`` on ``dr_tpu_torch``).

Q/K/V shard over the sequence axis, K/V blocks rotate around the ring
of ranks, and an online softmax merges blocks: O(block) memory for any
total sequence length.  Validated against dense attention in float64.
The inputs are f32, so the ring takes the blockwise route; the flash
kernel (K9) takes bf16 with head dimensions that are multiples of 128.

Run: python -m dr_tpu_torch.examples.ring_attention_example [--seq 512]
[--heads 4]
"""

import argparse
import sys

import numpy as np

from dr_tpu_torch.examples import device_args, init


def dense_reference(q, k, v, causal):
    B, S, h, d = q.shape
    qt = np.moveaxis(q, 2, 1).astype(np.float64)   # (B,h,S,d)
    kt = np.moveaxis(k, 2, 1).astype(np.float64)
    vt = np.moveaxis(v, 2, 1).astype(np.float64)
    logits = qt @ np.swapaxes(kt, -1, -2) / np.sqrt(d)
    if causal:
        mask = np.tril(np.ones((S, S), bool))
        logits = np.where(mask, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.moveaxis(p @ vt, 1, 2)               # (B,S,h,d)


def main(argv=None) -> int:
    ap = device_args(argparse.ArgumentParser())
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--causal", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args(argv)

    import dr_tpu_torch as dt

    init(args)
    P = dt.nprocs()
    S = args.seq // P * P
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(
        (1, S, args.heads, args.head_dim)).astype(np.float32)
        for _ in range(3))

    out = dt.to_numpy(dt.ring_attention(q, k, v, causal=args.causal))
    ref = dense_reference(q, k, v, args.causal)
    err = np.abs(out - ref).max()
    print(f"ring attention over {P} shard(s), seq={S}: "
          f"max |err| vs dense reference = {err:.2e}")
    if not err < 1e-3:
        print("mismatch vs dense reference")
        return 1

    # grouped-query attention: fewer shared K/V heads (h % hkv == 0);
    # the ring carries only the hkv heads
    if args.heads % 2 == 0:
        hkv = args.heads // 2
        kg, vg = k[:, :, :hkv], v[:, :, :hkv]
        gqa = dt.to_numpy(dt.ring_attention(q, kg, vg, causal=args.causal))
        ref_g = dense_reference(q, np.repeat(kg, 2, axis=2),
                                np.repeat(vg, 2, axis=2), args.causal)
        err_g = np.abs(gqa - ref_g).max()
        print(f"grouped-query (hkv={hkv}): max |err| = {err_g:.2e}")
        if not err_g < 1e-3:
            print("GQA mismatch vs dense reference")
            return 1
    print("PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
