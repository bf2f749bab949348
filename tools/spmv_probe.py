#!/usr/bin/env python3
"""Time the steps of the port's ELL SpMV and SpMM (``gemv`` / ``spmm``
in ``dr_tpu_torch/algorithms/gemv.py``) on one CUDA card at
``chip_smoke.py`` phase 18's shape (bench.py's config 5 pattern: 2^22
rows, 32 random columns a row), beside other torch formulations of the
same steps and one cuSPARSE call, and check each formulation against
the port's result.

Each line: a step or formulation, its milliseconds a call (CUDA events,
mean of back-to-back calls after a warm-up) and, where one is given,
the largest |difference| from the port's current formulation.  The
card's name and power limit are printed first.

Run from the repository root:  ``python3 tools/spmv_probe.py [--log2 N]``.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def events_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2", type=int, default=22)
    ap.add_argument("--nv", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spmv_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    import importlib
    import dr_tpu_torch as dt
    tg = importlib.import_module("dr_tpu_torch.algorithms.gemv")
    dt.init(["cuda:0"])
    dev = torch.device("cuda", 0)
    m, k, nv = 1 << args.log2, 32, args.nv
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = rng.integers(0, m, size=m * k)
    vals = rng.standard_normal(m * k).astype(np.float32)
    A = dt.sparse_matrix.from_coo((m, m), rows, cols, vals)
    assert A.ensure_ell()
    V, C = A._ell_vals[0], A._ell_cols[0]
    C64 = C.to(torch.int64)
    b = torch.randn(m, device=dev)
    B = torch.randn((m, nv), device=dev)
    out = {}

    def t(name, fn, ref=None, reps=10):
        ms = events_ms(fn, reps)
        rec = {"ms": ms}
        if ref is not None:
            rec["max_abs_diff"] = float((fn() - ref).abs().max())
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)

    ref = tg._ell_local(V, C, b)
    t("gemv: port (index_select, mul, sum)", lambda: tg._ell_local(V, C, b),
      ref)
    g = torch.index_select(b, 0, C.reshape(-1)).view(C.shape)
    t("gemv step: index_select int32", lambda: torch.index_select(
        b, 0, C.reshape(-1)))
    t("gemv step: index_select int64", lambda: torch.index_select(
        b, 0, C64.reshape(-1)))
    t("gemv step: take int64", lambda: torch.take(b, C64))
    t("gemv step: b[cols int32]", lambda: b[C])
    t("gemv step: mul", lambda: V * g)
    p = V * g
    t("gemv step: sum(1)", lambda: p.sum(1))
    t("gemv: take + linalg.vecdot", lambda: torch.linalg.vecdot(
        V, torch.take(b, C64)), ref)
    t("gemv: take + bmm", lambda: torch.bmm(
        V.unsqueeze(1), torch.take(b, C64).unsqueeze(2)).view(-1), ref)
    del g, p

    ref = tg._ell_local(V, C, B)
    t("spmm: port (index_select, mul, sum)", lambda: tg._ell_local(V, C, B),
      ref, reps=3)
    G = torch.index_select(B, 0, C.reshape(-1)).view(C.shape + (nv,))
    t("spmm step: index_select int32 (rows of nv)", lambda: torch.
      index_select(B, 0, C.reshape(-1)), reps=3)
    t("spmm step: index_select int64", lambda: torch.index_select(
        B, 0, C64.reshape(-1)), reps=3)
    t("spmm step: B[cols int64]", lambda: B[C64], reps=3)
    t("spmm step: mul", lambda: G * V.unsqueeze(-1), reps=3)
    P = G * V.unsqueeze(-1)
    t("spmm step: sum(1)", lambda: P.sum(1), reps=3)
    del P
    t("spmm: bmm (th,1,k)@(th,k,nv)", lambda: torch.bmm(
        V.unsqueeze(1), G).squeeze(1), ref, reps=3)
    t("spmm: index_select + bmm", lambda: torch.bmm(
        V.unsqueeze(1), torch.index_select(B, 0, C.reshape(-1)).view(
            C.shape + (nv,))).squeeze(1), ref, reps=3)
    Bt = B.t().contiguous()

    def per_column():
        return torch.stack([tg._ell_local(V, C, Bt[j]) for j in range(nv)],
                           1)
    t("spmm: one gemv a column", per_column, ref, reps=3)

    def over_k():
        y = torch.zeros((m, nv), device=dev)
        for j in range(k):
            y = y + V[:, j:j + 1] * torch.index_select(B, 0, C[:, j])
        return y
    t("spmm: accumulate over the 32 slots", over_k, ref, reps=3)
    del G

    def chunked(x, rows_per):
        ys = []
        for r0 in range(0, m, rows_per):
            cc, vv = C[r0:r0 + rows_per], V[r0:r0 + rows_per]
            g = torch.index_select(x, 0, cc.reshape(-1)).view(
                cc.shape + x.shape[1:])
            ys.append((g * vv.view(vv.shape + (1,) * (x.dim() - 1))).sum(1))
        return torch.cat(ys)
    for lg in (12, 15, 17, 19):
        t(f"spmm: index_select, mul, sum in chunks of 2^{lg} rows",
          lambda lg=lg: chunked(B, 1 << lg), ref, reps=3)
    t("spmm: gather with an expanded int64 index", lambda: (torch.gather(
        B, 0, C64.reshape(-1, 1).expand(-1, nv)).view(C.shape + (nv,))
        * V.unsqueeze(-1)).sum(1), ref, reps=3)
    ref1 = tg._ell_local(V, C, b)
    for lg in (15, 17, 19):
        t(f"gemv: index_select, mul, sum in chunks of 2^{lg} rows",
          lambda lg=lg: chunked(b, 1 << lg), ref1)
    g = torch.index_select(b, 0, C.reshape(-1)).view(C.shape)
    ones = torch.ones(k, device=dev)
    t("gemv step: (V * g) @ ones (cuBLAS)", lambda: (V * g) @ ones)
    del g
    key = torch.from_numpy(rows * m + cols).to(dev)
    order = torch.sort(key).indices
    csr = torch.sparse_csr_tensor(
        torch.arange(0, m * k + 1, k, dtype=torch.int32, device=dev),
        (key[order] % m).to(torch.int32), torch.from_numpy(vals).to(dev)[
            order], size=(m, m))
    del key, order
    t("cuSPARSE gemv (csr @ b)", lambda: csr @ b)
    t("cuSPARSE spmm (csr @ B)", lambda: csr @ B, reps=3)
    print(json.dumps({"card": card, "m": m, "k": k, "nv": nv, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
