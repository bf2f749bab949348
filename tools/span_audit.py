"""The port's spans on the card, one benchmark cell at a time.

    python3 tools/span_audit.py --workload <cell> --seed <n>

Builds the cell as ``drbench/run.py`` does (inputs, containers, one warm
call), then:

1. profiles the traffic's traced calls, each op inside its
   ``drbench.<op>`` range as the benchmark's traced run has it, and reads
   the six span metrics (``drbench/metrics_spans.py``), the traced
   call's milliseconds and the idle share; puts each of the ``--gaps``
   longest idle gaps down to the ``sync.*`` range it begins in, else the
   port range it overlaps most, else the host work it overlaps most; and
   sums the whole idle time by those labels (gaps under 20 us apart),
   each with the host work that overlaps its gaps most;
2. runs one more call with the obs ring armed under
   ``torch.cuda.set_sync_debug_mode("warn")`` and lists every
   synchronising call torch warns about, with the port's span stack at
   that moment and whether a ``sync.*`` span holds it.

Prints one JSON line.  ``--device cpu --override '{"n": 16384}'``
rehearses the control flow on the CPU at a size it holds (no device
events, no sync warnings there).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
NEW = ["sync_idle_ms.stencil", "sync_idle_ms.tpch", "rowcopy_ms.stencil",
       "exchange_ms.stencil", "join_sort_ms.q3", "join_merge_ms.q3",
       "join_ms.q3", "groupby_ms.q3", "copy_ms.stencil", "idle_pct.stencil",
       "idle_pct.tpch"]


def _overlap(e, a, b):
    s = float(e["ts"])
    return min(s + float(e["dur"]), b) - max(s, a)


def _label(view, port, gap):
    """What a gap ``(length, start, end)`` is put down to: the innermost
    ``sync.*`` range holding its start, else the port range overlapping
    it most, else the host work overlapping it most."""
    _, a, b = gap
    holding = [s for s in port if float(s["ts"]) <= a
               <= float(s["ts"]) + float(s["dur"])]
    syncs = [s for s in holding if s["name"].startswith("sync.")]
    if syncs:
        return "begins in " + min(syncs, key=lambda s: s["dur"])["name"]
    over = [(_overlap(s, a, b), -float(s["dur"]), s["name"]) for s in port]
    over = [o for o in over if o[0] > 0]
    if over:
        return "overlaps " + max(over)[2]
    host = [(_overlap(h, a, b), f"{h['cat']}:{h['name'][:50]}")
            for h in view.host if not h["name"].startswith("drbench.")]
    host = [h for h in host if h[0] > 0]
    return "host " + (max(host)[1] if host else "nothing")


def _host_under(view, gap, top=3):
    """The host ops and runtime calls overlapping a gap most."""
    _, a, b = gap
    over = {}
    for h in view.host:
        if h["cat"] == "user_annotation":
            continue
        ov = _overlap(h, a, b)
        if ov > 0:
            k = f"{h['cat']}:{h['name'][:50]}"
            over[k] = over.get(k, 0.0) + ov
    return [[k, round(v, 1)] for k, v in
            sorted(over.items(), key=lambda kv: -kv[1])[:top]]


def _stack_of(port, t):
    """The port ranges holding time ``t``, outermost first."""
    return [s["name"] for s in sorted(
        (s for s in port if float(s["ts"]) <= t
         <= float(s["ts"]) + float(s["dur"])), key=lambda s: -s["dur"])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--gaps", type=int, default=5)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--override", default="{}",
                    help="JSON object of configuration keys to replace")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "drbench" / ".cache" / "triton"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drbench import harness, metrics_spans
    from drbench.trace import TraceView

    man = harness.manifest(ROOT)
    w, cfg_entry = harness.cell(man, args.workload)
    cfg = dict(harness.config(ROOT, cfg_entry), **json.loads(args.override))
    tr = harness.traffic(ROOT, w["traffic"])
    fam = harness.family(ROOT, cfg["kind"])
    ops = harness.op_modules(ROOT, cfg["kind"], tr)
    dt = harness.import_port(ROOT)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    dt.init([args.device] * cfg.get("ranks", 1))
    from dr_tpu_torch import obs
    from dr_tpu_torch.obs import recorder
    prog = fam.build(dt, cfg, tr, fam.make_inputs(cfg, tr, args.seed, dev))
    where = {"op": None}

    def call(span):
        for op, mod in zip(tr["ops"], ops):
            where["op"] = op["op"]
            with span(op["op"]):
                mod.run(prog, op)

    call(harness._no_span)
    dt.fence()

    # 1. the traced calls
    tmp = tempfile.mkdtemp(prefix="span-audit-")
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof:
            for _ in range(tr["trace_calls"]):
                call(harness._span)
            dt.fence()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        view = TraceView.load(path, harness.port_kernels())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    calls = tr["trace_calls"]
    ctx = SimpleNamespace(config=cfg, traffic=tr, trace=view,
                          traced_calls=calls)
    metrics = {}
    for m in NEW:
        f = ROOT / "drbench" / "metrics" / f"{m}.py"
        try:
            metrics[m] = harness.load_module(f, "metric").read(ctx)
        except ValueError as e:
            metrics[m] = f"error: {e}"
    port = [s for s in view.host if s["cat"] == "user_annotation"
            and s["name"].startswith(metrics_spans.PORT)]
    gaps = []
    for g in sorted(view.gaps, reverse=True)[:args.gaps]:
        gaps.append({"us": g[0], "at_us": g[1] - view.t0,
                     "label": _label(view, port, g),
                     "ranges": _stack_of(port, g[1]),
                     "host": _host_under(view, g)})
    by, host_by = {}, {}
    for g in view.gaps:
        # gaps under 20 us (launch latency) are not labelled one by one
        k = _label(view, port, g) if g[0] >= 20 else "gaps under 20 us"
        by[k] = by.get(k, 0.0) + g[0]
        if g[0] >= 20:
            under = host_by.setdefault(k, {})
            for h, us in _host_under(view, g):
                under[h] = under.get(h, 0.0) + us
    idle_by = [[k, v / calls / 1e3, [
        [h, round(us / calls / 1e3, 4)] for h, us in sorted(
            host_by.get(k, {}).items(), key=lambda kv: -kv[1])[:3]]]
        for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:12]]

    # 2. one call under the sync debug mode, with the ring armed for the
    # span stack
    hits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "debug mode is a prototype" in str(message):
            return
        stack = [sp.name for _, sp in recorder._stack()]
        frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                  for f in traceback.extract_stack()[:-1]
                  if "warnings" not in f.filename][-6:]
        hits.append({"op": where["op"], "msg": str(message)[:100],
                     "at": f"{Path(filename).name}:{lineno}",
                     "spans": stack,
                     "in_sync": any(n.startswith("sync.") for n in stack),
                     "stack": frames})

    obs.arm(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                call(harness._no_span)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        dt.fence()
    finally:
        obs.arm(False)
        obs.reset()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "traced_call_ms": view.window_us / calls / 1e3,
        "idle_pct": 100.0 * view.idle_share() if view.dev else None,
        "metrics": metrics,
        "longest_gaps": gaps, "idle_ms_by_label": idle_by,
        "port_ranges": sorted({s["name"] for s in port}),
        "syncs": hits,
        "syncs_outside": [h for h in hits if not h["in_sync"]]}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"span_audit: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
