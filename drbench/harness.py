"""The benchmark's general machinery, driven by ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Everything else is
found by name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  sizes, with ``kind`` naming the family;
- ``traffic/<traffic>.json``: the inputs it reads, one call's ops and
  their parameters, the calls traced, the check's sample, the control's
  precision and the limits;
- ``families/<kind>.py``: makes the inputs from the seed
  (``make_inputs``) and the program's state over them (``build``);
- ``ops/<kind>/<op>.py``: one op's part of a user call (``run``) and
  what the check reads of it (``outputs``, where it has any);
- ``reference/<kind>.py`` and ``reference/<kind>/<op>.py``: the plain
  version of the state and of each op (``expect``), the control's
  outputs (``outputs``) and the comparison (``check``); an op's file
  leaves out what it has no part in;
- ``metrics/<metric>.py``: ``read(ctx)`` returns the metric, or None
  when the run has nothing for it to read.

One run: set-up (inputs, containers, one warm call of the cell's own
shapes), a closed-loop window of ``seconds`` (one caller, each call
started when the last has ended, timed on the device by CUDA events),
with ``trace`` a few profiled calls after it, then the check once the
program's state is freed.
"""

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no run may hold (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "dr_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), compared whole: ``dr_tpu_torch`` is not
    ``dr_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_module(path, tag):
    """Import one file of the benchmark by its path."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"drbench: no {path}")
    name = "drbench_" + tag + "_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root=ROOT):
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def cell(man, name):
    """The cell entry and its configuration entry."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"drbench: no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(cells)})")
    w = cells[name]
    cfg = next(c for c in man["configs"] if c["name"] == w["config"])
    return w, cfg


def load_json(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def config(root, cfg_entry):
    return load_json(Path(root) / cfg_entry["file"])


def traffic(root, name):
    return load_json(Path(root) / "drbench" / "traffic" / f"{name}.json")


def family(root, kind):
    return load_module(Path(root) / "drbench" / "families" / f"{kind}.py",
                       "family")


def op_modules(root, kind, traffic):
    """The program's module of each of the traffic's ops, in order."""
    mods = {name: load_module(Path(root) / "drbench" / "ops" / kind
                              / f"{name}.py", "op")
            for name in {op["op"] for op in traffic["ops"]}}
    return [mods[op["op"]] for op in traffic["ops"]]


def reference(root, kind, traffic):
    """The family's reference module and each op's, in order."""
    base = Path(root) / "drbench" / "reference"
    mods = {name: load_module(base / kind / f"{name}.py", "refop")
            for name in {op["op"] for op in traffic["ops"]}}
    return (load_module(base / f"{kind}.py", "reference"),
            [mods[op["op"]] for op in traffic["ops"]])


def reader(root, metric):
    return load_module(Path(root) / "drbench" / "metrics" / f"{metric}.py",
                       "metric").read


def metrics_of(man, cell_name, traced):
    """The metric entries a run of the cell reports: with ``traced`` the
    per-layer ones, else the end-to-end ones.  An entry without
    ``workloads`` applies wherever its end-to-end metric does."""
    e2e = [m for m in man["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in names]


@contextlib.contextmanager
def _no_span(name):
    yield


@contextlib.contextmanager
def _span(name):
    """A profiler annotation ``drbench.<op>`` around one op of a traced
    call; the op runs as in the window, with no fence added."""
    from torch.profiler import record_function
    with record_function("drbench." + name):
        yield


def port_kernels():
    """``__global__`` name -> the port's launch counter."""
    from dr_tpu_torch.ops import kernels
    from drbench.trace import global_kernels
    return global_kernels({c: (kernels.CSRC / src).read_text()
                           for c, src in kernels.SOURCES.items()})


def import_port(root):
    """The port, from this checkout and nowhere else."""
    import dr_tpu_torch
    where = Path(dr_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise ImportError(f"drbench: dr_tpu_torch came from {where}, "
                          f"not from the checkout {root}")
    return dr_tpu_torch


def quantile(values, q):
    """The ``q`` quantile (0 < q < 1) of ``values`` by
    ``statistics.quantiles``; a single value is its own."""
    if len(values) == 1:
        return values[0]
    cuts = statistics.quantiles(values, n=100)
    return cuts[round(q * 100) - 1]


def call_sample(seed, calls, size):
    """The calls whose op outputs the check reads one by one: ``size``
    drawn from the seed, and the last."""
    rng = random.Random(seed)
    return sorted(set(rng.sample(range(calls), min(size, calls))
                      + [calls - 1]))


def run(cell_name, seed, seconds, trace, t_start, *, device=None,
        control=False, config_override=None, root=ROOT, log=sys.stderr):
    """One run of one cell; returns the result object."""
    import torch
    man = manifest(root)
    w, cfg_entry = cell(man, cell_name)
    cfg = dict(config(root, cfg_entry), **(config_override or {}))
    tr = traffic(root, w["traffic"])
    if tr["family"] != cfg["kind"]:
        raise ValueError(f"drbench: traffic {w['traffic']!r} is for "
                         f"{tr['family']!r}, the configuration is "
                         f"{cfg['kind']!r}")
    fam = family(root, cfg["kind"])
    ops = op_modules(root, cfg["kind"], tr)
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("drbench: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < w["chips"]:
            raise NoDevice(f"drbench: {w['chips']} card(s) asked for, "
                           f"{torch.cuda.device_count()} visible")
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    dt = import_port(root)
    dt.init([device] * cfg.get("ranks", 1))
    from dr_tpu_torch.ops import kernels
    fence = dt.fence

    prog = fam.build(dt, cfg, tr, fam.make_inputs(cfg, tr, seed, dev))
    gc.collect()

    def call(span):
        did = {}
        for op, mod in zip(tr["ops"], ops):
            with span(op["op"]):
                for k, v in mod.run(prog, op).items():
                    did[k] = did.get(k, 0) + v
        return did

    call(_no_span)  # the warm call: the cell's own shapes
    fence()
    setup_s = time.perf_counter() - t_start

    calls, work, times, events = 0, {}, [], []
    total_calls = 1
    t_w = time.perf_counter()
    while True:
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        did = call(_no_span)
        if on_card:
            e1.record()
            events.append((e0, e1))
        fence()
        times.append((time.perf_counter() - t0) * 1e3)
        calls += 1
        total_calls += 1
        for k, v in did.items():
            work[k] = work.get(k, 0) + v
        if time.perf_counter() - t_w >= seconds:
            break
    window_s = time.perf_counter() - t_w
    call_ms = [a.elapsed_time(b) for a, b in events] if on_card else times

    view, launches = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from drbench.trace import TraceView
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        kernels.reset_counts()
        tmp = tempfile.mkdtemp(prefix="drbench-trace-")
        try:
            with profile(activities=acts) as prof:
                for _ in range(tr["trace_calls"]):
                    call(_span)
                    total_calls += 1
                fence()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            view = TraceView.load(path, port_kernels())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        launches = dict(kernels.launches)

    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    out = {"family": prog.outputs(),
           "ops": [_call(mod, "outputs", {}, prog, op)
                   for op, mod in zip(tr["ops"], ops)]}
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sample = call_sample(seed, total_calls, tr.get("check_sample", 0))
    checks = judge(root, cfg, tr, fam.make_inputs(cfg, tr, seed, dev), out,
                   total_calls, sample)
    del out
    correct = all(v <= lim for _, v, lim in checks)

    # what a metric reader may read
    ctx = SimpleNamespace(
        config=cfg, traffic=tr, setup_s=setup_s, window_s=window_s,
        call_ms=call_ms, work=work, trace=view,
        traced_calls=tr.get("trace_calls", 0))
    metrics = {}
    for m in metrics_of(man, cell_name, trace):
        v = reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": w["chips"] if on_card else 1,
        "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": calls, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and view is not None:
        device_info["busy_s"] = view.busy_us / 1e6
        device_info["window_s"] = view.window_us / 1e6
        result["breakdown"] = {
            "device_ops": [[k, t / 1e6] for k, t, _ in view.top_ops(10)],
            "idle_gaps": [[k, g / 1e6] for k, g in view.longest_gaps(10)]}
    if launches is not None:
        print(f"drbench: launches over {tr['trace_calls']} traced calls: "
              f"{json.dumps({k: v for k, v in launches.items() if v})}",
              file=log)
    for name, v, lim in checks:
        print(f"drbench check {name}: {v!r} (limit {lim!r})", file=log)
    if control:
        # the control after as many calls, for control.py alone
        cout = control_outputs(root, cfg, tr,
                               fam.make_inputs(cfg, tr, seed, dev),
                               total_calls, sample)
        result["control_checks"] = {
            name: {"value": v, "limit": lim} for name, v, lim in judge(
                root, cfg, tr, fam.make_inputs(cfg, tr, seed, dev), cout,
                total_calls, sample)}
        del cout
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def replay(root, cfg, tr, inputs, calls, control):
    """The reference's state after ``calls`` calls (one, where a call
    reads only the inputs), and each op's reference module."""
    rfam, rops = reference(root, cfg["kind"], tr)
    state = rfam.start(cfg, tr, inputs, control)
    state.calls = calls
    for _ in range(calls if rfam.REPLAY == "calls" else 1):
        for op, rop in zip(tr["ops"], rops):
            _call(rop, "expect", None, state, op)
    return rfam, rops, state


def judge(root, cfg, tr, inputs, got, calls, sample):
    """The reference's numbers ``[(name, value, limit)]`` for the outputs
    ``got``, each made a finite float (a NaN or an infinity reads as the
    largest float)."""
    rfam, rops, state = replay(root, cfg, tr, inputs, calls, False)
    limits = tr["limits"]
    res = rfam.check(state, got["family"], limits, sample)
    for op, rop, g in zip(tr["ops"], rops, got["ops"]):
        res += _call(rop, "check", [], state, op, g, limits, sample)
    return [(name, v if math.isfinite(v) else sys.float_info.max, lim)
            for name, v, lim in res]


def control_outputs(root, cfg, tr, inputs, calls, sample):
    """The control's outputs, shaped as the program's: the reference in
    the program's place at the traffic's ``control_precision``."""
    rfam, rops, state = replay(root, cfg, tr, inputs, calls, True)
    return {"family": rfam.outputs(state),
            "ops": [_call(rop, "outputs", {}, state, op, sample)
                    for op, rop in zip(tr["ops"], rops)]}


def _call(mod, name, default, *args):
    """``mod.<name>(*args)``, or ``default`` where the op's file has no
    such function (an op with nothing to keep, replay or compare)."""
    fn = getattr(mod, name, None)
    return default if fn is None else fn(*args)
