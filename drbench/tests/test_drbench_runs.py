"""Whole runs of every cell on the CPU at a tiny size, against the
plain reference: sound runs come out correct; the control and the
faults a cell can have come out not correct."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from drbench.tests.conftest import TINY

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
STENCIL = [c for c in CELLS if c.startswith("stencil1d-1g.")]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(run_cpu, cell, trace):
    r = run_cpu(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    if not trace:
        want = {m["name"] for m in MAN["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_cpu, cell):
    r = run_cpu(cell, control=True)
    assert r["correct"], r["checks"]
    assert any(v["value"] > v["limit"]
               for v in r["control_checks"].values()), r["control_checks"]


def _fault(monkeypatch, cell, fault):
    """Break the timed path underneath the harness."""
    import dr_tpu_torch as dt
    from dr_tpu_torch.algorithms import stencil
    if fault == "state_unchanged":
        for name in ("stencil_iterate_matmul", "stencil_iterate_blocked",
                     "stencil_iterate"):
            monkeypatch.setattr(dt, name, lambda a, *x, **k: a)
    elif fault == "exchange_left_out":
        monkeypatch.setattr(stencil, "_ring_exchange_full",
                            lambda *a, **k: None)
        monkeypatch.setattr(stencil, "exchange_rows", lambda *a, **k: None)
    elif fault == "dot_altered":
        real = dt.dot
        monkeypatch.setattr(dt, "dot", lambda a, b: real(a, b) * 1.001)
    elif fault == "scan_altered":
        real = dt.inclusive_scan

        def scan(a, out):
            real(a, out)
            row = out._rows[0]
            row[0, row.shape[-1] // 2] += 1.0
        monkeypatch.setattr(dt, "inclusive_scan", scan)
    elif fault == "join_row_altered":
        real = dt.join

        def join(lk, lv, rk, rv, ok, ol, orr, **kw):
            m = real(lk, lv, rk, rv, ok, ol, orr, **kw)
            ol._rows[0][0, m // 2] += 1
            return m
        monkeypatch.setattr(dt, "join", join)
    elif fault == "half_the_rows":
        real = dt.join

        def join(lk, lv, rk, rv, ok, ol, orr, **kw):
            h = len(lk) // 2
            return real(lk[0:h], lv[0:h], rk, rv, ok, ol, orr, **kw)
        monkeypatch.setattr(dt, "join", join)
    elif fault == "sum_altered":
        real = dt.groupby_aggregate

        def groupby(k, v, ok, ov, agg):
            g = real(k, v, ok, ov, agg=agg)
            if agg == "sum":
                ov._rows[0][0, g // 3] *= 1.01
            return g
        monkeypatch.setattr(dt, "groupby_aggregate", groupby)
    elif fault == "top_altered":
        real = dt.top_k

        def top_k(r, out_vals, out_idx=None, **kw):
            real(r, out_vals, out_idx, **kw)
            out_vals._rows[0][0, 3] *= 0.999
            return out_vals
        monkeypatch.setattr(dt, "top_k", top_k)
    else:
        raise ValueError(fault)


FAULTS = ([(c, f) for c in STENCIL
           for f in ("state_unchanged", "exchange_left_out", "dot_altered")]
          + [(c, "scan_altered") for c in STENCIL
             if c.endswith((".composed", ".blocked"))]
          + [("tpch-sf30.q3", f) for f in ("join_row_altered",
                                           "half_the_rows", "sum_altered",
                                           "top_altered")])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(run_cpu, monkeypatch, cell,
                                            fault):
    _fault(monkeypatch, cell, fault)
    r = run_cpu(cell)
    assert not r["correct"], r["checks"]


def _run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "drbench/run.py", "--workload", CELLS[0], "--seed",
         "3000000000", "--seconds", "1", "--trace", "0", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=600)


def test_run_without_a_card_fails():
    p = _run_py(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_run_without_the_port_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "drbench", tmp_path / "drbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run_py(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _copy(tmp_path):
    """BENCHMARK.json, the benchmark and the port in ``tmp_path``; returns
    the copy's manifest."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    ignore = shutil.ignore_patterns("__pycache__", ".cache", "_build")
    for d in ("drbench", "dr_tpu_torch"):
        shutil.copytree(ROOT / d, tmp_path / d, ignore=ignore)
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def _in_copy(tmp_path, code):
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    return p


def test_a_module_loaded_after_the_window_fails_the_run(tmp_path):
    """A metric reader that loads a stand-in ``dr_tpu`` (read after the
    window, as every reader is) leaves the run with no result and a
    non-zero exit."""
    man = _copy(tmp_path)
    (tmp_path / "dr_tpu").mkdir()
    (tmp_path / "dr_tpu" / "__init__.py").write_text("")
    (tmp_path / "drbench" / "metrics" / "leak.py").write_text(
        "def read(ctx):\n    import dr_tpu\n    return 1.0\n")
    cell = STENCIL[0]
    man["per_layer"].append({"name": "leak", "unit": "n", "better": "lower",
                             "source": "host_clock", "layer": "device",
                             "moves": "cell_updates_s",
                             "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import sys; sys.path.insert(0, '.');"
            "from drbench import run;"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '7',"
            "'--seconds', '0.2', '--trace', '1'], device='cpu',"
            f"config_override={TINY['stencil1d-1g']!r}))")
    p = _in_copy(tmp_path, code)
    assert p.returncode != 0, p.stdout[-2000:]
    assert p.stdout.strip() == ""
    assert "forbidden modules loaded: dr_tpu" in p.stderr


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric, and a mix with
    a column and an op of its own on a configuration that is there, each
    added as new files and manifest entries in a copy, make cells the
    harness runs."""
    man = _copy(tmp_path)
    b = tmp_path / "drbench"
    cfg = json.loads((b / "configs" / "stencil1d-1g.json").read_text())
    cfg.update(name="stencil1d-2k", n=2048)
    (b / "configs" / "stencil1d-2k.json").write_text(json.dumps(cfg))
    (b / "traffic" / "composed128.json").write_text(json.dumps({
        "family": "stencil1d", "halo": 256,
        "ops": [{"op": "stencil_iterate_matmul", "steps": 256,
                 "k_block": 128}, {"op": "dot"}],
        "trace_calls": 1, "check_sample": 4,
        "control_precision": {"stencil_iterate_matmul": "tf32",
                              "dot": "bf16"},
        "limits": {"field_drift": 1e-6, "dot_drift": 1e-6,
                   "last_dot_gap": 1e-5}}))
    (b / "metrics" / "dots_per_call.py").write_text(
        "def read(ctx):\n    spans = ctx.trace.spans('drbench.dot') if "
        "ctx.trace else []\n    return len(spans) / ctx.traced_calls\n")
    # a mix with a column and an op of its own (the port's reduce) on the
    # TPC-H configuration
    (b / "families" / "tpch").mkdir()
    (b / "families" / "tpch" / "l_tax.py").write_text(
        "def make(t):\n"
        "    return t.randint('l_tax', 0, 9, t.n_lines()).double()"
        ".div(100).float()\n")
    (b / "ops" / "tpch" / "total.py").write_text(
        "def run(prog, op):\n"
        "    prog.put(op['as'], prog.dt.reduce(prog.vector(op['of'])))\n"
        "    return {}\n\n\n"
        "def outputs(prog, op):\n"
        "    return {'total': float(prog.frame[op['as']][0])}\n")
    (b / "reference" / "tpch" / "total.py").write_text(
        "def expect(state, op):\n"
        "    state.frame[op['as']] = float(state.low(state.frame[op['of']])"
        ".double().sum())\n\n\n"
        "def outputs(state, op, sample):\n"
        "    return {'total': state.frame[op['as']]}\n\n\n"
        "def check(state, op, got, limits, sample):\n"
        "    want = state.frame[op['as']]\n"
        "    return [('total_gap', abs(got['total'] - want) / want,"
        " limits['total_gap'])]\n")
    (b / "traffic" / "taxes.json").write_text(json.dumps({
        "family": "tpch", "tables": {"lineitem": ["l_tax", "l_shipdate"]},
        "ops": [{"op": "select", "table": "lineitem",
                 "where": [["l_shipdate", ">", 1169]],
                 "keep": ["l_tax"], "as": "l", "work": "rows"},
                {"op": "total", "of": "l.l_tax", "as": "sum"}],
        "trace_calls": 1, "control_precision": "bf16",
        "limits": {"total_gap": 1e-5}}))
    man["configs"].append({"name": "stencil1d-2k", "source": "test",
                           "file": "drbench/configs/stencil1d-2k.json",
                           "reduced": [], "why": "test"})
    man["workloads"] += [
        {"name": "stencil1d-2k.composed128", "config": "stencil1d-2k",
         "traffic": "composed128", "chips": 1, "why": "test"},
        {"name": "tpch-sf30.taxes", "config": "tpch-sf30",
         "traffic": "taxes", "chips": 1, "why": "test"}]
    for m in man["end_to_end"]:
        if m["name"] == "cell_updates_s":
            m["workloads"].append("stencil1d-2k.composed128")
        if m["name"] == "rows_s":
            m["workloads"].append("tpch-sf30.taxes")
    man["per_layer"].append({"name": "dots_per_call", "unit": "n",
                             "better": "higher", "source": "host_clock",
                             "layer": "algorithms",
                             "moves": "cell_updates_s",
                             "workloads": ["stencil1d-2k.composed128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import sys, json, time; sys.path.insert(0, '.');"
            "from drbench import harness;"
            "r = [harness.run('stencil1d-2k.composed128', 5, 0.2, t, "
            "time.perf_counter(), device='cpu') for t in (0, 1)];"
            "r.append(harness.run('tpch-sf30.taxes', 5, 0.2, False, "
            "time.perf_counter(), device='cpu', control=True, "
            f"config_override={TINY['tpch-sf30']!r}));"
            "print(json.dumps(r))")
    p = _in_copy(tmp_path, code)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced, taxes = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"cell_updates_s", "call_ms_p90",
                                     "setup_s"}
    assert traced["metrics"]["dots_per_call"]["value"] == 1.0
    assert taxes["correct"], taxes["checks"]
    assert set(taxes["metrics"]) == {"rows_s", "call_ms_p90", "setup_s"}
    assert taxes["control_checks"]["total_gap"]["value"] > 1e-5


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """On a card: one short run of the first cell through run.py."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "drbench/run.py", "--workload", CELLS[0], "--seed",
         "3000000001", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
