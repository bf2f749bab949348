"""Whole runs of every cell on the CPU at a tiny size, against the
plain reference: sound runs come out correct; the control and the
faults a cell can have come out not correct.

What belongs to one configuration or family is found by name: its CPU
size in ``tiny/<config>.json`` (``conftest.TINY``), its planted faults
in ``faults/<kind>.py``.  A cell whose file is missing is left out of
the runs here, and one named test says which file to add.
"""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

from drbench import harness
from drbench.tests.conftest import TINY

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
STENCIL = [c for c in CELLS if c.startswith("stencil1d-1g.")]
FAULTS_DIR = ROOT / "drbench" / "tests" / "faults"


def _of(w):
    """A cell's configuration name, family and traffic mix."""
    cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
    kind = json.loads((ROOT / cfg["file"]).read_text())["kind"]
    return w["config"], kind, harness.traffic(ROOT, w["traffic"])


OF = {w["name"]: _of(w) for w in MAN["workloads"]}
#: the cells whose configuration has a CPU size
SIZED = [c for c in CELLS if OF[c][0] in TINY]
#: each family's faults module, None where it has none
PLANTS = {kind: (harness.load_module(FAULTS_DIR / f"{kind}.py", "faults")
                 if (FAULTS_DIR / f"{kind}.py").is_file() else None)
          for _, kind, _ in OF.values()}
FAULTS = [(c, f) for c in SIZED if PLANTS[OF[c][1]] is not None
          for f in PLANTS[OF[c][1]].faults(OF[c][2])]


def test_every_configuration_has_a_cpu_size():
    missing = [f"drbench/tests/tiny/{c['name']}.json" for c in MAN["configs"]
               if c["name"] not in TINY]
    assert not missing, ("no CPU size, so these configurations' cells do "
                         "not run here; add (the keys a run on the CPU "
                         f"overrides): {', '.join(missing)}")


def test_every_family_has_a_faults_module():
    missing = sorted(f"drbench/tests/faults/{kind}.py"
                     for kind, mod in PLANTS.items() if mod is None)
    assert not missing, ("no planted faults, so no test shows that these "
                         "families' checks can fail; add (faults(traffic), "
                         f"plant(monkeypatch, fault)): {', '.join(missing)}")


def test_every_cell_has_a_planted_fault():
    bare = [c for c in CELLS if PLANTS[OF[c][1]] is not None
            and not PLANTS[OF[c][1]].faults(OF[c][2])]
    assert not bare, ("a cell that no fault can break guards nothing; "
                      "name a fault for these cells' traffic in their "
                      f"family's faults module: {', '.join(bare)}")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", SIZED)
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


@pytest.mark.parametrize("cell", SIZED)
def test_control_is_not_correct(run_cpu, cell):
    r = run_cpu(cell, control=True)
    assert r["correct"], r["checks"]
    assert any(v["value"] > v["limit"]
               for v in r["control_checks"].values()), r["control_checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(run_cpu, monkeypatch, cell,
                                            fault):
    """Break the timed path underneath the harness."""
    PLANTS[OF[cell][1]].plant(monkeypatch, fault)
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


def _pytest_in_copy(tmp_path, expr):
    """This file's tests that ``-k expr`` selects, run in the copy;
    returns ``{test id: message of its failure or error, or None}``."""
    xml = tmp_path / "pytest.xml"
    subprocess.run(
        [sys.executable, "-m", "pytest", "drbench/tests/test_drbench_runs.py",
         "-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-m",
         "not gpu", "-k", expr, f"--junitxml={xml}"], cwd=tmp_path,
        capture_output=True, text=True, timeout=900)
    out = {}
    for case in ET.parse(xml).iter("testcase"):
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[case.get("name")] = (bad[0].tag + ": " + bad[0].get("message", "")
                                 if bad else None)
    return out


def _contents(root):
    """Every file under ``root`` (caches aside) -> its bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_a_new_family_is_new_files_only(tmp_path):
    """A configuration of a family of its own (the 1-D stencil's family,
    op, reference and faults files renamed), its CPU size and its
    manifest entries, added in a copy, make a cell whose sound runs,
    control and planted faults pass this file's tests there; no file that
    was in the tree changes but ``BENCHMARK.json``."""
    man = _copy(tmp_path)
    before = _contents(tmp_path)
    b = tmp_path / "drbench"
    for part in ("families/{}.py", "ops/{}", "reference/{}.py",
                 "reference/{}", "tests/faults/{}.py"):
        src, dst = b / part.format("stencil1d"), b / part.format("ring1d")
        for f in sorted(src.rglob("*.py")) if src.is_dir() else [src]:
            to = dst / f.relative_to(src) if src.is_dir() else dst
            to.parent.mkdir(parents=True, exist_ok=True)
            to.write_text(f.read_text().replace("stencil1d", "ring1d"))
    cfg = json.loads((b / "configs" / "stencil1d-1g.json").read_text())
    cfg.update(name="ring1d-1g", kind="ring1d")
    (b / "configs" / "ring1d-1g.json").write_text(json.dumps(cfg))
    (b / "tests" / "tiny" / "ring1d-1g.json").write_text(
        json.dumps(TINY["stencil1d-1g"]))
    tr = json.loads((b / "traffic" / "composed.json").read_text())
    tr["family"] = "ring1d"
    (b / "traffic" / "ring1d-composed.json").write_text(json.dumps(tr))
    cell = "ring1d-1g.composed"
    man["configs"].append({"name": "ring1d-1g", "source": "test",
                           "file": "drbench/configs/ring1d-1g.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": cell, "config": "ring1d-1g",
                             "traffic": "ring1d-composed", "chips": 1,
                             "why": "test"})
    next(m for m in man["end_to_end"]
         if m["name"] == "cell_updates_s")["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    got = _pytest_in_copy(tmp_path, cell)
    faults = ("state_unchanged", "exchange_left_out", "dot_altered",
              "scan_altered")
    assert got == {
        **{f"test_cell_runs_correct_on_the_cpu[{cell}-{t}]": None
           for t in (False, True)},
        f"test_control_is_not_correct[{cell}]": None,
        **{f"test_a_broken_timed_path_is_not_correct[{cell}-{f}]": None
           for f in faults}}
    after = _contents(tmp_path)
    assert [p for p in before if after.get(p) != before[p]] == \
        ["BENCHMARK.json"]


def test_a_missing_size_or_faults_file_fails_one_named_test(tmp_path):
    """With one configuration's CPU size and one family's faults module
    taken out of a copy, the cells they served leave the runs, and each
    missing file fails one named test that names it."""
    _copy(tmp_path)
    config = MAN["configs"][-1]["name"]
    kind = next(k for c, k, _ in OF.values()
                if c == MAN["configs"][0]["name"])
    size = f"drbench/tests/tiny/{config}.json"
    plants = f"drbench/tests/faults/{kind}.py"
    (tmp_path / size).unlink()
    (tmp_path / plants).unlink()
    cells = [c for c in CELLS if OF[c][0] == config or OF[c][1] == kind]
    got = _pytest_in_copy(tmp_path, " or ".join(["every_"] + cells))
    failed = {t: m for t, m in got.items() if m is not None}
    assert set(failed) == {"test_every_configuration_has_a_cpu_size",
                           "test_every_family_has_a_faults_module"}, failed
    assert size in failed["test_every_configuration_has_a_cpu_size"]
    assert plants in failed["test_every_family_has_a_faults_module"]
    left_out = [c for c in cells if OF[c][0] == config]
    for t in got:
        assert not any(f"[{c}-" in t or f"[{c}]" in t for c in left_out), t
        assert not t.startswith("test_a_broken_timed_path"), t
    assert any(m is None and "[" in t for t, m in got.items())


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
