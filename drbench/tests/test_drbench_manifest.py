"""BENCHMARK.json against the benchmark's contract: names, units, files,
the cells each metric is read in, the bounds and the time a check takes."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATHS.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
    assert len(set(names)) == len(names)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)


def test_configs_files_and_reduced():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("drbench/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(_dim|_rank|hidden|intermediate|"
                                 r"head|latent|width)", k)
        assert (ROOT / "drbench" / "families" / f"{cfg['kind']}.py").is_file()
        assert (ROOT / "drbench" / "reference"
                / f"{cfg['kind']}.py").is_file()


def test_cells():
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        tr = json.loads((ROOT / "drbench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
        kind = json.loads((ROOT / cfg["file"]).read_text())["kind"]
        assert tr["family"] == kind
        assert tr["limits"]
        for op in tr["ops"]:
            assert (ROOT / "drbench" / "ops" / kind
                    / f"{op['op']}.py").is_file()
            assert (ROOT / "drbench" / "reference" / kind
                    / f"{op['op']}.py").is_file()
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "drbench" / "metrics" / f"{m['name']}.py").is_file()

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    per_cell = {c: set() for c in cells}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert (ROOT / "drbench" / "metrics" / f"{m['name']}.py").is_file()
        for c in m.get("workloads", cells):
            assert c in cells and reports(c, m["moves"])
            per_cell[c].add(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        assert reports(c, "setup_s")
        assert any(reports(c, n) for n in e2e if n != "setup_s")
        assert per_cell[c], c


def test_a_full_check_fits():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
