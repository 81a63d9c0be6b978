"""BENCHMARK.json against the benchmark's rules, and the lookup by name:
a cell added as files (and its entry) is found with no code changed."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units():
    s = load()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"][1] == \
        "benchmark/run.py"
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(ROOT, c["file"][:-5] + ".py"))
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough_and_has_its_files():
    s = load()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e
    configs = {c["name"] for c in s["configs"]}
    used = set()
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert 1 <= len(w["why"]) <= 200
        used.add(w["config"])
        cell = spec.find_cell(w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.per_layer:
            assert m["moves"] in names
    assert used == configs
    for m in s["per_layer"]:
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in s["workloads"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = load()
    rs = s["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = load()
    s["workloads"].append({"name": "unet.pce_b12", "config": "unet",
                           "traffic": "pce_b12", "chips": 1, "why": "test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "unet.pce_b24" in m.get("workloads", []):
            m["workloads"].append("unet.pce_b12")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    traffic = json.loads((root / "benchmark/traffic/pce_b24.json")
                         .read_text())
    traffic["batch"] = 12
    (root / "benchmark/traffic/pce_b12.json").write_text(
        json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/unet.pce_b24.json",
                root / "benchmark/limits/unet.pce_b12.json")
    assert "unet.pce_b12" in spec.cells(spec.load_spec(str(root)))
    cell = spec.find_cell("unet.pce_b12", str(root))
    assert cell.traffic["batch"] == 12 and cell.limits
    assert {m["name"] for m in cell.per_layer} >= {"mfu.train"}
    assert hasattr(cell.metric_reader("mfu.train"), "read")
    assert hasattr(cell.reference_model(), "leaves")
    with pytest.raises(KeyError):
        spec.find_cell("no.such_cell", str(root))
