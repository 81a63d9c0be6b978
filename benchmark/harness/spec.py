"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
their configurations and metrics. Everything else is found by name:

* a configuration's sizes: the ``file`` its entry names, and its plain
  reference beside it, ``<file without .json>.py``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric's reader: ``benchmark/metrics/<metric>.py``;
* a method's reference loss, optimizer name and work a step:
  ``benchmark/reference/methods/<method>.py``;
* an optimizer's reference and the read of the program's first gradient:
  ``benchmark/optimizers/<name>.py``.

So a cell, a configuration or a metric is added by adding files and
entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_root(bench_dir: str = BENCH_DIR) -> str:
    return os.path.dirname(bench_dir)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    """One workload with its configuration, traffic, limits and the
    metrics it reports."""

    name: str
    entry: dict
    config_entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: str = ""
    bench_dir: str = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def reference_model(self):
        """The configuration's plain reference module."""
        path = os.path.join(self.root, self.config_entry["file"])
        return load_module(path[:-len(".json")] + ".py",
                           "bench_config_" + _safe(self.config_entry["name"]))

    def reference_method(self):
        method = self.traffic["method"]
        return load_module(
            os.path.join(self.bench_dir, "reference", "methods",
                         f"{method}.py"), "bench_method_" + _safe(method))

    def optimizer(self):
        """The method's optimizer: ``optimizers/<OPTIMIZER>.py``."""
        name = self.reference_method().OPTIMIZER
        return load_module(os.path.join(self.bench_dir, "optimizers",
                                        f"{name}.py"),
                           "bench_optimizer_" + _safe(name))

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{name}.py"),
                           "bench_metric_" + _safe(name))


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in `workload`: listed under its
    ``workloads``; with no list, in every cell (a reader that finds
    nothing to read there returns None)."""
    return workload in metric.get("workloads", [workload])


def load_spec(root: str | None = None) -> dict:
    return load_json(os.path.join(root or checkout_root(), "BENCHMARK.json"))


def cells(spec: dict) -> list[str]:
    return [w["name"] for w in spec["workloads"]]


def find_cell(name: str, root: str | None = None,
              spec: dict | None = None) -> Cell:
    root = root or checkout_root()
    spec = spec or load_spec(root)
    bench_dir = os.path.join(root, spec["paths"][0])
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: "
                       f"{', '.join(cells(spec))})")
    config_entry = next(c for c in spec["configs"]
                        if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if reports(m, name)]
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    return Cell(
        name=name, entry=entry, config_entry=config_entry,
        config=load_json(os.path.join(root, config_entry["file"])),
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       f"{entry['traffic']}.json")),
        limits=(load_json(limits_path) if os.path.exists(limits_path)
                else {}),
        end_to_end=e2e, per_layer=per_layer, root=root, bench_dir=bench_dir)
