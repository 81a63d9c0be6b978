#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Finds the cell in ``BENCHMARK.json`` (its configuration, traffic mix,
limits and metrics by name: ``harness/spec.py``), runs it through the
driver of its traffic's ``kind`` (``harness/train.py``,
``harness/infer.py``), checks the result against the plain reference and
prints one JSON line last on standard output: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (each read by
``metrics/<name>.py``), the device, and under ``checks`` (last) each
number compared beside its limit, which also end standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or if JAX or the JAX package was loaded.
Build and kernel caches stay inside the checkout (``build/``).
"""

import argparse
import json
import os
import sys
import time


def process_start() -> float:
    """The wall time at which this process started (from /proc on Linux;
    elsewhere, now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wsl4mis_tpu")
DRIVERS = {"train": "harness.train", "infer": "harness.infer"}


def environment(root: str) -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    cache = os.path.join(root, "build", "benchmark", "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seed_arg(text: str) -> int:
    v = int(text)
    if v < 0:
        raise argparse.ArgumentTypeError("the seed is a whole number >= 0")
    return v


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=seed_arg, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell, seed, seconds, trace, t_start, device, root=ROOT,
            marks=None):
    """One run of `cell` by the driver of its traffic's kind; `marks`
    [(name, seconds since t_start)] gathers the parts of set-up."""
    import importlib

    from harness.train import snapshot_root

    driver = importlib.import_module(DRIVERS[cell.traffic["kind"]])
    return driver.run(cell, seed, seconds, bool(trace), t_start, device,
                      snapshot_root(root, cell),
                      [] if marks is None else marks)


def result_line(cell, res, trace: bool, device_info: dict) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(res.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=res.memory_peak_bytes)
    line = {"correct": bool(res.correct), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if trace and res.trace is not None:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        line["breakdown"] = res.trace.breakdown()
    line["setup_parts"] = {name: t for name, t in
                           res.context.get("setup_marks", [])}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in res.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    environment(ROOT)
    from harness import spec

    marks = []

    def mark(name):  # harness.common.marker, before torch is imported
        marks.append((name, time.time() - T_START))

    cell = spec.find_cell(args.workload, ROOT)
    mark("python and the harness")
    import torch

    mark("torch imported")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    torch.empty(1, device="cuda")
    mark("CUDA context")
    res = execute(cell, args.seed, args.seconds, args.trace, T_START,
                  "cuda", marks=marks)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; it may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips}
    line = result_line(cell, res, bool(args.trace), device_info)
    print("set-up, seconds from process start: " + ", ".join(
        f"{name} {t:.3f}" for name, t in line["setup_parts"].items()),
        file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
