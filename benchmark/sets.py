#!/usr/bin/env python3
"""Runs of cells, one process after another, and the spread of each
metric: the numbers a cell's bounds are set from.

    python3 benchmark/sets.py --workload <name> --seeds 1,2,3
        [--trace 0] [--out FILE]

Each seed is one run of ``run.py`` in its own process (one process on the
card at a time), with BENCHMARK.json's ``run_seconds``, as a check runs
it. Per metric it prints the median and the spread: the
distance between the first and third quartiles (``statistics.quantiles(
values, n=4)``) as a share of the median. Every run's result line, its
exit code, wall seconds and the end of its standard error go to --out as
JSON lines.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    values = [float(v) for v in values]
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def one_run(workload, seed, seconds, trace):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=os.path.dirname(HERE))
    line = None
    for text in reversed(proc.stdout.strip().splitlines()):
        try:
            line = json.loads(text)
            break
        except ValueError:
            continue
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": proc.returncode, "wall_s": time.time() - t0,
            "result": line, "stderr_tail": proc.stderr[-1500:]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    runs = []
    for seed in (int(x) for x in args.seeds.split(",")):
        r = one_run(args.workload, seed, seconds, args.trace)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({"seed": seed, "rc": r["rc"],
                          "wall_s": round(r["wall_s"], 2),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "setup_parts": res.get("setup_parts"),
                          "checks": res.get("checks")}), flush=True)
        if r["rc"] != 0 or not res:
            print(r["stderr_tail"], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in runs
                if r["result"] and name in r["result"]["metrics"]]
        med, spr = spread(vals)
        print(f"spread {args.workload} {name} median {med!r} "
              f"iqr/median {spr!r} n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
