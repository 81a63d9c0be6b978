"""Experiment launcher (port of ``scripts/launch_experiments.py``, the
reference's train_wss.sh / train_semi.sh fan-out): (method, fold) jobs, each
a ``python -m wsl4mis_torch.cli train ...`` process pinned to one card
through ``CUDA_VISIBLE_DEVICES``, at most ``--parallel`` at a time (job
slot k takes card k). Failures are collected, not fatal.

    python -m wsl4mis_torch.cli launch --suite wss --folds fold1
    python -m wsl4mis_torch.cli launch --methods dmpls,pce --folds all \\
        --parallel 4
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time

from .cli import METHOD_DEFAULTS

SUITES = {
    # train_wss.sh methods
    "wss": ["fully_supervised", "pce", "pce_tv", "pce_entropy_mini",
            "pce_gatedcrf", "pce_mumford_shah", "pce_intensity_variance",
            "dmpls", "s2l", "ustm"],
    # train_semi.sh methods
    "semi": ["mean_teacher", "uamt", "entropy_minimization",
             "partially_supervised", "deep_adversarial"],
}
FOLDS = ["fold1", "fold2", "fold3", "fold4", "fold5"]


def job_command(method: str, fold: str, extra=()) -> list[str]:
    """The train command of one job: the method's reference script name
    (its defaults, ``cli.METHOD_DEFAULTS``), or train_scribblevc ACDC."""
    base = [sys.executable, "-m", "wsl4mis_torch.cli"]
    if method == "scribblevc":
        return base + ["train_scribblevc", "ACDC", "--fold", fold, *extra]
    scripts = [s for s, (m, _) in METHOD_DEFAULTS.items() if m == method]
    if not scripts:
        raise SystemExit(f"launch: unknown method {method!r}")
    return base + ["train", scripts[0], "--fold", fold, *extra]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="launch")
    p.add_argument("--suite", choices=sorted(SUITES), default=None)
    p.add_argument("--methods", type=str, default=None,
                   help="comma-separated method names")
    p.add_argument("--folds", type=str, default="fold1",
                   help="'all' or comma-separated fold names")
    p.add_argument("--parallel", type=int, default=1,
                   help="max concurrent jobs, one card each")
    p.add_argument("--extra", type=str, default="",
                   help="extra flags passed to every train command")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    methods = (SUITES[args.suite] if args.suite else
               [m.strip() for m in (args.methods or "dmpls").split(",")])
    folds = (FOLDS if args.folds == "all"
             else [f.strip() for f in args.folds.split(",")])
    extra = args.extra.split() if args.extra else []
    jobs = [(job, job_command(*job, extra))
            for job in itertools.product(methods, folds)]

    free = list(range(args.parallel))  # card slots
    running: list[tuple[subprocess.Popen, tuple, int]] = []
    failures = []

    def reap(block: bool):
        nonlocal running
        still = []
        for proc, job, card in running:
            if block:
                proc.wait()
            if proc.poll() is None:
                still.append((proc, job, card))
                continue
            free.append(card)
            if proc.returncode != 0:
                failures.append((job, proc.returncode))
        running = still

    for job, cmd in jobs:
        if args.dry_run:
            print("DRY:", " ".join(cmd))
            continue
        while not free:
            reap(block=False)
            if not free:
                time.sleep(5)
        card = free.pop(0)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(card))
        print("LAUNCH:", *job, "on card", card, flush=True)
        running.append((subprocess.Popen(cmd, env=env), job, card))
    reap(block=True)
    if failures:
        print("FAILED JOBS:", failures)
        return 1
    print("all jobs finished")
    return 0
