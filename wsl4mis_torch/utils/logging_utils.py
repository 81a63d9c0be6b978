"""Run logging: log.txt in the snapshot dir plus stdout, keyed running
averages and a step timer (port of ``wsl4mis_tpu/utils/logging_utils.py``)."""

from __future__ import annotations

import logging
import os
import sys
import time


def setup_run_logging(snapshot_path: str) -> None:
    os.makedirs(snapshot_path, exist_ok=True)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(
        filename=os.path.join(snapshot_path, "log.txt"),
        level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S",
    )
    root.addHandler(logging.StreamHandler(sys.stdout))


class AverageMeter:
    """Keyed running averages (tool/pyutils.py:20-45): float sums, int
    counts; `pop` returns the average and forgets the key."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, **kv):
        for k, v in kv.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def get(self, key: str) -> float:
        return self.sums[key] / max(self.counts[key], 1)

    def pop(self, key: str) -> float:
        v = self.get(key)
        self.sums.pop(key, None)
        self.counts.pop(key, None)
        return v


class Timer:
    """Host-clock interval timer (`tick` returns seconds since the last)."""

    def __init__(self):
        self.last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt, self.last = now - self.last, now
        return dt
