"""Run logging: log.txt in the snapshot dir plus stdout, and a step timer
(port of ``wsl4mis_tpu/utils/logging_utils.py``)."""

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


class Timer:
    """Host-clock interval timer (`tick` returns seconds since the last)."""

    def __init__(self):
        self.last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt, self.last = now - self.last, now
        return dt
