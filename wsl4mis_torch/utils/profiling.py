"""Profiling helpers (port of ``wsl4mis_tpu/utils/profiling.py``; the
reference's CUDA-event forward / backward timer, networks_other.py:203-
258):

* ``measure_fwd_bwd_time``: device time of a model's eval forward and of
  forward + backward (the gradient of sum(out^2) over the first output
  with respect to the parameters), timed with CUDA events around
  ``n_iters`` calls after ``n_warmup``, the counterpart of the JAX
  helper's ``block_until_ready`` fences; on a CPU tensor, the host clock;
* ``start_profile`` / ``stop_profile``: the one way the port opens and
  closes ``torch.profiler`` (the Trainer's ``--profile_steps`` window and
  ``trace``); closing writes ``trace.json`` (a Chrome trace: view it in
  Perfetto or TensorBoard) and ``spans.json`` (``span_summary``);
* ``trace(logdir)``: the two around a block;
* ``span(name)``: a named host interval at a boundary of the port's work
  (the Trainer's feed, sync and host hook, the feed thread's batches, a
  captured step's load, replay and capture, the validation pass's chunks,
  copies and zoom back). While no profiler records it is one flag check and
  records nothing. While one records, it is a ``record_function`` range in
  the trace, on the clock of the card's kernels, so that the trace's idle
  gaps carry its name, and a ``(name, thread, start_ns, end_ns)`` record
  (``span_records``; epoch nanoseconds, the profiler's clock), appended
  from any thread. The records are the process's, like the profiler:
  ``stop_profile`` clears them.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _time(fn, device, n_warmup: int, n_iters: int) -> float:
    """Seconds per call of fn, after n_warmup calls."""
    for _ in range(n_warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(n_iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n_iters
    t0 = time.perf_counter()
    for _ in range(n_iters):
        fn()
    return (time.perf_counter() - t0) / n_iters


def measure_fwd_bwd_time(model, x, n_warmup: int = 3, n_iters: int = 20,
                         **forward_kwargs):
    """(forward seconds, forward + backward seconds) per iteration of
    `model` in eval mode on `x` (on x's device)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd():
        with torch.no_grad():
            _first(model(x, train=False, **forward_kwargs)).sum()

    def fwd_bwd():
        out = _first(model(x, train=False, **forward_kwargs)).float()
        torch.autograd.grad((out * out).sum(), params, allow_unused=True)

    return (_time(fwd, x.device, n_warmup, n_iters),
            _time(fwd_bwd, x.device, n_warmup, n_iters))


_records: list = []  # (name, thread, start_ns, end_ns) while profiling
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        if _autograd_profiler._is_profiler_enabled:
            _records.append((self.name, threading.get_ident(), self._start,
                             end))
        return False


def span(name: str):
    """A context naming the block `name` while a torch.profiler records
    (see the module's docstring); otherwise a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_records() -> list:
    """The spans recorded so far: (name, thread id, start_ns, end_ns)."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


def span_summary(records, steps: int | None = None) -> dict:
    """{name: {"count", "total_ms", "ms_per_step"}} of `records`; ms a step
    over `steps` (None where no step count is given)."""
    out: dict = {}
    for name, _, start, end in records:
        row = out.setdefault(name, {"count": 0, "total_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += 1e-6 * (end - start)
    for row in out.values():
        row["ms_per_step"] = row["total_ms"] / steps if steps else None
    return out


def start_profile(device) -> torch.profiler.profile:
    """A started torch.profiler over the host's activity and, on a card,
    the card's; spans record until ``stop_profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, logdir: str, device, steps: int | None = None) -> str:
    """Stop `prof` once the card's work is done; write ``{logdir}/
    trace.json`` and ``{logdir}/spans.json`` (``span_summary`` over
    `steps`) and clear the spans. Returns the trace's path."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(span_summary(span_records(), steps), f, indent=1,
                  sort_keys=True)
    clear_spans()
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU and, where there is one, CUDA
    activity); writes ``{logdir}/trace.json`` and ``spans.json``, also
    when the block raises."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    prof = start_profile(device)
    try:
        yield prof
    finally:
        stop_profile(prof, logdir, device)
