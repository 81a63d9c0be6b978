"""Profiling helpers (port of ``wsl4mis_tpu/utils/profiling.py``; the
reference's CUDA-event forward / backward timer, networks_other.py:203-
258):

* ``measure_fwd_bwd_time``: device time of a model's eval forward and of
  forward + backward (the gradient of sum(out^2) over the first output
  with respect to the parameters), timed with CUDA events around
  ``n_iters`` calls after ``n_warmup``, the counterpart of the JAX
  helper's ``block_until_ready`` fences; on a CPU tensor, the host clock;
* ``trace(logdir)``: a ``torch.profiler`` context writing a Chrome trace
  (view it in Perfetto or TensorBoard).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU and, where there is one, CUDA
    activity); writes ``{logdir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
