"""The traced window: a torch.profiler trace of the work between a
synchronize and a synchronize, reduced to what the per-layer metrics and
the ``breakdown`` read.

* The window is the host span the harness marks with the annotation
  ``bench.window`` (a padding call runs before it, inside the trace, so
  the records the profiler may lose when it opens fall outside).
* Device operations (kernels, copies, sets) are clipped to the window;
  the device is busy where at least one runs (their union); idle is the
  rest of the window.
* Kernels fall into classes by name, a table frozen here after
  ``chip_smoke.py``'s (``PORT_KERNELS``, ``LIBRARY_KERNEL``): the port's
  own kernels, cuBLAS / cuDNN / CUTLASS products and convolutions, and
  the rest (PyTorch's elementwise, reduction and copy kernels). Copies
  and sets (``Memcpy``, ``Memset``) are no kernel class.
* The 3x3 convs' kernels: the port's ``conv3x3_*`` and cuDNN's
  convolutions.
* An idle gap is named by the innermost host operation the profiler saw
  around its middle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

WINDOW = "bench.window"
PORT_KERNELS = ("conv3x3_fwd_kernel", "conv3x3_wgrad_kernel",
                "conv3x3_fwd_mma_kernel", "conv3x3_wgrad_mma_kernel",
                "augment_fill_kernel", "augment_kernel",
                "augment_s2l_kernel",
                "maxpool_fwd_kernel", "maxpool_bwd_kernel",
                "gated_crf_kernel", "gated_crf_fold_kernel")
LIBRARY_KERNEL = re.compile(r"gemm|cutlass|xmma|cudnn|cublas|nvjet|"
                            r"convolve|fprop|dgrad|wgrad|splitk", re.I)
CONV3X3_KERNEL = re.compile(
    r"conv3x3_(fwd|wgrad)(_mma)?_kernel|cudnn.*(conv|fprop|dgrad|wgrad)|"
    r"(xmma|sm\d+).*_(fprop|dgrad|wgrad)|implicit_convolve", re.I)
TRANSFER = re.compile(r"^(Memcpy|Memset)")
NAME_CHARS = 120


def kernel_class(name: str) -> str:
    if TRANSFER.match(name):
        return "transfer"
    if any(k in name for k in PORT_KERNELS):
        return "port"
    if LIBRARY_KERNEL.search(name):
        return "library"
    return "torch"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list = field(default_factory=list)  # (name, start_s, end_s)
    gaps: list = field(default_factory=list)    # (host name, seconds)

    def seconds_by(self, pick) -> float:
        return sum(e - s for name, s, e in self.device if pick(name))

    def class_seconds(self, cls: str) -> float:
        return self.seconds_by(lambda n: kernel_class(n) == cls)

    def conv3x3_seconds(self) -> float:
        return self.seconds_by(lambda n: bool(CONV3X3_KERNEL.search(n)))

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for name, s, e in self.device:
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (e - s)
        idle: dict = {}
        for name, sec in self.gaps:
            idle[name] = idle.get(name, 0.0) + sec
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, window_name: str = WINDOW) -> Trace:
    """events: (name, on_device, start_ns, end_ns, is_annotation)."""
    marks = [(s, e) for name, dev, s, e, ann in events
             if name == window_name and not dev]
    if not marks:
        raise RuntimeError(f"no {window_name!r} span in the trace")
    w0, w1 = marks[-1]
    device, host = [], []
    for name, dev, s, e, ann in events:
        if name == window_name or ann:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        (device if dev else host).append((name, s, e))
    union = _union([(s, e) for _, s, e in device])
    busy = sum(e - s for s, e in union)
    host.sort(key=lambda t: t[1])
    gaps, prev, k, active = [], w0, 0, []
    for s, e in union + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            while k < len(host) and host[k][1] <= mid:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[2] >= mid]
            name = (min(active, key=lambda h: h[2] - h[1])[0] if active
                    else "host: no profiled op (Python, numpy)")
            gaps.append((name[:NAME_CHARS], 1e-9 * (s - prev)))
        prev = max(prev, e)
    return Trace(window_s=1e-9 * (w1 - w0), busy_s=1e-9 * busy,
                 device=[(n, 1e-9 * (s - w0), 1e-9 * (e - w0))
                         for n, s, e in device],
                 gaps=gaps)


def profiler_events(prof):
    """The trace's events, read from the profiler's raw results (building
    prof.events()' tree of CPU ops costs most of a long trace's time)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        ann = getattr(e, "is_user_annotation", lambda: False)()
        dev = e.device_type() == cuda
        out.append((e.name(), dev, e.start_ns(),
                    e.start_ns() + e.duration_ns(), ann and dev))
    return out


def traced(pad, work, device) -> Trace:
    """Trace `pad()` then, inside the window's span, `work()` ended by a
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    with profile(activities=acts) as prof:
        pad()
        sync()
        with record_function(WINDOW):
            work()
            sync()
    return reduce_events(profiler_events(prof))
