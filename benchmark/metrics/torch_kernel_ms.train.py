"""Method step: device ms a step of PyTorch's own kernels (neither the
port's nor cuBLAS / cuDNN / CUTLASS; no copies), from the traced
segment."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    return 1e3 * trace.class_seconds("torch") / ctx["traced_units"]
