"""What the per-layer readers of both kinds of cell share. Each driver
puts the same keys in a run's context:

* ``window_s``, ``units``: the untraced window's wall seconds and the
  steps (training) or passes (validation) it ran;
* ``work``: the model's operations a unit; ``peak_flops``: the dtype's
  dense peak;
* ``conv_bound_s``: the 3x3 convs' bound a unit (``harness/work``);
* ``trace``, ``traced_units``: the traced segment (``harness.trace.
  Trace``, or None without --trace 1) and the units it ran.

A reader that finds nothing to read returns None.
"""

from __future__ import annotations


def mfu(ctx):
    """The model's operations over the window's wall time, as a share of
    the dtype's dense peak, in %."""
    if not ctx.get("window_s"):
        return None
    rate = ctx["work"] * ctx["units"] / ctx["window_s"]
    return 100.0 * rate / ctx["peak_flops"]


def conv_roofline(ctx):
    """The 3x3 convs' bound over their kernels' traced time, in %."""
    trace = ctx.get("trace")
    spent = 0.0 if trace is None else trace.conv3x3_seconds()
    if spent <= 0:
        return None
    return 100.0 * ctx["conv_bound_s"] * ctx["traced_units"] / spent


def device_idle(ctx):
    """Share of the traced window in which no operation ran on the card
    (the window less the union of the device intervals), in %."""
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
