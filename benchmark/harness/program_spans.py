"""What the readers of ``program_span`` metrics share.

The port names the boundaries of its own work with spans
(``wsl4mis_torch.utils.profiling.span``): the Trainer's ``trainer.feed``
and ``trainer.sync``, the feed thread's ``loader.batch``, a captured
step's ``captured.load`` and ``captured.replay``, the validation pass's
``val.pass``, ``val.forward``, ``val.copy`` and ``val.zoom_back``. A span
records only while a torch.profiler runs, so a run's records are those of
its traced segment (``harness/trace.traced``: the padding call and the
window), and a --trace 0 run has none.

A reader sums the spans of one name over the segment and divides by the
units the segment ran, counted from the spans too: the replays recorded
(``captured.replay``, one a training step) or the passes (``val.pass``).
The sum and its count come from the same segment, so the pad's share
cancels. ``call_gap_ms`` pairs each ``trainer.sync`` (the read of a call's
metrics, which waits for the card) with the next ``captured.replay`` on
its thread: between the two the card has nothing queued.

The records are read from the program's module at call time, never at
import (the reference loads nothing of the program). A program without
spans, or a run without records, reads None.
"""

from __future__ import annotations

SYNC, REPLAY = "trainer.sync", "captured.replay"


def records():
    """The program's span records (name, thread, start_ns, end_ns), or []
    where the program keeps none."""
    from wsl4mis_torch.utils import profiling

    read = getattr(profiling, "span_records", None)
    return [] if read is None else list(read())


def total_ms(recs, name: str) -> float:
    return 1e-6 * sum(e - s for n, _, s, e in recs if n == name)


def count(recs, name: str) -> int:
    return sum(1 for n, *_ in recs if n == name)


def per_unit_ms(names, unit: str, recs=None):
    """Σ of the spans `names` over the count of `unit` spans, in ms; None
    without a `unit` span."""
    recs = records() if recs is None else recs
    units = count(recs, unit)
    if not units:
        return None
    return sum(total_ms(recs, n) for n in names) / units


def call_gap_ms(recs=None):
    """Mean ms from the end of each ``trainer.sync`` to the start of the
    next ``captured.replay`` on the same thread; None where no sync is
    followed by a replay."""
    recs = records() if recs is None else recs
    gaps, pending = [], {}
    for name, thread, start, end in sorted(
            (r for r in recs if r[0] in (SYNC, REPLAY)),
            key=lambda r: r[2]):
        if name == SYNC:
            pending[thread] = end
        elif thread in pending:
            gaps.append(start - pending.pop(thread))
    if not gaps:
        return None
    return 1e-6 * sum(gaps) / len(gaps)
