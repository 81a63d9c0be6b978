"""Trainer loop and data: host ms a call in which the card has nothing
queued: the mean time from the end of each ``trainer.sync`` (the log
line's read of the call's metrics, which waits for the card) to the start
of the next ``captured.replay`` on its thread, in the traced segment."""

from harness.program_spans import call_gap_ms


def read(ctx):
    return call_gap_ms()
