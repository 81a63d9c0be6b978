"""Trainer loop and data: host ms a step of the feed thread's work, the
``loader.batch`` spans (each batch the thread takes from the stream: the
index draw and the host gather) over the replays recorded, in the traced
segment. It runs beside the Trainer's thread and competes with it for the
interpreter lock."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["loader.batch"], "captured.replay")
