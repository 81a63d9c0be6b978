"""Trainer loop and data: host ms a step the Trainer waited for its
batches, from inside the program: the ``trainer.feed`` spans (each
``next`` on the feed) over the replays recorded, in the traced segment.
The program's side of ``data_wait_ms.train``."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["trainer.feed"], "captured.replay")
