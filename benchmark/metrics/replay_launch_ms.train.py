"""Method step: host ms to put one captured step on the card: the
``captured.load`` spans (the batch's copy, the generators' seeds, the step
scalars) and the ``captured.replay`` spans (the graph's launch and the
host counts' advance) over the replays recorded, in the traced segment."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["captured.load", "captured.replay"],
                       "captured.replay")
