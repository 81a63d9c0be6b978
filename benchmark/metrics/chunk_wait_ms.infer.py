"""Validation: host ms a pass copying the chunks' class maps to the host,
waiting for the card (``val.copy`` spans over the ``val.pass`` spans), in
the traced segment."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["val.copy"], "val.pass")
