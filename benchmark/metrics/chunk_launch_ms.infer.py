"""Validation: host ms a pass enqueueing the chunks' forwards and
decisions (``val.forward`` spans over the ``val.pass`` spans), in the
traced segment."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["val.forward"], "val.pass")
