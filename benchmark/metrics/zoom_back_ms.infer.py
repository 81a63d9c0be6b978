"""Validation: host ms a pass joining the chunks' class maps and zooming
each volume back to its native planes (``val.zoom_back`` spans over the
``val.pass`` spans), in the traced segment."""

from harness.program_spans import per_unit_ms


def read(ctx):
    return per_unit_ms(["val.zoom_back"], "val.pass")
