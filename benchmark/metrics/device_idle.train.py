"""Device: share of the traced training segment in which no operation ran
on the card."""

from harness.readers import device_idle as read  # noqa: F401
