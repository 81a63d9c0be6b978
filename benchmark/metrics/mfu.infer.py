"""Validation: the forward's operations of the real (unpadded) slices over
the window's wall time, as a share of the dtype's dense peak."""

from harness.readers import mfu as read  # noqa: F401
