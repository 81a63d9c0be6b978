"""Kernels: the 3x3 convs' bound (``harness/work``: per launch the larger
of bytes at 3.35 TB/s and operations at the dtype's peak, counted from the
model's shapes) over the traced time of the conv kernels (the port's
``conv3x3_*``, cuDNN's convolutions), in the traced segment."""

from harness.readers import conv_roofline as read  # noqa: F401
