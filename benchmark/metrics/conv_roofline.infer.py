"""Kernels: the 3x3 convs' bound of the chunks a pass runs (padding
included: it is the work the kernels are given) over the conv kernels'
traced time, in the traced segment."""

from harness.readers import conv_roofline as read  # noqa: F401
