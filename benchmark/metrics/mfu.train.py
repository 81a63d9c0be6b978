"""Method step: the model's operations over the window (the method's
``work``: forward, input and weight gradients of every conv, transposed
conv and head) over the window's wall time, as a share of the dtype's
dense peak (bf16 989, f32 67 TFLOP/s)."""

from harness.readers import mfu as read  # noqa: F401
