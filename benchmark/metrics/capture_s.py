"""Set-up: seconds the Trainer's CapturedStep spent warming up and
capturing the step, summed over its graphs (``capture_s``)."""


def read(ctx):
    return ctx.get("capture_s")
