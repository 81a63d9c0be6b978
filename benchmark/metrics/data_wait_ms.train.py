"""Trainer loop and data: host ms a step the Trainer waited for its batch
(the harness's span around each ``next`` on ``trainer.data_iter``, over
the untraced window of a --trace 1 run)."""


def read(ctx):
    waits = ctx.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
