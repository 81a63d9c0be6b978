"""Faults planted under the timed path, for the readings that set a
cell's limits (``calibrate.py``) and for the tests that see ``correct``
come out false (``tests/test_bench_faults.py``). Each is a context that
patches the port in this process and puts it back.

Training:
* ``unchanged``: the step leaves the state as it was (no backward, no
  update; the step count still moves);
* ``half``: the loss is taken over the first half of the batch alone.

Validation:
* ``half``: the second half of each chunk's class maps is left at 0;
* ``altered``: one slice of each chunk answers class (c + 1) mod C.
"""

from __future__ import annotations

import contextlib

TRAIN = ("unchanged", "half")
INFER = ("half", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    from wsl4mis_torch.engine.state import TrainState

    def minimize(self, loss):
        self.step += 1
        self.opt.count += 1

    return _patched(TrainState, "minimize", minimize)


def _half_loss():
    from wsl4mis_torch.ops import losses

    stack = contextlib.ExitStack()
    for name in ("cross_entropy", "pdice_loss", "dice_loss"):
        orig = getattr(losses, name)

        def half(a, b, *args, _orig=orig, **kw):
            n = max(1, a.shape[0] // 2)
            return _orig(a[:n], b[:n], *args, **kw)

        stack.enter_context(_patched(losses, name, half))
    return stack


def _infer(mode):
    from wsl4mis_torch.eval.val2d import VolumePredictor

    orig = VolumePredictor._predict

    def predict(self, x, variables):
        out = orig(self, x, variables)
        n = out.shape[0]
        if mode == "half":
            out[n // 2:] = 0
        else:
            out[0] = (out[0] + 1) % 4
        return out

    return _patched(VolumePredictor, "_predict", predict)


def planted(kind: str, name: str):
    if kind == "train" and name == "unchanged":
        return _unchanged()
    if kind == "train" and name == "half":
        return _half_loss()
    if kind == "infer" and name in INFER:
        return _infer(name)
    raise ValueError(f"no fault {name!r} for a {kind} cell")
