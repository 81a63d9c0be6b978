"""BatchNorm with f32 statistics and a compute-dtype apply (port of
``wsl4mis_tpu/models/norm.py`` FusedBatchNorm).

* In train mode the batch mean and variance come from ``moments`` (f32
  sum y and sum y^2 per channel, the conv3x3_stats epilogue's): one-pass,
  the variance clamped at 0.
* Running statistics follow flax momentum 0.9: new = 0.9 old + 0.1 batch,
  and the running variance is the **biased** one (flax's contract;
  torch.nn.BatchNorm2d would store the unbiased one, so it is not used).
* The apply is ``x * mul + add`` with mul, add computed in f32 and cast to
  x's dtype.
* ``update_stats = False`` leaves the running statistics alone in train
  mode: an EMA teacher normalises by batch statistics as the student does
  but keeps none (the JAX package discards the teacher's mutation).
* Under a process group the batch is the global one: the moments are
  summed over the ranks (``parallel.global_sums``, one all-reduce a layer),
  so every rank normalises by, and keeps, the same statistics.
* Inside ``statistics_frozen()`` no layer folds its batch into its running
  statistics: a checkpointed forward's recompute (ScribbleVC's ``remat``)
  runs under it, so the statistics take one update a forward, as under
  flax's ``nn.remat``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from .. import parallel

_frozen = threading.local()


@contextlib.contextmanager
def statistics_frozen():
    """No BN layer updates its running statistics inside, in this thread
    (the autograd engine recomputes a checkpointed forward in its own)."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


class FusedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def statistics(self, n: int, train: bool, moments=None):
        """(mean, var) to normalize by: the running statistics in eval
        mode; in train mode those of the batch from its moments (sum x, sum
        x^2) over n values per channel, folded into the running ones: of the
        global batch under a process group."""
        if not train:
            return self.mean, self.var
        s1, s2 = parallel.global_sums(*moments)
        n = parallel.global_batch(n)  # every rank holds n values
        mean, mean2 = s1 / n, s2 / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.update_stats and not getattr(_frozen, "on", False):
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x, train: bool, moments=None):
        """x (..., C); moments (sum x, sum x^2) over all but C, required
        in train mode."""
        mean, var = self.statistics(x.numel() // x.shape[-1], train, moments)
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)
