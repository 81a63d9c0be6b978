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
"""

from __future__ import annotations

import torch
from torch import nn


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

    def forward(self, x, train: bool, moments=None):
        """x (..., C); moments (sum x, sum x^2) over all but C, required
        in train mode."""
        if not train:
            mean, var = self.mean, self.var
        else:
            n = x.numel() // x.shape[-1]
            s1, s2 = moments
            mean, mean2 = s1 / n, s2 / n
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)
