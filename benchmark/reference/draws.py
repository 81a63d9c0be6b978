"""A training step's random draws, worked out from (seed, step).

The train command seeds one generator for each purpose of step t from
``SeedSequence([seed, t, purpose index])`` (the purposes in the order
aug, dropout, feature_perturb, method) and draws, on the step's device:

* aug: the per-sample policy, ``u = rand(B, 2)``, then ``k = randint(0, 4,
  B)``, ``axis = randint(0, 2, B)``, ``angle = randint(-20, 20, B)``;
  branch 0 (rot90 + flip) where u0 > 0.5, else branch 1 (rotation) where
  u1 > 0.5, else branch 2 (identity);
* dropout: one ``rand`` of each dropout's activation shape (B, H, W, C),
  in the order of the forward; kept where below 1 - p;
* feature_perturb: one ``rand(B, 1, 1, C)`` a feature of a perturbed
  decoder's input, kept where below 0.5;
* method: a method's own scalars (DMPLS' beta = rand() + 1e-10).

The same calls on a generator with the same seed give the same numbers
on a device, so the reference draws what the step drew.
"""

from __future__ import annotations

import numpy as np
import torch

PURPOSES = ("aug", "dropout", "feature_perturb", "method")


def step_generators(seed: int, step: int, device) -> dict:
    out = {}
    for i, name in enumerate(PURPOSES):
        s = int(np.random.SeedSequence([seed, step, i]).generate_state(
            1, np.uint64)[0])
        out[name] = torch.Generator(device=torch.device(device)
                                    ).manual_seed(s)
    return out


def policy(gen: torch.Generator, b: int, device) -> torch.Tensor:
    """(b, 4) int32 rows (branch, k, axis, angle)."""
    u = torch.rand((b, 2), generator=gen, device=device)
    k = torch.randint(0, 4, (b,), generator=gen, device=device)
    axis = torch.randint(0, 2, (b,), generator=gen, device=device)
    angle = torch.randint(-20, 20, (b,), generator=gen, device=device)
    branch = torch.where(u[:, 0] > 0.5, 0,
                         torch.where(u[:, 1] > 0.5, 1, 2))
    return torch.stack([branch, k, axis, angle], 1).to(torch.int32)
