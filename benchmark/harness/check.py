"""The numbers that decide ``correct``.

Training (the reference follows the program's first steps):

* ``loss``: the largest |L_program - L_reference| / |L_reference| over
  the steps followed (``loss_first``: the first step's alone);
* ``grad``: the first update's gradient as the optimizer took it, worked
  out from its state after one update by the method's optimizer file
  (``optimizers/sgd.py``: the momentum buffer, the gradient plus the
  weight decay), by the worst leaf: | |g_p| - |g_r| | over the larger of
  |g_r| and the median leaf's |g_r|;
* ``change``: each leaf's change over the steps followed, parameters and
  BN running statistics, by the worst leaf in the same measure.

A cell's limits file names the numbers it compares; the others are
reported beside them.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a conv bias before a train-mode BN, whose gradient the
normalisation cancels) move by round-off alone: they are left out of
``grad`` and ``change`` by that rule, not by name.

Validation: ``logit_gap``, the widest gap by which the reference's logit
of the class the program chose lies below the reference's best logit,
over every pixel compared (in units of the logits).
"""

from __future__ import annotations

import torch

NOUGHT = 1e-3  # of the median leaf's reference gradient


def _median(values):
    vals = sorted(values)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: gap of norms}: | |p| - |r| | over the larger of |r| and the
    median leaf's |r|."""
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = _median(rn.values())
    return {n: abs(float(prog[n].double().norm()) - rn[n])
            / max(rn[n], med, 1e-30) for n in names}


def counted_leaves(raw_grad_norms: dict) -> list[str]:
    """Parameters whose reference gradient is not nought to rounding."""
    med = _median(raw_grad_norms.values())
    return [n for n, v in raw_grad_norms.items() if v >= NOUGHT * med]


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"loss": [floats], "grad": {name: tensor}, "change":
    {name: tensor}}; ref also "raw_grad_norms" {name: float}."""
    keep = counted_leaves(ref["raw_grad_norms"])
    steps = [abs(p - r) / max(abs(r), 1e-30)
             for p, r in zip(prog["loss"], ref["loss"])]
    stats = [n for n in ref["change"] if n not in ref["raw_grad_norms"]]
    grad = leaf_gaps(prog["grad"], ref["grad"], keep)
    change = leaf_gaps(prog["change"], ref["change"], keep + stats)
    out = {"loss": max(steps), "loss_first": steps[0], "_loss_steps": steps}
    for name, gaps in (("grad", grad), ("change", change)):
        worst = max(gaps, key=gaps.get)
        out[name] = gaps[worst]
        out[f"_{name}_at"] = worst
    out["_left_out"] = sorted(set(ref["raw_grad_norms"]) - set(keep))
    return out


def logit_gap(ref_logits: torch.Tensor, pred: torch.Tensor) -> float:
    """ref_logits (..., C), pred (...) class indices."""
    best = ref_logits.max(-1).values
    chosen = ref_logits.gather(-1, pred.long()[..., None])[..., 0]
    return float((best - chosen).max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number the limits name within its limit, [(name, value,
    limit)]). A number missing or not finite fails; numbers the limits do
    not name are reported, not compared."""
    rows, ok = [], bool(limits)
    for name, entry in limits.items():
        value = numbers.get(name, float("nan"))
        limit = entry["limit"]
        ok = ok and value == value and value <= limit
        rows.append((name, value, limit))
    return ok, rows
