"""Checkpoints under the reference names (port of
``wsl4mis_tpu/utils/checkpoint.py``), as ``torch.save`` files.

* inference checkpoints (``iter_N.pth``, ``{model}_best_model.pth``,
  ``iter_N_dice_D.pth``, ``{model}_{dice}_model.pth``): {"model":
  state_dict, "step"}, plus the ``state.extra`` entries the method's eval
  forward needs (``eval_extra``: ScribbleVC's ``class_memory``);
* ``latest_full.ckpt``: the full train state (model incl. BN running
  statistics, optimizer step count and momentum buffers, step, extra),
  which ``restore_train_state`` resumes from.

Writes go to a temporary file first and are renamed into place.
"""

from __future__ import annotations

import os

import torch


def _save(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_model_checkpoint(path: str, state, eval_extra=()) -> None:
    """eval_extra: keys of state.extra to save beside the model; a key
    missing from state.extra raises."""
    extra = state.extra or {}
    missing = [k for k in eval_extra if k not in extra]
    if missing:
        raise KeyError(f"eval_extra {missing} not in state.extra "
                       f"{sorted(extra)}")
    _save(path, {"model": state.model.state_dict(), "step": state.step,
                 **{k: extra[k] for k in eval_extra}})


def save_train_state(path: str, state) -> None:
    _save(path, state.state_dict())


def restore_train_state(path: str, state) -> None:
    """Load `path` into `state` (same method and config) in place."""
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.load_state_dict(payload)
