"""Training checkpoints: save, restore, find the newest.

Port of ``unseenobjectswithmeanshift_tpu.utils.checkpoint_io`` (:16-42) in
the port's own format: one ``torch.save`` file, ``checkpoint_<step>.pth``,
holding

- ``model``: the model's state_dict under the reference checkpoint's key
  names, so ``build_two_stage_predictor(checkpoint=path)`` (through
  ``weights.load_reference_checkpoint``, which unwraps ``model``) serves it;
- ``optimizer``: the AdamW state; ``step``: the steps taken;
- ``config``: the training configuration as JSON text.

Everything in it loads with ``torch.load(weights_only=True)``. A save goes to
a temporary name first and is renamed into place, so an interrupted save
never leaves a file that ``latest_checkpoint`` would pick. A restored run
resumes bit for bit on the CPU: the draws of a step depend only on (seed,
step).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"checkpoint_(\d+)\.pth")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"checkpoint_{step:07d}.pth")


def save(path: str, trainer) -> str:
    """Write ``trainer``'s model, optimizer, step and config to path."""
    state = trainer.state_dict()
    state["config"] = json.dumps(dataclasses.asdict(trainer.cfg))
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, trainer) -> int:
    """Load a checkpoint into ``trainer`` (model, optimizer, step); returns
    the step. The file is read to host memory: ``load_state_dict`` copies
    the weights and the AdamW moments to the parameters' device and leaves
    AdamW's ``step`` counts on the host, where the optimizer keeps them (a
    count on the card would cost a host sync a parameter a step)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    trainer.load_state_dict(state)
    return trainer.step


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint_<step>.pth with the highest step in directory (by
    number, not by name), or None."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(directory)
             if (m := _NAME.fullmatch(name))]
    return os.path.join(directory, max(found)[1]) if found else None
