"""Training state for mid-run resume (counterpart of
``phi_3_vision_mlx_tpu/train/checkpoint.py``).

The reference keeps only the best-loss adapter; its optimizer state is lost.
The JAX package adds exact resume with orbax; the port does the same with
``torch.save``: ``<directory>/<step>/train_state.pt`` holds the trainable
LoRA leaves, the optimizer's state dict (``train/adamw.py``: the step count
and the moments) and the next step, and only the
newest ``max_to_keep`` steps are kept.  Only the adapter files
(``train/lora.py``) are shared with the JAX package; each package's train
state is its own.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from .adamw import AdamW

FILE = "train_state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


def save_train_state(directory: str, step: int, trainable: dict, optimizer: AdamW,
                     next_step: int, max_to_keep: int = 3) -> None:
    """Write the state of ``step`` and drop all but the newest
    ``max_to_keep`` steps."""
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    torch.save({"trainable": trainable, "optimizer": optimizer.state_dict(), "next_step": next_step},
               os.path.join(path, FILE))
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def restore_train_state(directory: str, step: Optional[int] = None):
    """(state, step) of ``step`` (default: the newest), or None when there
    is none.  ``state`` holds ``trainable``, ``optimizer`` and
    ``next_step``, on the CPU."""
    steps = _steps(directory)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None:
        return None
    state = torch.load(os.path.join(directory, str(step), FILE), map_location="cpu", weights_only=True)
    return state, step
