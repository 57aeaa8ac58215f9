"""Save and restore a training state, counterpart of
``siu3r_tpu/checkpoint_io.py``'s ``save_train_state``/``restore_train_state``:
the model's parameters and BatchNorm buffers, the optimizer's moments and
step count, and the loop's epoch and global step, in one ``torch.save`` file.
A restored state continues training as the saved one would."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch


def save_train_state(path: str | Path, pipeline, epoch: int, global_step: int) -> None:
    """``pipeline`` after ``init_train``."""
    torch.save(
        {
            "model": pipeline.model.state_dict(),
            "optimizer": pipeline.optimizer.state_dict(),
            "epoch": int(epoch),
            "global_step": int(global_step),
        },
        Path(path),
    )


def restore_train_state(path: str | Path, pipeline) -> Tuple[int, int]:
    """Load a state saved by ``save_train_state`` into ``pipeline`` (after
    ``init_train``, with the same config). Returns (epoch, global_step).
    Raises if the optimizer's parameter groups differ from the saved ones."""
    dev = next(pipeline.model.parameters()).device
    blob = torch.load(Path(path), map_location=dev, weights_only=False)
    pipeline.optimizer.load_state_dict(blob["optimizer"])
    pipeline.model.load_state_dict(blob["model"], strict=True)
    return blob["epoch"], blob["global_step"]
