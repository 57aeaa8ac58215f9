"""Save and restore a training state, counterpart of
``siu3r_tpu/checkpoint_io.py``'s ``save_train_state``/``restore_train_state``:
the model's parameters and BatchNorm buffers, the optimizer's moments and
step count, under gradient accumulation the running mean of the gradients
and the micro-step count (the JAX package keeps them in its ``opt_leaves``),
and the loop's epoch, global step and place in the epoch, in one
``torch.save`` file. A restored state continues training as the saved one
would, also from the middle of an accumulation or of an epoch.

Under a process group every rank calls both: the file is written by rank 0
alone, in the one-device layout (a ZeRO-1 state's moments and running mean
gathered to full parameter shapes first), and each rank restores its own
slice from it, so a one-device run and a data-parallel or ZeRO-1 run of the
same config restore each other's state."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from siu3r_tpu_torch import parallel


def save_train_state(path: str | Path, pipeline, epoch: int, global_step: int,
                     epoch_step: Optional[int] = None) -> None:
    """``pipeline`` after ``init_train``; ``epoch_step`` is the number of
    ``epoch``'s batches trained (None: the whole epoch). Under a process
    group, a collective: every rank calls it, rank 0 writes, and every rank
    returns once the file is complete."""
    state = {
        "model": pipeline.model.state_dict(),
        "optimizer": pipeline.optimizer.state_dict(),
        "epoch": int(epoch),
        "global_step": int(global_step),
        "epoch_step": None if epoch_step is None else int(epoch_step),
    }
    if parallel.rank() == 0:
        torch.save(state, Path(path))
    del state
    parallel.barrier()


def restore_train_state(path: str | Path, pipeline) -> Tuple[int, int]:
    """Load a state saved by ``save_train_state`` into ``pipeline`` (after
    ``init_train``, with the same config). Returns (epoch, global_step).
    Raises if the optimizer's parameter groups or its number of accumulated
    micro-steps differ from the saved ones: the file is mapped, not read,
    so a refusal reads only its small entries, and each tensor is copied
    from the file into its place on the device."""
    blob = torch.load(Path(path), map_location="cpu", mmap=True, weights_only=False)
    pipeline.optimizer.load_state_dict(blob["optimizer"])
    pipeline.model.load_state_dict(blob["model"], strict=True)
    return blob["epoch"], blob["global_step"]


def saved_epoch_step(path: str | Path) -> Optional[int]:
    """The batches of its epoch that a saved state had trained, or None
    where its saver gave none (a state saved outside ``cli/train``'s loop,
    or before this entry existed). Reads none of the file's tensors."""
    return torch.load(Path(path), map_location="cpu", mmap=True, weights_only=False).get("epoch_step")
