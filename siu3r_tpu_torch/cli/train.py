"""The training entry point, counterpart of ``siu3r_tpu/cli/train.py``
(reference src/run.py), on one device or data-parallel over the ranks of a
torchrun launch.

Usage:
    python -m siu3r_tpu_torch.cli.train --config configs/scannet.yaml \
        [--resume out/checkpoints/epoch003-120] [--device cuda] [key.path=value ...]
    torchrun --nproc_per_node N -m siu3r_tpu_torch.cli.train \
        [--dist_backend nccl|gloo] --config ... [key.path=value ...]

Builds the dataset and loader, runs ``Pipeline.train_step`` over them
(``trainer.accumulate_grad_batches`` micro-steps to an optimizer step),
logs the losses and the base group's learning rate to ``metrics.jsonl``
every ``trainer.log_every_n_steps`` steps, writes the eval step's renders of
the train batch through the Visualizer every
``pipeline.log_training_result_interval`` steps (under ``train_viz/``), and
saves the training state every ``trainer.check_val_every_n_epoch`` epochs,
at the last epoch and at ``trainer.max_steps`` (under ``checkpoints/``).
``--resume`` continues from such a state at its epoch + 1 and global step,
or, for a state that ``trainer.max_steps`` stopped inside an epoch, at the
next batch of that epoch (the batches it trained are loaded again and not
trained, so that the dataset's view draws go on as they did): the loader's
order and the dataset's view draws are functions of (seed, epoch), and each
step's random draws come from a generator seeded with (seed + 1, global
step), so with one loader worker the resumed run trains as the
uninterrupted one would have. (The JAX package's CLI resumes every state at
its epoch + 1.)

Runs on the GPU unless ``--device cpu`` is given. Under torchrun (one
process a rank; ``--dist_backend gloo`` where ranks share a card, which NCCL
refuses, or run on the CPU) every rank builds the same seeded loader and
takes its contiguous slice of each global batch (the loader's batch size must
divide by the number of ranks), ``Pipeline.train_step`` averages the
gradients, loss terms and BatchNorm statistics over the ranks, and
``trainer.zero1`` shards the optimizer state; rank r > 0 draws from a
generator that mixes r into the step's seed (the JAX step's ``fold_in`` of the
axis index). ``metrics.jsonl``, ``train_viz/`` (from the data-parallel eval
step, gathered on rank 0) and the checkpoints are written by rank 0 only.
``trainer.devices`` is the JAX package's mesh size; here the world size
decides. ``pipeline.model.dtype=bfloat16`` trains with the backbone and the
adapter computing in bf16 (fp32 parameters and optimizer state, so the
saved state restores into a run of either dtype).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def build_dataset(cfg, train: bool):
    """Dataset dispatch (reference get_datamodule.py:4-77): scannet /
    scannetpp / replica / concat (joint multi-dataset training) /
    scanrefer (referring-expression segmentation)."""
    from siu3r_tpu_torch.data import (
        ConcatSceneDataset,
        ReplicaDataset,
        ScanNetDataset,
        ScanNetPPDataset,
        ScanReferDataset,
    )

    dcfg = cfg.datamodule.dataset_cfg
    cls = {
        "scannet": ScanNetDataset,
        "scannetpp": ScanNetPPDataset,
        "replica": ReplicaDataset,
        "concat": ConcatSceneDataset,
        "scanrefer": ScanReferDataset,
    }[dcfg.name]
    return cls(
        dcfg.root,
        num_extra_context_views=dcfg.num_extra_context_views,
        num_extra_target_views=dcfg.num_extra_target_views,
        train=train,
        seg_task=dcfg.seg_task,
        image_size=dcfg.image_width,
        max_objects=dcfg.max_objects,
    )


def step_generator(seed: int, global_step: int, device, rank: int = 0):
    """The random draws of step ``global_step`` (the criterion's sample
    points): a generator on ``device`` seeded with (seed + 1, global_step),
    so that a resumed run continues the stream instead of replaying it. Rank
    r > 0 of a data-parallel run adds r times the 64-bit golden ratio, modulo
    2^64 (each rank its own draws); rank 0 keeps the one-device stream."""
    import torch

    base = ((seed + 1) << 32) + global_step
    return torch.Generator(device=device).manual_seed((base + rank * 0x9E3779B97F4A7C15) % (1 << 64))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="training state to resume from (parameters, optimizer, counters)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default="nccl",
                        help="the process group's backend under torchrun (gloo where ranks share a card)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from siu3r_tpu_torch import parallel

    owns_group = not parallel.is_distributed()
    try:
        return _train(args)
    finally:
        if owns_group:
            parallel.shutdown()


def _train(args) -> dict:
    import torch

    from siu3r_tpu_torch import parallel
    from siu3r_tpu_torch.checkpoint_io import restore_train_state, save_train_state, saved_epoch_step
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config
    from siu3r_tpu_torch.data import Loader
    from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline, gather_eval_arrays
    from siu3r_tpu_torch.train.optimizer import make_lr_schedule
    from siu3r_tpu_torch.utils.logging import MetricsHistory, RankedLogger
    from siu3r_tpu_torch.visualizer import Visualizer, eval_step_arrays

    log = RankedLogger(__name__, rank_zero_only=True)
    device = parallel.init_distributed(args.dist_backend, args.device)
    rank, world = parallel.rank(), parallel.world_size()
    cfg = bind_scannet_classes(load_config(args.config, args.overrides))
    out_dir = Path(cfg.output_path or f"outputs/{cfg.mode}/{cfg.experiment}")
    if rank == 0:
        out_dir.mkdir(parents=True, exist_ok=True)
    history = MetricsHistory(out_dir)

    dataset = build_dataset(cfg, train=cfg.mode == "train")
    loader = Loader(
        dataset,
        batch_size=cfg.datamodule.train_loader_cfg.batch_size,
        num_workers=cfg.datamodule.train_loader_cfg.num_workers,
        shuffle=cfg.mode == "train",
        seed=cfg.seed,
    )
    steps_per_epoch = max(len(loader), 1)
    parallel.shard_slice(cfg.datamodule.train_loader_cfg.batch_size)  # raises unless the ranks divide the batch
    pipe = Pipeline(cfg, device=device, seed=cfg.seed).init_train(steps_per_epoch=steps_per_epoch)
    log.info(f"device {device}; {world} rank(s); steps/epoch {steps_per_epoch}; "
             f"accumulate_grad_batches {cfg.trainer.accumulate_grad_batches}; optimizer "
             f"{type(getattr(pipe.optimizer, 'inner', pipe.optimizer)).__name__}")

    start_epoch, global_step, skip = 0, 0, 0
    if args.resume:
        epoch, global_step = restore_train_state(args.resume, pipe)
        done = saved_epoch_step(args.resume)
        if done is not None and done < steps_per_epoch:
            start_epoch, skip = epoch, done
        else:
            start_epoch = epoch + 1
        log.info(f"resumed {args.resume}: epoch {start_epoch}, step {global_step}"
                 + (f", after the epoch's first {skip} batches" if skip else ""))

    # LearningRateMonitor equivalent: the base group's schedule
    lr_of = make_lr_schedule(cfg.optimizer.lr, cfg.optimizer.warm_up_epochs, cfg.trainer.max_epochs,
                             steps_per_epoch)
    viz_interval = cfg.pipeline.log_training_result_interval
    viz = Visualizer(cfg.pipeline.visualizer)

    def write_train_viz(batch, inputs, step):
        """The eval step on the train batch (each rank's slice, gathered on
        rank 0), its renders and overlays under ``train_viz/step…``
        (reference src/pipeline.py:271-280)."""
        out, render, _ = pipe.eval_step({k: inputs[k] for k in EVAL_KEYS})
        arrays = gather_eval_arrays(eval_step_arrays(out, render))
        if arrays is None:
            return
        save_dir = out_dir / "train_viz" / f"step{step:07d}"
        viz.add_eval_arrays(str(save_dir), batch, arrays)
        viz.write_files()
        log.info(f"wrote training visualization: {save_dir}")

    max_steps = cfg.trainer.max_steps
    saved = []
    for epoch in range(start_epoch, cfg.trainer.max_epochs):
        t_epoch = time.time()
        loader.set_epoch(epoch)
        epoch_step = 0
        for batch in loader:
            if epoch_step < skip:  # trained before the resume
                epoch_step += 1
                continue
            if max_steps >= 0 and global_step >= max_steps:
                break
            inputs = {k: torch.from_numpy(v).to(device) for k, v in parallel.shard_batch(batch).items()
                      if isinstance(v, np.ndarray) and v.dtype != object}
            losses = pipe.train_step(inputs, step_generator(cfg.seed, global_step, device, rank))
            # a refer batch has no target views to render
            if viz_interval > 0 and global_step % viz_interval == 0 and "target_views_images" in batch:
                try:
                    write_train_viz(batch, inputs, global_step)
                except OSError as e:  # a full or unwritable disk must not end training; a kernel's error does
                    log.warning(f"train viz failed at step {global_step}: {e}")
            if global_step % cfg.trainer.log_every_n_steps == 0:
                keep = ("render_mse", "depth_smoothness", "seg", "lpips", "total", "word_match")
                vals = {k: float(v) for k, v in losses.items() if "_" not in k or k in keep}
                log.info(f"epoch {epoch} step {global_step}: " + json.dumps(vals))
                history.log(global_step, epoch=epoch, lr=lr_of(global_step),
                            **{f"train/{k}": v for k, v in vals.items()})
            global_step += 1
            epoch_step += 1
        skip = 0
        log.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
        history.log(global_step, epoch=epoch, epoch_seconds=time.time() - t_epoch)
        hit_max_steps = max_steps >= 0 and global_step >= max_steps
        if ((epoch + 1) % cfg.trainer.check_val_every_n_epoch == 0 or epoch == cfg.trainer.max_epochs - 1
                or hit_max_steps):
            ckpt = out_dir / "checkpoints" / f"epoch{epoch:03d}-{global_step}"
            if rank == 0:
                ckpt.parent.mkdir(parents=True, exist_ok=True)
            save_train_state(ckpt, pipe, epoch, global_step, epoch_step)
            saved.append(str(ckpt))
            log.info(f"saved checkpoint {ckpt}")
        if hit_max_steps:
            break
    return {"global_step": global_step, "checkpoints": saved}


if __name__ == "__main__":
    main()
