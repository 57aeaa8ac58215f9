"""Validation sweep, counterpart of ``siu3r_tpu/cli/validate.py`` (reference
``mode=val`` path: pipeline.py:289-326), on one device or data-parallel over
the ranks of a torchrun launch.

Runs ``Pipeline.eval_step`` (the lift forward and the novel-view render of
the 2 context and 4 extra target views) over the val split, writes each
scene's predictions through the Visualizer, then evaluates them
(PSNR/SSIM/LPIPS, mIoU/PQ/mAP, depth) and prints results.json. The
timings (each batch's eval step and host seconds, the evaluator's seconds,
ms per scene) go to ``sweep.json`` beside it.

Usage:
    python -m siu3r_tpu_torch.cli.validate --config configs/scannet.yaml \
        [--ckpt model.ckpt] [--batch_size 1] [--limit 10] [--device cuda] \
        [key.path=value ...]
    torchrun --nproc_per_node N -m siu3r_tpu_torch.cli.validate \
        [--dist_backend nccl|gloo] --config ... [key.path=value ...]

Runs on the GPU unless ``--device cpu`` is given. ``--ckpt`` takes what
``weights.load_checkpoint`` reads (a reference Lightning ``.ckpt``, a saved
training state or a bare state dict); without it the weights are a seeded
random init (seed 0). ``--batch_size`` defaults to the number of ranks (1
without torchrun) and must divide by it; the last batch is padded by
repeating its last item (the count of real scenes, ``n_real``, decides what
is written). Under torchrun (``--dist_backend gloo`` where ranks share a card)
each rank runs the eval step on its contiguous slice of every batch and lifts
its own label maps; rank 0 gathers them on the host (the JAX package's
``make_dp_eval_step`` and its host gather), writes every file, and runs the
Evaluator while the other ranks wait at a barrier. ``sweep.json``'s
``devices`` is the number of ranks, its timings are rank 0's and its
``launches`` each rank's kernel launches.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def _pad_batch(batch, full: int):
    """Edge-pad every array's leading dim to ``full`` (DistributedSampler
    wrap-around equivalent); returns (batch, n_real)."""
    n_real = len(batch["scene_names"])
    if n_real == full:
        return batch, n_real
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            pad = np.repeat(v[-1:], full - n_real, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        elif isinstance(v, list):
            out[k] = v + [v[-1]] * (full - n_real)
        else:
            out[k] = v
    return out, n_real


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--limit", type=int, default=-1, help="max number of eval batches")
    parser.add_argument("--batch_size", type=int, default=None, help="global batch (default: the number of ranks)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default="nccl",
                        help="the process group's backend under torchrun (gloo where ranks share a card)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from siu3r_tpu_torch import parallel

    owns_group = not parallel.is_distributed()
    try:
        return _validate(args)
    finally:
        if owns_group:
            parallel.shutdown()


def _validate(args) -> dict:
    from siu3r_tpu_torch import parallel
    from siu3r_tpu_torch.cli.train import build_dataset
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config
    from siu3r_tpu_torch.data import Loader
    from siu3r_tpu_torch.eval.evaluator import Evaluator
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline, gather_eval_arrays
    from siu3r_tpu_torch.utils.logging import RankedLogger
    from siu3r_tpu_torch.utils.profiling import sync
    from siu3r_tpu_torch.visualizer import Visualizer, eval_step_arrays
    from siu3r_tpu_torch.weights import load_checkpoint

    log = RankedLogger(__name__, rank_zero_only=True)
    device = parallel.init_distributed(args.dist_backend, args.device)
    world = parallel.world_size()
    cfg = bind_scannet_classes(load_config(args.config, args.overrides))
    cfg.mode = "val"
    cfg.datamodule.dataset_cfg.num_extra_target_views = 4  # config.py:180-181
    out_dir = Path(args.output_path or "outputs/val/run")
    writer = parallel.rank() == 0
    if writer:
        out_dir.mkdir(parents=True, exist_ok=True)
    batch_size = args.batch_size or world
    if batch_size % world:
        raise SystemExit(f"--batch_size {batch_size} not divisible by {world} ranks")

    dataset = build_dataset(cfg, train=False)
    loader = Loader(dataset, batch_size=batch_size, shuffle=False, num_workers=2, drop_last=False)
    pipe = Pipeline(cfg, device=device, seed=0)
    if args.ckpt:
        load_checkpoint(pipe.model, args.ckpt)
    else:
        log.warning("no --ckpt: seeded random init (seed 0)")

    viz = Visualizer(cfg.pipeline.visualizer)
    m2f = cfg.pipeline.model.mask2former
    n_batches = n_scenes = 0
    step_seconds, host_seconds = [], []
    for batch in loader:
        if 0 < args.limit <= n_batches:
            break
        batch, n_real = _pad_batch(batch, batch_size)
        mine = parallel.shard_batch({k: batch[k] for k in EVAL_KEYS})
        inputs = {k: torch.from_numpy(v).to(device) for k, v in mine.items()}
        t0 = time.perf_counter()
        out, render, qc = pipe.eval_step(inputs)
        sync(qc)
        step_seconds.append(time.perf_counter() - t0)
        arrays = gather_eval_arrays(eval_step_arrays(out, render, qc, m2f))
        del out, render, qc
        if writer:
            viz.add_eval_arrays(str(out_dir), batch, arrays, n_real=n_real)
            viz.write_files()
        n_scenes += n_real
        n_batches += 1
        host_seconds.append(time.perf_counter() - t0 - step_seconds[-1])
        log.info(f"batch {n_batches} ({n_real} scenes): {step_seconds[-1]:.2f}s step + {host_seconds[-1]:.2f}s host")

    # each rank's kernel launches over the sweep (none on the CPU)
    launches = parallel.gather_to_rank0(dict(_build.launch_counts))
    sweep = {"n_scenes": n_scenes, "batch_size": batch_size, "devices": world, "step_seconds": step_seconds,
             "host_seconds": host_seconds, "launches": launches}
    if len(step_seconds) > 1:  # skip the first batch (warm-up)
        per_item = sum(step_seconds[1:]) / (len(step_seconds) - 1) / batch_size
        sweep["ms_per_scene"] = per_item * 1000
        sweep["scenes_per_sec"] = 1.0 / per_item
        log.info(f"eval step: {per_item * 1000:.1f} ms/scene ({1.0 / per_item:.2f} scenes/sec) at batch "
                 f"{batch_size} over {world} rank(s)")
    # rank-0 evaluation behind a barrier (reference pipeline.py:315-326)
    parallel.barrier()
    if not writer:
        return sweep
    ev = Evaluator(cfg.pipeline.evaluator, device=device)
    t0 = time.perf_counter()
    result = ev.evaluate(str(out_dir))
    sweep["evaluate_seconds"] = time.perf_counter() - t0
    (out_dir / "sweep.json").write_text(json.dumps(sweep, indent=1))
    print(json.dumps({k: v for k, v in result.items() if not k.endswith("per_class")}, indent=2))
    sweep["results"] = result
    return sweep


if __name__ == "__main__":
    main()
