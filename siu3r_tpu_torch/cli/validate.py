"""Validation sweep, counterpart of ``siu3r_tpu/cli/validate.py`` (reference
``mode=val`` path: pipeline.py:289-326), on one device.

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

Runs on the GPU unless ``--device cpu`` is given. ``--ckpt`` takes what
``weights.load_checkpoint`` reads (a reference Lightning ``.ckpt``, a saved
training state or a bare state dict); without it the weights are a seeded
random init (seed 0). ``trainer.devices`` above 1 is logged and the sweep
runs on the one device; the data-parallel sweep waits for the distributed
slice.
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
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from siu3r_tpu_torch.cli.train import build_dataset
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config
    from siu3r_tpu_torch.data import Loader
    from siu3r_tpu_torch.device import resolve_device
    from siu3r_tpu_torch.eval.evaluator import Evaluator
    from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline
    from siu3r_tpu_torch.utils.logging import RankedLogger
    from siu3r_tpu_torch.utils.profiling import sync
    from siu3r_tpu_torch.visualizer import Visualizer
    from siu3r_tpu_torch.weights import load_checkpoint

    log = RankedLogger(__name__)
    device = resolve_device(args.device)
    cfg = bind_scannet_classes(load_config(args.config, args.overrides))
    cfg.mode = "val"
    cfg.datamodule.dataset_cfg.num_extra_target_views = 4  # config.py:180-181
    out_dir = Path(args.output_path or "outputs/val/run")
    out_dir.mkdir(parents=True, exist_ok=True)
    if cfg.trainer.devices > 1:
        log.info(f"trainer.devices={cfg.trainer.devices}: this sweep runs on the one device {device}")
    batch_size = args.batch_size

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
        inputs = {k: torch.from_numpy(batch[k]).to(device) for k in EVAL_KEYS}
        t0 = time.perf_counter()
        out, render, qc = pipe.eval_step(inputs)
        sync(qc)
        step_seconds.append(time.perf_counter() - t0)
        viz.add_eval_step(str(out_dir), batch, out, render, qc=qc, m2f=m2f, n_real=n_real)
        viz.write_files()
        n_scenes += n_real
        n_batches += 1
        host_seconds.append(time.perf_counter() - t0 - step_seconds[-1])
        log.info(f"batch {n_batches} ({n_real} scenes): {step_seconds[-1]:.2f}s step + {host_seconds[-1]:.2f}s host")

    sweep = {"n_scenes": n_scenes, "batch_size": batch_size, "devices": 1, "step_seconds": step_seconds,
             "host_seconds": host_seconds}
    if len(step_seconds) > 1:  # skip the first batch (warm-up)
        per_item = sum(step_seconds[1:]) / (len(step_seconds) - 1) / batch_size
        sweep["ms_per_scene"] = per_item * 1000
        sweep["scenes_per_sec"] = 1.0 / per_item
        log.info(f"eval step: {per_item * 1000:.1f} ms/scene ({1.0 / per_item:.2f} scenes/sec) at batch "
                 f"{batch_size} on {device}")
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
