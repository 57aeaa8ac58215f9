"""Referring-expression validation sweep, counterpart of
``siu3r_tpu/cli/validate_refer.py``.

Runs ``Pipeline.refer_eval_step`` (the understanding-only forward; text
tokens matched against the object queries by the six language layers) over
the ScanRefer val split and prints the referred-mask IoU as JSON: its mean
over the referred objects, their number, and the share above 0.5 and 0.25.
The reference ships no refer evaluator; mask IoU over the referred objects
is the standard ScanRefer protocol.

Usage:
    python -m siu3r_tpu_torch.cli.validate_refer --config configs/scanrefer.yaml \
        [--ckpt model.ckpt] [--limit 10] [--device cuda] [key.path=value ...]

Runs on the GPU unless ``--device cpu`` is given. ``--ckpt`` takes what
``weights.load_checkpoint`` reads (a reference Lightning ``.ckpt``, a
state_dict file or a saved training state); without it the weights are a
seeded random init (seed 0).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

BATCH_KEYS = ("context_views_images", "context_views_intrinsics", "text_token")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--limit", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from siu3r_tpu_torch.cli.train import build_dataset
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config
    from siu3r_tpu_torch.data import Loader
    from siu3r_tpu_torch.device import resolve_device
    from siu3r_tpu_torch.eval.metrics import referred_mask_iou
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.weights import load_checkpoint

    device = resolve_device(args.device)
    cfg = bind_scannet_classes(load_config(args.config, args.overrides))
    cfg.mode = "val"
    cfg.datamodule.dataset_cfg.name = "scanrefer"
    cfg.pipeline.model.mask2former.train_refer_segmentation = True

    dataset = build_dataset(cfg, train=False)
    loader = Loader(dataset, batch_size=1, shuffle=False, num_workers=2, drop_last=False)
    pipe = Pipeline(cfg, device=device, seed=0)
    if args.ckpt:
        load_checkpoint(pipe.model, args.ckpt)
    else:
        print("[siu3r_tpu_torch] no --ckpt: seeded random init (seed 0)", file=sys.stderr)

    all_ious = []
    for n, batch in enumerate(loader):
        if 0 < args.limit <= n:
            break
        pred_masks, _ = pipe.refer_eval_step({k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS})
        pred_masks = pred_masks.cpu().numpy()
        for bi in range(len(batch["scene_names"])):
            _, per_word = referred_mask_iou(pred_masks[bi], batch["gt_masks"][bi], batch["gt_valid"][bi])
            all_ious.extend(per_word.tolist())

    ious = np.asarray(all_ious)
    result = {
        "refer_miou": float(ious.mean()) if all_ious else 0.0,
        "num_referred": len(all_ious),
        "acc@0.5": float(np.mean(ious > 0.5)) if all_ious else 0.0,
        "acc@0.25": float(np.mean(ious > 0.25)) if all_ious else 0.0,
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
