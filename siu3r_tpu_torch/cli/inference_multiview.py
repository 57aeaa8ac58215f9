"""Multi-view inference to ``output.ply``, counterpart of
``siu3r_tpu/cli/inference_multiview.py``.

Usage:
    python -m siu3r_tpu_torch.cli.inference_multiview --image_dir imgs/ \
        [--model_path siu3r_4view.ckpt] [--output_path infer_outputs] \
        [--cx 128 --cy 128 --fx 318 --fy 318] [--device cuda]

Reads every image of ``--image_dir`` (sorted by name; at least 2), one view
each, runs the model for that many views (the shared-bank multi-view
backbone above two) with the query-class lift, and writes the fused
Gaussians of every view to ``output.ply`` in the reference schema. Runs on
the GPU unless ``--device cpu`` is given; without ``--model_path`` the
weights are a seeded random init (seed 0).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from siu3r_tpu_torch.cli.inference import add_model_args, model_cfg, run

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", type=str, required=True)
    add_model_args(parser)
    args = parser.parse_args(argv)

    paths = sorted(p for p in Path(args.image_dir).iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if len(paths) < 2:
        raise SystemExit(f"need >= 2 images in {args.image_dir}, got {len(paths)}")
    print(f"[siu3r_tpu_torch] {len(paths)} views from {args.image_dir}")
    return run(args, paths, model_cfg(len(paths)))


if __name__ == "__main__":
    main()
