"""Two-view inference to ``output.ply``, counterpart of
``siu3r_tpu/cli/inference.py``.

Usage:
    python -m siu3r_tpu_torch.cli.inference \
        --image_path1 a.jpg --image_path2 b.jpg [--model_path x.ckpt] \
        [--output_path infer_outputs] [--cx 128 --cy 128 --fx 318 --fy 318] \
        [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. ``--model_path`` takes the
reference's Lightning ``.ckpt``; without it the weights are a seeded random
init (seed 0). The PLY carries the reference schema: positions, zero
normals, SH, opacity, log scales, wxyz rotations, semantic and instance
labels and the per-query class confidences.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def preprocess_image(image_path) -> np.ndarray:
    """Shortest side to 256 (LANCZOS), centre crop 256x256, float [0, 1] HWC."""
    from PIL import Image

    image = Image.open(image_path).convert("RGB")
    w, h = image.size
    if w < h:
        new_w, new_h = 256, int(h * (256 / w))
        image = image.resize((new_w, new_h), Image.Resampling.LANCZOS)
        top = (new_h - 256) // 2
        image = image.crop((0, top, new_w, top + 256))
    else:
        new_h, new_w = 256, int(w * (256 / h))
        image = image.resize((new_w, new_h), Image.Resampling.LANCZOS)
        left = (new_w - 256) // 2
        image = image.crop((left, 0, left + 256, new_h))
    return np.asarray(image, dtype=np.float32) / 255.0


def model_cfg(num_views: int = 2):
    """The full-width ScanNet model's config (ViT-L CroCo, 256x256) for
    ``num_views`` views."""
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes

    cfg = bind_scannet_classes(RootCfg()).pipeline.model
    cfg.num_views = num_views
    return cfg


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The options both inference CLIs take besides their images."""
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="infer_outputs")
    parser.add_argument("--cx", type=float, default=128.0)
    parser.add_argument("--cy", type=float, default=128.0)
    parser.add_argument("--fx", type=float, default=318.0)
    parser.add_argument("--fy", type=float, default=318.0)
    parser.add_argument("--save_sh_dc_only", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")


def run(args: argparse.Namespace, image_paths, cfg) -> Path:
    """The forward of ``cfg``'s model over ``image_paths`` (one view each, in
    order) with the query-class lift, written to ``output.ply`` under
    ``args.output_path``; returns its path."""
    from siu3r_tpu_torch.device import resolve_device
    from siu3r_tpu_torch.io import export_ply
    from siu3r_tpu_torch.models.model import build_model
    from siu3r_tpu_torch.weights import load_checkpoint

    device = resolve_device(args.device)
    images = np.stack([preprocess_image(p) for p in image_paths])[None]  # [1, V, 256, 256, 3]
    v = images.shape[1]
    intr = np.array(
        [[args.fx / 256.0, 0, args.cx / 256.0], [0, args.fy / 256.0, args.cy / 256.0], [0, 0, 1]],
        dtype=np.float32,
    )
    images_t = torch.from_numpy(images).to(device)
    intr_t = torch.from_numpy(np.stack([intr] * v)[None]).to(device)

    model = build_model(cfg, device=device, seed=0)
    if args.model_path is None:
        print("[siu3r_tpu_torch] no checkpoint given - seeded random init (seed 0)")
    else:
        load_checkpoint(model, args.model_path)

    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(images_t, intr_t, enable_query_class_logit_lift=True)
    g = out.gaussians.to_host()
    print(f"[siu3r_tpu_torch] forward in {time.perf_counter() - t0:.1f}s on {device} "
          f"({g.means.shape[1]} gaussians from {v} views)")

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    export_ply(
        means=g.means[0],
        scales=g.scales[0],
        rotations=g.rotations[0],
        harmonics=g.harmonics[0],
        opacities=g.opacities[0],
        semantic_labels=g.semantic_labels[0],
        instance_labels=g.instance_labels[0],
        seg_query_class_logits=g.seg_query_class_logits[0],
        path=out_dir / "output.ply",
        shift_and_scale=False,
        save_sh_dc_only=args.save_sh_dc_only,
    )
    print(f"[siu3r_tpu_torch] wrote {out_dir / 'output.ply'}")
    return out_dir / "output.ply"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path1", type=str, required=True)
    parser.add_argument("--image_path2", type=str, required=True)
    add_model_args(parser)
    args = parser.parse_args(argv)
    run(args, [args.image_path1, args.image_path2], model_cfg(2))


if __name__ == "__main__":
    main()
