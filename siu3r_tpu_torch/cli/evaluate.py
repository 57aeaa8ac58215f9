"""The evaluator on its own, counterpart of ``siu3r_tpu/cli/evaluate.py``
(reference src/evaluator.py:407-423): evaluates a directory of per-scene
predictions written by the Visualizer and prints (and writes) results.json.

Usage:
    python -m siu3r_tpu_torch.cli.evaluate --eval_path outputs/val/run \
        [--eval_scan_num N] [--lpips_weights lpips_vgg.pth] [--device cuda]

LPIPS runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_path", type=str, required=True)
    parser.add_argument("--eval_scan_num", type=int, default=-1)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
    from siu3r_tpu_torch.eval.evaluator import Evaluator

    cfg = bind_scannet_classes(RootCfg()).pipeline.evaluator
    ev = Evaluator(cfg, lpips_weights=args.lpips_weights, device=args.device)
    result = ev.evaluate(args.eval_path, args.eval_scan_num)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
