"""File-driven evaluator, counterpart of ``siu3r_tpu/eval/evaluator.py``
(reference src/evaluator.py:28-423).

Walks per-scene prediction directories written by the Visualizer and
computes: PSNR/SSIM/LPIPS per target view, mIoU, panoptic quality,
COCO-style segmentation mAP (stuff excluded from instances, +1 id
alignment), and scale/shift-aligned depth AbsRel/RMSE; writes
``results.json``. Also exposes an in-memory ``update_*`` API so a val sweep
can skip the disk round-trip entirely.

LPIPS runs through ``siu3r_tpu_torch/train/lpips.py`` on the evaluator's
device (``cuda`` unless the caller names the CPU): the VGG of
``lpips_weights`` where that file exists, else the fixed-seed random VGG
(``compute()`` then reports ``"lpips_pretrained": false``), or the
parameters the caller passes as ``lpips_params``."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from siu3r_tpu_torch.config import EvaluatorCfg
from siu3r_tpu_torch.device import resolve_device
from siu3r_tpu_torch.eval import metrics as M


def _load_image(path: Path, normalize: bool = True) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path)).astype(np.float32)
    return img / 255.0 if normalize else img


def _unpack_seg(path: Path):
    from PIL import Image

    rgb = np.asarray(Image.open(path)).astype(np.int64)
    seg = rgb[..., 0] + rgb[..., 1] * 256 + rgb[..., 2] * 65536
    return seg // 1000, seg % 1000


class Evaluator:
    def __init__(self, cfg: EvaluatorCfg, lpips_weights: Optional[str] = None,
                 device: str | torch.device = "cuda", lpips_params: Optional[dict] = None):
        self.cfg = cfg
        self.things = [t + 1 for t in cfg.things]
        self.stuffs = [s + 1 for s in cfg.stuffs]
        self._lpips_weights = lpips_weights
        self.device = resolve_device(device)
        self._given_lpips_params = lpips_params
        self.setup()

    def setup(self) -> None:
        n_cls = len(self.cfg.id2label) + 1
        self.target_psnr: List[float] = []
        self.target_ssim: List[float] = []
        self.target_lpips: List[float] = []
        self.target_absrels: List[float] = []
        self.target_rmses: List[float] = []
        self.context_miou = M.MeanIoU(n_cls)
        self.target_miou = M.MeanIoU(n_cls)
        self.context_pq = M.PanopticQuality(self.things, self.stuffs)
        self.target_pq = M.PanopticQuality(self.things, self.stuffs)
        self.context_map = M.MeanAveragePrecision()
        self.target_map = M.MeanAveragePrecision()
        self._lpips_params = self._given_lpips_params

    @torch.inference_mode()
    def _lpips(self, pred: np.ndarray, target: np.ndarray) -> float:
        from siu3r_tpu_torch.train import lpips as lp

        if self._lpips_params is None:
            self._lpips_params = lp.init_lpips_params(self._lpips_weights, device=self.device)
        as_batch = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))[None].to(self.device)
        return float(lp.lpips(self._lpips_params, as_batch(pred), as_batch(target)))

    # -- in-memory updates --------------------------------------------------
    def update_image_quality(self, pred: np.ndarray, target: np.ndarray) -> Dict:
        res = {
            "psnr": M.psnr(pred, target),
            "ssim": M.ssim(pred, target),
            "lpips": self._lpips(pred, target),
        }
        self.target_psnr.append(res["psnr"])
        self.target_ssim.append(res["ssim"])
        self.target_lpips.append(res["lpips"])
        return res

    def update_depth(self, pred: np.ndarray, gt: np.ndarray) -> Dict:
        absrel, rmse = M.depth_errors(pred, gt)
        self.target_absrels.append(absrel)
        self.target_rmses.append(rmse)
        return {"absrel": absrel, "rmse": rmse}

    def _map_entries(self, sem, ins, pred_infos=None):
        """Build instance masks/labels for mAP (reference evaluator.py
        :152-227): ids +1-aligned, stuff excluded from GT, labels 0-based."""
        masks, labels, scores = [], [], []
        for iid in np.unique(ins):
            if iid == 0:
                continue
            m = ins == iid
            label = int(sem[m][0]) - 1
            if pred_infos is None:
                if label + 1 in self.stuffs:
                    continue
                masks.append(m)
                labels.append(label)
            else:
                infos = [i for i in pred_infos if i["id"] == iid]
                if infos:
                    masks.append(m)
                    labels.append(infos[0]["label_id"] - 1)
                    scores.append(float(np.mean([i["score"] for i in infos])))
                else:
                    masks.append(m)
                    labels.append(label)
                    scores.append(1.0)
        h, w = sem.shape[-2:]
        out = {
            "masks": np.asarray(masks, bool).reshape(-1, *sem.shape),
            "labels": np.asarray(labels, np.int64),
        }
        if pred_infos is not None:
            out["scores"] = np.asarray(scores, np.float64)
        return out

    def update_segmentation(
        self,
        which: str,  # "context" | "target"
        pred_sem: np.ndarray,
        pred_ins: np.ndarray,
        gt_sem: np.ndarray,
        gt_ins: np.ndarray,
        pred_infos: Optional[List[dict]] = None,
    ) -> None:
        miou = self.context_miou if which == "context" else self.target_miou
        pq = self.context_pq if which == "context" else self.target_pq
        mapm = self.context_map if which == "context" else self.target_map
        miou.update(pred_sem, gt_sem)
        pq.update(
            np.stack([pred_sem, pred_ins], -1), np.stack([gt_sem, gt_ins], -1)
        )
        pred_entry = self._map_entries(pred_sem, pred_ins, pred_infos or [])
        gt_entry = self._map_entries(gt_sem, gt_ins, None)
        mapm.update(pred_entry, gt_entry)

    # -- file-driven protocol -----------------------------------------------
    def evaluate(self, path: str, eval_scan_num: int = -1) -> Dict:
        eval_path = Path(path)
        scene_dirs = sorted(d for d in eval_path.iterdir() if d.is_dir())
        if eval_scan_num > 0:
            scene_dirs = scene_dirs[:eval_scan_num]
        for scene_dir in scene_dirs:
            if self.cfg.eval_image_quality and (scene_dir / "rgb").exists():
                scores = []
                for item in sorted((scene_dir / "rgb").glob("*.png")):
                    rgb = _load_image(item)
                    rgb_gt = _load_image(scene_dir / "rgb_gt" / item.name)
                    scores.append(
                        {"item": item.name, **self.update_image_quality(rgb, rgb_gt)}
                    )
                with open(scene_dir / "render_scores.json", "w") as f:
                    json.dump(scores, f, indent=4)
            for which in ("context", "target"):
                pred_dir = scene_dir / f"{which}_seg_pred"
                gt_dir = scene_dir / f"{which}_seg_gt"
                if not pred_dir.exists():
                    continue
                infos = None
                if (pred_dir / "pred.json").exists():
                    with open(pred_dir / "pred.json") as f:
                        infos = json.load(f)
                sems_p, inss_p, sems_g, inss_g = [], [], [], []
                for item in sorted(pred_dir.glob("*.png")):
                    ps, pi = _unpack_seg(item)
                    gs, gi = _unpack_seg(gt_dir / item.name.replace("pred", "gt"))
                    sems_p.append(ps)
                    inss_p.append(pi)
                    sems_g.append(gs)
                    inss_g.append(gi)
                if not sems_p:
                    continue
                # views concatenated along height (reference :146-150)
                self.update_segmentation(
                    which,
                    np.concatenate(sems_p, 0),
                    np.concatenate(inss_p, 0),
                    np.concatenate(sems_g, 0),
                    np.concatenate(inss_g, 0),
                    infos,
                )
            if self.cfg.eval_depth_quality and (scene_dir / "depth").exists():
                scores = []
                for item in sorted((scene_dir / "depth").glob("*.png")):
                    d = _load_image(item, normalize=False) / 1000.0
                    dg = _load_image(scene_dir / "depth_gt" / item.name, normalize=False) / 1000.0
                    absrel_rmse = self.update_depth(d, dg)
                    scores.append({"item": item.name, **absrel_rmse})
                with open(scene_dir / "depth_scores.json", "w") as f:
                    json.dump(scores, f, indent=4)

        result = self.compute()
        with open(eval_path / "results.json", "w") as f:
            json.dump(result, f, indent=4)
        return result

    def compute(self) -> Dict:
        result: Dict = {}
        if self.target_psnr:
            result["psnr"] = float(np.mean(self.target_psnr))
            result["ssim"] = float(np.mean(self.target_ssim))
            result["lpips"] = float(np.mean(self.target_lpips))
            # surface the random-VGG fallback (zero-egress environments):
            # lpips values are not reference-comparable unless pretrained
            if self._lpips_params is not None:
                result["lpips_pretrained"] = bool(
                    self._lpips_params.get("pretrained", False)
                )
        if self.target_absrels:
            result["absrel"] = float(np.mean(self.target_absrels))
            result["rmse"] = float(np.mean(self.target_rmses))
        for which in ("context", "target"):
            miou = getattr(self, f"{which}_miou")
            per = miou.compute()
            if per.size:
                result[f"{which}_ious_per_class"] = per.tolist()
                result[f"{which}_miou"] = float(per.mean())
            pq = getattr(self, f"{which}_pq").compute()
            if pq.size:
                result[f"{which}_pqs_per_class"] = pq.tolist()
                result[f"{which}_pq"] = float(pq.mean())
            mapm = getattr(self, f"{which}_map")
            if mapm.preds:
                result[f"{which}_map"] = mapm.compute()
        return result
