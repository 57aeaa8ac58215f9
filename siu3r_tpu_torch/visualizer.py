"""Prediction writer, counterpart of ``siu3r_tpu/visualizer.py`` (reference
src/visualizer.py subset).

Writes the per-scene directory protocol the evaluator consumes
(reference visualizer.py:261-554 / evaluator.py:238-404):

  {scene}_context{id1}_{id2}/
    rgb/{view}.png, rgb_gt/{view}.png          rendered + GT target views
    depth/{view}.png, depth_gt/{view}.png      16-bit mm PNG
    context_seg_pred/{view}_pred.png           RGB-packed 1000*sem+inst
    context_seg_gt/{view}_gt.png
    target_seg_pred/{view}_pred.png, target_seg_gt/{view}_gt.png
    pred.json                                  [{id, label_id, score}]
    gaussians.ply                              optional

Files are written through a thread pool with existence-guard idempotency
(reference :267-273, :340-341). Disk is how the evaluator receives the
predictions; its in-memory ``update_*`` API skips the round trip."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from siu3r_tpu_torch.config import VisualizerCfg


def eval_step_arrays(out, render, qc=None, m2f=None) -> dict:
    """What ``Visualizer.add_eval_step`` draws from one eval step's outputs,
    on the host, each with the batch leading: the rendered ``color`` and
    ``depth``, the context views' panoptic map ``context_seg`` and, with
    ``qc`` and ``m2f``, the lifted label maps ``sem_ids`` and ``ins_ids``
    (threshold 0.3) and the panoptic segments ``seg_infos`` (a list). The
    lift runs where ``qc`` is (about 0.5 GB an item at the full width)."""
    arrays = {"color": render.color.cpu().numpy(), "depth": render.depth.cpu().numpy(),
              "context_seg": out.post["segmentation"].cpu().numpy()}
    if qc is not None:
        from siu3r_tpu_torch.models.mask2former.postprocess import segments_info
        from siu3r_tpu_torch.pipeline import lift_rendered_qc

        arrays["seg_infos"] = segments_info(out.post, m2f.label_ids_to_fuse)
        sem_ids, ins_ids = lift_rendered_qc(qc, out.post["query_scores"], threshold=0.3,
                                            num_queries=m2f.num_queries, stuff_ids=tuple(m2f.label_ids_to_fuse))
        arrays["sem_ids"], arrays["ins_ids"] = sem_ids.cpu().numpy(), ins_ids.cpu().numpy()
    return arrays


def pack_segment_rgb(sem: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """segment_id = 1000*sem + inst -> RGB little-endian base-256
    (reference visualizer.py:486-503)."""
    seg = (1000 * sem.astype(np.int64) + ins.astype(np.int64)).clip(0)
    return np.stack(
        [seg % 256, (seg // 256) % 256, seg // 65536], axis=-1
    ).astype(np.uint8)


def gt_maps(gt_masks, gt_classes, gt_valid):
    """Padded object masks -> (semantic 1-based, instance) id maps [V, H, W]."""
    gm = np.asarray(gt_masks)  # [O, V, H, W]
    gc = np.asarray(gt_classes)
    gv = np.asarray(gt_valid)
    o, v, h, w = gm.shape
    sem = np.zeros((v, h, w), np.int32)
    ins = np.zeros((v, h, w), np.int32)
    for oi in range(o):
        if not gv[oi]:
            continue
        m = gm[oi] > 0.5
        sem[m] = int(gc[oi]) + 1
        ins[m] = oi + 1
    return sem, ins


def _save_png(path: Path, array: np.ndarray, mode: Optional[str] = None) -> None:
    from PIL import Image

    if path.exists():
        return
    Image.fromarray(array, mode=mode).save(path)


class Visualizer:
    def __init__(self, cfg: VisualizerCfg):
        self.cfg = cfg
        self._jobs: List[tuple] = []

    def reset(self) -> None:
        self._jobs = []

    def scene_dir(self, save_dir: str, scene: str, context_ids) -> Path:
        ids = "_".join(str(int(i)) for i in context_ids)
        return Path(save_dir) / f"{scene}_context{ids}"

    def add_scene(
        self,
        save_dir: str,
        scene: str,
        context_ids,
        target_ids,
        render_color: np.ndarray,  # [N, H, W, 3] in [0, 1]
        target_images: np.ndarray,  # [N, H, W, 3]
        render_depth: Optional[np.ndarray] = None,  # [N, H, W] meters
        target_depths: Optional[np.ndarray] = None,
        context_sem_pred: Optional[np.ndarray] = None,  # [V, H, W]
        context_ins_pred: Optional[np.ndarray] = None,
        context_sem_gt: Optional[np.ndarray] = None,
        context_ins_gt: Optional[np.ndarray] = None,
        target_sem_pred: Optional[np.ndarray] = None,  # [N, H, W]
        target_ins_pred: Optional[np.ndarray] = None,
        target_sem_gt: Optional[np.ndarray] = None,
        target_ins_gt: Optional[np.ndarray] = None,
        seg_infos: Optional[List[dict]] = None,
        context_images: Optional[np.ndarray] = None,  # [V, H, W, 3]
        context_seg_map: Optional[np.ndarray] = None,  # [V, H, W] segment ids
        gt_masks: Optional[np.ndarray] = None,  # [O, V, H, W]
        gt_classes: Optional[np.ndarray] = None,  # [O]
        gt_valid: Optional[np.ndarray] = None,  # [O]
        gaussians=None,
    ) -> None:
        d = self.scene_dir(save_dir, scene, context_ids)
        to_u8 = lambda img: (np.clip(img, 0, 1) * 255).astype(np.uint8)
        # 16-bit millimetres (the same PNG bytes as a mode "I" image, which
        # Pillow 13 no longer writes as PNG)
        to_mm = lambda dep: (np.clip(dep, 0, 65.535) * 1000).astype(np.int32).astype(np.uint16)

        for sub in (
            "rgb", "rgb_gt", "depth", "depth_gt",
            "context_seg_pred", "context_seg_gt",
            "target_seg_pred", "target_seg_gt",
        ):
            os.makedirs(d / sub, exist_ok=True)

        for i, vid in enumerate(target_ids):
            vid = int(vid)
            self._jobs.append((d / "rgb" / f"{vid}.png", to_u8(render_color[i]), None))
            self._jobs.append((d / "rgb_gt" / f"{vid}.png", to_u8(target_images[i]), None))
            if render_depth is not None:
                self._jobs.append((d / "depth" / f"{vid}.png", to_mm(render_depth[i]), None))
            if target_depths is not None:
                self._jobs.append((d / "depth_gt" / f"{vid}.png", to_mm(target_depths[i]), None))
            if target_sem_pred is not None:
                self._jobs.append(
                    (d / "target_seg_pred" / f"{vid}_pred.png",
                     pack_segment_rgb(target_sem_pred[i], target_ins_pred[i]), None)
                )
            if target_sem_gt is not None:
                self._jobs.append(
                    (d / "target_seg_gt" / f"{vid}_gt.png",
                     pack_segment_rgb(target_sem_gt[i], target_ins_gt[i]), None)
                )
        for i, vid in enumerate(context_ids):
            vid = int(vid)
            if context_sem_pred is not None:
                self._jobs.append(
                    (d / "context_seg_pred" / f"{vid}_pred.png",
                     pack_segment_rgb(context_sem_pred[i], context_ins_pred[i]), None)
                )
            if context_sem_gt is not None:
                self._jobs.append(
                    (d / "context_seg_gt" / f"{vid}_gt.png",
                     pack_segment_rgb(context_sem_gt[i], context_ins_gt[i]), None)
                )

        # human-readable extras: seg overlays + colored depth (reference
        # visualizer.py overlay/colored-depth outputs)
        from siu3r_tpu_torch.utils.visualize import colorize_depth, overlay_segmentation

        if target_sem_pred is not None:
            os.makedirs(d / "overlay", exist_ok=True)
            for i, vid in enumerate(target_ids):
                self._jobs.append(
                    (d / "overlay" / f"{int(vid)}.png",
                     overlay_segmentation(
                         render_color[i], target_sem_pred[i],
                         target_ins_pred[i], self.cfg.overlay_mask_alpha,
                     ), None)
                )
        if render_depth is not None and self.cfg.log_colored_depth:
            from siu3r_tpu_torch.utils.visualize import colorize_depth_jet

            os.makedirs(d / "depth_colored", exist_ok=True)
            os.makedirs(d / "depth_color", exist_ok=True)
            for i, vid in enumerate(target_ids):
                self._jobs.append(
                    (d / "depth_colored" / f"{int(vid)}.png",
                     colorize_depth(render_depth[i]), None)
                )
                # reference jet grids: log-quantile rendered / min-max GT
                # (visualizer.py:293-330, 346-380)
                self._jobs.append(
                    (d / "depth_color" / f"{int(vid)}.png",
                     colorize_depth_jet(render_depth[i], log_scale=True), None)
                )
            if target_depths is not None:
                os.makedirs(d / "depth_gt_color", exist_ok=True)
                for i, vid in enumerate(target_ids):
                    self._jobs.append(
                        (d / "depth_gt_color" / f"{int(vid)}.png",
                         colorize_depth_jet(target_depths[i], log_scale=False),
                         None)
                    )

        # labeled overlays with contours/boxes/class text over the context
        # views (reference draw_overlay_segm_masks, visualizer.py:556-712).
        # The overlay needs the panoptic SEGMENT-id map matching seg_infos'
        # ids (context_seg_map = post["segmentation"]); the lifted instance
        # ids live in a different id space.
        overlay_map = (
            context_seg_map if context_seg_map is not None else context_ins_pred
        )
        if (
            context_images is not None
            and overlay_map is not None
            and seg_infos is not None
        ):
            from siu3r_tpu_torch.utils.visualize import (
                labeled_gt_overlay,
                labeled_instance_overlay,
            )

            panels = [
                labeled_instance_overlay(
                    context_images, overlay_map, seg_infos,
                    alpha=self.cfg.overlay_mask_alpha,
                )
            ]
            if gt_masks is not None and gt_classes is not None:
                panels.append(
                    labeled_gt_overlay(
                        context_images, gt_masks, gt_classes, gt_valid,
                        alpha=self.cfg.overlay_mask_alpha,
                    )
                )
            self._jobs.append(
                (d / "seg_overlay_labeled.png",
                 np.concatenate(panels, axis=0), None)
            )
        if seg_infos is not None:
            for sub in ("context_seg_pred", "target_seg_pred"):
                with open(d / sub / "pred.json", "w") as f:
                    json.dump(seg_infos, f)
        if gaussians is not None and self.cfg.log_gaussian_ply:
            from siu3r_tpu_torch.io.ply import export_ply

            export_ply(
                means=gaussians.means,
                scales=gaussians.scales,
                rotations=gaussians.rotations,
                harmonics=gaussians.harmonics,
                opacities=gaussians.opacities,
                semantic_labels=gaussians.semantic_labels,
                instance_labels=gaussians.instance_labels,
                seg_query_class_logits=None,
                path=d / "gaussians.ply",
                save_sh_dc_only=self.cfg.save_sh_dc_only,
            )

    def add_eval_step(self, save_dir: str, batch, out, render, qc=None, m2f=None,
                      n_real: Optional[int] = None) -> None:
        """Queue the first ``n_real`` scenes (all by default) of one
        ``Pipeline.eval_step``'s outputs on ``batch``: the renders, the
        context views with their panoptic segment map, and the ground-truth
        masks. With ``qc`` and ``m2f`` (the validation sweep), also the target
        depths, the lifted (threshold 0.3) and ground-truth label maps and the
        panoptic segments; without them (the training loop's visualisation),
        none of these."""
        self.add_eval_arrays(save_dir, batch, eval_step_arrays(out, render, qc, m2f), n_real)

    def add_eval_arrays(self, save_dir: str, batch, arrays: dict, n_real: Optional[int] = None) -> None:
        """``add_eval_step`` from the host arrays ``eval_step_arrays`` gives
        (gathered from the ranks by the data-parallel sweep)."""
        n_real = batch["context_views_images"].shape[0] if n_real is None else n_real
        scenes = batch.get("scene_names")
        for bi in range(n_real):
            ctx_ids, tgt_ids = batch["context_views_id"][bi], batch["target_views_id"][bi]
            seg = {}
            if "sem_ids" in arrays:
                ctx_pos = [int(np.where(tgt_ids == c)[0][0]) for c in ctx_ids]
                sem_gt, ins_gt = gt_maps(batch["target_gt_masks"][bi], batch["target_gt_classes"][bi],
                                         batch["target_gt_valid"][bi])
                sem, ins = arrays["sem_ids"][bi], arrays["ins_ids"][bi]
                seg = dict(target_depths=batch["target_views_depths"][bi], context_sem_pred=sem[ctx_pos],
                           context_ins_pred=ins[ctx_pos], context_sem_gt=sem_gt[ctx_pos],
                           context_ins_gt=ins_gt[ctx_pos], target_sem_pred=sem, target_ins_pred=ins,
                           target_sem_gt=sem_gt, target_ins_gt=ins_gt, seg_infos=arrays["seg_infos"][bi])
            self.add_scene(
                save_dir, scenes[bi] if scenes is not None else f"item{bi}", list(map(int, ctx_ids)),
                list(map(int, tgt_ids)), arrays["color"][bi], batch["target_views_images"][bi],
                render_depth=arrays["depth"][bi], context_images=batch["context_views_images"][bi],
                context_seg_map=arrays["context_seg"][bi], gt_masks=batch["gt_masks"][bi],
                gt_classes=batch["gt_classes"][bi], gt_valid=batch["gt_valid"][bi], **seg,
            )

    def write_files(self, max_workers: int = 8) -> None:
        jobs, self._jobs = self._jobs, []
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            list(pool.map(lambda j: _save_png(j[0], j[1], j[2]), jobs))
