"""Evaluation metrics (numpy): PSNR, SSIM, streaming mean-IoU, panoptic
quality, COCO-style segmentation mAP, scale/shift-aligned depth errors and
the referred-mask IoU; a copy of ``siu3r_tpu/eval/metrics.py``.

Functional re-implementations of the metrics the reference pulls from
torchmetrics (src/evaluator.py:49-109) and its custom MeanIoU
(src/utils/miou.py:34-77). Definition notes:
  * PSNR/SSIM use data_range=1.0 (images are stored as 8-bit PNG / 255);
  * MeanIoU is a streaming per-class intersection/union accumulator over
    classes 1..C with background (0) excluded, reported per class over
    classes that appeared;
  * PanopticQuality follows the standard PQ = sum(IoU of TP) /
    (TP + FP/2 + FN/2) with IoU>0.5 matching, stuff classes as single
    segments, per-class output averaged over observed classes;
  * mAP is COCO-style mask AP over IoU 0.50:0.95 with 101-point
    interpolation (all areas, maxDet 100).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((pred.astype(np.float64) - target.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """pred/target [H, W, C] float. Standard SSIM (gaussian 11x1.5)."""
    from scipy.signal import fftconvolve

    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filt(img):
        return np.stack(
            [fftconvolve(img[..., c], k, mode="valid") for c in range(img.shape[-1])],
            axis=-1,
        )

    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    mu_p = filt(pred)
    mu_t = filt(target)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_pp = filt(pred * pred) - mu_pp
    sigma_tt = filt(target * target) - mu_tt
    sigma_pt = filt(pred * target) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    )
    return float(ssim_map.mean())


class MeanIoU:
    """Streaming per-class IoU (reference src/utils/miou.py:34-77: classes
    1..num_classes, background 0 excluded, per-class result over classes
    seen in either pred or gt)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.intersection = np.zeros(num_classes, np.int64)
        self.union = np.zeros(num_classes, np.int64)
        self.seen = np.zeros(num_classes, bool)

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        for c in range(1, self.num_classes):
            p = pred == c
            t = target == c
            inter = np.logical_and(p, t).sum()
            union = np.logical_or(p, t).sum()
            self.intersection[c] += inter
            self.union[c] += union
            if union > 0:
                self.seen[c] = True

    def compute(self) -> np.ndarray:
        classes = np.where(self.seen)[0]
        return np.array(
            [self.intersection[c] / max(self.union[c], 1) for c in classes]
        )


class PanopticQuality:
    """PQ with torchmetrics semantics: ``things``/``stuffs`` are 1-based
    category ids; inputs are [..., 2] (semantic, instance) maps; unknown
    prediction categories allowed (counted as void)."""

    def __init__(self, things: Sequence[int], stuffs: Sequence[int]):
        self.things = set(int(t) for t in things)
        self.stuffs = set(int(s) for s in stuffs)
        cats = sorted(self.things | self.stuffs)
        self.iou_sum = {c: 0.0 for c in cats}
        self.tp = {c: 0 for c in cats}
        self.fp = {c: 0 for c in cats}
        self.fn = {c: 0 for c in cats}
        self.seen = {c: False for c in cats}

    def _segments(self, sem: np.ndarray, ins: np.ndarray):
        """-> dict[(cat, seg_key)] = mask. Stuff: one segment per category."""
        segs = {}
        for c in self.stuffs:
            m = sem == c
            if m.any():
                segs[(c, 0)] = m
        for c in self.things:
            cm = sem == c
            if not cm.any():
                continue
            for iid in np.unique(ins[cm]):
                segs[(c, int(iid))] = cm & (ins == iid)
        return segs

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        """pred/target [..., 2] (semantic, instance)."""
        psem, pins = pred[..., 0], pred[..., 1]
        tsem, tins = target[..., 0], target[..., 1]
        pred_segs = self._segments(psem, pins)
        gt_segs = self._segments(tsem, tins)
        void = ~np.isin(tsem, list(self.iou_sum.keys()))

        matched_pred, matched_gt = set(), set()
        for gk, gmask in gt_segs.items():
            self.seen[gk[0]] = True
            best = None
            for pk, pmask in pred_segs.items():
                if pk[0] != gk[0] or pk in matched_pred:
                    continue
                inter = np.logical_and(gmask, pmask).sum()
                if inter == 0:
                    continue
                union = np.logical_or(gmask, pmask).sum() - np.logical_and(
                    pmask, void
                ).sum()
                iou = inter / max(union, 1)
                if iou > 0.5 and (best is None or iou > best[1]):
                    best = (pk, iou)
            if best is not None:
                self.tp[gk[0]] += 1
                self.iou_sum[gk[0]] += best[1]
                matched_pred.add(best[0])
                matched_gt.add(gk)
            else:
                self.fn[gk[0]] += 1
        for pk, pmask in pred_segs.items():
            if pk in matched_pred:
                continue
            # ignore predictions mostly covering void
            if np.logical_and(pmask, void).sum() / max(pmask.sum(), 1) > 0.5:
                continue
            if pk[0] in self.fp:
                self.fp[pk[0]] += 1
                self.seen[pk[0]] = True

    def compute(self) -> np.ndarray:
        out = []
        for c, s in self.seen.items():
            if not s:
                continue
            denom = self.tp[c] + 0.5 * self.fp[c] + 0.5 * self.fn[c]
            out.append(self.iou_sum[c] / denom if denom > 0 else 0.0)
        return np.array(out)


@dataclasses.dataclass
class _MapEntry:
    masks: np.ndarray  # [N, H, W] bool
    labels: np.ndarray  # [N]
    scores: Optional[np.ndarray] = None


class MeanAveragePrecision:
    """COCO-style mask mAP (IoU 0.50:0.95, 101-pt interpolation)."""

    IOUS = np.arange(0.5, 1.0, 0.05)

    def __init__(self):
        self.preds: List[_MapEntry] = []
        self.gts: List[_MapEntry] = []

    def update(self, preds: Dict, gts: Dict) -> None:
        self.preds.append(
            _MapEntry(
                np.asarray(preds["masks"], bool),
                np.asarray(preds["labels"]),
                np.asarray(preds["scores"], np.float64),
            )
        )
        self.gts.append(_MapEntry(np.asarray(gts["masks"], bool), np.asarray(gts["labels"])))

    @staticmethod
    def _mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """a [N, H*W], b [M, H*W] bool -> [N, M]."""
        a = a.reshape(a.shape[0], -1)
        b = b.reshape(b.shape[0], -1)
        inter = (a[:, None] & b[None]).sum(-1).astype(np.float64)
        union = (a[:, None] | b[None]).sum(-1).astype(np.float64)
        return np.where(union > 0, inter / np.maximum(union, 1), 0.0)

    def compute(self) -> Dict[str, float]:
        classes = sorted(
            set(
                int(c)
                for e in self.preds + self.gts
                for c in np.unique(e.labels)
            )
        )
        recall_grid = np.linspace(0, 1, 101)
        aps = []
        ap50s, ap75s = [], []
        for c in classes:
            # collect detections/gt per image
            scores_all, matches_all = [], []  # matches per iou threshold
            n_gt = 0
            for pred, gt in zip(self.preds, self.gts):
                p_idx = np.where(pred.labels == c)[0]
                g_idx = np.where(gt.labels == c)[0]
                n_gt += len(g_idx)
                if len(p_idx) == 0:
                    continue
                order = np.argsort(-pred.scores[p_idx])
                p_idx = p_idx[order]
                iou = (
                    self._mask_iou(pred.masks[p_idx], gt.masks[g_idx])
                    if len(g_idx)
                    else np.zeros((len(p_idx), 0))
                )
                m = np.zeros((len(self.IOUS), len(p_idx)), bool)
                for ti, thr in enumerate(self.IOUS):
                    taken = np.zeros(len(g_idx), bool)
                    for di in range(len(p_idx)):
                        best, bi = thr, -1
                        for gi in range(len(g_idx)):
                            if taken[gi] or iou[di, gi] < best:
                                continue
                            best, bi = iou[di, gi], gi
                        if bi >= 0:
                            taken[bi] = True
                            m[ti, di] = True
                scores_all.append(pred.scores[p_idx])
                matches_all.append(m)
            if n_gt == 0:
                continue
            if not scores_all:
                aps.append(0.0)
                ap50s.append(0.0)
                ap75s.append(0.0)
                continue
            scores_cat = np.concatenate(scores_all)
            matches_cat = np.concatenate(matches_all, axis=1)
            order = np.argsort(-scores_cat)
            matches_cat = matches_cat[:, order]
            per_thr = []
            for ti in range(len(self.IOUS)):
                tp = np.cumsum(matches_cat[ti])
                fp = np.cumsum(~matches_cat[ti])
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1)
                # monotone precision envelope
                for i in range(len(precision) - 2, -1, -1):
                    precision[i] = max(precision[i], precision[i + 1])
                interp = np.zeros_like(recall_grid)
                idx = np.searchsorted(recall, recall_grid, side="left")
                valid = idx < len(precision)
                interp[valid] = precision[idx[valid]]
                per_thr.append(interp.mean())
            aps.append(float(np.mean(per_thr)))
            ap50s.append(per_thr[0])
            ap75s.append(per_thr[5])
        if not aps:
            return {"map": -1.0, "map_50": -1.0, "map_75": -1.0}
        return {
            "map": float(np.mean(aps)),
            "map_50": float(np.mean(ap50s)),
            "map_75": float(np.mean(ap75s)),
        }


def fit_scale_and_shift(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """Least-squares scale+shift on valid gt pixels
    (reference evaluator.py:229-236)."""
    valid = gt > 0
    pv = pred[valid].astype(np.float64)
    gv = gt[valid].astype(np.float64)
    a = np.stack([pv, np.ones_like(pv)], axis=1)
    sol, *_ = np.linalg.lstsq(a, gv, rcond=None)
    return float(sol[0]), float(sol[1])


def depth_errors(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(absrel, rmse) after scale/shift fit (reference evaluator.py:333-366)."""
    scale, shift = fit_scale_and_shift(pred, gt)
    aligned = pred * scale + shift
    valid = gt > 0
    diff = aligned[valid] - gt[valid]
    absrel = float(np.mean(np.abs(diff) / gt[valid]))
    rmse = float(np.sqrt(np.mean(diff**2)))
    return absrel, rmse


def referred_mask_iou(
    pred_masks: np.ndarray, gt_masks: np.ndarray, gt_valid: np.ndarray
) -> Tuple[float, np.ndarray]:
    """Referring-expression evaluation: per-word mask IoU.

    pred_masks [W, V, H, W'] bool — the argmax-query mask per word,
    upsampled to GT resolution (Pipeline.refer_eval_step); gt_masks
    [O, V, H, W'] binary with word i <-> object i; gt_valid [O] bool.
    Returns (mean IoU over valid words, per-word IoU array). The reference
    ships no refer evaluator (its refer path stops at the training loss);
    mask-IoU over referred objects is the standard ScanRefer protocol."""
    n = min(pred_masks.shape[0], gt_masks.shape[0])
    ious = []
    for i in range(n):
        if not gt_valid[i]:
            continue
        p = pred_masks[i].astype(bool)
        g = gt_masks[i] > 0.5
        union = np.logical_or(p, g).sum()
        inter = np.logical_and(p, g).sum()
        ious.append(float(inter) / float(union) if union else 1.0)
    per_word = np.asarray(ious, np.float64)
    return (float(per_word.mean()) if len(per_word) else 0.0), per_word
