"""Dense panoptic post-process and the Gaussian query-class lift, counterpart
of ``siu3r_tpu/models/mask2former/postprocess.py`` (``panoptic_segmentation``,
``qc_logits_per_pixel``, ``instance_segmentation`` and the host-side
``segments_info``).

Masks are resized to the fixed 256x256 mask size, sigmoided, then resized to
the target size; each pixel goes to the kept query with the highest
score-weighted probability (first index on ties); queries failing the
area-ratio check leave their pixels unassigned; stuff classes in
``label_ids_to_fuse`` share one segment id; kept queries are packed into
``max_lift_queries`` slots. With word logits (text-referred segmentation)
only the queries that some word argmaxes to are kept. Everything, the
sequential segment-id assignment included, runs on the device with no copy
to the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from siu3r_tpu_torch.models.layers import resize_nhwc

MASK_SIZE = (256, 256)


def _resize_sigmoid_resize(ml: torch.Tensor, target_size: Tuple[int, int]) -> torch.Tensor:
    """[N, mh, mw] mask logits -> [N, th, tw] probabilities."""
    x = resize_nhwc(ml[..., None], MASK_SIZE, align_corners=False)
    x = resize_nhwc(torch.sigmoid(x), target_size, align_corners=False)
    return x[..., 0]


def _segment_ids(exists: torch.Tensor, labels: torch.Tensor, fuse_ids: Sequence[int]) -> torch.Tensor:
    """Sequential segment ids in query order over [B, Q] flags (0 where a
    query does not exist); a fused (stuff) label reuses the id of its first
    segment. The query loop of the JAX package's ``lax.scan`` becomes a
    [B, Q, Q] comparison: a query opens a new id unless its label is fused and
    an earlier existing query has it; new ids are a running count."""
    q = exists.shape[1]
    fused = torch.zeros_like(exists)
    for lbl in fuse_ids:
        fused |= labels == int(lbl)
    same = (labels[:, :, None] == labels[:, None, :]) & exists[:, None, :]  # [B, k, j]
    earlier = torch.ones(q, q, dtype=torch.bool, device=exists.device).tril(-1)
    opens = exists & ~(fused & (same & earlier).any(dim=-1))
    new_id = torch.cumsum(opens, dim=1)
    first = same.to(torch.uint8).argmax(dim=-1)  # first existing query with the label
    reused = torch.gather(new_id, 1, first)
    return torch.where(opens, new_id, torch.where(exists, reused, torch.zeros_like(new_id)))


def panoptic_segmentation(
    class_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    *,
    target_size: Tuple[int, int],
    label_ids_to_fuse: Sequence[int],
    num_labels: int,
    max_lift_queries: int = 16,
    threshold: float = 0.5,
    mask_threshold: float = 0.5,
    overlap_area_threshold: float = 0.8,
    word_logits: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """class_logits [B, Q, C+1]; mask_logits [B, Q, V, h, w]; word_logits
    optional [B, n_words, Q]. Returns the JAX package's dense dict (segment
    ids and semantic labels [B, V, H, W], per-query flags [B, Q], lift slots
    [B, S, ...])."""
    b, q, v, mh, mw = mask_logits.shape
    th, tw = target_size
    dev = mask_logits.device
    s = max_lift_queries

    class_probs = torch.softmax(class_logits, dim=-1)
    pred_scores, pred_labels = class_probs.max(dim=-1)
    keep = (pred_labels != num_labels) & (pred_scores > threshold)
    if word_logits is not None:
        # keep only the queries that some word argmaxes to
        preserve = torch.zeros_like(keep).scatter_(1, word_logits.argmax(dim=-1), True)
        keep = keep & preserve

    probs = _resize_sigmoid_resize(mask_logits.reshape(b * q * v, mh, mw), (th, tw))
    w = probs.reshape(b, q, v, th, tw) * pred_scores[:, :, None, None, None]
    original_area = (w >= mask_threshold).sum(dim=(2, 3, 4))
    wm = torch.where(keep[:, :, None, None, None], w, torch.full_like(w, -1.0))
    pixel_query = wm.argmax(dim=1)  # [B, V, H, W]
    del probs, w, wm

    flat_pq = pixel_query.reshape(b, -1)
    counts = torch.zeros((b, q), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_pq, torch.ones_like(flat_pq)
    )
    mask_area = torch.where(keep, counts, torch.zeros_like(counts))
    ratio = mask_area / original_area.clamp(min=1)
    exists = keep & (mask_area > 0) & (original_area > 0) & (ratio > overlap_area_threshold)

    seg_ids = _segment_ids(exists, pred_labels, label_ids_to_fuse)

    gather = lambda t: torch.gather(t, 1, flat_pq).reshape(pixel_query.shape)
    pix_exists = gather(exists)
    zero = torch.zeros_like(pixel_query)
    segmentation = torch.where(pix_exists, gather(seg_ids), zero)
    segmentation = torch.where(keep.any(dim=1)[:, None, None, None], segmentation, zero - 1)
    semantic = torch.where(pix_exists, gather(pred_labels) + 1, zero)

    slot = torch.where(exists, torch.cumsum(exists, dim=1) - 1, torch.full_like(counts, q + s))
    lifted = exists & (slot < s)

    # pack lifted queries into slots; slot s collects the rest and is dropped
    tgt = torch.where(lifted, slot, torch.full_like(slot, s))
    ar_q = torch.arange(q, device=dev).expand(b, q)
    lift_q = torch.zeros((b, s + 1), dtype=torch.int64, device=dev).scatter_(1, tgt, ar_q)[:, :s]
    valid = torch.zeros((b, s + 1), dtype=torch.bool, device=dev).scatter_(1, tgt, lifted)[:, :s]
    ar_b = torch.arange(b, device=dev)[:, None]
    sel = mask_logits[ar_b, lift_q]  # [B, S, V, mh, mw]
    sel_probs = _resize_sigmoid_resize(sel.reshape(b * s * v, mh, mw), (th, tw)).reshape(b, s, v, th, tw)
    qc_mask = torch.where(valid[:, :, None, None, None], sel_probs, torch.zeros_like(sel_probs))
    qc_class = torch.where(valid[:, :, None], class_probs[ar_b, lift_q], class_probs.new_zeros(()))
    query_scores = torch.where(valid, pred_scores[ar_b, lift_q], pred_scores.new_zeros(()))
    # no query lifted: one pseudo-query with no-object probability 1
    none_kept = ~lifted.any(dim=1)
    fb_class = torch.zeros_like(qc_class)
    fb_class[:, 0, num_labels].fill_(1.0)
    fb_mask = torch.zeros_like(qc_mask)
    fb_mask[:, 0].fill_(1.0)
    qc_class = torch.where(none_kept[:, None, None], fb_class, qc_class)
    qc_mask = torch.where(none_kept[:, None, None, None, None], fb_mask, qc_mask)

    return {
        "segmentation": segmentation.to(torch.int32),  # [B, V, H, W] segment ids (0 = bg)
        "semantic": semantic.to(torch.int32),  # [B, V, H, W] label+1 (0 = bg)
        "keep": keep,
        "exists": exists,
        "seg_ids": seg_ids,
        "pred_labels": pred_labels,
        "pred_scores": pred_scores,
        "lift_slot": slot,
        "lifted": lifted,
        "qc_class_probs": qc_class,  # [B, S, C+1]
        "qc_mask_probs": qc_mask,  # [B, S, V, H, W]
        "query_scores": query_scores,  # [B, S]
        "qc_valid": valid,  # [B, S]
    }


def qc_logits_per_pixel(result: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-Gaussian query-class confidence class_probs x mask_probs:
    [B, V*H*W, S, C+1]."""
    qc_class = result["qc_class_probs"]
    qc_mask = result["qc_mask_probs"]
    b, s, v, h, w = qc_mask.shape
    prod = qc_class[:, :, None, :] * qc_mask.reshape(b, s, v * h * w)[..., None]
    return prod.transpose(1, 2)


def instance_segmentation(
    class_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    *,
    target_size: Tuple[int, int],
    num_labels: int,
    num_topk: int = 10,
    threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Instance post-processing (reference
    image_processing_video_mask2former.py:1057-1237): the top ``num_topk``
    (query, class) pairs by class score (ties to the lower index, as
    ``lax.top_k``), masks binarised at logit 0, mask-quality-weighted scores,
    sequential instance ids in top-k order with later instances overwriting
    overlaps; the per-query confidence factored as (class_probs, mask_probs).
    class_logits [B, Q, C+1], mask_logits [B, Q, V, h, w]."""
    b, q, v, mh, mw = mask_logits.shape
    th, tw = target_size
    k = num_topk
    ml = resize_nhwc(mask_logits.reshape(b * q * v, mh, mw, 1), MASK_SIZE, align_corners=False)
    ml = ml.reshape(b, q, v, *MASK_SIZE)
    class_probs = torch.softmax(class_logits, dim=-1)
    flat = class_probs[..., :-1].reshape(b, -1)  # [B, Q*C]
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    labels = top_idx % num_labels
    queries = top_idx // num_labels
    sel = ml[torch.arange(b, device=ml.device)[:, None], queries]  # [B, K, V, 256, 256]
    binarized = (sel > 0).to(sel.dtype)
    area = binarized.sum(dim=(2, 3, 4))
    mask_quality = (torch.sigmoid(sel) * binarized).sum(dim=(2, 3, 4)) / (area + 1e-6)
    pred_scores = top_scores * mask_quality
    resized = resize_nhwc(binarized.reshape(b * k * v, *MASK_SIZE, 1), (th, tw), align_corners=False)
    resized = resized.reshape(b, k, v, th, tw)
    keep = (pred_scores >= threshold) & (area > 0)
    seg = torch.full((b, v, th, tw), -1, dtype=torch.int32, device=ml.device)
    seg_id = (torch.cumsum(keep, dim=1) - 1).to(torch.int32)
    for j in range(k):
        write = keep[:, j, None, None, None] & (resized[:, j] == 1.0)
        seg = torch.where(write, seg_id[:, j, None, None, None], seg)
    mask_probs = torch.sigmoid(resize_nhwc(ml.reshape(b * q * v, *MASK_SIZE, 1), (th, tw), align_corners=False))
    return {
        "segmentation": seg,  # [B, V, H, W], -1 background
        "labels": labels,  # [B, K]
        "queries": queries,
        "scores": pred_scores,
        "valid": keep,
        "class_probs": class_probs,  # [B, Q, C+1] (confidence factor 1)
        "mask_probs": mask_probs.reshape(b, q, v, th, tw),  # (confidence factor 2)
    }


def segments_info(result: Dict[str, torch.Tensor], fuse_ids: Sequence[int]) -> List[List[dict]]:
    """The reference's ``segments_info`` list for each batch item, on the host:
    one {"id", "label_id", "was_fused", "score"} per query that got a segment,
    in query order, from ``panoptic_segmentation``'s ``exists``, ``seg_ids``,
    ``pred_labels`` and ``pred_scores``."""
    exists, seg_ids, labels, scores = (result[k].cpu().numpy()
                                       for k in ("exists", "seg_ids", "pred_labels", "pred_scores"))
    fuse = {int(x) for x in fuse_ids}
    out = []
    for bi in range(exists.shape[0]):
        infos = []
        for k in range(exists.shape[1]):
            if not exists[bi, k]:
                continue
            lbl = int(labels[bi, k])
            infos.append({"id": int(seg_ids[bi, k]), "label_id": lbl, "was_fused": lbl in fuse,
                          "score": round(float(scores[bi, k]), 6)})
        out.append(infos)
    return out
