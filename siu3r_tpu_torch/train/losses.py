"""Training losses, counterpart of ``siu3r_tpu/train/losses.py``.

The segmentation criterion of the reference's VideoMask2FormerLoss:
Hungarian-matched cross-entropy over the classes (no-object weight 0.1) and
point-sampled sigmoid-BCE and dice mask losses with uncertainty-based
sampling (12544 points, oversample 3, importance 0.75), for the final and
every auxiliary decoder state. Then the pipeline's instance-masked depth
smoothness and render MSE, and the refer path's word-match cross-entropy.

The point losses and the matcher sample the masks with the gather form
(``grid_sample_bilinear``): the JAX package's separable one-hot products
(its ``grid_sample_separable``) and the matcher's interpolation matrix are
the same function laid out for the TPU's matrix unit, and on the H100 their
one-hot rows ([rows, points, H] per sampling) cost about 0.5 s of
elementwise device time a training step at full width (PERF.md, PR 3).

Random draws come from an explicit ``torch.Generator`` (the JAX package's
``jax.random`` keys give other numbers); ``injected_coords`` replaces every
draw so that the criterion can be held term by term against the JAX package.
The training path's ``approx_max_k`` (a TPU device choice) is the exact
``torch.topk``. All decoder layers are matched by one batched auction (one
convergence test, ``ops/lap.py``) before the losses.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from siu3r_tpu_torch.ops.deformable import grid_sample_bilinear
from siu3r_tpu_torch.ops.lap import auction_lap
from siu3r_tpu_torch.train.matcher import match_costs, sample_mask_points


def _sample(logits: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """logits [R, H, W]; coords [R, P, 2] in [0, 1] -> [R, P]."""
    return grid_sample_bilinear(logits[..., None], 2.0 * coords - 1.0)[..., 0]


def _sample_points(logits, num_points, oversample, importance, pre_coords, extra_coords, generator):
    """Uncertainty-based point sampling for R masks [R, H, W] (reference
    :444-506): ``pre_coords`` [R, n_sampled, 2] and ``extra_coords``
    [R, n_random, 2] override the two random draws. Returns [R, num_points, 2]
    (x, y) in [0, 1], with no gradient."""
    r = logits.shape[0]
    n_sampled = int(num_points * oversample)
    n_uncertain = int(importance * num_points)
    dev = logits.device
    with torch.no_grad():
        coords = (pre_coords if pre_coords is not None
                  else torch.rand(r, n_sampled, 2, generator=generator, device=dev))
        uncertainty = -_sample(logits, coords).abs()
        idx = torch.topk(uncertainty, n_uncertain, dim=-1).indices
        picked = coords.gather(1, idx[..., None].expand(-1, -1, 2))
        extra = (extra_coords if extra_coords is not None
                 else torch.rand(r, num_points - n_uncertain, 2, generator=generator, device=dev))
        return torch.cat([picked, extra], dim=1)


def _point_losses(logits, tgt, coords):
    """Sigmoid BCE and dice per row at the sample points: logits and tgt
    [R, H, W], coords [R, P, 2] -> (ce [R], dice [R])."""
    pl = _sample(logits, coords)
    with torch.no_grad():
        tl = _sample(tgt, coords)
    ce = (pl.clamp(min=0) - pl * tl + F.softplus(-pl.abs())).mean(-1)
    probs = torch.sigmoid(pl)
    dice = 1 - (2 * (probs * tl).sum(-1) + 1) / (probs.sum(-1) + tl.sum(-1) + 1)
    return ce, dice


def _mask_losses_item(
    mask_logits: torch.Tensor,
    gt_masks: torch.Tensor,
    assignment: torch.Tensor,
    num_points: int,
    oversample: float,
    importance: float,
    generator: Optional[torch.Generator] = None,
    pre_coords: Optional[torch.Tensor] = None,
    extra_coords: Optional[torch.Tensor] = None,
):
    """(ce_sum, dice_sum) over one item's matched (object, view) rows
    (reference loss_masks :343-409); normalised by num_masks at batch level.
    mask_logits [Q, V, h, w]; gt_masks [O, V, H, W]; assignment [O] (-1
    invalid); injected coords [O*V, n, 2]. All rows at once: the JAX
    package's chunks of 16 rows bound its one-hot rows, which the gather form
    does not build."""
    o, v = gt_masks.shape[:2]
    pred = mask_logits[assignment.clamp(min=0)]  # [O, V, h, w]
    rows_pred = pred.reshape(o * v, *pred.shape[2:])
    coords = _sample_points(rows_pred.detach(), num_points, oversample, importance, pre_coords, extra_coords,
                            generator)
    ce, dice = _point_losses(rows_pred, gt_masks.reshape(o * v, *gt_masks.shape[2:]), coords)
    rows_valid = (assignment >= 0).repeat_interleave(v)
    zero = mask_logits.new_zeros(())
    return torch.where(rows_valid, ce, zero).sum(), torch.where(rows_valid, dice, zero).sum()


def _label_loss(class_logits, gt_classes, assignment, num_labels: int, no_object_weight: float):
    """Weighted CE (reference loss_labels :298-341; CrossEntropyLoss with class
    weights normalises by the targets' summed weights). class_logits
    [B, Q, C+1]; gt_classes, assignment [B, O]. Only matched queries take
    their object's class. (The JAX package also writes no-object, through the
    clipped index 0, for each invalid object: where query 0 is matched, its
    scatter order decides which write stays.)"""
    b, q, _ = class_logits.shape
    valid = assignment >= 0
    target = torch.full((b, q + 1), num_labels, dtype=torch.int64, device=class_logits.device)
    target.scatter_(1, torch.where(valid, assignment, q), gt_classes.long())
    target = target[:, :q]
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -logp.gather(-1, target[..., None])[..., 0]
    weights = torch.where(target == num_labels, no_object_weight, 1.0).to(ce.dtype)
    return (ce * weights).sum() / weights.sum()


def segmentation_loss(
    aux_class_logits: List[torch.Tensor],
    aux_mask_logits: List[torch.Tensor],
    gt_masks: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    generator: Optional[torch.Generator],
    num_labels: int,
    class_weight: float = 2.0,
    mask_weight: float = 5.0,
    dice_weight: float = 5.0,
    no_object_weight: float = 0.1,
    num_points: int = 12544,
    oversample: float = 3.0,
    importance: float = 0.75,
    match_points: int = 12544,
    injected_coords: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Dict[str, torch.Tensor]:
    """The criterion over the final and auxiliary decoder outputs (reference
    VideoMask2FormerLoss.forward :508-571 and the weights of :2327-2331).
    gt_masks [B, O, V, H, W] binary float; gt_classes [B, O]; gt_valid [B, O].

    ``injected_coords``: per layer, ``match`` [B, P, 2], ``pre``
    [B, O*V, n_sampled, 2] and ``extra`` [B, O*V, n_random, 2], replacing the
    draws. Without it (training): the matcher's points are drawn once per
    item and shared by the layers, as in the JAX package, and each layer's
    point losses run under activation checkpointing (recomputed in the
    backward) as the JAX package's ``jax.checkpoint`` does.

    Returns ``loss_mask``/``loss_dice``/``loss_cross_entropy`` (with ``_i``
    for auxiliary layer i) and ``seg_total``."""
    if injected_coords is None and generator is None:
        raise ValueError("the random path draws from an explicit torch.Generator")
    b, o = gt_classes.shape
    n_layers = len(aux_class_logits)
    dev = gt_masks.device
    num_masks = gt_valid.sum().float().clamp(min=1.0)
    if injected_coords is not None:
        match = torch.stack([inj["match"] for inj in injected_coords])  # [L, B, P, 2]
    else:
        match = torch.rand(b, match_points, 2, generator=generator, device=dev).expand(n_layers, -1, -1, -1)
    # the ground truth at the match points: once per distinct draw
    n_draws = n_layers if injected_coords is not None else 1
    tgt_pts = torch.stack([
        torch.stack([sample_mask_points(gt_masks[i], match[li, i]).reshape(o, -1) for i in range(b)])
        for li in range(n_draws)
    ]).expand(n_layers, -1, -1, -1)
    cost = match_costs(
        torch.stack(aux_class_logits).flatten(0, 1), torch.stack(aux_mask_logits).flatten(0, 1),
        gt_classes.expand(n_layers, -1, -1).flatten(0, 1), match.flatten(0, 1), tgt_pts.flatten(0, 1),
        cost_class=1.0, cost_mask=mask_weight, cost_dice=dice_weight,
    )
    assignments = auction_lap(cost, row_valid=gt_valid.expand(n_layers, -1, -1).flatten(0, 1))
    assignments = assignments.reshape(n_layers, b, o)

    def layer_point_losses(msk_l, assignment, inj, gen):
        ce_sum = dice_sum = 0.0
        for i in range(b):
            ce, dice = _mask_losses_item(
                msk_l[i], gt_masks[i], assignment[i], num_points, oversample, importance, gen,
                None if inj is None else inj["pre"][i], None if inj is None else inj["extra"][i],
            )
            ce_sum = ce_sum + ce
            dice_sum = dice_sum + dice
        return ce_sum, dice_sum

    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for li, (cls_l, msk_l) in enumerate(zip(aux_class_logits, aux_mask_logits)):
        if injected_coords is not None:
            ce_sum, dice_sum = layer_point_losses(msk_l, assignments[li], injected_coords[li], None)
        else:
            # each run of the layer (the first, and the recompute in the
            # backward) draws from a copy of the generator taken here, so
            # both draw the same points; the generator then moves on as the
            # first run left its copy
            start = generator.get_state()
            end = {}

            def run(m, a=assignments[li], start=start, end=end):
                gen = torch.Generator(device=dev)
                gen.set_state(start)
                out = layer_point_losses(m, a, None, gen)
                end.setdefault("state", gen.get_state())
                return out

            ce_sum, dice_sum = checkpoint(run, msk_l, use_reentrant=False)
            generator.set_state(end["state"])
        loss_mask = ce_sum / num_masks
        loss_dice = dice_sum / num_masks
        loss_ce = _label_loss(cls_l, gt_classes, assignments[li], num_labels, no_object_weight)
        suffix = "" if li == n_layers - 1 else f"_{li}"
        losses[f"loss_mask{suffix}"] = loss_mask
        losses[f"loss_dice{suffix}"] = loss_dice
        losses[f"loss_cross_entropy{suffix}"] = loss_ce
        total = total + mask_weight * loss_mask + dice_weight * loss_dice + class_weight * loss_ce
    losses["seg_total"] = total
    return losses


def depth_smoothness_loss(depth: torch.Tensor, seg_mask: torch.Tensor, instance_masked: bool = True) -> torch.Tensor:
    """Instance-masked depth smoothness (reference pipeline.py:242-265):
    depth [B, N, H, W] rendered at the context views; seg_mask [B, N, H, W]
    segment ids (-1 the empty fill). ``instance_masked=False`` penalises
    every depth gradient."""
    depth_dx = torch.diff(depth, dim=-1)
    depth_dy = torch.diff(depth, dim=-2)
    if not instance_masked:
        return depth_dx.abs().mean() + depth_dy.abs().mean()
    same_x = (torch.diff(seg_mask, dim=-1) == 0) & (seg_mask[..., :, 1:] != -1)
    same_y = (torch.diff(seg_mask, dim=-2) == 0) & (seg_mask[..., 1:, :] != -1)
    return (depth_dx * same_x).abs().mean() + (depth_dy * same_y).abs().mean()


def mse_render_loss(render: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE over all elements."""
    return ((render - target) ** 2).mean()


def refer_word_match_loss(word_logits: torch.Tensor, assignment: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """The referring-expression loss (reference refer_seg_forward,
    video_seg_decoder.py:573-594): cross-entropy between the word/query
    similarity logits [B, W, Q] and the query matched to each word's object
    (word i <-> object i; assignment [B, O], gt_valid [B, O]). The mean over
    an item's valid words, summed over the items, as the reference's
    per-item ``F.cross_entropy`` accumulated with ``+=``. A word whose object
    is invalid or unassigned (-1) is left out."""
    nw = word_logits.shape[1]
    a = assignment[:, :nw]
    valid = (a >= 0) & gt_valid[:, :nw]
    logp = torch.log_softmax(word_logits, dim=-1)
    ce = -logp.gather(-1, a.clamp(min=0).long()[..., None])[..., 0]
    per_item = torch.where(valid, ce, torch.zeros_like(ce)).sum(dim=1) / valid.sum(dim=1).clamp(min=1)
    return per_item.sum()
