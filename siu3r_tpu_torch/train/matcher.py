"""Hungarian matching between queries and padded ground-truth objects,
counterpart of ``siu3r_tpu/train/matcher.py``.

Point-sampled class, mask-BCE and dice costs over a fixed pad of objects
(invalid ones masked), solved on the device by the auction LAP
(``ops/lap.py``). ``match_costs`` builds the cost matrices of any number of
(decoder layer, batch item) problems so that one ``auction_lap`` call solves
them all; ``hungarian_match`` is the single-item form of the JAX package.
Matching is not differentiated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from siu3r_tpu_torch.ops.deformable import grid_sample_bilinear
from siu3r_tpu_torch.ops.lap import auction_lap


def sample_mask_points(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks [N, V, H, W]; coords [P, 2] in [0, 1] as (x, y), shared by the N
    masks. Returns [N, V, P] bilinear samples (grid_sample semantics)."""
    n, v, h, w = masks.shape
    grid = (2.0 * coords - 1.0).expand(n * v, *coords.shape)
    return grid_sample_bilinear(masks.reshape(n * v, h, w, 1).float(), grid).reshape(n, v, -1)


def pairwise_sigmoid_ce(inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """inputs [..., Q, P] logits; labels [..., O, P] binary -> [..., Q, O]."""
    p = inputs.shape[-1]
    pos = F.softplus(-inputs)  # BCE against 1
    neg = F.softplus(inputs)  # BCE against 0
    loss = pos @ labels.transpose(-1, -2) + neg @ (1.0 - labels).transpose(-1, -2)
    return loss / p


def pairwise_dice(inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    probs = torch.sigmoid(inputs)
    numerator = 2 * (probs @ labels.transpose(-1, -2))
    denominator = probs.sum(-1)[..., :, None] + labels.sum(-1)[..., None, :]
    return 1 - (numerator + 1) / (denominator + 1)


def match_costs(
    class_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    gt_classes: torch.Tensor,
    coords: torch.Tensor,
    tgt_pts: torch.Tensor,
    cost_class: float = 1.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
) -> torch.Tensor:
    """Cost matrices [N, O, Q] of N problems: class_logits [N, Q, C+1],
    mask_logits [N, Q, V, h, w], gt_classes [N, O], coords [N, P, 2] and the
    ground truth sampled there, tgt_pts [N, O, V*P]."""
    with torch.no_grad():
        n, q = class_logits.shape[:2]
        pred_pts = torch.stack([sample_mask_points(mask_logits[i], coords[i]) for i in range(n)])
        pred_pts = pred_pts.reshape(n, q, -1)
        probs = torch.softmax(class_logits.float(), dim=-1)
        cls_cost = -probs.gather(2, gt_classes.clamp(0, probs.shape[-1] - 1).long()[:, None, :].expand(-1, q, -1))
        cost = (
            cost_mask * pairwise_sigmoid_ce(pred_pts, tgt_pts)
            + cost_class * cls_cost
            + cost_dice * pairwise_dice(pred_pts, tgt_pts)
        )  # [N, Q, O]
        return cost.transpose(1, 2)


def hungarian_match(
    class_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    gt_masks: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_points: int = 12544,
    cost_class: float = 1.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
    coords: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-item matching. class_logits [Q, C+1]; mask_logits [Q, V, h, w];
    gt_masks [O, V, H, W]; gt_classes [O]; gt_valid [O]. Returns the query of
    each ground-truth object [O] int64 (-1 where invalid). ``coords`` [P, 2]
    overrides the random sample points drawn from ``generator``."""
    if coords is None:
        coords = torch.rand(num_points, 2, generator=generator, device=gt_masks.device)
    tgt_pts = sample_mask_points(gt_masks, coords).reshape(gt_masks.shape[0], -1)
    cost = match_costs(class_logits[None], mask_logits[None], gt_classes[None], coords[None], tgt_pts[None],
                       cost_class, cost_mask, cost_dice)
    return auction_lap(cost, row_valid=gt_valid[None])[0]
