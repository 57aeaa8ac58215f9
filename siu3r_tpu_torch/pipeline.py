"""Validation step, counterpart of the eval part of ``siu3r_tpu/pipeline.py``
(the reference's step_w_query_class_logit_lift): the model forward with the
query-class lift, then novel-view RGB, depth and factored query-class
rendering over one shared binning, and the lift of the rendered
query-class confidences to semantic and instance maps.

Training (losses, LPIPS, the optimizer) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from siu3r_tpu_torch.config import RootCfg
from siu3r_tpu_torch.models.model import ModelOutput, SIU3RModel
from siu3r_tpu_torch.renderer import RenderOutput, render_color_and_qc


class Pipeline:
    """Holds the model (``cuda`` unless the caller names the CPU; raises
    without a GPU) in eval mode, with a seeded random init."""

    def __init__(self, cfg: RootCfg, device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = cfg
        self.model = SIU3RModel(cfg.pipeline.model, device=device, seed=seed).eval()

    @torch.inference_mode()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Tuple[ModelOutput, RenderOutput, torch.Tensor]:
        """batch: ``context_views_images`` [B, 2, H, W, 3],
        ``context_views_intrinsics`` [B, 2, 3, 3] (normalised),
        ``target_views_extrinsics`` [B, N, 4, 4] (camera-to-world),
        ``target_views_intrinsics`` [B, N, 3, 3], on the model's device.
        Returns (model output, render [B, N, ...], qc [B, N, S, C+1, H, W])."""
        images = batch["context_views_images"]
        intr = batch["context_views_intrinsics"]
        b, v, h, w = images.shape[:4]
        out = self.model(images, intr, enable_query_class_logit_lift=True)
        s = out.post["qc_mask_probs"].shape[1]
        qc_mask_cols = out.post["qc_mask_probs"].reshape(b, s, v * h * w).transpose(1, 2)
        render, qc = render_color_and_qc(
            out.gaussians,
            out.post["qc_class_probs"],
            qc_mask_cols,
            batch["target_views_extrinsics"],
            batch["target_views_intrinsics"],
            (h, w),
        )
        return out, render, qc


def lift_rendered_qc(
    qc: torch.Tensor,
    query_scores: torch.Tensor,
    threshold: float = 0.3,
    num_queries: int = 100,
    stuff_ids: Tuple[int, ...] = (0, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Novel-view semantic and instance maps from rendered query-class
    confidences (reference pipeline.py:137-202). qc [B, V, S, C+1, H, W] ->
    (sem_id, ins_id) [B, V, H, W], with the no-object channel rolled to 0,
    threshold 0.3 and stuff instance ids mapped to num_queries + stuff + 1.
    ``query_scores`` is taken for the reference's signature and not used."""
    c_logit, q_index = qc.max(dim=2)  # [B, V, C+1, H, W]
    c_logit = torch.cat([c_logit[:, :, -1:], c_logit[:, :, :-1]], dim=2)
    q_index = torch.cat([q_index[:, :, -1:], q_index[:, :, :-1]], dim=2)
    sem_logits, sem_id = c_logit.max(dim=2)  # [B, V, H, W]
    ins_id = q_index.gather(2, sem_id.unsqueeze(2)).squeeze(2) + 1
    sem_id = torch.where(sem_logits < threshold, torch.zeros_like(sem_id), sem_id)
    ins_id = torch.where(sem_id == 0, torch.zeros_like(ins_id), ins_id)
    for stuff in stuff_ids:
        ins_id = torch.where(sem_id == stuff + 1, torch.full_like(ins_id, num_queries + stuff + 1), ins_id)
    return sem_id, ins_id
