"""Training and validation steps, counterpart of ``siu3r_tpu/pipeline.py``.

``Pipeline.train_step`` (after ``init_train``): the model forward in train
mode (BatchNorm on batch statistics, updating its running statistics), the
render of the target views, and the loss of the reference's recipe
(pipeline.py:216-281, :337-364):
  total = 0.05 * seg + 0.05 * instance-masked depth smoothness
        + MSE(render, target) + 0.5 * LPIPS at half resolution,
then the gradient and the 3-group AdamW update with the global-norm clip.
Gradients run backward through the port's kernels: the compositing's
backward is the ``raster_bwd`` kernel on CUDA; the attention and deformable
attention kernels' backward is the plain version's VJP (the JAX package's
backward there is XLA code, not a TPU kernel); the rest is autograd.
Gradient accumulation and data parallelism wait for the distributed slice.

``Pipeline.eval_step`` (the reference's step_w_query_class_logit_lift): the
forward in eval mode with the query-class lift, then novel-view RGB, depth
and factored query-class rendering over one shared binning; and
``lift_rendered_qc`` turns the rendered query-class confidences into
semantic and instance maps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from siu3r_tpu_torch.config import RootCfg
from siu3r_tpu_torch.models.layers import resize_nhwc
from siu3r_tpu_torch.models.model import ModelOutput, SIU3RModel
from siu3r_tpu_torch.renderer import RenderOutput, render_color_and_qc, render_gaussians
from siu3r_tpu_torch.train import lpips as lpips_mod
from siu3r_tpu_torch.train.losses import depth_smoothness_loss, mse_render_loss, segmentation_loss
from siu3r_tpu_torch.train.optimizer import AdamW3


class Pipeline:
    """Holds the model (``cuda`` unless the caller names the CPU; raises
    without a GPU) in eval mode, with a seeded random init."""

    def __init__(self, cfg: RootCfg, device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = cfg
        self.model = SIU3RModel(cfg.pipeline.model, device=device, seed=seed).eval()
        self.device = next(self.model.parameters()).device
        self.optimizer: Optional[AdamW3] = None
        self.lpips_params = None

    def init_train(
        self, steps_per_epoch: int = 1000, lpips_weights: Optional[str] = None, lpips_enabled: bool = True,
    ) -> "Pipeline":
        """Set up training: the optimizer (fresh moments, step 0) and LPIPS
        (``lpips_weights`` if that file exists, else the fixed-seed VGG)."""
        if self.cfg.trainer.accumulate_grad_batches > 1:
            raise NotImplementedError("gradient accumulation is not ported yet")
        self.lpips_params = (lpips_mod.init_lpips_params(lpips_weights, device=self.device)
                             if lpips_enabled else None)
        self.optimizer = AdamW3(
            self.model, self.cfg.optimizer, self.cfg.trainer, steps_per_epoch=steps_per_epoch,
            freeze_encoder=self.cfg.pipeline.model.croco.freeze == "encoder",
        )
        return self

    def loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator],
        injected_coords: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss with the model in train mode (its BatchNorm
        running statistics update). batch: ``context_views_images``
        [B, V, H, W, 3], ``context_views_intrinsics`` [B, V, 3, 3],
        ``target_views_images`` [B, N, H, W, 3], ``target_views_extrinsics``
        [B, N, 4, 4] (camera-to-world), ``target_views_intrinsics``
        [B, N, 3, 3], ``gt_masks`` [B, O, V, H, W], ``gt_classes`` [B, O],
        ``gt_valid`` [B, O] bool, and optionally ``context_views_id`` [B, V]
        and ``target_views_id`` [B, N]. ``generator`` (on the model's device)
        draws the criterion's sample points; ``injected_coords`` replaces
        them (``segmentation_loss``). Returns (total, every term: the
        criterion's ``loss_*``, ``seg``, ``depth_smoothness``,
        ``render_mse``, ``lpips``, ``total``)."""
        m2f = self.cfg.pipeline.model.mask2former
        pcfg = self.cfg.pipeline
        images = batch["context_views_images"]
        b, v, h, w = images.shape[:4]
        self.model.train()
        out = self.model(images, batch["context_views_intrinsics"])
        render = render_gaussians(
            out.gaussians, batch["target_views_extrinsics"], batch["target_views_intrinsics"], (h, w))

        losses: Dict[str, torch.Tensor] = segmentation_loss(
            out.seg.aux_class_logits, out.seg.aux_mask_logits, batch["gt_masks"], batch["gt_classes"],
            batch["gt_valid"], generator, num_labels=m2f.num_labels, class_weight=m2f.class_weight,
            mask_weight=m2f.mask_weight, dice_weight=m2f.dice_weight, no_object_weight=m2f.no_object_weight,
            num_points=m2f.train_num_points, oversample=m2f.oversample_ratio,
            importance=m2f.importance_sample_ratio, injected_coords=injected_coords,
        )
        losses["seg"] = losses.pop("seg_total")
        loss = pcfg.weight_seg_loss * losses["seg"]

        # depth smoothness on the context views' rendered depths, found by
        # view id in the target list (the datamodule puts extra targets
        # between the context pair); without ids, the first V targets
        if "context_views_id" in batch and "target_views_id" in batch:
            same = batch["context_views_id"][:, :, None] == batch["target_views_id"][:, None, :]
            ctx_pos = same.to(torch.int32).argmax(dim=-1)  # [B, V]
            ctx_depth = render.depth.gather(1, ctx_pos[:, :, None, None].expand(-1, -1, h, w))
        else:
            ctx_depth = render.depth[:, :v]
        losses["depth_smoothness"] = depth_smoothness_loss(
            ctx_depth, out.post["segmentation"], instance_masked=pcfg.enable_instance_depth_smoothness)
        loss = loss + pcfg.weight_depth_smoothness * losses["depth_smoothness"]

        target = batch["target_views_images"]
        losses["render_mse"] = mse_render_loss(render.color, target)
        loss = loss + losses["render_mse"]
        if self.lpips_params is not None:
            n = target.shape[1]
            half = (h // 2, w // 2)
            losses["lpips"] = lpips_mod.lpips(
                self.lpips_params,
                resize_nhwc(render.color.reshape(b * n, h, w, 3), half, align_corners=True),
                resize_nhwc(target.reshape(b * n, h, w, 3), half, align_corners=True),
            )
            loss = loss + 0.5 * losses["lpips"]
        else:
            losses["lpips"] = loss.new_zeros(())
        losses["total"] = loss
        return loss, losses

    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (see ``loss_fn``). Returns every
        loss term, detached, on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_train first")
        for p in self.model.parameters():
            p.grad = None
        loss, losses = self.loss_fn(batch, generator)
        loss.backward()
        self.optimizer.step()
        for p in self.model.parameters():
            p.grad = None
        return {k: x.detach() for k, x in losses.items()}

    @torch.inference_mode()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Tuple[ModelOutput, RenderOutput, torch.Tensor]:
        """batch: ``context_views_images`` [B, 2, H, W, 3],
        ``context_views_intrinsics`` [B, 2, 3, 3] (normalised),
        ``target_views_extrinsics`` [B, N, 4, 4] (camera-to-world),
        ``target_views_intrinsics`` [B, N, 3, 3], on the model's device.
        Returns (model output, render [B, N, ...], qc [B, N, S, C+1, H, W]).
        Switches the model to eval mode."""
        self.model.eval()
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
