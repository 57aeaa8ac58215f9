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
With ``trainer.accumulate_grad_batches = k > 1`` the optimizer is
``MultiSteps`` (optax.MultiSteps' semantics): a step is k micro-steps whose
gradients are averaged, the parameters moving on the k-th.
Under a process group (``siu3r_tpu_torch.parallel``, one rank a process,
launched by torchrun) ``train_step`` is the JAX package's data-parallel step
(``make_dp_train_step``): each rank takes the loss and its backward on its
slice of the global batch with its own random draws, then the gradients, the
loss terms and the BatchNorm running statistics are averaged over the ranks
(each rank's BatchNorm normalises with its own slice's statistics, as on the
JAX mesh: no SyncBatchNorm) before the one optimizer update; with
``trainer.zero1`` the optimizer state is sharded over the ranks
(``Zero1AdamW3``).
A batch with ``text_token`` (ScanRefer) trains the refer path instead
(``refer_loss_fn``): the understanding-only forward, one final-layer
Hungarian match and the word-match cross-entropy.
Under ``model.dtype: bfloat16`` every step trains as the JAX package's does
(``jax.value_and_grad`` through the same bf16 modules): the backbone and the
adapter compute in bf16, so their activations and the cotangents that run
back through them are bf16; parameters, gradients, the AdamW moments, the
global-norm clip and the averaged gradients of a process group stay fp32
(each cast of an fp32 weight to bf16 passes its gradient back as fp32).

``Pipeline.eval_step`` (the reference's step_w_query_class_logit_lift): the
forward in eval mode with the query-class lift, then novel-view RGB, depth
and factored query-class rendering over one shared binning; and
``lift_rendered_qc`` turns the rendered query-class confidences into
semantic and instance maps. ``Pipeline.refer_eval_step`` gives each
referring expression's mask: the mask of the query its word argmaxes to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from siu3r_tpu_torch import parallel
from siu3r_tpu_torch.config import RootCfg
from siu3r_tpu_torch.models.layers import resize_nhwc
from siu3r_tpu_torch.models.model import ModelOutput, SIU3RModel
from siu3r_tpu_torch.renderer import RenderOutput, render_color_and_qc, render_gaussians
from siu3r_tpu_torch.train import lpips as lpips_mod
from siu3r_tpu_torch.train.losses import (
    depth_smoothness_loss,
    mse_render_loss,
    refer_word_match_loss,
    segmentation_loss,
)
from siu3r_tpu_torch.train.matcher import hungarian_match_batch
from siu3r_tpu_torch.train.optimizer import AdamW3, MultiSteps, Zero1AdamW3

# the batch keys ``Pipeline.eval_step`` reads
EVAL_KEYS = ("context_views_images", "context_views_intrinsics", "target_views_extrinsics",
             "target_views_intrinsics")


class Pipeline:
    """Holds the model (``cuda`` unless the caller names the CPU; raises
    without a GPU) in eval mode, with a seeded random init."""

    def __init__(self, cfg: RootCfg, device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = cfg
        self.model = SIU3RModel(cfg.pipeline.model, device=device, seed=seed).eval()
        self.device = next(self.model.parameters()).device
        self.optimizer: Optional[AdamW3 | MultiSteps] = None
        self.lpips_params = None

    def init_train(
        self, steps_per_epoch: int = 1000, lpips_weights: Optional[str] = None, lpips_enabled: bool = True,
    ) -> "Pipeline":
        """Set up training: the optimizer (fresh moments, step 0; sharded over
        the ranks with ``trainer.zero1`` under a group of more than one rank;
        wrapped in ``MultiSteps`` when ``trainer.accumulate_grad_batches`` >
        1) and LPIPS (``lpips_weights`` if that file exists, else the
        fixed-seed VGG)."""
        self.lpips_params = (lpips_mod.init_lpips_params(lpips_weights, device=self.device)
                             if lpips_enabled else None)
        zero1 = self.cfg.trainer.zero1 and parallel.world_size() > 1
        self.optimizer = (Zero1AdamW3 if zero1 else AdamW3)(
            self.model, self.cfg.optimizer, self.cfg.trainer, steps_per_epoch=steps_per_epoch,
            freeze_encoder=self.cfg.pipeline.model.croco.freeze == "encoder",
        )
        k = self.cfg.trainer.accumulate_grad_batches
        if k > 1:
            self.optimizer = MultiSteps(self.optimizer, k)
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

    def refer_loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator],
        injected_coords: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The referring-expression loss (reference get_loss_dict's refer
        branch, video_seg_decoder.py:2308-2320) with the model in train mode:
        ``seg_forward`` with the text tokens (no DPT or Gaussian head: a
        ScanRefer batch has no target views), one Hungarian match of the
        final decoder state at ``train_num_points`` points (class cost 1,
        mask and dice costs at their loss weights), then the word-match
        cross-entropy. batch: ``context_views_images`` [B, V, H, W, 3],
        ``context_views_intrinsics`` [B, V, 3, 3], ``gt_masks``
        [B, O, V, H, W], ``gt_classes`` [B, O], ``gt_valid`` [B, O] and
        ``text_token`` [B, O, T] (word i refers to object i).
        ``injected_coords`` [B, P, 2] replaces the matcher's points drawn
        from ``generator``. Returns (total, {"word_match", "total"})."""
        m2f = self.cfg.pipeline.model.mask2former
        self.model.train()
        seg, _ = self.model.seg_forward(batch["context_views_images"], batch["context_views_intrinsics"],
                                        text_tokens=batch["text_token"])
        if injected_coords is None and generator is None:
            raise ValueError("the random path draws from an explicit torch.Generator")
        assignment = hungarian_match_batch(
            seg.class_queries_logits, seg.masks_queries_logits, batch["gt_masks"], batch["gt_classes"],
            batch["gt_valid"], generator, num_points=m2f.train_num_points, cost_class=1.0,
            cost_mask=m2f.mask_weight, cost_dice=m2f.dice_weight, coords=injected_coords)
        losses = {"word_match": refer_word_match_loss(seg.word_logits, assignment, batch["gt_valid"])}
        losses["total"] = self.cfg.pipeline.weight_seg_loss * losses["word_match"]
        return losses["total"], losses

    def train_step(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                   injected_coords=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (one micro-step under gradient
        accumulation): ``refer_loss_fn`` where it holds ``text_token``, else
        ``loss_fn``, each with ``generator`` or ``injected_coords`` as it takes
        them. Returns every loss term, detached, on the device. Parameters the
        loss does not reach (a refer step's heads) take a zero gradient:
        AdamW still decays them. Under a process group, ``batch`` is this
        rank's slice and ``generator`` this rank's; the gradients (a zero one
        included), the loss terms and the BatchNorm running statistics are
        averaged over the ranks before the update, so every rank returns the
        same terms and keeps the same parameters."""
        if self.optimizer is None:
            raise RuntimeError("call init_train first")
        for p in self.model.parameters():
            p.grad = None
        loss_fn = self.refer_loss_fn if "text_token" in batch else self.loss_fn
        loss, losses = loss_fn(batch, generator, injected_coords)
        loss.backward()
        losses = {k: x.detach() for k, x in losses.items()}
        if parallel.is_distributed():
            losses = self._mean_over_ranks(losses)
        self.optimizer.step()
        for p in self.model.parameters():
            p.grad = None
        return losses

    def _mean_over_ranks(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The JAX step's three ``pmean``s: of the gradients (each
        parameter's, zeros where the loss did not reach it), of the loss terms
        and of the BatchNorm running statistics, in place. Returns the
        averaged terms."""
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        terms = torch.stack(list(losses.values()))
        stats = [t for m in self.model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                 and m.track_running_stats for t in (m.running_mean, m.running_var)]
        parallel.all_reduce_mean_([p.grad for p in params] + [terms] + stats)
        return dict(zip(losses, terms.unbind()))

    @torch.inference_mode()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Tuple[ModelOutput, RenderOutput, torch.Tensor]:
        """batch: ``context_views_images`` [B, V, H, W, 3],
        ``context_views_intrinsics`` [B, V, 3, 3] (normalised; V the
        model's ``num_views``),
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

    @torch.inference_mode()
    def refer_eval_step(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The referring-expression eval forward: ``seg_forward`` in eval mode
        with ``text_token`` [B, W, T]; for each word, the mask logits of the
        query it argmaxes to, resized bilinearly to the input size
        (half-pixel centres) and thresholded at 0 (sigmoid at 0.5). Returns
        (masks [B, W, V, H, W] bool, word_logits [B, W, Q]). Switches the
        model to eval mode."""
        self.model.eval()
        images = batch["context_views_images"]
        h, w = images.shape[2:4]
        seg, _ = self.model.seg_forward(images, batch["context_views_intrinsics"], text_tokens=batch["text_token"])
        ml = seg.masks_queries_logits  # [B, Q, V, h, w]
        b, _, v, mh, mw = ml.shape
        pred_q = seg.word_logits.argmax(dim=-1)  # [B, W]
        nw = pred_q.shape[1]
        masks = ml.gather(1, pred_q[:, :, None, None, None].expand(-1, -1, v, mh, mw))
        up = resize_nhwc(masks.reshape(b * nw * v, mh, mw, 1), (h, w), align_corners=False)
        return up.reshape(b, nw, v, h, w) > 0.0, seg.word_logits


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


def gather_eval_arrays(arrays: dict) -> Optional[dict]:
    """The data-parallel eval step's gather (the JAX package's
    ``make_dp_eval_step`` returns its outputs sharded and the caller fetches
    them to the host): each rank's ``visualizer.eval_step_arrays`` of its
    slice, concatenated along the batch in rank order on rank 0, which alone
    writes; None on the other ranks. Without a group, ``arrays``."""
    import numpy as np

    parts = parallel.gather_to_rank0(arrays)
    if parts is None:
        return None
    return {k: sum((p[k] for p in parts), []) if isinstance(v, list) else np.concatenate([p[k] for p in parts])
            for k, v in arrays.items()}
