"""SIU3RModel, counterpart of ``siu3r_tpu/models/model.py``.

One forward over V views: CroCo backbone (the two-view ``AsymmetricCroCo``
at V = 2, the shared-bank ``AsymmetricCroCoMulti`` above) -> ViT-Adapter
(every view batched) -> DPT pts3d and Gaussian-parameter heads (head 1 for
view 0, the shared head 2 for the others) -> Gaussian adapter; video
Mask2Former -> dense panoptic post-process, whose labels (and, on request,
per-query class confidences) are lifted onto the Gaussians.

Text-referred segmentation (``mask2former.train_refer_segmentation``): a
learned token embedding, mean-pooled per referring expression, gives the
word embeddings that Mask2Former's language layers match against the object
queries; ``seg_forward`` is the understanding-only path (no DPT or Gaussian
heads) that the refer steps run. Train or eval mode (the adapter's BatchNorm)
follows ``module.train()``.

``cfg.dtype`` ("float32" or "bfloat16") is the compute dtype of the backbone
and the adapter only, as in the JAX package (siu3r_tpu/models/model.py:56-70);
parameters stay fp32. Mask2Former, the heads and the text embedding compute
in fp32: the hooks into the heads and the adapter's levels are cast to fp32
before them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from siu3r_tpu_torch.config import ModelCfg
from siu3r_tpu_torch.device import resolve_device
from siu3r_tpu_torch.gaussians import Gaussians
from siu3r_tpu_torch.models.adapter import CroCoViTAdapter
from siu3r_tpu_torch.models.backbone import AsymmetricCroCo, AsymmetricCroCoMulti
from siu3r_tpu_torch.models.gaussian_adapter import adapt_gaussians
from siu3r_tpu_torch.models.heads.dpt import DPTHead, dpt_hooks, postprocess_pts3d
from siu3r_tpu_torch.models.layers import DTYPES, init_weights, set_layers_dtype
from siu3r_tpu_torch.models.mask2former.model import SegOutput, VideoMask2Former
from siu3r_tpu_torch.models.mask2former.postprocess import (
    panoptic_segmentation,
    qc_logits_per_pixel,
)


@dataclasses.dataclass
class ModelOutput:
    gaussians: Gaussians  # flattened [B, V*H*W, ...] with labels attached
    seg: SegOutput
    post: Dict[str, torch.Tensor]  # dense panoptic post-process outputs
    pts3d: torch.Tensor  # [B, V, H, W, 3]


class SIU3RModel(nn.Module):
    """The model for ``cfg.num_views`` views (at least 2) on ``device``
    (``cuda`` unless the caller names the CPU; raises without a GPU) with a
    seeded random init.

    The modules are built without storage and materialised on the device, so
    the init runs there, drawn from a ``torch.Generator`` on that device: the
    same seed gives the same weights on the same kind of device."""

    def __init__(self, cfg: ModelCfg, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if cfg.num_views < 2:
            raise ValueError(f"the model takes at least 2 views, not {cfg.num_views}")
        if cfg.dtype not in DTYPES:
            raise ValueError(f"model.dtype is one of {sorted(DTYPES)}, not {cfg.dtype!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self._build_modules(cfg)
        self.to_empty(device=dev)
        init_weights(self, torch.Generator(device=dev).manual_seed(seed))

    def _build_modules(self, cfg: ModelCfg) -> None:
        c = cfg.croco
        dt = DTYPES[cfg.dtype]
        self.backbone = AsymmetricCroCo(c, dt) if cfg.num_views == 2 else AsymmetricCroCoMulti(c, dt)
        d = c.enc_depth
        self.adapter = CroCoViTAdapter(
            embed_dim=c.enc_embed_dim,
            patch_size=c.patch_size,
            interaction_indexes=tuple(d * k // 4 - 1 for k in (1, 2, 3, 4)),
            dtype=dt,
        )
        self.mask2former = VideoMask2Former(cfg.mask2former, in_channels=c.enc_embed_dim)
        tok = (c.enc_embed_dim,) + (c.dec_embed_dim,) * 3
        raw = cfg.gaussian_head.raw_dim
        self.downstream_head1 = DPTHead(3, tok, head_type="regression", patch_size=c.patch_size)
        self.downstream_head2 = DPTHead(3, tok, head_type="regression", patch_size=c.patch_size)
        self.gaussian_param_head1 = DPTHead(raw, tok, head_type="gs_params", patch_size=c.patch_size)
        self.gaussian_param_head2 = DPTHead(raw, tok, head_type="gs_params", patch_size=c.patch_size)
        m = cfg.mask2former
        if m.train_refer_segmentation:
            # the reference ships no text encoder (its ScanRefer data carries
            # token ids, its Mask2Former takes ready word embeddings): a
            # learned embedding, mean-pooled, as the JAX package has
            self.text_embed = nn.Embedding(m.text_vocab_size, m.hidden_dim)

    def _embed_text(self, text_tokens: torch.Tensor) -> torch.Tensor:
        """text_tokens [B, O, T] int (0 = padding) -> one embedding per
        referring expression [B, O, hidden]: the mean over its tokens."""
        if not hasattr(self, "text_embed"):
            raise ValueError("text tokens need the text embedding: build the model with "
                             "mask2former.train_refer_segmentation")
        emb = self.text_embed(text_tokens.long())  # [B, O, T, C]
        m = (text_tokens > 0)[..., None].to(emb.dtype)
        return (emb * m).sum(dim=2) / m.sum(dim=2).clamp(min=1.0)

    def _features(self, images: torch.Tensor, intrinsics: torch.Tensor):
        """Backbone and adapter over every view: (the per-view decoder
        outputs for the heads, the adapter's 4 levels [B, V, H_l, W_l, C] in
        fp32 for Mask2Former)."""
        b, v, h, w, _ = images.shape
        out = self.backbone(images, intrinsics)
        if self.cfg.num_views == 2:
            all_feat = [torch.cat([f1, f2], dim=0) for f1, f2 in zip(out.all_feat1, out.all_feat2)]
            imgs_flat = torch.cat([images[:, 0], images[:, 1]], dim=0)
            dec_per_view = [out.dec1, out.dec2]
            feats = self.adapter(imgs_flat, all_feat)
            return dec_per_view, [torch.stack([f[:b], f[b:]], dim=1).float() for f in feats]
        all_feat = [f.reshape(b * v, *f.shape[2:]) for f in out.all_feat]
        dec_per_view = [[d[:, vi] for d in out.dec_feat] for vi in range(v)]
        feats = self.adapter(images.reshape(b * v, h, w, 3), all_feat)
        return dec_per_view, [f.reshape(b, v, *f.shape[1:]).float() for f in feats]

    def _segment(self, multi_scale_feat, image_size, word_embeddings, text_tokens):
        """Mask2Former (with its language layers where words are given) and
        the panoptic post-process: (SegOutput, post)."""
        if text_tokens is not None and word_embeddings is None:
            word_embeddings = self._embed_text(text_tokens)
        seg = self.mask2former(multi_scale_feat, word_embeddings=word_embeddings)
        m2f = self.cfg.mask2former
        post = panoptic_segmentation(
            seg.class_queries_logits,
            seg.masks_queries_logits,
            target_size=image_size,
            label_ids_to_fuse=tuple(m2f.label_ids_to_fuse),
            num_labels=m2f.num_labels,
            max_lift_queries=m2f.max_lift_queries,
            threshold=m2f.seg_threshold,
            word_logits=seg.word_logits,
        )
        return seg, post

    def _gaussians_for_views(
        self, dec_per_view: List[List[torch.Tensor]], images: torch.Tensor, image_size: Tuple[int, int]
    ) -> Tuple[Gaussians, torch.Tensor]:
        h, w = image_size
        b, v = images.shape[:2]
        hooks = dpt_hooks(self.cfg.croco.dec_depth)
        pts_list, raw_list = [], []
        for vi, dec in enumerate(dec_per_view):
            center_head = self.downstream_head1 if vi == 0 else self.downstream_head2
            param_head = self.gaussian_param_head1 if vi == 0 else self.gaussian_param_head2
            tokens = [dec[i].float() for i in hooks]
            pts_list.append(postprocess_pts3d(center_head(tokens, None, image_size)))
            raw_list.append(param_head(tokens, images[:, vi], image_size))
        pts3d = torch.stack(pts_list, dim=1)  # [B, V, H, W, 3]
        raw = torch.stack(raw_list, dim=1).reshape(b, v, h * w, -1)
        gaussians = adapt_gaussians(pts3d.reshape(b, v, h * w, 3), raw, self.cfg.gaussian_head.sh_degree)
        return gaussians, pts3d

    def forward(
        self,
        images: torch.Tensor,
        intrinsics: torch.Tensor,
        enable_query_class_logit_lift: bool = False,
        word_embeddings: Optional[torch.Tensor] = None,
        text_tokens: Optional[torch.Tensor] = None,
    ) -> ModelOutput:
        """images [B, V, H, W, 3] in [0, 1]; intrinsics [B, V, 3, 3]
        normalised (V = 2 for the two-view backbone). ``word_embeddings``
        [B, W, hidden] or ``text_tokens`` [B, W, T] (embedded in the model)
        restrict the kept queries to those some word refers to."""
        b, v, h, w, _ = images.shape
        dec_per_view, multi_scale_feat = self._features(images, intrinsics)
        gaussians, pts3d = self._gaussians_for_views(dec_per_view, images, (h, w))
        seg, post = self._segment(multi_scale_feat, (h, w), word_embeddings, text_tokens)

        flat = gaussians.flatten_views()
        semantic = post["semantic"].reshape(b, v * h * w)
        # Gaussian labels use 0 for background even where the seg map holds
        # the -1 empty-image fill
        instance = post["segmentation"].clamp(min=0).reshape(b, v * h * w)
        flat = flat.replace(semantic_labels=semantic, instance_labels=instance)
        if enable_query_class_logit_lift:
            flat = flat.replace(
                seg_query_class_logits=qc_logits_per_pixel(post),
                seg_query_scores=post["query_scores"],
                seg_query_valid=post["qc_valid"],
            )
        return ModelOutput(gaussians=flat, seg=seg, post=post, pts3d=pts3d)

    def seg_forward(
        self,
        images: torch.Tensor,
        intrinsics: torch.Tensor,
        word_embeddings: Optional[torch.Tensor] = None,
        text_tokens: Optional[torch.Tensor] = None,
    ) -> Tuple[SegOutput, Dict[str, torch.Tensor]]:
        """The understanding-only path (reference model.py:391-467): backbone,
        adapter, Mask2Former and the panoptic post-process, with no DPT or
        Gaussian head. Inputs as ``forward``. Returns (SegOutput, post)."""
        _, multi_scale_feat = self._features(images, intrinsics)
        return self._segment(multi_scale_feat, tuple(images.shape[2:4]), word_embeddings, text_tokens)


def set_compute_dtype(model: SIU3RModel, dtype: str) -> SIU3RModel:
    """Switch ``model``'s compute dtype ("float32" or "bfloat16") in place:
    the backbone's and the adapter's layers compute in it from the next call
    on, as a model built with ``model.dtype: <dtype>``; the (fp32)
    parameters and buffers are untouched. Returns ``model``."""
    if dtype not in DTYPES:
        raise ValueError(f"model.dtype is one of {sorted(DTYPES)}, not {dtype!r}")
    for part in (model.backbone, model.adapter):
        set_layers_dtype(part, DTYPES[dtype])
    model.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    return model


def build_model(cfg: ModelCfg, device: str | torch.device = "cuda", seed: int = 0) -> SIU3RModel:
    """SIU3RModel in eval mode on ``device`` with a seeded random init."""
    return SIU3RModel(cfg, device=device, seed=seed).eval()
