"""Top-level video Mask2Former, counterpart of
``siu3r_tpu/models/mask2former/model.py`` (without the refer path's language
layers, which wait for a later slice): pixel decoder, masked-attention
transformer module and the class predictor on every intermediate state."""

from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn

from siu3r_tpu_torch.config import Mask2formerCfg
from siu3r_tpu_torch.models.mask2former.decoder import VideoMask2FormerTransformerModule
from siu3r_tpu_torch.models.mask2former.pixel_decoder import VideoMask2FormerPixelDecoder


@dataclasses.dataclass
class SegOutput:
    class_queries_logits: torch.Tensor  # [B, Q, num_labels+1]
    masks_queries_logits: torch.Tensor  # [B, Q, V, H/4, W/4]
    aux_class_logits: List[torch.Tensor]  # per decoder state (incl. final)
    aux_mask_logits: List[torch.Tensor]
    last_hidden_state: torch.Tensor  # [B, Q, C]


class _Model(nn.Module):
    def __init__(self, cfg: Mask2formerCfg, in_channels: int):
        super().__init__()
        self.pixel_decoder = VideoMask2FormerPixelDecoder(cfg, in_channels)
        self.transformer_module = VideoMask2FormerTransformerModule(cfg)


class VideoMask2Former(nn.Module):
    def __init__(self, cfg: Mask2formerCfg, in_channels: int = 1024):
        super().__init__()
        self.model = _Model(cfg, in_channels)
        self.class_predictor = nn.Linear(cfg.hidden_dim, cfg.num_labels + 1)

    def forward(self, multi_scale_feat: List[torch.Tensor]) -> SegOutput:
        """multi_scale_feat: 4 levels [B, V, H_l, W_l, C_in] (1/4 .. 1/32)."""
        multi_scale, mask_features = self.model.pixel_decoder(multi_scale_feat)
        dec = self.model.transformer_module(multi_scale, mask_features)
        class_logits = [self.class_predictor(s) for s in dec["intermediate"]]
        return SegOutput(
            class_queries_logits=class_logits[-1],
            masks_queries_logits=dec["mask_logits"][-1],
            aux_class_logits=class_logits,
            aux_mask_logits=dec["mask_logits"],
            last_hidden_state=dec["last_hidden_state"],
        )
