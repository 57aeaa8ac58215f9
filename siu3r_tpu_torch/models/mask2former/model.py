"""Top-level video Mask2Former, counterpart of
``siu3r_tpu/models/mask2former/model.py``: pixel decoder, masked-attention
transformer module and the class predictor on every intermediate state; for
text-referred segmentation (``cfg.train_refer_segmentation``), six language
cross-attention layers that match word embeddings against the object queries
(reference video_seg_decoder.py:2400-2443).

The language layers run after the decoder, never inside it: the reference's
top-level forward calls its decoder without the word embeddings, so the
decoder's own language path is dead code there and ``lang_input`` stays off
(the JAX package's note at the same place).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.config import Mask2formerCfg
from siu3r_tpu_torch.models.mask2former.decoder import MultiheadAttention, VideoMask2FormerTransformerModule
from siu3r_tpu_torch.models.mask2former.pixel_decoder import VideoMask2FormerPixelDecoder

LANG_LAYERS = 6


@dataclasses.dataclass
class SegOutput:
    class_queries_logits: torch.Tensor  # [B, Q, num_labels+1]
    masks_queries_logits: torch.Tensor  # [B, Q, V, H/4, W/4]
    aux_class_logits: List[torch.Tensor]  # per decoder state (incl. final)
    aux_mask_logits: List[torch.Tensor]
    last_hidden_state: torch.Tensor  # [B, Q, C]
    word_logits: Optional[torch.Tensor] = None  # [B, n_words, Q] with word embeddings


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
        self.refer = cfg.train_refer_segmentation
        if self.refer:
            d = cfg.hidden_dim
            layers = lambda make: nn.ModuleList([make() for _ in range(LANG_LAYERS)])
            # the query set is unmasked, so the attention takes the flash_attn kernel
            self.lang_cross_attns = layers(lambda: MultiheadAttention(d, cfg.num_attention_heads))
            self.lang_attn_norms = layers(lambda: nn.LayerNorm(d, eps=1e-5))
            self.lang_fc1s = layers(lambda: nn.Linear(d, d))
            self.lang_fc2s = layers(lambda: nn.Linear(d, d))
            self.lang_attn_norms_final = layers(lambda: nn.LayerNorm(d, eps=1e-5))

    def _word_logits(self, words: torch.Tensor, obj_queries: torch.Tensor) -> torch.Tensor:
        """words [B, W, C] against the decoder's last hidden state [B, Q, C]:
        the six post-norm layers, then the dot-product similarity [B, W, Q]."""
        hs = words
        for attn, norm, fc1, fc2, norm_final in zip(self.lang_cross_attns, self.lang_attn_norms, self.lang_fc1s,
                                                     self.lang_fc2s, self.lang_attn_norms_final):
            hs = norm(hs + attn(hs, obj_queries, obj_queries))
            hs = norm_final(hs + fc2(F.relu(fc1(hs))))
        return torch.einsum("bwc,bqc->bwq", hs, obj_queries)

    def forward(self, multi_scale_feat: List[torch.Tensor],
                word_embeddings: Optional[torch.Tensor] = None) -> SegOutput:
        """multi_scale_feat: 4 levels [B, V, H_l, W_l, C_in] (1/4 .. 1/32);
        word_embeddings: optional [B, n_words, hidden_dim] (needs the
        language layers of ``train_refer_segmentation``)."""
        if word_embeddings is not None and not self.refer:
            raise ValueError("word embeddings need the language layers: build the model with "
                             "mask2former.train_refer_segmentation")
        multi_scale, mask_features = self.model.pixel_decoder(multi_scale_feat)
        dec = self.model.transformer_module(multi_scale, mask_features)
        class_logits = [self.class_predictor(s) for s in dec["intermediate"]]
        word_logits = None
        if word_embeddings is not None:
            word_logits = self._word_logits(word_embeddings, dec["last_hidden_state"])
        return SegOutput(
            class_queries_logits=class_logits[-1],
            masks_queries_logits=dec["mask_logits"][-1],
            aux_class_logits=class_logits,
            aux_mask_logits=dec["mask_logits"],
            last_hidden_state=dec["last_hidden_state"],
            word_logits=word_logits,
        )
