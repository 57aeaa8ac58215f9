"""Masked-attention transformer decoder of the video Mask2Former, counterpart
of ``siu3r_tpu/models/mask2former/decoder.py``.

Learned queries; each layer is masked cross-attention to one pixel-decoder
level (restricted to the previous prediction's foreground, sigmoid >= 0.5; a
row that excludes every key attends everywhere instead), query
self-attention (the ``flash_attn`` kernel) and an FFN, post-norm. Batch-first
throughout; views are frames.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.config import Mask2formerCfg
from siu3r_tpu_torch.models.layers import resize_nhwc
from siu3r_tpu_torch.models.mask2former.position import sine_pos_embed_3d
from siu3r_tpu_torch.ops.attention import multi_head_attention


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.view(b, n, h, c // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed ``in_proj``),
    batch-first, with an exclude mask [B, Nq, Nk] (True = do not attend)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, exclude_mask: Optional[torch.Tensor] = None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        h = self.num_heads
        q = _heads(F.linear(query, wq, bq), h)
        k = _heads(F.linear(key, wk, bk), h)
        v = _heads(F.linear(value, wv, bv), h)
        mask = None if exclude_mask is None else ~exclude_mask
        return self.out_proj(_merge(multi_head_attention(q, k, v, mask=mask)))


class SelfAttention(nn.Module):
    """Position embeddings added to q and k; values from the plain states."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, hidden, pos):
        h = self.num_heads
        withpos = hidden + pos
        q = _heads(self.q_proj(withpos), h)
        k = _heads(self.k_proj(withpos), h)
        v = _heads(self.v_proj(hidden), h)
        return self.out_proj(_merge(multi_head_attention(q, k, v)))


class MLPPredictionHead(nn.Sequential):
    """3-layer MLP; child ``{i}.0`` is the Linear, ``{i}.1`` the activation."""

    def __init__(self, dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        dims_in = [dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        super().__init__(
            *[
                nn.Sequential(nn.Linear(i, o), nn.ReLU() if n < num_layers - 1 else nn.Identity())
                for n, (i, o) in enumerate(zip(dims_in, dims_out))
            ]
        )


class MaskPredictor(nn.Module):
    def __init__(self, cfg: Mask2formerCfg):
        super().__init__()
        self.mask_embedder = MLPPredictionHead(cfg.hidden_dim, cfg.hidden_dim, cfg.mask_feature_size)

    def forward(self, outputs, pixel_embeddings, target_hw: Tuple[int, int]):
        """outputs [B, Q, C]; pixel_embeddings [B, V, H, W, C]. Returns
        (mask_logits [B, Q, V, H, W], exclude_mask [B, Q, V*th*tw])."""
        mask_emb = self.mask_embedder(outputs)
        mask_logits = torch.einsum("bqc,bvhwc->bqvhw", mask_emb, pixel_embeddings)
        b, q, v, h, w = mask_logits.shape
        th, tw = target_hw
        att = resize_nhwc(mask_logits.reshape(b * q * v, h, w, 1), (th, tw), align_corners=False)
        att = torch.sigmoid(att).reshape(b, q, v * th * tw)
        return mask_logits, att < 0.5


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Mask2formerCfg):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.cross_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = SelfAttention(d, cfg.num_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, hidden, level_feat, level_pos, query_pos, exclude_mask):
        attn = self.cross_attn(hidden + query_pos, level_feat + level_pos, level_feat, exclude_mask)
        hidden = self.cross_attn_layer_norm(hidden + attn)
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(hidden, query_pos))
        ff = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + ff)


class _Decoder(nn.Module):
    def __init__(self, cfg: Mask2formerCfg):
        super().__init__()
        self.layers = nn.ModuleList([DecoderLayer(cfg) for _ in range(cfg.decoder_layers - 1)])
        self.layernorm = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)
        self.mask_predictor = MaskPredictor(cfg)


class VideoMask2FormerTransformerModule(nn.Module):
    def __init__(self, cfg: Mask2formerCfg):
        super().__init__()
        d = cfg.hidden_dim
        self.cfg = cfg
        self.level_embed = nn.Embedding(3, d)
        self.queries_features = nn.Embedding(cfg.num_queries, d)
        self.queries_embedder = nn.Embedding(cfg.num_queries, d)
        self.decoder = _Decoder(cfg)

    def forward(self, multi_scale_features: List[torch.Tensor], mask_features: torch.Tensor):
        """multi_scale_features: 3 x [B, V, h, w, d] (1/32, 1/16, 1/8);
        mask_features [B, V, H/4, W/4, d]. Returns ``intermediate`` (layernormed
        states per layer), ``mask_logits`` per layer and ``last_hidden_state``."""
        c = self.cfg
        b, v = mask_features.shape[:2]
        d = c.hidden_dim
        dev = mask_features.device
        level_feats, level_pos, size_list = [], [], []
        for i in range(3):
            f = multi_scale_features[i]
            hh, ww = f.shape[2], f.shape[3]
            size_list.append((hh, ww))
            pos = sine_pos_embed_3d(v, hh, ww, d // 2, device=dev)
            level_pos.append(pos.reshape(1, v * hh * ww, d))
            level_feats.append(f.reshape(b, v * hh * ww, d) + self.level_embed.weight[i])

        hidden = self.queries_features.weight[None].expand(b, -1, -1)
        query_pos = self.queries_embedder.weight[None].expand(b, -1, -1)
        dec = self.decoder

        inter = dec.layernorm(hidden)
        intermediate = [inter]
        pred_mask, exclude = dec.mask_predictor(inter, mask_features, size_list[0])
        mask_logits_all = [pred_mask]
        for idx, layer in enumerate(dec.layers):
            level = idx % 3
            exclude = exclude & ~exclude.all(dim=-1, keepdim=True)
            hidden = layer(hidden, level_feats[level], level_pos[level], query_pos, exclude)
            inter = dec.layernorm(hidden)
            intermediate.append(inter)
            pred_mask, exclude = dec.mask_predictor(inter, mask_features, size_list[(idx + 1) % 3])
            mask_logits_all.append(pred_mask)

        return {
            "intermediate": intermediate,
            "mask_logits": mask_logits_all,
            "last_hidden_state": hidden,
        }
