"""Video Mask2Former pixel decoder, counterpart of
``siu3r_tpu/models/mask2former/pixel_decoder.py``: input projections
(1x1 conv + GroupNorm(32)) of the 1/32, 1/16, 1/8 levels, six deformable
encoder layers over their concatenated tokens (``MSDeformAttn``, whose
sampling runs in the ``msda`` kernel), an extra FPN level at 1/4 and a 1x1 mask projection. Views
ride the batch axis; maps are NHWC at the boundary."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.config import Mask2formerCfg
from siu3r_tpu_torch.models.adapter import MSDeformAttn
from siu3r_tpu_torch.models.mask2former.position import sine_pos_embed_2d
from siu3r_tpu_torch.ops.deformable import reference_points_for_shapes


def _proj(cin: int, d: int, bias: bool = True) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, d, 1, bias=bias), nn.GroupNorm(32, d, eps=1e-5))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, cfg: Mask2formerCfg, n_levels: int):
        super().__init__()
        d = cfg.feature_size
        self.self_attn = MSDeformAttn(d, n_levels, cfg.num_attention_heads, n_points=4)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.encoder_feedforward_dim)
        self.fc2 = nn.Linear(cfg.encoder_feedforward_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, hidden, pos_embed, reference_points, spatial_shapes):
        attn = self.self_attn(hidden + pos_embed, reference_points, hidden, spatial_shapes)
        hidden = self.self_attn_layer_norm(hidden + attn)
        ff = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + ff)


class _Encoder(nn.Module):
    def __init__(self, cfg: Mask2formerCfg, n_levels: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [DeformableEncoderLayer(cfg, n_levels) for _ in range(cfg.encoder_layers)]
        )


class VideoMask2FormerPixelDecoder(nn.Module):
    def __init__(self, cfg: Mask2formerCfg, in_channels: int):
        super().__init__()
        d = cfg.feature_size
        self.cfg = cfg
        self.level_embed = nn.Parameter(torch.zeros(3, d))
        self.input_projections = nn.ModuleList([_proj(in_channels, d) for _ in range(3)])
        self.encoder = _Encoder(cfg, 3)
        self.adapter_1 = _proj(in_channels, d, bias=False)
        self.layer_1 = nn.Sequential(
            nn.Conv2d(d, d, 3, 1, 1, bias=False), nn.GroupNorm(32, d, eps=1e-5), nn.ReLU()
        )
        self.mask_projection = nn.Conv2d(d, cfg.mask_feature_size, 1)

    def forward(self, features: List[torch.Tensor]):
        """features: 4 levels [B, V, H_l, W_l, C_in], high -> low resolution.
        Returns (3 x [B, V, h, w, d] at 1/32, 1/16, 1/8; mask_features
        [B, V, H/4, W/4, d_mask])."""
        d = self.cfg.feature_size
        b, v = features[0].shape[:2]
        flat = [f.reshape((b * v,) + tuple(f.shape[2:])).permute(0, 3, 1, 2) for f in features]

        levels = [flat[3], flat[2], flat[1]]
        embeds, pos_embeds, shapes = [], [], []
        for i, x in enumerate(levels):
            e = self.input_projections[i](x)  # [N, d, h, w]
            hh, ww = e.shape[2], e.shape[3]
            shapes.append((hh, ww))
            embeds.append(e.flatten(2).transpose(1, 2))
            pe = sine_pos_embed_2d(hh, ww, d // 2, device=x.device).reshape(1, hh * ww, d)
            pos_embeds.append(pe + self.level_embed[i])

        hidden = torch.cat(embeds, dim=1)
        pos = torch.cat(pos_embeds, dim=1)
        ref = reference_points_for_shapes(shapes, hidden.device)
        ref = ref.expand(1, ref.shape[1], len(shapes), 2)
        for layer in self.encoder.layers:
            hidden = layer(hidden, pos, ref, shapes)

        outputs = []
        start = 0
        for hh, ww in shapes:
            outputs.append(hidden[:, start : start + hh * ww].transpose(1, 2).reshape(b * v, d, hh, ww))
            start += hh * ww

        lateral = self.adapter_1(flat[0])
        up = F.interpolate(outputs[-1], size=lateral.shape[2:], mode="bilinear", align_corners=False)
        outputs.append(self.layer_1(lateral + up))
        mask_features = self.mask_projection(outputs[-1])

        unflat = lambda x: x.permute(0, 2, 3, 1).reshape((b, v) + tuple(x.shape[2:]) + (x.shape[1],))
        return [unflat(o) for o in outputs[:3]], unflat(mask_features)
