"""Sine position embeddings of the video Mask2Former, counterpart of
``siu3r_tpu/models/mask2former/position.py`` (normalize=True, scale 2*pi;
outputs [H, W, C] and [T, H, W, C])."""

from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.floor(i / 2) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """sin on even dims, cos on odd dims, interleaved."""
    return torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1).reshape(pos.shape)


def sine_pos_embed_2d(
    h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    """[H, W, 2*num_pos_feats] = concat(y-embed, x-embed)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None] / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :] / (w + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, device)
    pos_y = _interleave_sin_cos(y[..., None].expand(h, w, num_pos_feats) / dim_t)
    pos_x = _interleave_sin_cos(x[..., None].expand(h, w, num_pos_feats) / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_pos_embed_3d(
    t: int, h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    """[T, H, W, 2*num_pos_feats]: concat(y, x) plus a frame term."""
    scale = 2 * math.pi
    eps = 1e-6
    yx = sine_pos_embed_2d(h, w, num_pos_feats, temperature, device)
    z = torch.arange(1, t + 1, dtype=torch.float32, device=device) / (t + eps) * scale
    pos_z = _interleave_sin_cos(z[:, None] / _dim_t(2 * num_pos_feats, temperature, device))
    return yx[None] + pos_z[:, None, None, :]
