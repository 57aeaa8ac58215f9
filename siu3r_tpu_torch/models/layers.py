"""Transformer building blocks of the CroCo backbone, counterpart of
``siu3r_tpu/models/layers.py``.

Pre-norm ViT blocks with RoPE2D on q/k inside attention, LayerNorm eps 1e-6
and exact GELU. Module and parameter names are the reference's torch names, so
a reference ``state_dict`` loads as it is.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.ops.attention import multi_head_attention, rope_attention

LayerNorm = partial(nn.LayerNorm, eps=1e-6)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H] (a strided view, unit stride on the head dim)."""
    b, n, c = x.shape
    return x.view(b, n, h, c // h).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class Attention(nn.Module):
    """Self-attention with RoPE2D."""

    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = 100.0):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [b, h, n, d] views
        if self.rope_base is not None:
            out = rope_attention(q, k, v, xpos, xpos, rope_base=self.rope_base)
        else:
            out = multi_head_attention(q, k, v)
        return self.proj(_merge_heads(out))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = 100.0):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, qpos, kpos, mask=None):
        h = self.num_heads
        q = _heads(self.projq(query), h)
        k = _heads(self.projk(key), h)
        v = _heads(self.projv(value), h)
        if self.rope_base is not None:
            out = rope_attention(q, k, v, qpos, kpos, rope_base=self.rope_base, mask=mask)
        else:
            out = multi_head_attention(q, k, v, mask=mask)
        return self.proj(_merge_heads(out))


class Block(nn.Module):
    """Encoder block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: Optional[float] = 100.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attention, cross-attention to the other views, MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: Optional[float] = 100.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.norm_y = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, y, xpos, ypos):
        """Two-view layer: x [B, L, C] cross-attends the other view's y."""
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))

    def forward_multi(self, x, xpos, bank, bank_pos, cross_mask):
        """Multi-view layer (``siu3r_tpu/models/backbone.py:MultiViewDecoderBlock``):
        x [B, Vq, L, C] with xpos [B, Vq, L, 2], self-attention within each
        view, then every view's queries cross-attend the bank [B, Vk*L, C]
        (positions [B, Vk*L, 2]) where ``cross_mask`` [1, Vq*L, Vk*L] allows
        (the plain path: masked attention runs no kernel), then the MLP."""
        b, vq, l, c = x.shape
        xf = x.reshape(b * vq, l, c)
        xf = xf + self.attn(self.norm1(xf), xpos.reshape(b * vq, l, 2))
        q = xf.reshape(b, vq * l, c)
        y_ = self.norm_y(bank)
        q = q + self.cross_attn(self.norm2(q), y_, y_, xpos.reshape(b, vq * l, 2), bank_pos, mask=cross_mask)
        q = q + self.mlp(self.norm3(q))
        return q.reshape(b, vq, l, c)


def token_positions(h: int, w: int, device=None) -> torch.Tensor:
    """Integer (y, x) position of each patch token, row-major: [h*w, 2]."""
    yy, xx = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


class PatchEmbed(nn.Module):
    """Conv p x p / stride p patchifier."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, images):
        """images [B, H, W, 3] -> tokens [B, N, C], pos [B, N, 2]."""
        b, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by {p}")
        x = self.proj(images.permute(0, 3, 1, 2))  # [B, C, gh, gw]
        x = x.flatten(2).transpose(1, 2)
        pos = token_positions(h // p, w // p, images.device)[None].expand(b, -1, -1)
        return x, pos


def resize_nhwc(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of an NHWC map (torch interpolate semantics)."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)
