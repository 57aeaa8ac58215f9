"""2D rotary position embedding (RoPE2D), counterpart of ``siu3r_tpu/ops/rope.py``.

The head dim D is split in half: the first half is rotated by the token's y
position, the second by its x position, each half in the rotate-half layout
with ``D/4`` frequencies ``base**(-2i/(D/2))`` (the "quarter" layout of
``_rotate_half2``, not the common half layout).
"""

from __future__ import annotations

import torch


def rope2d_cos_sin(positions: torch.Tensor, head_dim: int, base: float = 100.0,
                   dtype: torch.dtype = torch.float32):
    """positions [B, N, 2] integer (y, x) -> cos, sin [B, N, D], laid out so
    that ``out = tokens * cos + _rotate_half2(tokens) * sin``; computed in
    fp32, then rounded to ``dtype`` (bf16 for the bf16 kernel, as the JAX
    package casts the tables to q's dtype)."""
    if head_dim % 4 != 0:
        raise ValueError(f"head_dim must be divisible by 4, got {head_dim}")
    half = head_dim // 2
    inv_freq = 1.0 / (
        base ** (torch.arange(0, half, 2, dtype=torch.float32, device=positions.device) / half)
    )
    freqs = positions.to(torch.float32)[..., None] * inv_freq  # [B, N, 2, D/4]
    freqs = torch.cat([freqs, freqs], dim=-1)  # [B, N, 2, D/2]
    angles = torch.cat([freqs[..., 0, :], freqs[..., 1, :]], dim=-1)  # [B, N, D]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate_half2(x: torch.Tensor) -> torch.Tensor:
    """rotate_half applied independently to the y-half and the x-half."""
    y1, y2, x1, x2 = x.chunk(4, dim=-1)
    return torch.cat([-y2, y1, -x2, x1], dim=-1)


def rope2d_from_cos_sin(
    tokens: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """tokens [B, H, N, D]; cos/sin [B, N, D], cast to the tokens' dtype. In
    bf16 each product and the sum round to bf16."""
    cos = cos[:, None].to(tokens.dtype)
    sin = sin[:, None].to(tokens.dtype)
    return tokens * cos + _rotate_half2(tokens) * sin


def rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """tokens [B, H, N, D]; positions [B, N, 2] int (y, x)."""
    cos, sin = rope2d_cos_sin(positions, tokens.shape[-1], base=base)
    return rope2d_from_cos_sin(tokens, cos, sin)
