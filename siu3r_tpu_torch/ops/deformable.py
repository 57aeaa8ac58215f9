"""Bilinear point sampling and multi-scale deformable attention, plain
PyTorch, counterpart of ``siu3r_tpu/ops/deformable.py``.

Bilinear sampling with zero padding and ``align_corners=False`` semantics,
the sample point of a location ``x`` in [0, 1] on a level of width W being
``x * W - 0.5``. ``multi_scale_deformable_attention`` (gather form) is the
plain version that ``kernels/msda.py`` holds its CUDA kernel against; the
one-hot matrix product of the JAX default path is a TPU formulation of the
same function and is not carried over. ``grid_sample_bilinear`` is the
criterion's and the matcher's point sampler, in fp32 throughout (the JAX
package's separable one-hot form, ``grid_sample_separable``, is again the
same function laid out for the TPU's matrix unit, and it samples the binary
ground-truth masks with bf16 products; neither choice is carried over).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``torch.nn.functional.grid_sample(mode="bilinear", padding_mode="zeros",
    align_corners=False)`` for flattened sample points: img [B, H, W, C];
    grid [B, P, 2] normalised (x, y) in [-1, 1]. Returns [B, P, C]."""
    b, h, w, c = img.shape
    gx = (grid[..., 0] + 1.0) * w / 2.0 - 0.5
    gy = (grid[..., 1] + 1.0) * h / 2.0 - 0.5
    return _sample_level(img.reshape(b, h * w, c), gx, gy, h, w)


def _sample_level(
    img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, hh: int, ww: int
) -> torch.Tensor:
    """img [N, HW, D]; gx/gy [N, P] pixel-space sample points -> [N, P, D]."""
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    d = img.shape[-1]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < hh) & (xi >= 0) & (xi < ww)
        idx = (yi.clamp(0, hh - 1) * ww + xi.clamp(0, ww - 1))[..., None]
        vals = torch.gather(img, 1, idx.expand(-1, -1, d))
        return vals * valid[..., None].to(img.dtype)

    return (
        tap(y0, x0) * (1 - wx) * (1 - wy)
        + tap(y0, x0 + 1) * wx * (1 - wy)
        + tap(y0 + 1, x0) * (1 - wx) * wy
        + tap(y0 + 1, x0 + 1) * wx * wy
    )


def multi_scale_deformable_attention(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [B, Len_in, H, D] (Len_in = sum of h*w over levels);
    sampling_locations [B, Lq, H, L, P, 2] in [0, 1] as (x, y);
    attention_weights [B, Lq, H, L, P]. Returns [B, Lq, H*D] in value's
    dtype, sampled and accumulated in fp32."""
    b, _, n_heads, head_dim = value.shape
    _, lq, _, _, n_points, _ = sampling_locations.shape
    out = torch.zeros((b, n_heads, lq, head_dim), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        img = value[:, start : start + hh * ww].float()  # [B, HW, H, D]
        start += hh * ww
        img = img.permute(0, 2, 1, 3).reshape(b * n_heads, hh * ww, head_dim)
        loc = sampling_locations[:, :, :, lvl].float()  # [B, Lq, H, P, 2]
        loc = loc.permute(0, 2, 1, 3, 4).reshape(b * n_heads, lq * n_points, 2)
        gx = loc[..., 0] * ww - 0.5
        gy = loc[..., 1] * hh - 0.5
        sampled = _sample_level(img, gx, gy, hh, ww)
        sampled = sampled.reshape(b, n_heads, lq, n_points, head_dim)
        w = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3)  # [B, H, Lq, P]
        out = out + torch.einsum("bhqp,bhqpd->bhqd", w, sampled)
    out = out.permute(0, 2, 1, 3).reshape(b, lq, n_heads * head_dim)
    return out.to(value.dtype)


def reference_points_for_shapes(
    spatial_shapes: Sequence[Tuple[int, int]], device=None
) -> torch.Tensor:
    """Pixel-centre reference points, normalised per level and concatenated.
    Returns [1, sum(h*w), 1, 2] as (x, y)."""
    pts = []
    for hh, ww in spatial_shapes:
        ys = (torch.arange(hh, dtype=torch.float32, device=device) + 0.5) / hh
        xs = (torch.arange(ww, dtype=torch.float32, device=device) + 0.5) / ww
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    return torch.cat(pts, dim=0)[None, :, None, :]
