"""The rasterizer's tile grid and compositing constants, shared by
``render/rasterizer.py`` and the binning and raster kernels' wrappers
(counterparts of ``siu3r_tpu/render/rasterizer.py:36-59``)."""

from __future__ import annotations

from typing import Tuple

import torch

from siu3r_tpu_torch.render.projection import ProjectedGaussians

TILE_H = 16
TILE_W = 128
_CHUNK = 128  # gaussians composited per step; the K cap is a multiple of it
_ALPHA_MIN = 1.0 / 255.0
_ALPHA_MAX = 0.99
_T_EPS = 1e-4  # whole-tile early exit once every pixel's transmittance is below
# the static slot grid: a footprint spans at most 4 tile rows and 2 tile
# columns (fewer where the image has fewer)
SLOTS_Y = 4
SLOTS_X = 2


def tile_grid(image_size: Tuple[int, int]) -> Tuple[int, int]:
    h, w = image_size
    return -(-h // TILE_H), -(-w // TILE_W)


def _tile_ranges(proj: ProjectedGaussians, n_ty: int, n_tx: int, slots_y: int, slots_x: int):
    """Per-gaussian touched-tile ranges (the 3-sigma box, clamped to the
    static slot grid, which truncates extreme outliers).
    Returns (y0, y1, x0, x1, alive), int32 ranges of proj's leading shape."""
    u, v = proj.mean2d[..., 0], proj.mean2d[..., 1]
    r = proj.radius

    def tile(x, size, n):
        return torch.floor(x / size).clamp(0, n - 1).to(torch.int32)

    x0 = tile(u - r, TILE_W, n_tx)
    x1 = tile(u + r, TILE_W, n_tx)
    y0 = tile(v - r, TILE_H, n_ty)
    y1 = tile(v + r, TILE_H, n_ty)
    y1 = torch.minimum(y1, y0 + (slots_y - 1))
    x1 = torch.minimum(x1, x0 + (slots_x - 1))
    return y0, y1, x0, x1, r > 0
