"""Tile-compositing kernel wrapper: ``csrc/raster.cu`` and its plain version.

Replaces the TPU kernel ``_raster_kernel`` of ``siu3r_tpu/render/rasterizer.py``;
launches are counted as ``raster``. Both versions composite each 16x128 tile
of each view front to back over the tile's list from the binning and return
the untiled image. The kernel stops a tile once every pixel's transmittance
is at most 1e-4 (as the TPU kernel does); the plain version, like
``_tiles_jnp``, composites every listed gaussian, so the two differ by the
contributions below that transmittance.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from siu3r_tpu_torch.kernels import _build
from siu3r_tpu_torch.render.tiles import (
    _ALPHA_MAX,
    _ALPHA_MIN,
    _CHUNK,
    _T_EPS,
    TILE_H,
    TILE_W,
    tile_grid,
)


def tiles_plain(
    counts: torch.Tensor,
    row0: torch.Tensor,
    col0: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counterpart of ``_tiles_jnp``: the chunked log-sum transmittance math
    with no early exit. counts/row0/col0 [NT] int; params [NT, K, 8]
    (mx, my, a, b, c, opacity, depth, 0); colors [NT, K, C]. Returns color
    [NT, C, 16, 128], depth and alpha [NT, 16, 128], and the chunks the
    kernel's whole-tile exit would sweep [NT] int32."""
    nt, k_cap, _ = params.shape
    n_channels = colors.shape[-1]
    if k_cap % _CHUNK:
        raise ValueError(f"the list length {k_cap} is not a multiple of {_CHUNK}")
    dev = params.device
    npix = TILE_H * TILE_W
    p = torch.arange(npix, device=dev)
    px = col0.to(torch.float32)[:, None, None] + (p % TILE_W).to(torch.float32)  # [NT, 1, npix]
    py = row0.to(torch.float32)[:, None, None] + (p // TILE_W).to(torch.float32)
    ar = torch.arange(_CHUNK, device=dev)
    tril = (ar[None, :] < ar[:, None]).to(torch.float32)  # strictly lower: exclusive cumsum
    counts = counts.reshape(nt, 1, 1)

    trans = torch.ones((nt, 1, npix), dtype=torch.float32, device=dev)
    color_acc = torch.zeros((nt, n_channels, npix), dtype=torch.float32, device=dev)
    depth_acc = torch.zeros((nt, 1, npix), dtype=torch.float32, device=dev)
    swept = torch.zeros((nt,), dtype=torch.int32, device=dev)
    for base in range(0, k_cap, _CHUNK):
        # the kernel's loop condition before this chunk (monotone: once false, it stays false)
        swept += ((base < counts.view(nt)) & (trans.amax(dim=(1, 2)) > _T_EPS)).to(torch.int32)
        prm = params[:, base : base + _CHUNK]  # [NT, CHUNK, 8]
        col = colors[:, base : base + _CHUNK]  # [NT, CHUNK, C]
        dx = px - prm[..., 0:1]  # [NT, CHUNK, npix]
        dy = py - prm[..., 1:2]
        power = -0.5 * (prm[..., 2:3] * dx * dx + prm[..., 4:5] * dy * dy) - prm[..., 3:4] * dx * dy
        alpha = torch.clamp(prm[..., 5:6] * torch.exp(power), max=_ALPHA_MAX)
        alpha = torch.where(alpha >= _ALPHA_MIN, alpha, torch.zeros_like(alpha))
        k_ids = base + ar[None, :, None]
        alpha = torch.where(k_ids < counts, alpha, torch.zeros_like(alpha))
        logs = torch.log1p(-alpha)
        cum_excl = tril @ logs
        wgt = alpha * trans * torch.exp(cum_excl)
        color_acc = color_acc + col.transpose(1, 2) @ wgt  # [NT, C, npix]
        depth_acc = depth_acc + (prm[..., 6:7] * wgt).sum(dim=1, keepdim=True)
        trans = trans * torch.exp(logs.sum(dim=1, keepdim=True))
    return (
        color_acc.reshape(nt, n_channels, TILE_H, TILE_W),
        depth_acc.reshape(nt, TILE_H, TILE_W),
        (1.0 - trans).reshape(nt, TILE_H, TILE_W),
        swept,
    )


def untile(x: torch.Tensor, n_views: int, image_size: Tuple[int, int]) -> torch.Tensor:
    """[N*T, C, 16, 128] -> [N, H, W, C] (tiles in row-major order)."""
    h, w = image_size
    n_ty, n_tx = tile_grid(image_size)
    c = x.shape[1]
    x = x.reshape(n_views, n_ty, n_tx, c, TILE_H, TILE_W).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n_views, n_ty * TILE_H, n_tx * TILE_W, c)[:, :h, :w]


def _flatten(table, counts, params, colors):
    lead = table.shape[:-2]
    t, k = table.shape[-2:]
    n = math.prod(lead)
    g = params.shape[-2]
    if params.shape[:-2] != lead or params.shape[-1] != 8:
        raise ValueError(f"params {tuple(params.shape)} is not [*{tuple(lead)}, G, 8]")
    if counts.shape != (*lead, t):
        raise ValueError(f"counts {tuple(counts.shape)} is not [*{tuple(lead)}, {t}]")
    if colors.shape[-2] != g:
        raise ValueError(f"colors {tuple(colors.shape)} do not hold G={g} gaussians")
    cols = colors.reshape(-1, g, colors.shape[-1])
    if n % cols.shape[0]:
        raise ValueError(f"{n} views do not split evenly over {cols.shape[0]} colour sets")
    return lead, table.reshape(n, t, k), counts.reshape(n, t), params.reshape(n, g, 8), cols


def raster_plain(
    table: torch.Tensor,
    counts: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
    image_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wrapper's function in plain PyTorch: gather each tile's params and
    colours through the table, then ``tiles_plain``, then untile."""
    lead, table, counts, params, cols = _flatten(table, counts, params, colors)
    n, t, k = table.shape
    n_ty, n_tx = tile_grid(image_size)
    if t != n_ty * n_tx:
        raise ValueError(f"the table has {t} tiles, the image {n_ty * n_tx}")
    idx = table.reshape(n, t * k).long()
    gp = params.gather(1, idx[..., None].expand(-1, -1, 8)).reshape(n * t, k, 8)
    slab = torch.arange(n, device=table.device) // (n // cols.shape[0])
    gc = cols[slab[:, None], idx].reshape(n * t, k, cols.shape[-1])
    tile_ids = torch.arange(t, dtype=torch.int32, device=table.device)
    row0 = ((tile_ids // n_tx) * TILE_H).repeat(n)
    col0 = ((tile_ids % n_tx) * TILE_W).repeat(n)
    color_t, depth_t, alpha_t, swept = tiles_plain(counts.reshape(-1), row0, col0, gp, gc)
    color = untile(color_t, n, image_size)
    depth = untile(depth_t[:, None], n, image_size)[..., 0]
    alpha = untile(alpha_t[:, None], n, image_size)[..., 0]
    h, w = image_size
    return (
        color.reshape(*lead, h, w, -1), depth.reshape(*lead, h, w),
        alpha.reshape(*lead, h, w), swept.reshape(*lead, t),
    )


def raster(
    table: torch.Tensor,
    counts: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
    image_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every tile of every view.

    table [..., T, K] and counts [..., T] int32 from ``bin_gaussians``
    (K a multiple of 128); params [..., G, 8] fp32; colors [M, G, C] fp32
    (any leading shape that flattens to M colour sets; a non-unit channel
    stride is copied to unit stride), view n using set n // (views / M).
    Returns color [..., H, W, C], depth and alpha [..., H, W] and the chunks
    swept per tile [..., T] int32.
    CPU tensors take the plain version; CUDA tensors launch the kernel, all
    views in one launch."""
    dev = table.device
    if dev.type == "cpu":
        return raster_plain(table, counts, params, colors, image_size)
    if dev.type != "cuda":
        raise ValueError(f"raster runs on cuda or cpu tensors, got {dev}")
    lead, table, counts, params, cols = _flatten(table, counts, params, colors)
    n, t, k = table.shape
    g, c = cols.shape[1:]
    n_ty, n_tx = tile_grid(image_size)
    if t != n_ty * n_tx or k % _CHUNK or g < 1 or c < 1:
        raise ValueError(f"table [{n}, {t}, {k}] does not fit the image {image_size} in 16x128 tiles "
                         f"with K a multiple of {_CHUNK}, or there are no gaussians or channels")
    for name, x, dtype in (("table", table, torch.int32), ("counts", counts, torch.int32),
                           ("params", params, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
    if cols.device != dev or cols.dtype != torch.float32:
        raise ValueError(f"colors must be fp32 on {dev}")
    if cols.stride(-1) != 1:  # the kernel reads a gaussian's channels as one row
        cols = cols.contiguous()
    h, w = image_size
    color = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
    depth = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    alpha = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    swept = torch.empty((n, t), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    err = lib.siu3r_raster_fwd(
        table.data_ptr(), counts.data_ptr(), params.data_ptr(), cols.data_ptr(),
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), swept.data_ptr(),
        n, n_ty, n_tx, k, g, h, w, c, n // cols.shape[0], cols.stride(0), cols.stride(1),
        _build.stream_handle(dev),
    )
    _build.check_launch(err, "raster")
    _build.launch_counts["raster"] += 1
    return (
        color.reshape(*lead, h, w, c), depth.reshape(*lead, h, w),
        alpha.reshape(*lead, h, w), swept.reshape(*lead, t),
    )
