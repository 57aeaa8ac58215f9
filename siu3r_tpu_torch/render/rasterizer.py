"""Tile-based 3D Gaussian splat rasterizer, counterpart of the non-kernel
parts of ``siu3r_tpu/render/rasterizer.py``.

1. EWA projection (``render/projection.py``);
2. tile binning (``kernels/binning.py``): each 16x128 tile lists the first K
   alive gaussians in stable depth order whose 3-sigma box, clamped to a
   static slot grid, covers it;
3. compositing (``kernels/raster.py``): each tile front to back over its
   list, with the whole-tile exit at transmittance 1e-4. Outputs colour,
   expected depth and alpha, differentiable in the projected params and the
   colours (the backward is the ``raster_bwd`` kernel on CUDA), so gradients
   reach the means, covariances, opacities and colours through the
   projection; the binning carries none.

Every view of every scene is flattened into one batch dimension, so a
render makes one binning launch and one raster launch per channel set,
whatever its width (the kernel sweeps the channels in groups). Lists are
capped at K (the farthest gaussians are cut) and footprints at the slot
grid, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from siu3r_tpu_torch.kernels.binning import _flat, bin_gaussians
from siu3r_tpu_torch.kernels.raster import raster
from siu3r_tpu_torch.render.projection import Bound, ProjectedGaussians, project_gaussians
from siu3r_tpu_torch.render.tiles import _ALPHA_MAX, _ALPHA_MIN, _CHUNK, SLOTS_X, SLOTS_Y, _tile_ranges, tile_grid


def pack_params(proj: ProjectedGaussians, opacities: torch.Tensor) -> torch.Tensor:
    """The compositing's per-gaussian record [..., G, 8]: (mx, my, a, b, c,
    opacity, depth, 0); opacities broadcast against proj.depth."""
    return torch.stack(
        [
            proj.mean2d[..., 0],
            proj.mean2d[..., 1],
            proj.conic[..., 0],
            proj.conic[..., 1],
            proj.conic[..., 2],
            opacities.expand_as(proj.depth),
            proj.depth,
            torch.zeros_like(proj.depth),
        ],
        dim=-1,
    )


def bin_gaussians_sort(
    proj: ProjectedGaussians,
    image_size: Tuple[int, int],
    max_per_tile: int,
    slots_y: int,
    slots_x: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile binning by one sort of packed keys, counterpart of
    ``siu3r_tpu/render/rasterizer.py:bin_gaussians_sort``: the same
    (table [..., T, K], counts [..., T]) as ``kernels.binning.bin_gaussians``
    from the same [..., G] projected Gaussians (table entries past a tile's
    count are some gaussian id). No render path selects it: it is a second,
    independent oracle of the binning kernel.

    Each (gaussian, slot) pair whose slot lies in the gaussian's slot-clamped
    tile box gives the key ((view * T + tile) * G + depth rank), int64, the
    rank from a stable sort of depth; every view's keys go through one sort,
    so each (view, tile) segment lists its gaussians in depth order."""
    lead = proj.depth.shape[:-1]
    p = _flat(proj)
    n, g = p.depth.shape
    n_ty, n_tx = tile_grid(image_size)
    n_tiles = n_ty * n_tx
    dev = p.depth.device

    order = torch.sort(p.depth, dim=-1, stable=True).indices  # [N, G]
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(g, device=dev).expand(n, g))
    y0, y1, x0, x1, alive = _tile_ranges(p, n_ty, n_tx, slots_y, slots_x)
    sy = torch.arange(slots_y, device=dev)[:, None]
    sx = torch.arange(slots_x, device=dev)[None, :]
    ty = y0[..., None, None] + sy  # [N, G, slots_y, slots_x]
    tx = x0[..., None, None] + sx
    ok = alive[..., None, None] & (ty <= y1[..., None, None]) & (tx <= x1[..., None, None])
    view = torch.arange(n, device=dev)[:, None, None, None]
    key = (view * n_tiles + ty * n_tx + tx) * g + rank[..., None, None]  # int64, as view and rank are
    invalid = n * n_tiles * g  # past every segment
    sorted_keys = torch.where(ok, key, invalid).reshape(-1).sort().values

    segments = sorted_keys // g
    seg_range = torch.arange(n * n_tiles, device=dev)
    starts = torch.searchsorted(segments, seg_range)
    counts = (torch.searchsorted(segments, seg_range + 1) - starts).clamp(max=max_per_tile)
    idx = (starts[:, None] + torch.arange(max_per_tile, device=dev)).clamp(max=sorted_keys.numel() - 1)
    ranks = (sorted_keys[idx] % g).reshape(n, n_tiles * max_per_tile)
    table = order.gather(1, ranks).reshape(n, n_tiles, max_per_tile).to(torch.int32)
    return table.reshape(*lead, n_tiles, max_per_tile), counts.to(torch.int32).reshape(*lead, n_tiles)


def rasterize_multi(
    means: torch.Tensor,
    covariances: torch.Tensor,
    opacities: torch.Tensor,
    colors_list: Sequence[torch.Tensor],
    viewmats: torch.Tensor,
    intrinsics_px: torch.Tensor,
    image_size: Tuple[int, int],
    near: Bound = 0.2,
    far: Bound = 1000.0,
    max_per_tile: int = 4096,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Rasterize scenes into their views, compositing any number of channel
    sets over one shared projection and binning.

    means [..., G, 3]; covariances [..., G, 3, 3]; opacities [..., G]; each
    entry of ``colors_list`` is [..., G, C_i], shared by a scene's views, or
    [..., V, G, C_i] per view (SH evaluated per view); viewmats [..., V, 4, 4]
    world-to-camera; intrinsics_px [..., V, 3, 3]; near/far floats or
    [..., V] tensors. ``...`` is the scenes' leading shape (none for one
    scene).

    Returns (list of color [..., V, H, W, C_i], with no background blended,
    depth [..., V, H, W], alpha [..., V, H, W]).
    """
    # the compositing takes the lists in 128-gaussian chunks
    max_per_tile = -(-max_per_tile // _CHUNK) * _CHUNK
    n_ty, n_tx = tile_grid(image_size)

    proj = project_gaussians(
        means.unsqueeze(-3), covariances.unsqueeze(-4), viewmats, intrinsics_px,
        image_size, near, far,
    )  # [..., V, G]
    # the binning is gradient-free, as in the JAX package: its table and
    # counts are integers
    table, counts = bin_gaussians(
        ProjectedGaussians(*(x.detach() for x in proj)), image_size, max_per_tile,
        min(SLOTS_Y, n_ty), min(SLOTS_X, n_tx),
    )
    params = pack_params(proj, opacities.unsqueeze(-2))

    outs = []
    depth = alpha = None
    for colors in colors_list:
        color, d, a, _ = raster(table, counts, params, colors, image_size)
        outs.append(color)
        if depth is None:
            depth, alpha = d, a
    return outs, depth, alpha


def rasterize(
    means: torch.Tensor,
    covariances: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmats: torch.Tensor,
    intrinsics_px: torch.Tensor,
    image_size: Tuple[int, int],
    near: Bound = 0.2,
    far: Bound = 1000.0,
    background: Optional[torch.Tensor] = None,
    max_per_tile: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One channel set through :func:`rasterize_multi`, with the background
    blended by 1 - alpha. Returns (color [..., V, H, W, C], depth, alpha)."""
    outs, depth, alpha = rasterize_multi(
        means, covariances, opacities, [colors], viewmats, intrinsics_px, image_size,
        near=near, far=far, max_per_tile=max_per_tile,
    )
    color = outs[0]
    if background is not None:
        color = color + (1.0 - alpha).unsqueeze(-1) * background
    return color, depth, alpha


def rasterize_reference(
    means: torch.Tensor,
    covariances: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmats: torch.Tensor,
    intrinsics_px: torch.Tensor,
    image_size: Tuple[int, int],
    near: float = 0.2,
    far: float = 1000.0,
    background: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slow dense compositor with no tiling and no cut, the oracle of the
    tests: O(G * H * W), tiny inputs only. One scene: means [G, 3],
    viewmats [V, 4, 4]; colors [G, C]."""
    h, w = image_size
    dev = means.device
    outs = []
    for viewmat, intr in zip(viewmats, intrinsics_px):
        proj = project_gaussians(means, covariances, viewmat, intr, image_size, near, far)
        order = torch.argsort(proj.depth, stable=True)
        mean2d, conic = proj.mean2d[order], proj.conic[order]
        depth, radius = proj.depth[order], proj.radius[order]
        op, col = opacities[order], colors[order]
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        dx = xx[None] - mean2d[:, 0, None, None]
        dy = yy[None] - mean2d[:, 1, None, None]
        power = (
            -0.5 * (conic[:, 0, None, None] * dx * dx + conic[:, 2, None, None] * dy * dy)
            - conic[:, 1, None, None] * dx * dy
        )
        alpha = torch.clamp(op[:, None, None] * torch.exp(power), max=_ALPHA_MAX)
        alpha = torch.where(alpha >= _ALPHA_MIN, alpha, torch.zeros_like(alpha))
        alpha = torch.where(radius[:, None, None] > 0, alpha, torch.zeros_like(alpha))
        trans = torch.cumprod(1.0 - alpha, dim=0)
        trans = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
        wgt = trans * alpha  # [G, H, W]
        img = torch.einsum("ghw,gc->hwc", wgt, col)
        dimg = torch.einsum("ghw,g->hw", wgt, depth)
        aimg = 1.0 - torch.prod(1.0 - alpha, dim=0)
        if background is not None:
            img = img + (1.0 - aimg)[..., None] * background
        outs.append((img, dimg, aimg))
    return tuple(torch.stack(x) for x in zip(*outs))
