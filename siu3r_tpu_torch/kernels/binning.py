"""Tile-binning kernel wrapper: ``csrc/binning.cu`` and its plain version.

Replaces the TPU kernel ``_bin_kernel`` of ``siu3r_tpu/render/rasterizer.py``;
launches are counted as ``bin`` (one count: three device launches after the
depth sort, see ``_build``). Both versions give each 16x128 tile of each
view the first K alive gaussians, in stable depth order, whose slot-clamped
3-sigma tile range covers it: a table [..., T, K] of gaussian ids and counts
[..., T]. Table entries past a tile's count are unspecified (the kernel
writes 0, the plain version some id); both are valid gaussian ids.
"""

from __future__ import annotations

from typing import Tuple

import torch

from siu3r_tpu_torch.kernels import _build
from siu3r_tpu_torch.render.projection import ProjectedGaussians
from siu3r_tpu_torch.render.tiles import TILE_H, TILE_W, _tile_ranges, tile_grid

# the kernels pack a tile box into 8 bits a bound and keep 10 ints a tile in
# shared memory (csrc/binning.cu)
MAX_TILE_ROWS = 256
MAX_TILES = 4096


def _flat(proj: ProjectedGaussians) -> ProjectedGaussians:
    g = proj.depth.shape[-1]
    return ProjectedGaussians(
        mean2d=proj.mean2d.reshape(-1, g, 2), conic=proj.conic.reshape(-1, g, 3),
        depth=proj.depth.reshape(-1, g), radius=proj.radius.reshape(-1, g),
    )


def bin_gaussians_plain(
    proj: ProjectedGaussians,
    image_size: Tuple[int, int],
    max_per_tile: int,
    slots_y: int,
    slots_x: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``bin_gaussians_count``: enumerate the gaussians in
    stable depth order, build the [T, G] membership mask from the range
    tests, cumsum along G and binary-search the k-th member's position."""
    lead = proj.depth.shape[:-1]
    p = _flat(proj)
    n, g = p.depth.shape
    n_ty, n_tx = tile_grid(image_size)
    dev = p.depth.device

    order = torch.sort(p.depth, dim=-1, stable=True).indices  # [N, G]
    sorted_proj = ProjectedGaussians(
        mean2d=p.mean2d.gather(1, order[..., None].expand(-1, -1, 2)),
        conic=p.conic, depth=p.depth.gather(1, order), radius=p.radius.gather(1, order),
    )
    y0, y1, x0, x1, alive = _tile_ranges(sorted_proj, n_ty, n_tx, slots_y, slots_x)
    ty = torch.arange(n_ty, dtype=torch.int32, device=dev)[None, :, None]
    tx = torch.arange(n_tx, dtype=torch.int32, device=dev)[None, :, None]
    in_y = (y0[:, None] <= ty) & (ty <= y1[:, None])  # [N, n_ty, G]
    in_x = (x0[:, None] <= tx) & (tx <= x1[:, None])  # [N, n_tx, G]
    mask = (in_y[:, :, None] & in_x[:, None] & alive[:, None, None]).reshape(n, n_ty * n_tx, g)

    csum = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)  # [N, T, G] monotone
    counts = csum[..., -1].clamp(max=max_per_tile) if g else csum.new_zeros(n, n_ty * n_tx)
    k_range = torch.arange(1, max_per_tile + 1, dtype=torch.int32, device=dev)
    # position of the k-th member = first index where csum == k
    pos = torch.searchsorted(csum, k_range.expand(n, n_ty * n_tx, -1).contiguous(), side="left")
    pos = pos.clamp(0, max(g - 1, 0))
    if g:
        table = order.gather(1, pos.reshape(n, -1)).reshape(n, n_ty * n_tx, max_per_tile)
    else:
        table = pos
    table = table.to(torch.int32)
    return table.reshape(*lead, *table.shape[1:]), counts.reshape(*lead, -1)


def bin_gaussians(
    proj: ProjectedGaussians,
    image_size: Tuple[int, int],
    max_per_tile: int,
    slots_y: int,
    slots_x: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """proj with leading (views) dimensions [..., G] -> (table [..., T, K]
    int32, counts [..., T] int32), T = ceil(H/16) * ceil(W/128). CPU tensors
    take the plain version; CUDA tensors launch the kernels, all views at
    once: the stable depth sort here (torch), then the tile boxes, the
    histograms and the ranked writes in ``csrc/binning.cu``."""
    dev = proj.depth.device
    if dev.type == "cpu":
        return bin_gaussians_plain(proj, image_size, max_per_tile, slots_y, slots_x)
    if dev.type != "cuda":
        raise ValueError(f"bin_gaussians runs on cuda or cpu tensors, got {dev}")
    if max_per_tile < 1 or slots_y < 1 or slots_x < 1:
        raise ValueError("max_per_tile and the slot grid must be positive")
    for name, t in zip(proj._fields, proj):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"proj.{name} must be fp32 on {dev}")
    lead = proj.depth.shape[:-1]
    p = _flat(proj)
    n, g = p.depth.shape
    n_ty, n_tx = tile_grid(image_size)
    if n_ty > MAX_TILE_ROWS or n_tx > MAX_TILE_ROWS or n_ty * n_tx > MAX_TILES:
        raise ValueError(f"the binning kernel takes at most {MAX_TILE_ROWS} tile rows and columns and "
                         f"{MAX_TILES} tiles; {image_size} has {n_ty} x {n_tx}")
    lib = _build.load_library()
    n_scratch = lib.siu3r_bin_scratch_ints(n, g, n_ty, n_tx)
    if n_scratch < 0:
        raise ValueError(f"binning scratch for {n} views of {g} gaussians exceeds 2^31 entries")
    mean2d, radius = p.mean2d.contiguous(), p.radius.contiguous()
    if mean2d.data_ptr() % 8:  # the kernel reads a mean as one float2
        mean2d = mean2d.clone()
    order = torch.sort(p.depth, dim=-1, stable=True).indices
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    table = torch.empty((n, n_ty * n_tx, max_per_tile), dtype=torch.int32, device=dev)
    counts = torch.empty((n, n_ty * n_tx), dtype=torch.int32, device=dev)
    err = lib.siu3r_bin_gaussians(
        mean2d.data_ptr(), radius.data_ptr(), order.data_ptr(), scratch.data_ptr(), table.data_ptr(),
        counts.data_ptr(), n, g, n_ty, n_tx, TILE_H, TILE_W, slots_y, slots_x, max_per_tile,
        _build.stream_handle(dev),
    )
    _build.check_launch(err, "bin")
    _build.launch_counts["bin"] += 1
    return table.reshape(*lead, *table.shape[1:]), counts.reshape(*lead, -1)
