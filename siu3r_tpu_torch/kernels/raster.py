"""Tile-compositing kernels' wrappers: ``csrc/raster.cu`` (forward),
``csrc/raster_bwd.cu`` (backward) and their plain versions.

The forward replaces the TPU kernel ``_raster_kernel`` of
``siu3r_tpu/render/rasterizer.py`` (launches counted as ``raster``), the
backward ``_raster_bwd_kernel`` of the same file (counted as
``raster_bwd``). Both versions composite each 16x128 tile of each view front
to back over the tile's list from the binning and return the untiled image.
The kernels stop a tile once every pixel's transmittance is at most 1e-4 (as
the TPU kernels do); the plain versions, like ``_tiles_jnp`` and its VJP,
composite every listed gaussian, so the two differ by the contributions below
that transmittance.

``raster`` is differentiable in ``params`` and ``colors`` (a
``torch.autograd.Function``): on CUDA tensors its backward is the
``raster_bwd`` kernel, handed the forward's ``swept`` so that it stops where
the forward stopped; on CPU tensors it is ``raster_backward_plain``, the VJP
of the plain version (the counterpart of differentiating ``_tiles_jnp``).
The table and counts carry no gradient: the binning is gradient-free, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

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


def _pixel_grid(row0: torch.Tensor, col0: torch.Tensor):
    """Pixel coordinates [NT, 1, npix] of each tile and the strictly lower
    triangle [CHUNK, CHUNK] of the exclusive cumulative sum."""
    dev = row0.device
    p = torch.arange(TILE_H * TILE_W, device=dev)
    px = col0.to(torch.float32)[:, None, None] + (p % TILE_W).to(torch.float32)
    py = row0.to(torch.float32)[:, None, None] + (p // TILE_W).to(torch.float32)
    ar = torch.arange(_CHUNK, device=dev)
    return px, py, (ar[None, :] < ar[:, None]).to(torch.float32)


def _chunk(px, py, tril, counts, base, trans, prm, col):
    """One chunk of ``_tiles_jnp``'s scan body: prm [NT, CHUNK, 8], col
    [NT, CHUNK, C], trans [NT, 1, npix], counts [NT, 1, 1]. Returns the colour
    and depth it adds ([NT, C, npix], [NT, 1, npix]) and the transmittance
    after it."""
    dx = px - prm[..., 0:1]  # [NT, CHUNK, npix]
    dy = py - prm[..., 1:2]
    power = -0.5 * (prm[..., 2:3] * dx * dx + prm[..., 4:5] * dy * dy) - prm[..., 3:4] * dx * dy
    alpha = torch.clamp(prm[..., 5:6] * torch.exp(power), max=_ALPHA_MAX)
    alpha = torch.where(alpha >= _ALPHA_MIN, alpha, torch.zeros_like(alpha))
    k_ids = base + torch.arange(_CHUNK, device=prm.device)[None, :, None]
    alpha = torch.where(k_ids < counts, alpha, torch.zeros_like(alpha))
    logs = torch.log1p(-alpha)
    wgt = alpha * trans * torch.exp(tril @ logs)
    color = col.transpose(1, 2) @ wgt
    depth = (prm[..., 6:7] * wgt).sum(dim=1, keepdim=True)
    return color, depth, trans * torch.exp(logs.sum(dim=1, keepdim=True))


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
    px, py, tril = _pixel_grid(row0, col0)
    counts = counts.reshape(nt, 1, 1)

    trans = torch.ones((nt, 1, npix), dtype=torch.float32, device=dev)
    color_acc = torch.zeros((nt, n_channels, npix), dtype=torch.float32, device=dev)
    depth_acc = torch.zeros((nt, 1, npix), dtype=torch.float32, device=dev)
    swept = torch.zeros((nt,), dtype=torch.int32, device=dev)
    for base in range(0, k_cap, _CHUNK):
        # the kernel's loop condition before this chunk (monotone: once false, it stays false)
        swept += ((base < counts.view(nt)) & (trans.amax(dim=(1, 2)) > _T_EPS)).to(torch.int32)
        color, depth, trans = _chunk(px, py, tril, counts, base, trans,
                                     params[:, base : base + _CHUNK], colors[:, base : base + _CHUNK])
        color_acc = color_acc + color
        depth_acc = depth_acc + depth
    return (
        color_acc.reshape(nt, n_channels, TILE_H, TILE_W),
        depth_acc.reshape(nt, TILE_H, TILE_W),
        (1.0 - trans).reshape(nt, TILE_H, TILE_W),
        swept,
    )


def tiles_backward_plain(
    counts: torch.Tensor,
    row0: torch.Tensor,
    col0: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
    gcolor: torch.Tensor,
    gdepth: torch.Tensor,
    galpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``tiles_plain`` (the counterpart of differentiating
    ``_tiles_jnp``): gcolor [NT, C, 16, 128], gdepth and galpha [NT, 16, 128]
    are the cotangents of its outputs. Returns (dparams [NT, K, 8], dcolors
    [NT, K, C]). As ``_tiles_jnp`` checkpoints its chunk body, the carried
    transmittances are kept and each chunk is recomputed in the backward, so
    the memory is that of one chunk."""
    nt, k_cap, _ = params.shape
    npix = TILE_H * TILE_W
    px, py, tril = _pixel_grid(row0, col0)
    counts = counts.reshape(nt, 1, 1)
    params, colors = params.detach(), colors.detach()
    trans_in = [torch.ones((nt, 1, npix), dtype=torch.float32, device=params.device)]
    with torch.no_grad():
        for base in range(0, k_cap - _CHUNK, _CHUNK):
            trans_in.append(_chunk(px, py, tril, counts, base, trans_in[-1], params[:, base : base + _CHUNK],
                                   colors[:, base : base + _CHUNK])[2])
    g_color = gcolor.reshape(nt, -1, npix)
    g_depth = gdepth.reshape(nt, 1, npix)
    g_trans = -galpha.reshape(nt, 1, npix)  # alpha = 1 - T
    dparams = torch.zeros_like(params)
    dcolors = torch.zeros_like(colors)
    for ci in reversed(range(k_cap // _CHUNK)):
        sl = slice(ci * _CHUNK, (ci + 1) * _CHUNK)
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(True) for x in (params[:, sl], colors[:, sl], trans_in[ci])]
            outputs = _chunk(px, py, tril, counts, ci * _CHUNK, inputs[2], *inputs[:2])
            dparams[:, sl], dcolors[:, sl], g_trans = torch.autograd.grad(
                outputs, inputs, (g_color, g_depth, g_trans))
    return dparams, dcolors


def untile(x: torch.Tensor, n_views: int, image_size: Tuple[int, int]) -> torch.Tensor:
    """[N*T, C, 16, 128] -> [N, H, W, C] (tiles in row-major order)."""
    h, w = image_size
    n_ty, n_tx = tile_grid(image_size)
    c = x.shape[1]
    x = x.reshape(n_views, n_ty, n_tx, c, TILE_H, TILE_W).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n_views, n_ty * TILE_H, n_tx * TILE_W, c)[:, :h, :w]


def tile_image(x: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """The transpose of ``untile``: [N, H, W, C] -> [N*T, C, 16, 128], zero
    past the image's edge."""
    h, w = image_size
    n_ty, n_tx = tile_grid(image_size)
    n, c = x.shape[0], x.shape[-1]
    x = torch.nn.functional.pad(x, (0, 0, 0, n_tx * TILE_W - w, 0, n_ty * TILE_H - h))
    x = x.reshape(n, n_ty, TILE_H, n_tx, TILE_W, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n * n_ty * n_tx, c, TILE_H, TILE_W)


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


def _gather(table, counts, params, cols, image_size):
    """Flattened inputs -> each tile's params [N*T, K, 8] and colours
    [N*T, K, C] gathered through the table, with the gather indices and the
    tiles' first rows and columns."""
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
    return idx, slab, gp, gc, row0, col0


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
    n, t, _ = table.shape
    _, _, gp, gc, row0, col0 = _gather(table, counts, params, cols, image_size)
    color_t, depth_t, alpha_t, swept = tiles_plain(counts.reshape(-1), row0, col0, gp, gc)
    color = untile(color_t, n, image_size)
    depth = untile(depth_t[:, None], n, image_size)[..., 0]
    alpha = untile(alpha_t[:, None], n, image_size)[..., 0]
    h, w = image_size
    return (
        color.reshape(*lead, h, w, -1), depth.reshape(*lead, h, w),
        alpha.reshape(*lead, h, w), swept.reshape(*lead, t),
    )


def raster_backward_plain(
    table: torch.Tensor,
    counts: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
    image_size: Tuple[int, int],
    gcolor: torch.Tensor,
    gdepth: torch.Tensor,
    galpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``raster_plain`` in params and colors: gcolor
    [..., H, W, C], gdepth and galpha [..., H, W] -> (dparams shaped as
    params, dcolors shaped as colors). ``tiles_backward_plain`` on the
    gathered tiles, then each slot's gradient added to its gaussian."""
    lead, table, counts, params_f, cols = _flatten(table, counts, params, colors)
    n, t, k = table.shape
    idx, slab, gp, gc, row0, col0 = _gather(table, counts, params_f, cols, image_size)
    dgp, dgc = tiles_backward_plain(
        counts.reshape(-1), row0, col0, gp, gc,
        tile_image(gcolor.reshape(n, *image_size, -1), image_size),
        tile_image(gdepth.reshape(n, *image_size, 1), image_size),
        tile_image(galpha.reshape(n, *image_size, 1), image_size),
    )
    g = params_f.shape[1]
    dparams = torch.zeros_like(params_f).scatter_add_(1, idx[..., None].expand(-1, -1, 8), dgp.reshape(n, t * k, 8))
    c = cols.shape[-1]
    flat = (slab[:, None] * g + idx).reshape(-1)
    dcolors = cols.new_zeros(cols.shape[0] * g, c).index_add_(0, flat, dgc.reshape(-1, c))
    return dparams.reshape(params.shape), dcolors.reshape(colors.shape)


def _checked(table, counts, params, colors, image_size):
    """The CUDA kernels' inputs, flattened and checked."""
    dev = table.device
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
    if cols.stride(-1) != 1:  # the kernels read a gaussian's channels as one row
        cols = cols.contiguous()
    if params.data_ptr() % 16:  # the kernels copy a gaussian's params as two 16-byte vectors
        params = params.clone()
    return lead, table, counts, params, cols


def launch_config(backward: bool, n_views: int, image_size: Tuple[int, int], n_channels: int) -> dict:
    """The raster kernel's (or, with ``backward``, ``raster_bwd``'s) launch
    for these sizes: blocks, threads a block, blocks a cluster, blocks a
    16x128 tile, static shared bytes a block, and what can be resident at
    once (the forward: clusters on the device; the backward: blocks an SM).
    Needs the built library."""
    lib = _build.load_library()
    out = (ctypes.c_int * 6)()
    fn = lib.siu3r_raster_bwd_launch_config if backward else lib.siu3r_raster_fwd_launch_config
    err = fn(n_views, *tile_grid(image_size), n_channels, out)
    _build.check_launch(err, "raster_bwd launch_config" if backward else "raster launch_config")
    keys = ("blocks", "threads", "cluster", "blocks_per_tile", "shared_bytes",
            "resident_blocks_per_sm" if backward else "max_active_clusters")
    return dict(zip(keys, out))


def _raster_cuda(table, counts, params, colors, image_size):
    lead, table, counts, params, cols = _checked(table, counts, params, colors, image_size)
    dev = table.device
    n, t, k = table.shape
    g, c = cols.shape[1:]
    n_ty, n_tx = tile_grid(image_size)
    h, w = image_size
    color = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
    depth = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    alpha = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    swept = torch.empty((n, t), dtype=torch.int32, device=dev)
    order = torch.empty((n * t,), dtype=torch.int32, device=dev)  # the tiles, longest first
    lib = _build.load_library()
    err = lib.siu3r_raster_fwd(
        table.data_ptr(), counts.data_ptr(), order.data_ptr(), params.data_ptr(), cols.data_ptr(),
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), swept.data_ptr(),
        n, n_ty, n_tx, k, g, h, w, c, n // cols.shape[0], cols.stride(0), cols.stride(1),
        _build.stream_handle(dev),
    )
    _build.check_launch(err, "raster")
    _build.launch_counts["raster"] += 1  # order_tiles_kernel and raster_kernel
    return (
        color.reshape(*lead, h, w, c), depth.reshape(*lead, h, w),
        alpha.reshape(*lead, h, w), swept.reshape(*lead, t),
    )


def raster_backward(
    table: torch.Tensor,
    counts: torch.Tensor,
    params: torch.Tensor,
    colors: torch.Tensor,
    image_size: Tuple[int, int],
    gcolor: torch.Tensor,
    gdepth: torch.Tensor,
    galpha: torch.Tensor,
    swept: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``raster``'s color, depth and alpha in params and colors,
    from their cotangents gcolor [..., H, W, C], gdepth and galpha [..., H, W].
    Returns (dparams shaped as params, dcolors shaped as colors), summed over
    every tile that lists a gaussian. CPU tensors take the plain version (the
    VJP of the whole lists; ``swept`` is not read); CUDA tensors launch the
    ``raster_bwd`` kernel, all views in one launch, which needs ``swept``
    [..., T] int32, the chunks ``raster`` composited per tile: it stops where
    the forward stopped."""
    if table.device.type == "cpu":
        return raster_backward_plain(table, counts, params, colors, image_size, gcolor, gdepth, galpha)
    _, table_f, counts_f, params_f, cols = _checked(table, counts, params, colors, image_size)
    dev = table.device
    n, t, k = table_f.shape
    if swept is None:
        raise ValueError("raster_backward on CUDA tensors needs the forward's swept")
    if swept.device != dev or swept.dtype != torch.int32 or swept.numel() != n * t:
        raise ValueError(f"swept must be int32 on {dev} with {n * t} elements (one per tile)")
    swept = swept.reshape(n, t).contiguous()
    g, c = cols.shape[1:]
    n_ty, n_tx = tile_grid(image_size)
    h, w = image_size
    grads = []
    for name, x, shape in (("gcolor", gcolor, (n, h, w, c)), ("gdepth", gdepth, (n, h, w)),
                           ("galpha", galpha, (n, h, w))):
        if x.device != dev or x.dtype != torch.float32 or x.numel() != math.prod(shape):
            raise ValueError(f"{name} must be fp32 on {dev} with {math.prod(shape)} elements")
        grads.append(x.reshape(shape).contiguous())
    dparams = torch.zeros((n, g, 8), dtype=torch.float32, device=dev)
    dcolors = torch.zeros((cols.shape[0], g, c), dtype=torch.float32, device=dev)
    order = torch.empty((n * t,), dtype=torch.int32, device=dev)  # the tiles, longest first
    lib = _build.load_library()
    err = lib.siu3r_raster_bwd(
        table_f.data_ptr(), counts_f.data_ptr(), swept.data_ptr(), order.data_ptr(), params_f.data_ptr(),
        cols.data_ptr(),
        *(x.data_ptr() for x in grads), dparams.data_ptr(), dcolors.data_ptr(),
        n, n_ty, n_tx, k, g, h, w, c, n // cols.shape[0], cols.stride(0), cols.stride(1),
        _build.stream_handle(dev),
    )
    _build.check_launch(err, "raster_bwd")
    _build.launch_counts["raster_bwd"] += 1  # order_tiles_kernel and raster_bwd_kernel
    return dparams.reshape(params.shape), dcolors.reshape(colors.shape)


def _raster_forward(table, counts, params, colors, image_size):
    if table.device.type == "cpu":
        return raster_plain(table, counts, params, colors, image_size)
    return _raster_cuda(table, counts, params, colors, image_size)


class _Raster(torch.autograd.Function):
    """``raster`` with its backward: the kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, counts, params, colors, image_size):
        out = _raster_forward(table, counts, params, colors, image_size)
        ctx.save_for_backward(table, counts, params, colors, out[3])
        ctx.image_size = image_size
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, gcolor, gdepth, galpha, _gswept):
        table, counts, params, colors, swept = ctx.saved_tensors
        dparams, dcolors = raster_backward(table, counts, params, colors, ctx.image_size, gcolor, gdepth, galpha,
                                           swept)
        need = ctx.needs_input_grad
        return None, None, dparams if need[2] else None, dcolors if need[3] else None, None


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
    swept per tile [..., T] int32. Differentiable in params and colors.
    CPU tensors take the plain versions; CUDA tensors launch the kernels, all
    views in one launch."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster runs on cuda or cpu tensors, got {table.device}")
    return _Raster.apply(table, counts, params, colors, image_size)
