"""The raster kernels' schedule and arithmetic, rehearsed on the CPU.

``csrc/raster.cu`` splits each 16x128 tile over a cluster of 8 blocks of
16x16 pixels, 128 threads of 2 pixels (one column, 2 rows), so that a warp's
pixels are a 16x4 rectangle. Every block walks
the tile's whole list in chunks of 128; at each chunk boundary a block ORs
its pixels' T > 1e-4, writes the result into every block's flag slot (two
flag buffers, alternating) and, after one cluster barrier, the cluster stops
unless some flag is set. Colour groups past the first sweep the first
group's chunk count. Each warp skips a gaussian whose alpha is below 1/255
at every pixel of its rectangle (``skip_test`` in ``csrc/raster_common.cuh``).
``csrc/raster_bwd.cu`` takes the forward's ``swept``, splits the tile over 8
blocks in the same layout, and keeps the total R and the
prefix of w r as compensated fp32 pairs so that the suffix R - prefix
survives where a pixel saturates.

The kernels run only on the card; here test-only emulations of that
schedule and arithmetic are held against the plain versions: the forward
within chip_smoke.py's RASTER_ATOL with the same ``swept``, the backward
within its per-slot tolerance, where an fp32 suffix misses it. The autograd
wrapper is shown to hand the forward's ``swept`` to ``raster_backward``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import siu3r_tpu_torch.kernels.raster as R
from siu3r_tpu_torch.kernels.raster import raster, tiles_backward_plain, tiles_plain
from siu3r_tpu_torch.render.tiles import _ALPHA_MAX, _ALPHA_MIN, _CHUNK, _T_EPS, TILE_H, TILE_W

NPIX = TILE_H * TILE_W
SUB_W = 16  # a block's sub-tile: 16 x 16 pixels
BLOCKS = TILE_W // SUB_W  # blocks a tile (the forward's cluster)
THREADS = 128  # a block of either kernel: 128 threads of 2 pixels
RASTER_ATOL = 2e-4  # chip_smoke.py's gate for the forward kernel
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5  # and for the backward, per parameter slot


def thread_pixels() -> torch.Tensor:
    """[BLOCKS, THREADS, pixels a thread] -> pixel index in the tile
    (row * 128 + column), as the kernels map them: thread t of block r owns
    column 16 r + t % 16 and rows (t / 16) * n + i."""
    n = TILE_H * SUB_W // THREADS
    rank = torch.arange(BLOCKS)[:, None, None]
    tid = torch.arange(THREADS)[None, :, None]
    i = torch.arange(n)[None, None, :]
    return ((tid // SUB_W) * n + i) * TILE_W + rank * SUB_W + tid % SUB_W


def warp_rectangles() -> list[tuple[int, int, int, int]]:
    """(x0, x1, y0, y1) of each warp's pixels in the tile, as the kernels
    give skip_test: 16 columns and 32 / 16 x (pixels a thread) = 4 rows."""
    rows = 32 // SUB_W * (TILE_H * SUB_W // THREADS)
    return [(r * SUB_W, r * SUB_W + SUB_W - 1, w * rows, w * rows + rows - 1)
            for r in range(BLOCKS) for w in range(THREADS // 32)]


def power_of(prm: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The kernels' power for prm [N, 8] at dx, dy [N, P], rounded op by op
    (each torch op rounds to fp32)."""
    q = prm[..., 2:3] * dx * dx + prm[..., 4:5] * dy * dy
    return -0.5 * q - prm[..., 3:4] * dx * dy


def skip_test(prm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``skip_test`` of raster_common.cuh in fp32: (h, t) per gaussian."""
    a, b, c, op = prm[..., 2], prm[..., 3], prm[..., 4], prm[..., 5]
    lam = 0.5 * (a + c) - torch.sqrt(0.25 * (a - c) * (a - c) + b * b) - 4e-6 * (a.abs() + c.abs() + 2 * b.abs())
    h = torch.where(lam > 0, 0.5 * lam * (1 - 1e-5), torch.full_like(lam, -float("inf")))
    return h, torch.log(255.0 * op) + 1e-4


def skipped(prm: torch.Tensor, rect, row0: torch.Tensor, col0: torch.Tensor) -> torch.Tensor:
    """``skipped`` of raster_common.cuh for the rectangle rect of each tile."""
    x0, x1, y0, y1 = rect
    x0, x1 = (col0.float() + x0)[..., None], (col0.float() + x1)[..., None]
    y0, y1 = (row0.float() + y0)[..., None], (row0.float() + y1)[..., None]
    mx, my = prm[..., 0], prm[..., 1]
    ex = torch.clamp(torch.maximum(x0 - mx, mx - x1), min=0.0)
    ey = torch.clamp(torch.maximum(y0 - my, my - y1), min=0.0)
    h, t = skip_test(prm)
    return h * (ex * ex + ey * ey) > t


def _coords(row0, col0):
    p = torch.arange(NPIX)
    return col0.float()[:, None] + (p % TILE_W).float(), row0.float()[:, None] + (p // TILE_W).float()


def _warp_skip_mask(params, row0, col0) -> torch.Tensor:
    """[NT, K, 2048]: True where the pixel's warp skips the gaussian."""
    warp_of = torch.empty(NPIX, dtype=torch.long)
    rects = warp_rectangles()
    for wi, (x0, x1, y0, y1) in enumerate(rects):
        for y in range(y0, y1 + 1):
            warp_of[y * TILE_W + x0:y * TILE_W + x1 + 1] = wi
    per_warp = torch.stack([skipped(params, rect, row0, col0) for rect in rects], dim=-1)  # [NT, K, warps]
    return per_warp[..., warp_of]


def emulate_forward(counts, row0, col0, params, colors):
    """The cluster schedule of csrc/raster.cu: (color [NT, C, 16, 128],
    depth, alpha [NT, 16, 128], swept [NT])."""
    nt, k, _ = params.shape
    n_ch = colors.shape[-1]
    cg = 4 if n_ch <= 4 else 16
    px, py = _coords(row0, col0)
    block_pixels = thread_pixels().reshape(BLOCKS, -1)  # [8, 256]
    skip = _warp_skip_mask(params, row0, col0)
    color = torch.zeros(nt, n_ch, NPIX)
    depth = torch.zeros(nt, NPIX)
    trans_out = None
    n_chunks = torch.zeros(nt, dtype=torch.int32)
    for c0 in range(0, n_ch, cg):
        trans = torch.ones(nt, NPIX)
        flags = torch.zeros(2, nt, BLOCKS, dtype=torch.bool)  # [round, tile, rank]
        stopped = torch.zeros(nt, dtype=torch.bool)
        for ci, base in enumerate(range(0, k, _CHUNK)):
            if c0 == 0:
                if ci > 0:  # the vote on T after chunk ci - 1
                    flags[ci & 1] = (trans[:, block_pixels] > _T_EPS).any(dim=-1)  # each block's __syncthreads_or
                    stopped |= ~flags[ci & 1].any(dim=-1)  # every block reads the 8 flags
                active = ~stopped & (base < counts)
                n_chunks += active.to(torch.int32)
            else:
                active = ci < n_chunks
            for j in range(base, base + _CHUNK):
                prm = params[:, j]
                dx, dy = px - prm[:, 0:1], py - prm[:, 1:2]
                power = power_of(prm, dx, dy)
                alpha = torch.clamp(prm[:, 5:6] * torch.exp(power), max=_ALPHA_MAX)
                keep = (alpha >= _ALPHA_MIN) & (active & (j < counts))[:, None] & ~skip[:, j]
                w = torch.where(keep, alpha * trans, torch.zeros_like(alpha))
                color[:, c0:c0 + cg] += colors[:, j, c0:c0 + cg, None] * w[:, None]
                if c0 == 0:
                    depth += prm[:, 6:7] * w
                trans = torch.where(keep, trans * (1 - alpha), trans)
        if c0 == 0:
            trans_out = trans
    return (color.reshape(nt, n_ch, TILE_H, TILE_W), depth.reshape(nt, TILE_H, TILE_W),
            (1 - trans_out).reshape(nt, TILE_H, TILE_W), n_chunks)


def _two_prod(a, b):
    """a * b and its rounding error, exactly (the kernel's fmaf(a, b, -p))."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def emulate_backward(counts, row0, col0, params, colors, gcolor, gdepth, galpha, swept, suffix):
    """csrc/raster_bwd.cu's per-pixel arithmetic over the forward's swept
    chunks: ``suffix`` "compensated" (the kernel's pairs) or "fp32" (a plain
    fp32 R - prefix). Returns (dparams [NT, K, 8], dcolors [NT, K, C])."""
    nt, k, _ = params.shape
    px, py = _coords(row0, col0)
    gc = gcolor.reshape(nt, -1, NPIX)
    gd, gt = gdepth.reshape(nt, NPIX), -galpha.reshape(nt, NPIX)
    n = torch.minimum(counts, swept * _CHUNK)
    skip = _warp_skip_mask(params, row0, col0)
    zero = torch.zeros(nt, NPIX)

    def pairs():
        for j in range(k):
            prm = params[:, j]
            dx, dy = px - prm[:, 0:1], py - prm[:, 1:2]
            power = power_of(prm, dx, dy)
            e = torch.exp(power)
            raw = prm[:, 5:6] * e
            alpha = torch.clamp(raw, max=_ALPHA_MAX)
            keep = (alpha >= _ALPHA_MIN) & (j < n)[:, None] & ~skip[:, j]
            r = prm[:, 6:7] * gd + (colors[:, j, :, None] * gc).sum(dim=1)
            yield j, prm, dx, dy, e, raw, alpha, keep, r

    def add(hi, lo, w, r, keep):
        if suffix == "fp32":
            return torch.where(keep, hi + w * r, hi), lo
        p, pe = _two_prod(w, r)
        s, se = _two_sum(hi, p)
        return torch.where(keep, s, hi), torch.where(keep, lo + (se + pe), lo)

    trans, tot = torch.ones(nt, NPIX), (zero, zero)
    for _, _, _, _, _, _, alpha, keep, r in pairs():  # sweep 1: R and T_N
        tot = add(*tot, alpha * trans, r, keep)
        trans = torch.where(keep, trans * (1 - alpha), trans)
    tn_gt, trans, pre = trans * gt, torch.ones(nt, NPIX), (zero, zero)
    dparams, dcolors = torch.zeros_like(params), torch.zeros_like(colors)
    for j, prm, dx, dy, e, raw, alpha, keep, r in pairs():  # sweep 2: the gradients
        w = alpha * trans
        pre = add(*pre, w, r, keep)
        s = (tot[0] - pre[0]) + (tot[1] - pre[1])
        da = torch.where(keep & (raw < _ALPHA_MAX), trans * r - (s + tn_gt) / (1 - alpha), zero)
        dpw = da * raw
        w = torch.where(keep, w, zero)
        a, b, c = prm[:, 2:3], prm[:, 3:4], prm[:, 4:5]
        terms = (dpw * (a * dx + b * dy), dpw * (c * dy + b * dx), dpw * (-0.5 * dx * dx), dpw * (-dx * dy),
                 dpw * (-0.5 * dy * dy), da * e, w * gd)
        dparams[:, j, :7] = torch.stack([x.sum(dim=1) for x in terms], dim=-1)
        dcolors[:, j] = (w[:, None] * gc).sum(dim=2)
        trans = torch.where(keep, trans * (1 - alpha), trans)
    return dparams, dcolors


def _tiles(rng, nt, k, n_channels, opacity_hi=0.35):
    params = np.zeros((nt, k, 8), np.float32)
    params[..., 0] = rng.uniform(-10, TILE_W + 10, (nt, k))
    params[..., 1] = rng.uniform(-10, TILE_H + 10, (nt, k))
    params[..., 2] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 3] = rng.uniform(-0.01, 0.01, (nt, k))
    params[..., 4] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 5] = rng.uniform(0.05, opacity_hi, (nt, k))
    params[..., 6] = rng.uniform(1, 10, (nt, k))
    return params, rng.rand(nt, k, n_channels).astype(np.float32)


def _fat_splats(rng, nt, k, n_channels, opacity, conic):
    """Splats a tile wide and nearly opaque over the tile: it saturates in
    its first chunk (the JAX package's saturated-tile test: opacity 0.9,
    conic 0.002)."""
    params, colors = _tiles(rng, nt, k, n_channels)
    params[..., 0] = rng.uniform(0, TILE_W, (nt, k))
    params[..., 1] = rng.uniform(0, TILE_H, (nt, k))
    params[..., 2] = params[..., 4] = conic
    params[..., 3] = 0.0
    params[..., 5] = opacity
    return params, colors


def _scene(name):
    """(counts, row0, col0, params, colors) as tensors."""
    rng = np.random.RandomState(11)
    if name == "unsaturated":
        nt, k = 3, 3 * _CHUNK
        params, colors = _tiles(rng, nt, k, 3)
        counts = [k, k // 2 + 37, 0]
    elif name == "saturating_tile":
        nt, k = 1, 4 * _CHUNK
        params, colors = _fat_splats(rng, nt, k, 3, 0.9, 0.002)
        counts = [k]
    elif name == "two_colour_groups":  # C = 20: groups of 16 and 4; some tiles saturate
        nt, k = 3, 4 * _CHUNK
        params, colors = _tiles(rng, nt, k, 20, opacity_hi=0.95)
        params[0, :, 2:5:2] = 0.002
        counts = [k, k - 50, 100]
    else:  # fat_opaque_tile: alpha up to 0.985, where an fp32 suffix fails
        nt, k = 1, 2 * _CHUNK
        params, colors = _fat_splats(np.random.RandomState(0), nt, k, 3, 0.985, 0.0005)
        counts = [k]
    row0 = torch.tensor([TILE_H * (i % 2) for i in range(nt)], dtype=torch.int32)
    col0 = torch.tensor([TILE_W * (i // 2) for i in range(nt)], dtype=torch.int32)
    return (torch.tensor(counts, dtype=torch.int32), row0, col0, torch.from_numpy(params),
            torch.from_numpy(colors))


def _cotangents(nt, n_channels, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for shape in ((nt, n_channels, TILE_H, TILE_W), (nt, TILE_H, TILE_W), (nt, TILE_H, TILE_W)))


def _worst_excess(got, want) -> float:
    """The backward's gate of chip_smoke.py, as a ratio: the worst
    (|err| - rtol |want| - atol) / atol over the parameter slots (atol x
    the slot's largest |gradient|, at least 1) and the colours; <= 0 passes."""
    (dp, dc), (wp, wc) = got, want
    worst = -np.inf
    for a, b, scale in [(dp[..., i], wp[..., i], max(1.0, float(wp[..., i].abs().max()))) for i in range(7)] + [
            (dc, wc, 1.0)]:
        atol = BWD_ATOL * scale
        worst = max(worst, float(((a - b).abs() - BWD_RTOL * b.abs() - atol).max()) / atol)
    return worst


def test_blocks_and_warps_cover_the_tile():
    """Each pixel of a 16x128 tile belongs to exactly one thread; a block's
    pixels are its 16x16 sub-tile and a warp's lie in its skip rectangle."""
    pix = thread_pixels()
    assert torch.equal(pix.flatten().sort().values, torch.arange(NPIX))
    cols = pix % TILE_W
    assert torch.equal(cols // SUB_W, torch.arange(BLOCKS)[:, None, None].expand_as(cols))
    rects = warp_rectangles()
    per_warp = pix.reshape(BLOCKS, THREADS // 32, -1)
    for (x0, x1, y0, y1), p in zip(rects, per_warp.reshape(-1, per_warp.shape[-1])):
        assert bool(((p % TILE_W >= x0) & (p % TILE_W <= x1) & (p // TILE_W >= y0) & (p // TILE_W <= y1)).all())
        assert p.numel() == (x1 - x0 + 1) * (y1 - y0 + 1)


@pytest.mark.parametrize("origin", [(0, 0), (15 * TILE_H, 7 * TILE_W)])
def test_skip_test_never_skips_a_kept_alpha(origin):
    """Over random gaussians (round and elongated, any orientation, opacities
    down to 1/255, means in and around the tile), a warp skips a gaussian
    only where its alpha, rounded as the kernels round it, is below 1/255 at
    every pixel of the warp's rectangle; and it skips most of those far away.
    The tile lies at the image's origin or far from it, where the pixel
    coordinates, and so the rounding of dx and dy, are larger."""
    row, col = origin
    rng = np.random.RandomState(row + col)
    g = 6000
    params = np.zeros((1, g, 8), np.float32)
    params[..., 0] = col + rng.uniform(-60, TILE_W + 60, g)
    params[..., 1] = row + rng.uniform(-60, TILE_H + 60, g)
    sx, sy = np.exp(rng.uniform(np.log(0.3), np.log(40), (2, g)))
    th = rng.uniform(0, np.pi, g)
    cs, sn = np.cos(th), np.sin(th)
    a = cs**2 / sx**2 + sn**2 / sy**2
    c = sn**2 / sx**2 + cs**2 / sy**2
    params[..., 2], params[..., 3], params[..., 4] = a, cs * sn * (1 / sx**2 - 1 / sy**2), c
    params[..., 5] = rng.uniform(1 / 255, 1.0, g)
    params = torch.from_numpy(params)
    row0, col0 = torch.tensor([row], dtype=torch.int32), torch.tensor([col], dtype=torch.int32)
    px, py = _coords(row0, col0)
    prm = params[0]
    power = power_of(prm, px - prm[:, 0:1], py - prm[:, 1:2])
    alpha = torch.clamp(prm[:, 5:6] * torch.exp(power), max=_ALPHA_MAX)
    n_skipped = n_dropped = 0
    for x0, x1, y0, y1 in warp_rectangles():
        x, y = px[0] - col, py[0] - row
        inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        kept_here = (alpha[:, inside] >= _ALPHA_MIN).any(dim=1)
        skip = skipped(params, (x0, x1, y0, y1), row0, col0)[0]
        assert not bool((skip & kept_here).any()), "a skipped gaussian keeps an alpha in the rectangle"
        n_skipped += int(skip.sum())
        n_dropped += int((~kept_here).sum())
    assert n_skipped > 0.8 * n_dropped


@pytest.mark.parametrize("scene", ["unsaturated", "saturating_tile", "two_colour_groups"])
def test_cluster_schedule_matches_the_plain_compositing(scene):
    """The forward's cluster schedule (sub-tiles, the vote across the
    cluster at each chunk boundary, groups after the first on the first's
    chunk count, warps skipping gaussians) gives tiles_plain's swept, and its
    outputs with the counts cut at swept x 128, within RASTER_ATOL."""
    counts, row0, col0, params, colors = _scene(scene)
    color, depth, alpha, swept = emulate_forward(counts, row0, col0, params, colors)
    want_swept = tiles_plain(counts, row0, col0, params, colors)[3]
    assert torch.equal(swept, want_swept)
    cut = torch.minimum(counts, swept * _CHUNK)
    want = tiles_plain(cut, row0, col0, params, colors)
    for got, ref, scale in ((color, want[0], 1.0), (alpha, want[2], 1.0),
                            (depth, want[1], float(params[..., 6].abs().max()))):
        torch.testing.assert_close(got, ref, rtol=0, atol=RASTER_ATOL * scale)
    if scene != "unsaturated":
        assert bool((cut < counts).any())  # a tile stopped before the end of its list
    assert float(alpha.max()) > 0.5


@pytest.mark.parametrize("scene", ["unsaturated", "saturating_tile", "two_colour_groups", "fat_opaque_tile"])
def test_compensated_suffix_meets_the_per_slot_gate(scene):
    """The backward's arithmetic over the forward's swept chunks, with R and
    the prefix as compensated fp32 pairs, within chip_smoke.py's per-slot
    tolerance of tiles_backward_plain with the counts cut at swept x 128."""
    counts, row0, col0, params, colors = _scene(scene)
    swept = tiles_plain(counts, row0, col0, params, colors)[3]
    grads = _cotangents(len(counts), colors.shape[-1], 5)
    want = tiles_backward_plain(torch.minimum(counts, swept * _CHUNK), row0, col0, params, colors, *grads)
    got = emulate_backward(counts, row0, col0, params, colors, *grads, swept, "compensated")
    assert _worst_excess(got, want) <= 0
    assert float(got[0].abs().max()) > 0


def test_fp32_suffix_misses_the_per_slot_gate():
    """Where fat, nearly opaque splats saturate a tile within a few, a plain
    fp32 R - prefix loses the suffix (about 1e-7 R, divided by 1 - alpha)
    and misses the gate that the compensated pairs meet: why the kernel keeps
    them (it kept fp64 sums before)."""
    counts, row0, col0, params, colors = _scene("fat_opaque_tile")
    swept = tiles_plain(counts, row0, col0, params, colors)[3]
    assert int(swept[0]) * _CHUNK < int(counts[0])
    grads = _cotangents(1, 3, 5)
    want = tiles_backward_plain(torch.minimum(counts, swept * _CHUNK), row0, col0, params, colors, *grads)
    fp32 = _worst_excess(emulate_backward(counts, row0, col0, params, colors, *grads, swept, "fp32"), want)
    compensated = _worst_excess(
        emulate_backward(counts, row0, col0, params, colors, *grads, swept, "compensated"), want)
    assert fp32 > 0 >= compensated


def test_autograd_hands_the_forward_swept_to_the_backward(monkeypatch):
    """``raster``'s backward calls ``raster_backward`` with the forward's
    swept (CPU tensors: the plain version, which does not read it)."""
    rng = np.random.RandomState(2)
    n, g, k, hw = 2, 200, 256, (32, 128)
    table = torch.from_numpy(rng.randint(0, g, (n, 2, k)).astype(np.int32))
    counts = torch.tensor([[k, 100], [37, 0]], dtype=torch.int32)
    params = np.zeros((n, g, 8), np.float32)
    params[..., 0] = rng.uniform(0, hw[1], (n, g))
    params[..., 1] = rng.uniform(0, hw[0], (n, g))
    params[..., 2] = params[..., 4] = 0.01
    params[..., 5] = rng.uniform(0.3, 0.95, (n, g))
    params[..., 6] = rng.uniform(1, 5, (n, g))
    params = torch.from_numpy(params).requires_grad_(True)
    colors = torch.from_numpy(rng.rand(n, g, 3).astype(np.float32)).requires_grad_(True)
    seen = []
    original = R.raster_backward

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return original(*args, **kwargs)

    monkeypatch.setattr(R, "raster_backward", spy)
    out = raster(table, counts, params, colors, hw)
    assert int(out[3].min()) < int(out[3].max())  # the tiles sweep different chunk counts
    torch.autograd.grad(out[0].sum() + out[1].sum() + out[2].sum(), (params, colors))
    assert len(seen) == 1
    args, kwargs = seen[0]
    got = kwargs["swept"] if "swept" in kwargs else args[8]
    assert torch.equal(got, out[3])

