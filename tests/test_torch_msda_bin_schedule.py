"""The MSDA and binning kernels' schedules and arithmetic, rehearsed on the CPU.

``csrc/msda.cu`` runs one block of 16 warps per (batch, head, chunk of
queries), with the head's value slice staged in shared memory where it fits
(else the same steps read global memory). A warp step puts a lane on each
(query, point): it computes the point's row and column weights (0 outside
the level) and top-left row; then each half-warp sums every other point of
the step's queries, tap by tap, with out-of-level rows clamped into the
slice, and a shuffle adds the halves. ``launch`` in the same file picks
the number of query chunks from the card's resident blocks.

``csrc/binning.cu`` spreads the work over (view, chunk of 1024 gaussians in
depth order): a prep kernel packs each gaussian's tile box into one 32-bit
code; a count kernel gathers the codes in depth order and counts each tile's
members for each warp's run of 128 gaussians and for the chunk; a write
kernel sums the chunk histograms into the chunk's base in each tile's list
and the counts, zero-fills its share of tiles past their counts, skips a
chunk whose covered tiles are all full, and walks each warp's run 32 at a
time from the warp's base, ranking members by the warp's lane masks (row
ballots AND column ballots) and popcounts.

The kernels run only on the card; here test-only emulations of those
schedules are held against the JAX package: the binning exactly against
``bin_gaussians_count`` (every table entry written exactly once, zeros past
the counts), the MSDA within chip_smoke.py's MSDA_ATOL of
``multi_scale_deformable_attention``; the host-side chunking covers every
query exactly once.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.render.rasterizer as JR
from siu3r_tpu.ops import deformable as JD
from siu3r_tpu_torch.render.tiles import TILE_H, TILE_W, tile_grid
from test_torch_render import BIN_CASES, _assert_table_equal, _jax_proj, _random_proj

MSDA_ATOL = 1e-5  # chip_smoke.py's gate for the MSDA kernel

# ---------------------------------------------------------------- binning

BIN_WARPS, BIN_CHUNK = 8, 1024  # csrc/binning.cu
EMPTY = 1  # y0 = 1 > y1 = 0


def _popc(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x.astype(np.uint32)).astype(np.int64)


def box_codes(mean2d, radius, n_ty, n_tx, slots_y, slots_x) -> np.ndarray:
    """box_code of csrc/binning.cu: the slot-clamped tile box in fp32
    (x / size for a power-of-two tile size is the kernel's IEEE division),
    packed 8 bits a bound; dead gaussians get the empty box."""
    u, v, r = (torch.from_numpy(np.ascontiguousarray(a)) for a in (mean2d[:, 0], mean2d[:, 1], radius))

    def tile(x, size, n):
        return torch.floor(x / size).clamp(0, n - 1).to(torch.int64)

    x0 = tile(u - r, TILE_W, n_tx)
    x1 = torch.minimum(tile(u + r, TILE_W, n_tx), x0 + slots_x - 1)
    y0 = tile(v - r, TILE_H, n_ty)
    y1 = torch.minimum(tile(v + r, TILE_H, n_ty), y0 + slots_y - 1)
    code = y0 | y1 << 8 | x0 << 16 | x1 << 24
    return torch.where(r > 0, code, torch.full_like(code, EMPTY)).numpy()


def members(codes: np.ndarray, n_ty: int, n_tx: int) -> np.ndarray:
    """[len(codes), T] bool: the tiles each packed box covers."""
    y0, y1, x0, x1 = (codes >> s & 255 for s in (0, 8, 16, 24))
    ty = np.arange(n_ty)[:, None].repeat(n_tx, 1).reshape(-1)
    tx = np.arange(n_tx)[None, :].repeat(n_ty, 0).reshape(-1)
    return ((y0[:, None] <= ty) & (ty <= y1[:, None]) & (x0[:, None] <= tx) & (tx <= x1[:, None]))


def warp_masks(codes: np.ndarray, n_ty: int, n_tx: int) -> np.ndarray:
    """[warps, T] uint32: each tile's members among a warp's lanes, as the
    kernels' ballots give them: the lanes whose box spans the tile's row,
    AND those whose box spans its column."""
    y0, y1, x0, x1 = (codes >> s & 255 for s in (0, 8, 16, 24))
    bit = (np.uint32(1) << (np.arange(len(codes)) % 32).astype(np.uint32))[:, None]
    rows = np.where((y0[:, None] <= np.arange(n_ty)) & (np.arange(n_ty) <= y1[:, None]), bit, np.uint32(0))
    cols = np.where((x0[:, None] <= np.arange(n_tx)) & (np.arange(n_tx) <= x1[:, None]), bit, np.uint32(0))
    rows = np.bitwise_or.reduce(rows.reshape(-1, 32, n_ty), axis=1)  # [warps, n_ty]
    cols = np.bitwise_or.reduce(cols.reshape(-1, 32, n_tx), axis=1)
    return (rows[:, :, None] & cols[:, None, :]).reshape(-1, n_ty * n_tx)


def emulate_binning(mean2d, depth, radius, image, k, slots_y, slots_x, chunk=BIN_CHUNK):
    """The three kernels of csrc/binning.cu for one view. Returns (table,
    counts, chunks skipped by the write kernel)."""
    n_ty, n_tx = tile_grid(image)
    t_n, g = n_ty * n_tx, len(depth)
    codes_in = box_codes(mean2d, radius, n_ty, n_tx, slots_y, slots_x)  # bin_prep_kernel
    order = np.argsort(depth, kind="stable")  # the wrapper's stable torch.sort
    chunks = max(1, math.ceil(g / chunk))
    run_len = chunk // BIN_WARPS  # a warp's run of gaussians in its chunk
    padded = chunks * chunk
    codes = np.full(padded, EMPTY, np.int64)
    codes[:g] = codes_in[order]
    ids = np.zeros(padded, np.int64)
    ids[:g] = order

    # bin_count_kernel: each warp's tile counts, and the chunk's
    steps = codes.reshape(chunks, BIN_WARPS, run_len // 32, 32)
    hist_warp = np.zeros((chunks, BIN_WARPS, t_n), np.int64)
    for c in range(chunks):
        for w in range(BIN_WARPS):
            for step in steps[c, w]:
                hist_warp[c, w] += _popc(warp_masks(step, n_ty, n_tx)[0])
    hist_chunk = hist_warp.sum(1)
    total = hist_chunk.sum(0)
    counts = np.minimum(total, k)

    # bin_write_kernel: every entry must be written exactly once
    table = np.full((t_n, k), -1, np.int64)
    writes = np.zeros((t_n, k), np.int64)
    skipped = 0
    below = ((1 << np.arange(32)) - 1).astype(np.uint32)
    for c in range(chunks):
        base = hist_chunk[:c].sum(0)  # the chunk's base in each tile's list
        for t in range(c, t_n, chunks):  # the block's share of tiles: zeros past the count
            table[t, counts[t]:] = 0
            writes[t, counts[t]:] += 1
        if not ((hist_chunk[c] > 0) & (base < k)).any():
            skipped += 1
            continue
        for w in range(BIN_WARPS):
            run = base + hist_warp[c, :w].sum(0)  # the warp's base
            for j, step in enumerate(steps[c, w]):
                i = c * chunk + w * run_len + j * 32 + np.arange(32)
                m = members(step, n_ty, n_tx)  # [lanes, T]
                mask = warp_masks(step, n_ty, n_tx)[0]
                rank = run[None] + _popc(mask[None] & below[:, None])
                hit = m & (rank < k)
                lanes, tt = np.nonzero(hit)
                table[tt, rank[lanes, tt]] = ids[i[lanes]]
                np.add.at(writes, (tt, rank[lanes, tt]), 1)
                first = m & (_popc(mask[None] & below[:, None]) == 0)
                assert (first.sum(0) == (m.sum(0) > 0)).all()  # one first member a covered tile
                run = run + np.where(first, _popc(mask)[None], 0).sum(0)
            assert (run == base + hist_warp[c, :w + 1].sum(0)).all()
    assert (writes == 1).all(), "a table entry was written twice or never"
    return table, counts, skipped


def _tied_across_boundary(g=3000):
    """Runs of 600 equal depths, two straddling the chunk boundaries at
    gaussians 1024 and 2048 of the depth order, in shuffled submission
    order: only a stable sort keeps them."""
    rng = np.random.RandomState(11)
    mean2d, conic, _, radius = _random_proj(rng, g, max_radius=60.0, dead_frac=0.05)
    depth = np.floor(rng.permutation(g) / 600.0).astype(np.float32)
    return mean2d, conic, depth, radius


def _k_mid_chunk(g=3000):
    """Large splats: every tile reaches K = 64, most inside the first chunk."""
    rng = np.random.RandomState(12)
    return _random_proj(rng, g, max_radius=400.0, dead_frac=0.0)


SCHEDULE_CASES = {
    **{name: (lambda case=case: _random_proj(np.random.RandomState(case[0]), case[1], **case[5]),
              case[2], case[3], case[4]) for name, case in BIN_CASES.items()},
    "ties_across_chunk_boundary": (_tied_across_boundary, (256, 256), 512, (4, 2)),
    "k_mid_chunk": (_k_mid_chunk, (256, 256), 64, (4, 2)),
}


@pytest.mark.parametrize("chunk", [BIN_CHUNK, 256])
@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_binning_schedule_matches_count_oracle(name, chunk):
    make, image, k, (sy, sx) = SCHEDULE_CASES[name]
    arrs = make()
    mean2d, _, depth, radius = arrs
    table, counts, skipped = emulate_binning(mean2d, depth, radius, image, k, sy, sx, chunk)
    t_ref, c_ref = JR.bin_gaussians_count(_jax_proj(arrs), image, k, sy, sx)
    _assert_table_equal(torch.from_numpy(table), torch.from_numpy(counts), t_ref, c_ref)
    live = np.arange(k) < counts[:, None]
    assert (table[~live] == 0).all()
    if name == "k_mid_chunk":
        assert (counts == k).all()
        if chunk == 256:  # later chunks cover only full tiles
            assert skipped > 0


# ---------------------------------------------------------------- MSDA

MSDA_WARPS = 16  # csrc/msda.cu
TAP_BYTES = MSDA_WARPS * 32 * 16  # a (query, point) item's taps: 16 bytes
SMEM_OPTIN = 232448  # an H100's largest dynamic shared memory a block
FIXED = {(1, 4), (3, 4)}  # the instantiations with L and P fixed


def point_taps(x, y, a, hh, ww, start):
    """point_taps of csrc/msda.cu and the consumer's rows and weights: the
    rows' weights a (1 - wy), a wy and the columns' 1 - wx, wx, each 0
    outside the level; tap (dy, dx) weighs their product at row r00 + dy ww
    + dx, clamped into the slice (weight 0 there)."""
    gx = (x * ww - 0.5).clamp(-2.0, ww + 1.0)
    gy = (y * hh - 0.5).clamp(-2.0, hh + 1.0)
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0f, gy - y0f
    x0, y0 = x0f.long(), y0f.long()
    zero = torch.zeros_like(wx)
    ay = [torch.where((y0 + d >= 0) & (y0 + d < hh), a * (wy if d else 1.0 - wy), zero) for d in (0, 1)]
    bx = [torch.where((x0 + d >= 0) & (x0 + d < ww), wx if d else 1.0 - wx, zero) for d in (0, 1)]
    r00 = start + y0 * ww + x0
    return [(r00 + dy * ww + dx, ay[dy] * bx[dx]) for dy in (0, 1) for dx in (0, 1)]


def emulate_msda(value, shapes, loc, aw):
    """The kernel's sum for every (batch, query, head): the two half-warps
    take the even and the odd points in order, each point's taps in order,
    every tap read from the head's slice; a shuffle adds the halves."""
    b, len_in, h, d = value.shape
    lq, n_points = loc.shape[1], loc.shape[4]
    slice_ = value.permute(0, 2, 1, 3)  # [B, H, len_in, D]: the staged rows
    bi = torch.arange(b)[:, None, None]
    heads = torch.arange(h)[None, None, :]
    halves = [torch.zeros(b, lq, h, d), torch.zeros(b, lq, h, d)]
    start = 0
    for lvl, (hh, ww) in enumerate(shapes):
        for p in range(n_points):
            pt = lvl * n_points + p
            for r, w in point_taps(loc[:, :, :, lvl, p, 0], loc[:, :, :, lvl, p, 1], aw[:, :, :, lvl, p],
                                   hh, ww, start):
                row = slice_[bi, heads, r.clamp(0, len_in - 1)]
                halves[pt % 2] = halves[pt % 2] + w[..., None] * row
        start += hh * ww
    return (halves[0] + halves[1]).reshape(b, lq, h * d)


def msda_blocks(b, lq, h, d, shapes, n_points, per_sm, sms=132):
    """``launch`` of csrc/msda.cu: (staged, query range of each chunk,
    queries a warp step)."""
    len_in = sum(a * c for a, c in shapes)
    fixed = (len(shapes), n_points) in FIXED
    qb = 32 // (len(shapes) * n_points) if fixed else 1
    staged = TAP_BYTES + len_in * d * 4 <= SMEM_OPTIN
    steps = -(-lq // qb)
    if staged:
        chunks = max(1, min((sms * per_sm) // (b * h), steps))
    else:
        chunks = -(-steps // MSDA_WARPS)
    q_per_block = -(-steps // chunks) * qb
    chunks = -(-lq // q_per_block)
    return staged, [(c * q_per_block, min((c + 1) * q_per_block, lq)) for c in range(chunks)], qb


def _msda_inputs(rng, shapes, b, lq, h, d, p, lo=-0.1, hi=1.1):
    nl = len(shapes)
    hw = sum(a * c for a, c in shapes)
    val = rng.standard_normal((b, hw, h, d)).astype(np.float32)
    loc = (rng.rand(b, lq, h, nl, p, 2) * (hi - lo) + lo).astype(np.float32)
    aw = rng.rand(b, lq, h, nl * p).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(b, lq, h, nl, p)
    return val, loc, aw


MSDA_SCHEDULE_CASES = {
    # name: (levels, B, Lq, H, D, P, loc lo, loc hi)
    "adapter_shape": (((16, 16),), 1, 40, 4, 64, 4, -0.05, 1.05),
    "pixel_decoder_shape": (((4, 4), (8, 8), (16, 16)), 1, 30, 2, 32, 4, -0.05, 1.05),
    "generic_two_levels": (((8, 8), (1, 1)), 2, 21, 2, 32, 2, -0.2, 1.2),
    "generic_40_points": (((8, 8), (4, 4), (2, 2), (1, 1), (6, 5)), 1, 9, 2, 32, 8, -0.1, 1.1),
    "outside_unit_square": (((16, 16),), 1, 20, 2, 64, 4, -0.5, 1.5),
}


@pytest.mark.parametrize("name", list(MSDA_SCHEDULE_CASES))
def test_msda_tap_order_matches_jax(name):
    shapes, b, lq, h, d, p, lo, hi = MSDA_SCHEDULE_CASES[name]
    val, loc, aw = _msda_inputs(np.random.RandomState(21), shapes, b, lq, h, d, p, lo, hi)
    got = emulate_msda(torch.from_numpy(val), shapes, torch.from_numpy(loc), torch.from_numpy(aw))
    ref = JD.multi_scale_deformable_attention(jnp.asarray(val), shapes, jnp.asarray(loc), jnp.asarray(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=MSDA_ATOL)


def test_msda_integer_points_tap_order_matches_jax():
    """Sample points on pixel centres and cell corners: floor() at exact
    integers, taps of weight 0 and 1."""
    shapes = ((8, 8), (4, 4))
    rng = np.random.RandomState(22)
    val, _, aw = _msda_inputs(rng, shapes, 2, 32, 2, 32, 4)
    grid = (rng.randint(0, 17, (2, 32, 2, 2, 4, 2)) / 16.0).astype(np.float32)
    got = emulate_msda(torch.from_numpy(val), shapes, torch.from_numpy(grid), torch.from_numpy(aw))
    ref = JD._msda_matmul(jnp.asarray(val), shapes, jnp.asarray(grid), jnp.asarray(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=MSDA_ATOL)


# (B, Lq, H, D, levels, P, resident blocks an SM): the main path's two
# shapes, and a slice too large for shared memory
GRID_CASES = {
    "adapter": (2, 1344, 16, 64, ((16, 16),), 4, 2),
    "pixel_decoder": (2, 1344, 8, 32, ((8, 8), (16, 16), (32, 32)), 4, 1),
    "few_queries": (1, 7, 2, 32, ((8, 8), (4, 4), (2, 2)), 4, 1),
    "global_slice": (1, 500, 8, 32, ((64, 64), (32, 32), (16, 16), (8, 8)), 4, 0),
}


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_msda_chunks_cover_every_query_once(name):
    b, lq, h, d, shapes, p, per_sm = GRID_CASES[name]
    staged, ranges, qb = msda_blocks(b, lq, h, d, shapes, p, per_sm)
    assert staged == (name != "global_slice")
    if name in ("adapter", "pixel_decoder"):  # the main path: one full wave
        assert 132 * per_sm - b * h < len(ranges) * b * h <= 132 * per_sm
    seen = np.zeros(lq, np.int64)
    for lo, hi in ranges:  # each warp's steps: lo + warp * qb + k * 16 * qb, qb queries, cut at hi
        assert lo < hi
        for warp in range(MSDA_WARPS):
            for qs in range(lo + warp * qb, hi, MSDA_WARPS * qb):
                seen[qs:min(qs + qb, hi)] += 1
    assert (seen == 1).all()
