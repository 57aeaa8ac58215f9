"""Kernel 1b's resident schedule and arithmetic, rehearsed on the CPU.

``csrc/flash_attention.cu``'s ``flash_attn_rope_bf16_resident_kernel`` holds
a head's K and V in shared memory, rotates K once in bf16 (each product
rounded, then the sum), and gives each group of 16 query rows to KG warps
that take contiguous, disjoint shares of the head's 16-key chunks. Each warp
walks its chunks four at a time, then a tail of two and of one. Pass 1
keeps an online max of its rows in log2 units (the raw fp32 maximum times
sl2 = scale * log2 e; keys past Nk at -inf) and their sums of e =
exp2(s * sl2 - m), the argument one fused multiply-add, and records each
tile's e and m. The KG warps merge their (max, sum) in order, so every one
holds the row's exact max and sum, and take 1 / sum as an fp32 reciprocal.
Pass 2 rounds p = e * f to bf16, f = exp2(m_tile - max) * (1 / sum) taken
once a tile and row, and accumulates p v in fp32 over the warp's own keys;
the partial accumulators are added in fp32, warp by warp, and rounded to
bf16 once.

The kernel runs only on the card; here a test-only emulation of that order
of operations, for KG = 1, 2 and 4, is held against the plain version
(``flash_attn_plain`` on bf16) and the JAX package's Pallas kernel on bf16
inputs in interpret mode, elementwise within one bf16 ulp of each (at least
2^-8, the ulp of [1/2, 1)): chip_smoke.py's gate for the kernel; and at
least 99% of the outputs bit-equal, which the ulp alone does not show: it
holds a wrong rounding point of p. Splitting
the keys changes only the order of fp32 sums, and the record only fp32
roundings inside the normalised p, never where a value is rounded to bf16.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.ops.flash_attention as JF
from siu3r_tpu_torch.kernels.flash_attention import flash_attn_plain
from siu3r_tpu_torch.ops.rope import rope2d_cos_sin, rope2d_from_cos_sin
from test_torch_ops import interpret_mode  # noqa: F401  (fixture)
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)

ULP = 2.0**-8  # chip_smoke.py's ATTN_BF16_ULP: the least ulp of the gate
# and at least this share of the outputs bit-equal (tests/test_torch_bf16.py's
# BIT_EQUAL for the plain version against the Pallas kernel). Measured 0.998
# to 1; rounding the unnormalised p to bf16 and dividing after p v (an
# online softmax's rounding point) stays within the ulp but scores 0.51
BIT_EQUAL = 0.99
CHUNK = 16  # keys a chunk: one k-step of p v, two column tiles of q k^T
LOG2E = 1.4426950408889634

# (B, H, Nq, Nk, D): the decoder launch (12 heads, keys split), queries
# against a longer key set, a 65-key tail at D = 32, an 8-key set (one chunk,
# half of it past Nk), and a single key (warps without keys when KG > 1)
CASES = [(1, 12, 257, 257, 64), (1, 4, 100, 257, 64), (1, 3, 70, 65, 32), (1, 4, 33, 8, 64), (2, 3, 70, 1, 32)]
KEY_GROUPS = (1, 2, 4)


def warp_tiles(nk: int, kg: int, key_groups: int) -> list[tuple[int, int]]:
    """Key ranges [k0, k1) of warp ``kg``'s tiles, in the order it walks them
    (k1 may pass Nk inside the last chunk), as the kernel's loops take them."""
    chunks = -(-nk // CHUNK)
    c, c_hi = kg * chunks // key_groups, (kg + 1) * chunks // key_groups
    tiles = []
    while c + 4 <= c_hi:
        tiles.append((c * CHUNK, (c + 4) * CHUNK))
        c += 4
    if c + 2 <= c_hi:
        tiles.append((c * CHUNK, (c + 2) * CHUNK))
        c += 2
    if c < c_hi:
        tiles.append((c * CHUNK, (c + 1) * CHUNK))
    return tiles


def kernel_emulation(q, k, v, scale, qrope, krope, key_groups: int) -> torch.Tensor:
    """The resident kernel's order of operations on bf16 q, k, v and tables."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    qr = rope2d_from_cos_sin(q, *qrope).float()  # bf16 rotation: products rounded, then the sum
    kr = rope2d_from_cos_sin(k, *krope).float()
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    s = qr @ kr.transpose(-1, -2)  # the raw fp32 scores
    padded = -(-nk // CHUNK) * CHUNK
    s = torch.cat([s, s.new_full((b, h, nq, padded - nk), -math.inf)], -1)  # keys past Nk
    vp = torch.cat([v.float(), v.new_zeros(b, h, padded - nk, d).float()], 2)
    # pass 1, per warp and tile: the online max in log2 units (the raw
    # maximum times sl2), the sum of e = exp2(s * sl2 - m) with the argument
    # one fused multiply-add (exact in float64, then rounded once), and the
    # record of each tile's e and m
    stats, records = [], []
    for kg in range(key_groups):
        m = torch.full((b, h, nq), -math.inf)
        l = torch.zeros(b, h, nq)
        record = []
        for k0, k1 in warp_tiles(nk, kg, key_groups):
            mx = torch.maximum(m, s[..., k0:k1].amax(-1) * sl2)
            e = torch.exp2((s[..., k0:k1].double() * sl2.double() - mx[..., None].double()).float())
            l = l * torch.exp2(m - mx) + e.sum(-1)
            m = mx
            record.append((k0, k1, e, mx))
        stats.append((m, l))
        records.append(record)
    # every warp merges the row group's (max, sum) in the same order
    mx = torch.stack([m for m, _ in stats]).amax(0)
    total = torch.zeros(b, h, nq)
    for m, l in stats:
        total = total + l * torch.exp2(m - mx)
    inv = 1.0 / total  # fp32, correctly rounded (the kernel's __frcp_rn)
    # pass 2 from the record: p = e * f with f = exp2(m_tile - max) * inv,
    # rounded to bf16; each warp's p v in fp32, the partial accumulators
    # added warp by warp, then one rounding to bf16
    out = torch.zeros(b, h, nq, d)
    for record in records:
        part = torch.zeros(b, h, nq, d)
        for k0, k1, e, m_tile in record:
            f = torch.exp2(m_tile - mx) * inv
            p = (e * f[..., None]).to(torch.bfloat16)
            part = part + p.float() @ vp[:, :, k0:k1]
        out = out + part
    return out.to(torch.bfloat16)


def _ulp(ref: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``ref`` (bf16), at least ULP, as fp32."""
    a = ref.abs()
    up = (a.view(torch.int16) + 1).view(torch.bfloat16)
    return (up.float() - a.float()).clamp(min=ULP)


def _within_ulp(out: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    excess = ((out.float() - ref.float()).abs() - _ulp(ref)).max().item()
    assert excess <= 0, f"{what}: beyond one bf16 ulp by {excess}"
    equal = (out == ref).float().mean().item()
    assert equal >= BIT_EQUAL, f"{what}: {equal} of the outputs bit-equal"


_REFERENCES: dict = {}


def _case(shape):
    """Inputs of one case (numpy seed 0), the plain version's output and the
    Pallas kernel's (interpret mode) on them, computed once a case."""
    if shape not in _REFERENCES:
        b, h, nq, nk, d = shape
        rng = np.random.RandomState(0)
        q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))
        qpos, kpos = rng.randint(0, 17, (b, nq, 2)), rng.randint(0, 17, (b, nk, 2))
        scale = d**-0.5
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        qrope = rope2d_cos_sin(torch.from_numpy(qpos), d, dtype=torch.bfloat16)
        krope = rope2d_cos_sin(torch.from_numpy(kpos), d, dtype=torch.bfloat16)
        plain = flash_attn_plain(tq, tk, tv, scale, qrope, krope)
        pallas = JF.flash_attention_rope(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                         jnp.asarray(qpos), jnp.asarray(kpos), scale)
        pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32))).bfloat16()
        _REFERENCES[shape] = ((tq, tk, tv, scale, qrope, krope), plain, pallas)
    return _REFERENCES[shape]


@pytest.mark.parametrize("key_groups", KEY_GROUPS)
@pytest.mark.parametrize("shape", CASES)
def test_split_key_schedule_matches_plain_and_pallas(interpret_mode, shape, key_groups):
    inputs, plain, pallas = _case(shape)
    out = kernel_emulation(*inputs, key_groups=key_groups)
    assert out.shape == plain.shape and out.dtype == torch.bfloat16
    _within_ulp(out, plain, f"KG={key_groups} against the plain version")
    _within_ulp(out, pallas, f"KG={key_groups} against the Pallas kernel")


def test_warp_tiles_cover_each_key_once():
    """Every chunk of the head goes to exactly one warp, in contiguous shares
    that differ by at most one chunk, each walked four chunks at a time and
    then a tail of at most two and one."""
    for nk in (1, 8, 16, 17, 65, 100, 257, 768):
        chunks = -(-nk // CHUNK)
        for key_groups in KEY_GROUPS:
            tiles = [warp_tiles(nk, kg, key_groups) for kg in range(key_groups)]
            flat = [t for w in tiles for t in w]
            assert [k0 for k0, _ in flat] == [k1 for _, k1 in [(0, 0)] + flat[:-1]]
            assert flat[-1][1] == chunks * CHUNK
            shares = [sum(k1 - k0 for k0, k1 in w) // CHUNK for w in tiles]
            assert max(shares) - min(shares) <= 1
            for w in tiles:
                sizes = [(k1 - k0) // CHUNK for k0, k1 in w]
                tail = [n for n in sizes if n != 4]
                assert sizes == [4] * (len(sizes) - len(tail)) + tail and tail in ([], [2], [1], [2, 1])
