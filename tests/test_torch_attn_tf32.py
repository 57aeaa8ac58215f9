"""The attention kernel's 3xTF32 arithmetic, rehearsed on the CPU.

``csrc/flash_attention.cu`` runs both products on the tensor cores in
3xTF32: each fp32 operand x is split into big = tf32(x)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, 10 mantissa
bits) and small = x - big, which the tensor core reads truncated to tf32,
and a*b is taken as a_small*b_big + a_big*b_small + a_big*b_big into fp32. The kernel itself runs only on the card; here a
test-only emulation of its arithmetic (the rounding in torch bit operations,
the split of q, k, p and v, the online softmax over 64-key tiles in log2
units, masked keys at -1e30) is held against the plain fp32 version and the
JAX package's attention within chip_smoke.py's gate, 2e-5, and plain TF32
(one product of the big parts) is shown to miss it: why the kernel splits.
The wrapper's checks of what the kernel's 16-byte copies need are called
directly on CPU tensors.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.ops.attention as JA
import siu3r_tpu.ops.rope as JR
from siu3r_tpu_torch.kernels.flash_attention import _check, flash_attn_plain
from siu3r_tpu_torch.ops.rope import rope2d_cos_sin, rope2d_from_cos_sin

ATTN_ATOL = 2e-5  # chip_smoke.py's gate for the kernel against the plain version
KEY_TILE = 64  # keys per shared-memory tile of the kernel
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 (ties away from zero), as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, truncate_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take it: the cross terms first."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def kernel_emulation(q, k, v, scale, qrope=None, krope=None, kv_mask=None, mm=mm_3xtf32, key_groups=1):
    """The kernel's arithmetic in fp32: rotation, q scaled by scale * log2(e),
    then per 64-key tile the scores, the online max, exp2 and the rescaled
    sums (keys past Nk are not in any tile). With ``key_groups=2`` each tile's
    two 32-key halves go to two softmax states, merged at the end, as the
    kernel does for launches with few heads."""
    if qrope is not None:
        q = rope2d_from_cos_sin(q, *qrope)
        k = rope2d_from_cos_sin(k, *krope)
    q = q * (scale * LOG2E)
    b, h, nq, d = q.shape
    width = KEY_TILE // key_groups
    states = []
    for group in range(key_groups):
        m = torch.full((b, h, nq), -math.inf)
        l = torch.zeros(b, h, nq)
        o = torch.zeros(b, h, nq, d)
        for k0 in range(group * width, k.shape[2], KEY_TILE):
            s = mm(q, k[:, :, k0:k0 + width].transpose(-1, -2))
            if kv_mask is not None:
                s = torch.where(kv_mask[:, None, None, k0:k0 + width], s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + mm(p, v[:, :, k0:k0 + width])
            m = mx
        states.append((m, l, o))
    m, l, o = states[0]
    for m1, l1, o1 in states[1:]:
        mx = torch.maximum(m, m1)
        a0, a1 = torch.exp2(m - mx), torch.exp2(m1 - mx)
        m, l, o = mx, l * a0 + l1 * a1, o * a0[..., None] + o1 * a1[..., None]
    return o / l[..., None]


def _inputs(b, h, nq, nk, d, rope, mask_kind, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32)) for n in (nq, nk, nk))
    qpos = kpos = qrope = krope = kv_mask = None
    if rope:
        qpos = rng.randint(0, 17, (b, nq, 2)).astype(np.int32)
        kpos = rng.randint(0, 17, (b, nk, 2)).astype(np.int32)
        qrope = rope2d_cos_sin(torch.from_numpy(qpos), d)
        krope = rope2d_cos_sin(torch.from_numpy(kpos), d)
    if mask_kind == "first_tile_masked":  # the first key tile wholly masked, later keys live
        mask = rng.rand(b, nk) > 0.5
        mask[:, :KEY_TILE] = False
        mask[:, KEY_TILE] = True
        kv_mask = torch.from_numpy(mask)
    elif mask_kind == "one_live_key":
        mask = rng.rand(b, nk) > 0.5
        mask[0] = False
        mask[0, nk // 2] = True
        kv_mask = torch.from_numpy(mask)
    return q, k, v, qrope, krope, kv_mask, qpos, kpos


def _jax_reference(q, k, v, scale, qpos, kpos, kv_mask) -> np.ndarray:
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    if qpos is not None:
        jq = JR.rope2d(jq, jnp.asarray(qpos))
        jk = JR.rope2d(jk, jnp.asarray(kpos))
    mask = None if kv_mask is None else jnp.asarray(kv_mask.numpy())
    return np.asarray(JA.xla_attention(jq, jk, jv, scale, kv_mask=mask))


# (B, H, Nq, Nk, D, rope, mask): the Mask2Former and encoder shapes, then
# the kernel's tiling edges (key tails of 8, 9, 63, 65; a 17-row query set;
# a wholly masked first tile; one live key)
MAIN = [(1, 8, 100, 100, 32, False, None), (1, 8, 100, 100, 32, True, None),
        (2, 16, 257, 257, 64, False, None), (2, 16, 257, 257, 64, True, None)]
EDGE = [(1, 4, 33, 8, 64, True, None), (2, 2, 40, 9, 32, False, None), (1, 3, 20, 63, 64, False, None),
        (1, 3, 70, 65, 32, True, None), (2, 4, 17, 100, 32, True, None),
        (2, 4, 65, 200, 32, False, "first_tile_masked"), (2, 3, 40, 130, 64, True, "first_tile_masked"),
        (2, 4, 65, 130, 32, False, "one_live_key")]


@pytest.mark.parametrize("key_groups", [1, 2])
@pytest.mark.parametrize("case", MAIN + EDGE, ids=lambda c: "x".join(map(str, c[:5])) + f"-rope{int(c[5])}-{c[6]}")
def test_3xtf32_emulation_within_gate(case, key_groups):
    """The kernel's 3xTF32 arithmetic, with one or two softmax states a row,
    stays within 2e-5 of the plain fp32 version and, at the main path's
    shapes, of the JAX package's attention."""
    b, h, nq, nk, d, rope, mask_kind = case
    q, k, v, qrope, krope, kv_mask, qpos, kpos = _inputs(*case)
    scale = d ** -0.5
    got = kernel_emulation(q, k, v, scale, qrope, krope, kv_mask, key_groups=key_groups)
    plain = flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= ATTN_ATOL
    if case in MAIN:
        ref = _jax_reference(q, k, v, scale, qpos, kpos, kv_mask)
        assert np.abs(got.numpy() - ref).max() <= ATTN_ATOL


@pytest.mark.parametrize("case", MAIN, ids=lambda c: "x".join(map(str, c[:5])) + f"-rope{int(c[5])}")
def test_plain_tf32_misses_gate(case):
    """One TF32 product per fp32 product misses the gate at the main path's
    shapes: the reason the kernel takes three."""
    q, k, v, qrope, krope, kv_mask, _, _ = _inputs(*case)
    scale = case[4] ** -0.5
    got = kernel_emulation(q, k, v, scale, qrope, krope, kv_mask, mm=mm_tf32)
    plain = flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    assert (got - plain).abs().max().item() > ATTN_ATOL


def test_tf32_rounding():
    """Round to nearest with ties away from zero at the 13th bit, as cvt.rna;
    big + small, as the tensor core reads them, carries x to within 2^-21
    of itself."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10  # tf32 keeps 10 mantissa bits
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 1.5 * ulp, 3.0])
    assert tf32(x).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0]
    assert tf32(one).item() == 1.0
    r = torch.from_numpy(np.random.RandomState(1).randn(10000).astype(np.float32))
    big, small = split(r)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all() and ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((big + small - r).abs() <= r.abs() * 2.0 ** -21).all()


def _model_layouts():
    """The layouts the model gives the kernel: strided views of one packed
    projection, and transposed [B, N, H, D] views."""
    qkv = torch.randn(2, 257, 3, 16, 64).permute(2, 0, 3, 1, 4)
    cross = [torch.randn(1, 100, 8, 32).transpose(1, 2) for _ in range(3)]
    return [(qkv[0], qkv[1], qkv[2]), tuple(cross)]


def test_check_accepts_model_layouts():
    for q, k, v in _model_layouts():
        _check(q, k, v, None, None, None)


def _misaligned(shape) -> torch.Tensor:
    """A contiguous tensor starting 4 bytes past a 16-byte boundary."""
    n = math.prod(shape)
    buf = torch.zeros(n + 8)
    off = (4 - buf.data_ptr() % 16 // 4) % 4 + 1  # elements to the next boundary, plus one
    return buf[off:off + n].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v", "row_stride", "head_stride", "rope_table"])
def test_check_rejects_what_the_copies_cannot_take(which):
    b, h, n, d = 1, 2, 9, 32
    q, k, v = (torch.zeros(b, h, n, d) for _ in range(3))
    qrope = krope = None
    if which in ("q", "k", "v"):
        t = _misaligned((b, h, n, d))
        assert t.data_ptr() % 16 != 0
        q, k, v = (t if name == which else x for name, x in zip("qkv", (q, k, v)))
    elif which == "row_stride":  # rows 34 floats apart
        k = torch.zeros(b, h, n, d + 2)[..., :d]
    elif which == "head_stride":  # heads 34 floats apart: a [B, N, H, D + 2] projection cut to D
        v = torch.zeros(b, n, h, d + 2)[..., :d].transpose(1, 2)
    else:
        cos, sin = rope2d_cos_sin(torch.zeros(b, n, 2, dtype=torch.int64), d)
        qrope = krope = (_misaligned((b, n, d)).copy_(cos), sin)
    with pytest.raises(ValueError):
        _check(q, k, v, qrope, krope, None)
