"""siu3r_tpu_torch ops against the JAX package's ops and Pallas kernels.

Inputs are made from a seed with numpy and fed to both sides. The port runs
on the CPU, where each kernel wrapper takes its plain PyTorch version; the
JAX side runs its XLA ops and, where named, its Pallas kernels in interpret
mode. Tolerance: atol 1e-5 throughout (fp32; the two sides sum in other
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.ops.attention as JA
import siu3r_tpu.ops.deformable as JD
import siu3r_tpu.ops.flash_attention as JF
import siu3r_tpu.ops.msda_pallas as JM
import siu3r_tpu.ops.rope as JR
from siu3r_tpu_torch.kernels.flash_attention import flash_attn
from siu3r_tpu_torch.kernels.msda import msda
from siu3r_tpu_torch.ops import attention as TA
from siu3r_tpu_torch.ops import deformable as TD
from siu3r_tpu_torch.ops import rope as TR

ATOL = 1e-5
_PALLAS_CALL = JF.pl.pallas_call


@pytest.fixture()
def interpret_mode(monkeypatch):
    """Run every pallas_call (flash attention and msda share the module) in
    interpret mode."""
    def patched(*a, **k):
        k["interpret"] = True
        return _PALLAS_CALL(*a, **k)

    monkeypatch.setattr(JF.pl, "pallas_call", patched)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _qkv(rng, b, h, nq, nk, d):
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    return q, k, v


def _pos(rng, b, n):
    return rng.randint(0, 17, (b, n, 2)).astype(np.int64)


def test_rope2d_matches_jax():
    rng = np.random.RandomState(0)
    tok = rng.standard_normal((2, 3, 21, 16)).astype(np.float32)
    pos = _pos(rng, 2, 21)
    cos, sin = TR.rope2d_cos_sin(torch.from_numpy(pos), 16)
    jcos, jsin = JR.rope2d_cos_sin(jnp.asarray(pos), 16)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(TR.rope2d(torch.from_numpy(tok), torch.from_numpy(pos)), JR.rope2d(jnp.asarray(tok), jnp.asarray(pos)))


@pytest.mark.parametrize("case", ["plain", "kv_mask", "mask"])
def test_attention_matches_xla(case):
    rng = np.random.RandomState(1)
    q, k, v = _qkv(rng, 2, 3, 13, 19, 8)
    kv_mask = mask = None
    if case == "kv_mask":
        kv_mask = rng.rand(2, 19) > 0.4
        kv_mask[:, 0] = True
    if case == "mask":
        mask = rng.rand(2, 13, 19) > 0.5
        mask[0, 3] = False  # a row with every key excluded
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    port = TA.attention(t(q), t(k), t(v), 0.3, kv_mask=t(kv_mask), mask=t(mask))
    ref = JA.xla_attention(j(q), j(k), j(v), 0.3, kv_mask=j(kv_mask), mask=j(mask))
    _close(port, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_rope_attention_matches_jax(masked):
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, 1, 4, 17, 23, 16)
    qpos, kpos = _pos(rng, 1, 17), _pos(rng, 1, 23)
    mask = (rng.rand(1, 17, 23) > 0.3) if masked else None
    port = TA.rope_attention(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), rope_base=100.0,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    ref = JA.rope_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), rope_base=100.0,
        mask=None if mask is None else jnp.asarray(mask),
    )
    _close(port, ref)


def test_multi_head_attention_matches_jax():
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 2, 4, 10, 10, 8)
    kv_mask = rng.rand(2, 10) > 0.5
    kv_mask[:, 1] = True
    port = TA.multi_head_attention(*map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(kv_mask))
    ref = JA.multi_head_attention(*map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(kv_mask))
    _close(port, ref)


@pytest.mark.parametrize(
    "case",
    [
        (1, 4, 17, 17, 16, True, False),   # RoPE self-attention
        (2, 3, 9, 30, 32, True, False),    # RoPE, Nq != Nk
        (2, 8, 12, 12, 32, False, False),  # plain
        (2, 2, 7, 20, 32, False, True),    # plain, kv_mask with one live key in a row
        (1, 2, 5, 1, 32, False, False),    # one key
    ],
)
def test_attention_plain_matches_pallas_kernel(interpret_mode, case):
    """The plain version the CUDA kernel is held to equals the TPU kernels
    (``_attn_rope_kernel`` / ``_attn_kernel``) run in interpret mode."""
    b, h, nq, nk, d, rope, use_mask = case
    rng = np.random.RandomState(4)
    q, k, v = _qkv(rng, b, h, nq, nk, d)
    scale = d**-0.5
    if rope:
        qpos, kpos = _pos(rng, b, nq), _pos(rng, b, nk)
        qrope = TR.rope2d_cos_sin(torch.from_numpy(qpos), d)
        krope = TR.rope2d_cos_sin(torch.from_numpy(kpos), d)
        port = flash_attn(*map(torch.from_numpy, (q, k, v)), scale, qrope=qrope, krope=krope)
        ref = JF.flash_attention_rope(*map(jnp.asarray, (q, k, v, qpos, kpos)), scale, 100.0)
    else:
        kv_mask = None
        if use_mask:
            kv_mask = rng.rand(b, nk) > 0.5
            kv_mask[0] = False
            kv_mask[0, 5] = True
        port = flash_attn(
            *map(torch.from_numpy, (q, k, v)), scale,
            kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
        )
        ref = JF.flash_attention(
            *map(jnp.asarray, (q, k, v)), scale,
            kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        )
    _close(port, ref)


def _msda_inputs(rng, shapes, lq, h, d, p, lo=-0.1, hi=1.1, b=2):
    nl = len(shapes)
    hw = sum(a * c for a, c in shapes)
    val = rng.standard_normal((b, hw, h, d)).astype(np.float32)
    loc = (rng.rand(b, lq, h, nl, p, 2) * (hi - lo) + lo).astype(np.float32)
    aw = rng.rand(b, lq, h, nl * p).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(b, lq, h, nl, p)
    return val, loc, aw


MSDA_CASES = {
    "adapter_like": (((16, 16),), 100, 4, 8, 4),
    "multi_level": (((8, 8), (4, 4), (2, 2)), 84, 2, 8, 4),
    "one_by_one_level": (((4, 4), (1, 1)), 21, 2, 4, 2),
    "gather_form": (((48, 48),), 30, 2, 4, 2),  # > 2048 values: the JAX gather path
}


@pytest.mark.parametrize("name", list(MSDA_CASES))
def test_msda_matches_jax(name):
    shapes, lq, h, d, p = MSDA_CASES[name]
    val, loc, aw = _msda_inputs(np.random.RandomState(5), shapes, lq, h, d, p)
    port = msda(*map(torch.from_numpy, (val,)), shapes, torch.from_numpy(loc), torch.from_numpy(aw))
    ref = JD.multi_scale_deformable_attention(jnp.asarray(val), shapes, jnp.asarray(loc), jnp.asarray(aw))
    _close(port, ref)


def test_msda_integer_points_match_jax():
    """Sample points exactly on pixel centres and cell corners."""
    shapes = ((8, 8), (4, 4))
    rng = np.random.RandomState(6)
    val, _, aw = _msda_inputs(rng, shapes, 32, 2, 8, 4)
    grid = (rng.randint(0, 17, (2, 32, 2, 2, 4, 2)) / 16.0).astype(np.float32)
    port = TD.multi_scale_deformable_attention(torch.from_numpy(val), shapes, torch.from_numpy(grid), torch.from_numpy(aw))
    ref = JD._msda_matmul(jnp.asarray(val), shapes, jnp.asarray(grid), jnp.asarray(aw))
    _close(port, ref)


@pytest.mark.parametrize("name", ["adapter_like", "multi_level"])
def test_msda_plain_matches_pallas_kernel(interpret_mode, name):
    """The plain version the CUDA kernel is held to equals the TPU kernel
    ``_level_kernel`` run in interpret mode."""
    shapes, lq, h, d, p = MSDA_CASES[name]
    val, loc, aw = _msda_inputs(np.random.RandomState(7), shapes, lq, h, d, p)
    port = TD.multi_scale_deformable_attention(*map(torch.from_numpy, (val,)), shapes, torch.from_numpy(loc), torch.from_numpy(aw))
    ref = JM.msda_pallas(jnp.asarray(val), shapes, jnp.asarray(loc), jnp.asarray(aw))
    _close(port, ref)


def test_reference_points_match_jax():
    shapes = [(8, 8), (4, 4), (2, 2)]
    _close(TD.reference_points_for_shapes(shapes), JD.reference_points_for_shapes(shapes), atol=0)
