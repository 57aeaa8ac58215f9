"""Multi-head attention, counterpart of ``siu3r_tpu/ops/attention.py``.

``attention`` is the plain version (the counterpart of ``xla_attention``):
fp32 logits and accumulation, masked keys set to -1e30, the softmax in fp32
and its probabilities rounded to v's dtype before p v (a no-op in fp32; in
bf16 the multi-view bank and every masked call round as the JAX package
does), the output in q's dtype. ``rope_attention`` and
``multi_head_attention`` follow the JAX dispatch rule: with no per-query
``mask`` they take the hand-written attention kernel
(``kernels/flash_attention.py``); with a ``mask`` (Mask2Former's masked
cross-attention) they take the plain path, as the JAX package leaves that
case to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from siu3r_tpu_torch.ops.rope import rope2d, rope2d_cos_sin


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    kv_mask: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, N, D] tensors.

    kv_mask: optional [B, Nk] bool, True = attendable.
    mask: optional [B, Nq, Nk] or [B, H, Nq, Nk] bool, True = attendable.
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    neg = logits.new_full((), -1e30)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, neg)
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, H, N, D] attention; the kernel path whenever ``mask is None``."""
    # imported here: the kernel module imports ``attention`` from this one
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None:
        return flash_attn(q, k, v, scale, kv_mask=kv_mask)
    return attention(q, k, v, scale, kv_mask=kv_mask, mask=mask)


def rope_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    rope_base: float = 100.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RoPE2D on q/k, then attention. With no ``mask`` the rotation runs
    inside the attention kernel, from the cos/sin tables of
    ``rope2d_cos_sin`` in q's dtype (kernel 1b on bf16)."""
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn

    d = q.shape[-1]
    scale = d**-0.5
    if mask is None:
        qrope = rope2d_cos_sin(qpos, d, base=rope_base, dtype=q.dtype)
        krope = qrope if kpos is qpos else rope2d_cos_sin(kpos, d, base=rope_base, dtype=q.dtype)
        return flash_attn(q, k, v, scale, qrope=qrope, krope=krope)
    q = rope2d(q, qpos, base=rope_base)
    k = rope2d(k, kpos, base=rope_base)
    return attention(q, k, v, scale, mask=mask)
