"""Attention kernel wrapper: ``csrc/flash_attention.cu`` and its plain version.

One templated CUDA kernel replaces the two TPU kernels of
``siu3r_tpu/ops/flash_attention.py``: with RoPE tables it is the fused
RoPE2D attention (``_attn_rope_kernel``, launches counted as
``flash_attn_rope``), without them the plain attention with an optional
per-batch key mask (``_attn_kernel``, counted as ``flash_attn``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from siu3r_tpu_torch.kernels import _build
from siu3r_tpu_torch.ops.attention import attention
from siu3r_tpu_torch.ops.rope import rope2d_from_cos_sin

CosSin = Tuple[torch.Tensor, torch.Tensor]
KERNEL_HEAD_DIMS = (32, 64)


def flash_attn_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    qrope: Optional[CosSin] = None,
    krope: Optional[CosSin] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rotate q/k by their cos/sin
    tables, then ``attention``."""
    if qrope is not None:
        q = rope2d_from_cos_sin(q, *qrope)
        k = rope2d_from_cos_sin(k, *krope)
    return attention(q, k, v, scale, kv_mask=kv_mask)


def _check(q, k, v, qrope, krope, kv_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be [B, H, N, D]")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != (b, h, nk, d):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim {KERNEL_HEAD_DIMS}, got {d}")
    if nq < 1 or nk < 1:
        raise ValueError("empty query or key set")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be fp32 on {q.device} with unit stride on D")
    if (qrope is None) != (krope is None):
        raise ValueError("qrope and krope go together")
    if qrope is not None:
        for t, n in ((qrope[0], nq), (qrope[1], nq), (krope[0], nk), (krope[1], nk)):
            if (t.shape != (b, n, d) or t.dtype != torch.float32
                    or t.device != q.device or not t.is_contiguous()):
                raise ValueError("RoPE tables must be contiguous fp32 [B, N, D] on q's device")
    if kv_mask is not None and (
        kv_mask.shape != (b, nk) or kv_mask.dtype != torch.bool
        or kv_mask.device != q.device or not kv_mask.is_contiguous()
    ):
        raise ValueError("kv_mask must be a contiguous bool [B, Nk] on q's device")


def flash_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    qrope: Optional[CosSin] = None,
    krope: Optional[CosSin] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(rot(q) rot(k)^T * scale) v.

    q [B, H, Nq, D], k/v [B, H, Nk, D] fp32, D in (32, 64), any strides with
    unit stride on D. qrope/krope: (cos, sin) tables [B, N, D] from
    ``rope2d_cos_sin``, or None for no rotation. kv_mask: [B, Nk] bool, True =
    attendable. Returns [B, H, Nq, D] contiguous. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, qrope, krope, kv_mask)
    lib = _build.load_library()
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty((b, h, nq, d), dtype=torch.float32, device=q.device)
    rope_ptrs = (
        [t.data_ptr() for t in (*qrope, *krope)] if qrope is not None else [None] * 4
    )
    err = lib.siu3r_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *rope_ptrs,
        None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
        b, h, nq, nk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _build.stream_handle(q.device),
    )
    name = "flash_attn_rope" if qrope is not None else "flash_attn"
    _build.check_launch(err, name)
    _build.launch_counts[name] += 1
    return out
