"""Attention kernel wrapper: ``csrc/flash_attention.cu`` and its plain version.

One templated CUDA kernel replaces the two TPU kernels of
``siu3r_tpu/ops/flash_attention.py`` on fp32 inputs: with RoPE tables it is
the fused RoPE2D attention (``_attn_rope_kernel``, launches counted as
``flash_attn_rope``), without them the plain attention with an optional
per-batch key mask (``_attn_kernel``, counted as ``flash_attn``). Its two
products run on the tensor cores in 3xTF32 (each fp32 operand split into two
TF32 parts, three products), which keeps fp32-level accuracy whatever
``torch.backends`` says about TF32: those switches govern cuBLAS and cuDNN
only. K and V reach shared memory by 16-byte asynchronous copies, so every
row of q, k and v must start on a 16-byte boundary (``_check``): fp32 rows
with batch, head and row strides that are multiples of 4 elements.

On bf16 q, k and v (the backbone under ``model.dtype: bfloat16``) a sibling
kernel, kernel 1b, is ``_attn_rope_kernel`` as the JAX package runs it on
bf16: the rotation in bf16 with bf16 tables, bf16 products accumulated in
fp32, the softmax in fp32 and the normalised probabilities rounded to bf16
before p v, a bf16 output (launches counted as ``flash_attn_rope_bf16``,
and in ``_build.variant_counts`` by the kernel that ran: ``.resident``, the
head's K and V and pass 1's record in shared memory, as at every shape the
model makes; ``.streamed`` for longer key sets; ``bf16_variant`` says which
from Nk and D). It takes RoPE tables and no key mask (no bf16 call has one: the masked
attention takes the plain path, and kernel 2's callers, Mask2Former and the
language layers, compute in fp32), bf16 tables, and rows on 16-byte
boundaries: batch, head and row strides that are multiples of 8 elements.
A bf16 call without RoPE or with a mask raises on CUDA tensors.

``flash_attn`` is differentiable (a ``torch.autograd.Function``). Its forward
is the kernel on CUDA tensors and the plain version on CPU tensors. Its
backward recomputes the plain version (RoPE2D, then ``attention``) and takes
its VJP, the counterpart of the JAX package's ``_flash_rope_diff_bwd`` and
``_flash_diff_bwd`` (``siu3r_tpu/ops/attention.py``): the TPU kernels are
forward-only and their gradient is XLA code, so there is no TPU backward
kernel to port here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from siu3r_tpu_torch.kernels import _build
from siu3r_tpu_torch.ops.attention import attention
from siu3r_tpu_torch.ops.rope import rope2d_from_cos_sin

CosSin = Tuple[torch.Tensor, torch.Tensor]
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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
    tables (in q's dtype: on bf16, each product and the sum rounded to bf16),
    then ``attention``."""
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
    dtype = q.dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"attention kernel takes {KERNEL_DTYPES}, got {dtype}")
    # the kernel copies rows in 16-byte pieces: 4 fp32 or 8 bf16 elements
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != dtype or t.stride(-1) != 1:
            raise ValueError(f"{name} must be {dtype} on {q.device} with unit stride on D")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        if any(stride % per16 != 0 for stride, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name}'s batch, head and row strides must be multiples of {per16} elements, "
                             f"got {t.stride()[:3]}")
    if (qrope is None) != (krope is None):
        raise ValueError("qrope and krope go together")
    if dtype == torch.bfloat16 and (qrope is None or kv_mask is not None):
        raise ValueError("the bf16 attention kernel (kernel 1b) takes RoPE tables and no kv_mask; "
                         "kernel 2 (no RoPE, optional kv_mask) runs in fp32 only")
    if qrope is not None:
        for t, n in ((qrope[0], nq), (qrope[1], nq), (krope[0], nk), (krope[1], nk)):
            if (t.shape != (b, n, d) or t.dtype != dtype
                    or t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16 != 0):
                raise ValueError(f"RoPE tables must be contiguous {dtype} [B, N, D] on q's device, "
                                 "on a 16-byte boundary")
    if kv_mask is not None and (
        kv_mask.shape != (b, nk) or kv_mask.dtype != torch.bool
        or kv_mask.device != q.device or not kv_mask.is_contiguous()
    ):
        raise ValueError("kv_mask must be a contiguous bool [B, Nk] on q's device")


# kernel 1b's variants, as siu3r_flash_attn_bf16_variant numbers them
BF16_VARIANTS = {1: "flash_attn_rope_bf16.resident", 2: "flash_attn_rope_bf16.streamed"}


@functools.lru_cache(maxsize=None)
def bf16_variant(nk: int, d: int) -> str:
    """The kernel 1b variant that takes Nk keys of head dim D: the resident
    kernel with pass 1's record where K, V and the record fit a block's
    shared memory (up to 320 keys at D = 64, 400 at D = 32), else the
    streamed one. Needs the built library."""
    return BF16_VARIANTS[_build.load_library().siu3r_flash_attn_bf16_variant(nk, d)]


def launch_config(b: int, h: int, nq: int, nk: int, d: int, rope: bool,
                  dtype: torch.dtype = torch.float32) -> tuple[int, int, int]:
    """The kernel's launch at these sizes (kernel 1b's for bf16, in its
    variant's layout): (blocks, threads a block, dynamic shared memory bytes
    a block). Needs the built library."""
    lib = _build.load_library()
    out = [ctypes.c_int() for _ in range(3)]
    refs = (ctypes.byref(x) for x in out)
    if dtype == torch.bfloat16:
        err = lib.siu3r_flash_attn_bf16_launch_config(b, h, nq, nk, d, *refs)
    else:
        err = lib.siu3r_flash_attn_launch_config(b, h, nq, d, int(rope), *refs)
    _build.check_launch(err, "flash_attn launch_config")
    return tuple(x.value for x in out)


def _flash_attn_forward(q, k, v, scale, qrope, krope, kv_mask) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, qrope, krope, kv_mask)
    lib = _build.load_library()
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        err = lib.siu3r_flash_attn_rope_bf16_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in (*qrope, *krope)), out.data_ptr(),
            b, h, nq, nk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), _build.stream_handle(q.device),
        )
        _build.check_launch(err, "flash_attn_rope_bf16")
        _build.launch_counts["flash_attn_rope_bf16"] += 1
        _build.variant_counts[bf16_variant(nk, d)] += 1
        return out
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


class _FlashAttn(torch.autograd.Function):
    """The kernel's forward with the plain version's VJP as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, qcos, qsin, kcos, ksin, kv_mask):
        qrope = None if qcos is None else (qcos, qsin)
        krope = None if kcos is None else (kcos, ksin)
        ctx.save_for_backward(q, k, v, qcos, qsin, kcos, ksin, kv_mask)
        ctx.scale = scale
        return _flash_attn_forward(q, k, v, scale, qrope, krope, kv_mask)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, qcos, qsin, kcos, ksin, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attn_plain(
                *inputs, ctx.scale, None if qcos is None else (qcos, qsin),
                None if kcos is None else (kcos, ksin), kv_mask,
            )
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None, None, None, None, None, None


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

    q [B, H, Nq, D], k/v [B, H, Nk, D] fp32 or bf16, D in (32, 64), unit
    stride on D; on CUDA, 16-byte-aligned with batch, head and row strides
    that are multiples of 4 elements in fp32, 8 in bf16 (every layout the
    model makes: the packed qkv projection's row stride is 3C). qrope/krope:
    (cos, sin) tables [B, N, D] from ``rope2d_cos_sin`` in q's dtype, or
    None for no rotation. kv_mask: [B, Nk] bool, True = attendable. bf16
    takes kernel 1b (launches counted as ``flash_attn_rope_bf16``), which
    needs the tables and no kv_mask. Returns [B, H, Nq, D] in q's dtype,
    contiguous, differentiable in q, k, v. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if (qrope is None) != (krope is None):
        raise ValueError("qrope and krope go together")
    return _FlashAttn.apply(q, k, v, scale, *(qrope or (None, None)), *(krope or (None, None)), kv_mask)
