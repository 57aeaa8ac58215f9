"""Multi-scale deformable attention kernel wrapper: ``csrc/msda.cu`` and its
plain version (``ops/deformable.multi_scale_deformable_attention``).

Replaces the TPU kernel ``_level_kernel`` of ``siu3r_tpu/ops/msda_pallas.py``;
launches are counted as ``msda``, and by the kernel that ran in
``_build.variant_counts`` (``msda.staged`` where the head's value slice fits
shared memory, as on the main path; ``msda.global`` otherwise).

``msda`` is differentiable (a ``torch.autograd.Function``). Its forward is
the kernel on CUDA tensors and the plain version on CPU tensors. Its
backward recomputes the plain version and takes its VJP, the counterpart of
the JAX package's backward (``siu3r_tpu/ops/msda_pallas.py``, whose ``_bwd``
differentiates ``_msda_matmul``, the same function): the TPU kernel is
forward-only and its gradient is XLA code, so there is no TPU backward kernel
to port here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from siu3r_tpu_torch.kernels import _build
from siu3r_tpu_torch.ops.deformable import multi_scale_deformable_attention

KERNEL_HEAD_DIMS = (32, 64)
MAX_LEVELS = 8
# the kernel that ran, as siu3r_msda_fwd reports it: the head's value slice
# staged in shared memory (where it fits), or taps read from global memory
VARIANTS = {1: "msda.staged", 2: "msda.global"}

msda_plain = multi_scale_deformable_attention


def _check(value, spatial_shapes, loc, aw) -> None:
    if value.dim() != 4:
        raise ValueError("value must be [B, Len_in, H, D]")
    b, len_in, h, d = value.shape
    n_levels = len(spatial_shapes)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"msda kernel takes 1..{MAX_LEVELS} levels, got {n_levels}")
    if sum(hh * ww for hh, ww in spatial_shapes) != len_in:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not cover Len_in={len_in}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"msda kernel takes head dim {KERNEL_HEAD_DIMS}, got {d}")
    if loc.dim() != 6 or loc.shape[0] != b or loc.shape[2:4] != (h, n_levels) or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations {tuple(loc.shape)} is not [B, Lq, H, L, P, 2]")
    if aw.shape != loc.shape[:5]:
        raise ValueError(f"attention_weights {tuple(aw.shape)} is not [B, Lq, H, L, P]")
    for name, t in (("value", value), ("sampling_locations", loc), ("attention_weights", aw)):
        if t.device != value.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 on {value.device}")
    # the kernel reads value rows as float4 and a point's (x, y) as one float2
    if value.data_ptr() % 16 or loc.data_ptr() % 8:
        raise ValueError("value must start on 16 bytes and sampling_locations on 8")


def _msda_forward(value, spatial_shapes, sampling_locations, attention_weights) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"msda runs on cuda or cpu tensors, got {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    lib = _build.load_library()
    b, len_in, h, d = value.shape
    lq, n_points = sampling_locations.shape[1], sampling_locations.shape[4]
    n_levels = len(spatial_shapes)
    hw = (ctypes.c_int * (2 * n_levels))(*[int(x) for s in spatial_shapes for x in s])
    starts, acc = [], 0
    for hh, ww in spatial_shapes:
        starts.append(acc)
        acc += hh * ww
    start = (ctypes.c_int * n_levels)(*starts)
    out = torch.empty((b, lq, h * d), dtype=torch.float32, device=value.device)
    variant = ctypes.c_int(0)
    err = lib.siu3r_msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
        out.data_ptr(), hw, start, n_levels, b, len_in, lq, h, d, n_points, ctypes.byref(variant),
        _build.stream_handle(value.device),
    )
    _build.check_launch(err, "msda")
    _build.launch_counts["msda"] += 1
    _build.variant_counts[VARIANTS[variant.value]] += 1
    return out


class _MSDA(torch.autograd.Function):
    """The kernel's forward with the plain version's VJP as its backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return _msda_forward(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = msda_plain(inputs[0], ctx.spatial_shapes, inputs[1], inputs[2])
            dvalue, dloc, dweights = torch.autograd.grad(out, inputs, grad)
        return dvalue, None, dloc, dweights


def msda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value [B, Len_in, H, D]; sampling_locations [B, Lq, H, L, P, 2] in
    [0, 1] as (x, y); attention_weights [B, Lq, H, L, P]. Returns
    [B, Lq, H*D] in value's dtype, differentiable in all three. CPU tensors
    take the plain version; CUDA tensors launch the kernel.

    The kernel is fp32. A bf16 value (the adapter under ``model.dtype:
    bfloat16``) is sampled in fp32, as the JAX package's ``_msda_matmul``
    samples it: the three inputs are cast to fp32 here, and the output back
    to value's dtype."""
    out = _MSDA.apply(value.float(), tuple(spatial_shapes), sampling_locations.float(), attention_weights.float())
    return out.to(value.dtype)
