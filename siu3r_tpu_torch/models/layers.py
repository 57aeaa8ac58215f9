"""Transformer building blocks of the CroCo backbone, counterpart of
``siu3r_tpu/models/layers.py``.

Pre-norm ViT blocks with RoPE2D on q/k inside attention, LayerNorm eps 1e-6
and exact GELU. Module and parameter names are the reference's torch names, so
a reference ``state_dict`` loads as it is.

Compute dtype (``model.dtype``), as flax's ``dtype`` attribute: parameters
stay fp32; ``Linear``, ``Conv2d`` and ``ConvTranspose2d`` built with
``compute_dtype`` cast their input, weight and bias to it (flax's
``nn.Dense``/``nn.Conv`` with ``dtype=``), so under bf16 they compute and
return bf16. ``LayerNorm`` has no dtype in the JAX package: flax promotes a
bf16 input with its fp32 scale, so it returns fp32 whatever it is given.
Residual adds promote as in JAX (bf16 + bf16 stays bf16, fp32 + bf16 is
fp32). No ``torch.autocast``: its per-op lists are not flax's rules.

In bf16 the port also rounds where the JAX package's ops round: a layer's
product and its bias add are rounded each (``nn.Dense`` adds the bias after
the product), and ``gelu`` and ``softmax`` take ``jax.nn``'s steps in bf16,
each rounded. A fused bias or a GELU rounded once differs from the JAX
package in a quarter of the elements by one bf16 ulp, about as much as bf16
differs from fp32. In fp32 each is the one fused call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.ops.attention import multi_head_attention, rope_attention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# sqrt(0.5) rounded to bf16, as jax.nn.gelu casts it to the input's dtype
_SQRT_HALF_BF16 = float(torch.tensor(0.5**0.5).to(torch.bfloat16))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU; in bf16 ``jax.nn.gelu(approximate=False)``'s steps, each
    rounded: (0.5 x) erfc(-x sqrt(0.5))."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (0.5 * x) * torch.erfc(-x * _SQRT_HALF_BF16)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax; in bf16 ``jax.nn.softmax``'s steps, each rounded (the sum
    accumulated in fp32)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def _with_bias(product, x, weight, bias, dt: torch.dtype, bias_view=lambda b: b):
    """``product(x, weight, bias)`` in ``dt``; below fp32 the bias is added
    after the rounded product, as flax adds it."""
    x, weight = x.to(dt), weight.to(dt)
    if dt == torch.float32 or bias is None:
        return product(x, weight, None if bias is None else bias.to(dt))
    return product(x, weight, None) + bias_view(bias.to(dt))


class Linear(nn.Linear):
    """nn.Linear computing in ``compute_dtype`` (input, weight and bias cast)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _with_bias(F.linear, x, self.weight, self.bias, self.compute_dtype)


def _per_channel(b: torch.Tensor) -> torch.Tensor:
    return b[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``compute_dtype`` (input, weight and bias cast)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _with_bias(self._conv_forward, x, self.weight, self.bias, self.compute_dtype, _per_channel)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (no padding) computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        def product(x, w, b):
            return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding, self.groups,
                                      self.dilation)

        return _with_bias(product, x, self.weight, self.bias, self.compute_dtype, _per_channel)


class LayerNorm(nn.LayerNorm):
    """LayerNorm, eps 1e-6, with an fp32 output: flax's promotion of a bf16
    input with fp32 parameters."""

    def __init__(self, normalized_shape: int):
        super().__init__(normalized_shape, eps=1e-6)

    def forward(self, x):
        return super().forward(x.float())


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, compute_dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H] (a strided view, unit stride on the head dim)."""
    b, n, c = x.shape
    return x.view(b, n, h, c // h).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class Attention(nn.Module):
    """Self-attention with RoPE2D."""

    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = 100.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x, xpos):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [b, h, n, d] views
        if self.rope_base is not None:
            out = rope_attention(q, k, v, xpos, xpos, rope_base=self.rope_base)
        else:
            out = multi_head_attention(q, k, v)
        return self.proj(_merge_heads(out))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = 100.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = Linear(dim, dim, compute_dtype=dtype)
        self.projk = Linear(dim, dim, compute_dtype=dtype)
        self.projv = Linear(dim, dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, query, key, value, qpos, kpos, mask=None):
        h = self.num_heads
        q = _heads(self.projq(query), h)
        k = _heads(self.projk(key), h)
        v = _heads(self.projv(value), h)
        if self.rope_base is not None:
            out = rope_attention(q, k, v, qpos, kpos, rope_base=self.rope_base, mask=mask)
        else:
            out = multi_head_attention(q, k, v, mask=mask)
        return self.proj(_merge_heads(out))


class Block(nn.Module):
    """Encoder block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: Optional[float] = 100.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attention, cross-attention to the other views, MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: Optional[float] = 100.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base, dtype)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.norm_y = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, y, xpos, ypos):
        """Two-view layer: x [B, L, C] cross-attends the other view's y."""
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))

    def forward_multi(self, x, xpos, bank, bank_pos, cross_mask):
        """Multi-view layer (``siu3r_tpu/models/backbone.py:MultiViewDecoderBlock``):
        x [B, Vq, L, C] with xpos [B, Vq, L, 2], self-attention within each
        view, then every view's queries cross-attend the bank [B, Vk*L, C]
        (positions [B, Vk*L, 2]) where ``cross_mask`` [1, Vq*L, Vk*L] allows
        (the plain path: masked attention runs no kernel), then the MLP."""
        b, vq, l, c = x.shape
        xf = x.reshape(b * vq, l, c)
        xf = xf + self.attn(self.norm1(xf), xpos.reshape(b * vq, l, 2))
        q = xf.reshape(b, vq * l, c)
        y_ = self.norm_y(bank)
        q = q + self.cross_attn(self.norm2(q), y_, y_, xpos.reshape(b, vq * l, 2), bank_pos, mask=cross_mask)
        q = q + self.mlp(self.norm3(q))
        return q.reshape(b, vq, l, c)


def set_layers_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The compute dtype of every ``Linear``, ``Conv2d`` and
    ``ConvTranspose2d`` (and every other layer with a ``compute_dtype``) in
    ``module``, from the next call on; parameters untouched."""
    for mod in module.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
    return module


def token_positions(h: int, w: int, device=None) -> torch.Tensor:
    """Integer (y, x) position of each patch token, row-major: [h*w, 2]."""
    yy, xx = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


class PatchEmbed(nn.Module):
    """Conv p x p / stride p patchifier."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, compute_dtype=dtype)

    def forward(self, images):
        """images [B, H, W, 3] -> tokens [B, N, C], pos [B, N, 2]."""
        b, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by {p}")
        x = self.proj(images.permute(0, 3, 1, 2))  # [B, C, gh, gw]
        x = x.flatten(2).transpose(1, 2)
        pos = token_positions(h // p, w // p, images.device)[None].expand(b, -1, -1)
        return x, pos


def resize_nhwc(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of an NHWC map (torch interpolate semantics)."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every parameter and buffer, in module order:
    Linear/Conv/ConvTranspose weights and biases and packed attention
    projections uniform in +-1/sqrt(fan_in) (torch's default bound), norms at
    scale 1 / shift 0, embeddings and level embeddings N(0, 1), BatchNorm at
    running mean 0 / var 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                receptive = w[0][0].numel() if w.dim() > 2 else 1
                # ConvTranspose2d keeps its input channels first
                in_ch = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
                bound = (in_ch * receptive) ** -0.5
                nn.init.uniform_(w, -bound, bound, generator=generator)
                if mod.bias is not None:
                    nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
                if isinstance(mod, nn.BatchNorm2d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
                    mod.num_batches_tracked.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, generator=generator)
            for pname, p in mod.named_parameters(recurse=False):
                if pname == "level_embed":
                    nn.init.normal_(p, generator=generator)
                elif pname == "in_proj_weight":
                    bound = p.shape[1] ** -0.5
                    nn.init.uniform_(p, -bound, bound, generator=generator)
                    nn.init.uniform_(mod.in_proj_bias, -bound, bound, generator=generator)
    return model
