"""CroCo ViT-Adapter, counterpart of ``siu3r_tpu/models/adapter.py``.

A conv spatial prior (SPM) gives a 1/8, 1/16, 1/32 token pyramid; at the ViT
blocks ``interaction_indexes`` a deformable-attention Extractor pulls ViT
features into it (ConvFFN with a depthwise conv after each); a transposed conv
brings the 1/8 level to 1/4; BatchNorm closes each level.
Convolutions run NCHW inside the modules; the public boundary is NHWC, as in
the JAX package.

BatchNorm follows flax's ``nn.BatchNorm`` (the JAX package's): in eval mode
it normalises with the running statistics; in train mode (``module.train()``)
with the batch's mean and *biased* variance E[x^2] - E[x]^2 (clipped at 0),
differentiated through, and it updates the running statistics with the same
biased variance at momentum 0.1 (``nn.BatchNorm2d`` would store the unbiased
one). Either way in flax's arithmetic, (x - mean) * (rsqrt(var + eps) *
scale) + bias in fp32: under bf16 its output is rounded to bf16 by the next
convolution, and another fp32 rounding order moves some of those roundings.
The statistics are those of this device's batch, as the JAX package's
single-device step computes them (the reference's SyncBN waits for the
data-parallel slice).

``dtype`` is the compute dtype (the JAX modules' ``dtype``) of the SPM
convolutions and its ``fc1..4``, the deformable attention's projections, the
ConvFFN (its depthwise conv included) and the ``up`` transposed conv. The
BatchNorms compute in fp32 and return fp32 (flax's ``nn.BatchNorm`` without
a dtype), as do the LayerNorms; the softmax of bf16 attention logits gives
bf16 weights, and the deformable sampling runs in fp32 (``kernels/msda.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.kernels.msda import msda
from siu3r_tpu_torch.models.layers import Conv2d, ConvTranspose2d, LayerNorm, Linear, gelu, softmax
from siu3r_tpu_torch.ops.deformable import reference_points_for_shapes


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over NCHW with flax's train-mode statistics (see the
    module docstring); the parameter and buffer names are torch's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _conv_bn_relu(cin: int, cout: int, stride: int, dtype: torch.dtype) -> List[nn.Module]:
    return [Conv2d(cin, cout, 3, stride, 1, bias=False, compute_dtype=dtype), BatchNorm(cout), nn.ReLU()]


class SpatialPriorModule(nn.Module):
    def __init__(self, inplanes: int = 64, embed_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = nn.Sequential(
            *_conv_bn_relu(3, inplanes, 2, dtype),
            *_conv_bn_relu(inplanes, inplanes, 1, dtype),
            *_conv_bn_relu(inplanes, inplanes, 1, dtype),
            nn.MaxPool2d(kernel_size=3, stride=2, padding=1),
        )
        self.conv2 = nn.Sequential(*_conv_bn_relu(inplanes, 2 * inplanes, 2, dtype))
        self.conv3 = nn.Sequential(*_conv_bn_relu(2 * inplanes, 4 * inplanes, 2, dtype))
        self.conv4 = nn.Sequential(*_conv_bn_relu(4 * inplanes, 4 * inplanes, 2, dtype))
        self.fc1 = Conv2d(inplanes, embed_dim, 1, compute_dtype=dtype)
        self.fc2 = Conv2d(2 * inplanes, embed_dim, 1, compute_dtype=dtype)
        self.fc3 = Conv2d(4 * inplanes, embed_dim, 1, compute_dtype=dtype)
        self.fc4 = Conv2d(4 * inplanes, embed_dim, 1, compute_dtype=dtype)

    def forward(self, x):
        """x [B, 3, H, W] -> four NCHW maps at 1/4, 1/8, 1/16, 1/32."""
        c1 = self.stem(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module; the sampling runs in the
    ``msda`` kernel."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2, compute_dtype=dtype)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points, compute_dtype=dtype)
        self.value_proj = Linear(d_model, d_model, compute_dtype=dtype)
        self.output_proj = Linear(d_model, d_model, compute_dtype=dtype)

    def forward(self, query, reference_points, value_flat, spatial_shapes):
        """query [B, Lq, C]; reference_points [1 or B, Lq, n_levels, 2];
        value_flat [B, Len_in, C]; spatial_shapes [(H, W)] per level."""
        b, lq, _ = query.shape
        len_in, c = value_flat.shape[1], value_flat.shape[2]
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_flat).view(b, len_in, nh, c // nh)
        offsets = self.sampling_offsets(query).view(b, lq, nh, nl, npt, 2)
        weights = self.attention_weights(query).view(b, lq, nh, nl * npt)
        weights = softmax(weights, dim=-1).view(b, lq, nh, nl, npt)
        # filled on the device: a tensor from a host list, or an assigned
        # Python number, is copied from the host and syncs the stream. fp32,
        # as the JAX module's: bf16 offsets divide into fp32 locations
        normalizer = offsets.new_empty((nl, 2), dtype=torch.float32)
        for lvl, (h, w) in enumerate(spatial_shapes):
            normalizer[lvl, 0].fill_(w)
            normalizer[lvl, 1].fill_(h)
        locations = (
            reference_points[:, :, None, :, None, :]
            + offsets / normalizer[None, None, None, :, None, :]
        )
        out = msda(value, spatial_shapes, locations, weights)
        return self.output_proj(out)


class DWConv(nn.Module):
    """Depthwise 3x3 over the three pyramid sub-resolutions."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim, compute_dtype=dtype)

    def forward(self, x, h16: int, w16: int):
        b, n, c = x.shape
        n1 = n // 21
        parts = []
        for lo, hi, hh, ww in (
            (0, 16 * n1, 2 * h16, 2 * w16),
            (16 * n1, 20 * n1, h16, w16),
            (20 * n1, n, h16 // 2, w16 // 2),
        ):
            t = x[:, lo:hi].transpose(1, 2).reshape(b, c, hh, ww)
            parts.append(self.dwconv(t).flatten(2).transpose(1, 2))
        return torch.cat(parts, dim=1)


class ConvFFN(nn.Module):
    def __init__(self, in_features: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden, compute_dtype=dtype)
        self.dwconv = DWConv(hidden, dtype)
        self.fc2 = Linear(hidden, in_features, compute_dtype=dtype)

    def forward(self, x, h16: int, w16: int):
        return self.fc2(gelu(self.dwconv(self.fc1(x), h16, w16)))


class Extractor(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_points: int, cffn_ratio: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query_norm = LayerNorm(dim)
        self.feat_norm = LayerNorm(dim)
        self.attn = MSDeformAttn(dim, 1, num_heads, n_points, dtype)
        self.ffn_norm = LayerNorm(dim)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio), dtype)

    def forward(self, query, reference_points, feat, spatial_shapes, h16, w16):
        query = query + self.attn(
            self.query_norm(query), reference_points, self.feat_norm(feat), spatial_shapes
        )
        return query + self.ffn(self.ffn_norm(query), h16, w16)


class InteractionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_points: int, extra_extractor: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.extractor = Extractor(dim, num_heads, n_points, dtype=dtype)
        self.extra_extractors = (
            nn.ModuleList([Extractor(dim, num_heads, n_points, dtype=dtype) for _ in range(2)])
            if extra_extractor else None
        )

    def forward(self, x, c, ref_points, spatial_shapes, h16, w16):
        c = self.extractor(c, ref_points, x, spatial_shapes, h16, w16)
        for ex in self.extra_extractors or ():
            c = ex(c, ref_points, x, spatial_shapes, h16, w16)
        return c


class CroCoViTAdapter(nn.Module):
    def __init__(
        self,
        embed_dim: int = 1024,
        patch_size: int = 16,
        conv_inplane: int = 64,
        n_points: int = 4,
        deform_num_heads: int = 16,
        interaction_indexes: Sequence[int] = (5, 11, 17, 23),
        add_vit_feature: bool = True,
        use_extra_extractor: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.interaction_indexes = tuple(interaction_indexes)
        self.add_vit_feature = add_vit_feature
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        self.spm = SpatialPriorModule(conv_inplane, embed_dim, dtype)
        n_inter = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            [
                InteractionBlock(
                    embed_dim, deform_num_heads, n_points,
                    extra_extractor=use_extra_extractor and i == n_inter - 1, dtype=dtype,
                )
                for i in range(n_inter)
            ]
        )
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, 2, compute_dtype=dtype)
        self.norm1 = BatchNorm(embed_dim)
        self.norm2 = BatchNorm(embed_dim)
        self.norm3 = BatchNorm(embed_dim)
        self.norm4 = BatchNorm(embed_dim)

    def forward(self, image: torch.Tensor, all_feat: List[torch.Tensor]) -> List[torch.Tensor]:
        """image [B, H, W, 3]; all_feat: per ViT block [B, N, C] (intrinsic
        token stripped). Returns 4 NHWC maps at 1/4, 1/8, 1/16, 1/32."""
        b, h, w, _ = image.shape
        ed = self.embed_dim
        h16, w16 = h // self.patch_size, w // self.patch_size
        shapes_query = [(h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32)]
        shapes_feat = [(h16, w16)]
        ref_query = reference_points_for_shapes(shapes_query, image.device)

        c1, c2, c3, c4 = self.spm(image.permute(0, 3, 1, 2))
        tok = lambda t, i: t.flatten(2).transpose(1, 2) + self.level_embed[i]
        c = torch.cat([tok(c2, 0), tok(c3, 1), tok(c4, 2)], dim=1)
        n2, n3 = c2.shape[2] * c2.shape[3], c3.shape[2] * c3.shape[3]

        outs = []
        for blk, idx in zip(self.interactions, self.interaction_indexes):
            x = all_feat[idx]
            c = blk(x, c, ref_query, shapes_feat, h16, w16)
            outs.append(x.transpose(1, 2).reshape(b, ed, h16, w16))

        nchw = lambda t, hh, ww: t.transpose(1, 2).reshape(b, ed, hh, ww)
        c2o = nchw(c[:, :n2], h // 8, w // 8)
        c3o = nchw(c[:, n2 : n2 + n3], h16, w16)
        c4o = nchw(c[:, n2 + n3 :], h // 32, w // 32)
        c1o = self.up(c2o) + c1

        if self.add_vit_feature:
            x1, x2, x3, x4 = outs
            rs = lambda t, hh, ww: F.interpolate(t, size=(hh, ww), mode="bilinear", align_corners=False)
            c1o = c1o + rs(x1, h // 4, w // 4)
            c2o = c2o + rs(x2, h // 8, w // 8)
            c3o = c3o + x3
            c4o = c4o + rs(x4, h // 32, w // 32)

        f = [self.norm1(c1o), self.norm2(c2o), self.norm3(c3o), self.norm4(c4o)]
        return [t.permute(0, 2, 3, 1) for t in f]
