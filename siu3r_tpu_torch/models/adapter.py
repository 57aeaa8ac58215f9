"""CroCo ViT-Adapter, counterpart of ``siu3r_tpu/models/adapter.py``.

A conv spatial prior (SPM) gives a 1/8, 1/16, 1/32 token pyramid; at the ViT
blocks ``interaction_indexes`` a deformable-attention Extractor pulls ViT
features into it (ConvFFN with a depthwise conv after each); a transposed conv
brings the 1/8 level to 1/4; BatchNorm (eval mode) closes each level.
Convolutions run NCHW inside the modules; the public boundary is NHWC, as in
the JAX package.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.kernels.msda import msda
from siu3r_tpu_torch.ops.deformable import reference_points_for_shapes

LayerNorm6 = partial(nn.LayerNorm, eps=1e-6)
BatchNorm = partial(nn.BatchNorm2d, eps=1e-5, momentum=0.1)


def _conv_bn_relu(cin: int, cout: int, stride: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), BatchNorm(cout), nn.ReLU()]


class SpatialPriorModule(nn.Module):
    def __init__(self, inplanes: int = 64, embed_dim: int = 1024):
        super().__init__()
        self.stem = nn.Sequential(
            *_conv_bn_relu(3, inplanes, 2),
            *_conv_bn_relu(inplanes, inplanes, 1),
            *_conv_bn_relu(inplanes, inplanes, 1),
            nn.MaxPool2d(kernel_size=3, stride=2, padding=1),
        )
        self.conv2 = nn.Sequential(*_conv_bn_relu(inplanes, 2 * inplanes, 2))
        self.conv3 = nn.Sequential(*_conv_bn_relu(2 * inplanes, 4 * inplanes, 2))
        self.conv4 = nn.Sequential(*_conv_bn_relu(4 * inplanes, 4 * inplanes, 2))
        self.fc1 = nn.Conv2d(inplanes, embed_dim, 1)
        self.fc2 = nn.Conv2d(2 * inplanes, embed_dim, 1)
        self.fc3 = nn.Conv2d(4 * inplanes, embed_dim, 1)
        self.fc4 = nn.Conv2d(4 * inplanes, embed_dim, 1)

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

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_flat, spatial_shapes):
        """query [B, Lq, C]; reference_points [1 or B, Lq, n_levels, 2];
        value_flat [B, Len_in, C]; spatial_shapes [(H, W)] per level."""
        b, lq, _ = query.shape
        len_in, c = value_flat.shape[1], value_flat.shape[2]
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_flat).view(b, len_in, nh, c // nh)
        offsets = self.sampling_offsets(query).view(b, lq, nh, nl, npt, 2)
        weights = self.attention_weights(query).view(b, lq, nh, nl * npt)
        weights = torch.softmax(weights, dim=-1).view(b, lq, nh, nl, npt)
        # filled on the device: a tensor from a host list, or an assigned
        # Python number, is copied from the host and syncs the stream
        normalizer = offsets.new_empty((nl, 2))
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

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

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
    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, in_features)

    def forward(self, x, h16: int, w16: int):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h16, w16)))


class Extractor(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_points: int, cffn_ratio: float = 0.25):
        super().__init__()
        self.query_norm = LayerNorm6(dim)
        self.feat_norm = LayerNorm6(dim)
        self.attn = MSDeformAttn(dim, 1, num_heads, n_points)
        self.ffn_norm = LayerNorm6(dim)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))

    def forward(self, query, reference_points, feat, spatial_shapes, h16, w16):
        query = query + self.attn(
            self.query_norm(query), reference_points, self.feat_norm(feat), spatial_shapes
        )
        return query + self.ffn(self.ffn_norm(query), h16, w16)


class InteractionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_points: int, extra_extractor: bool):
        super().__init__()
        self.extractor = Extractor(dim, num_heads, n_points)
        self.extra_extractors = (
            nn.ModuleList([Extractor(dim, num_heads, n_points) for _ in range(2)])
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
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.interaction_indexes = tuple(interaction_indexes)
        self.add_vit_feature = add_vit_feature
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        self.spm = SpatialPriorModule(conv_inplane, embed_dim)
        n_inter = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            [
                InteractionBlock(
                    embed_dim, deform_num_heads, n_points,
                    extra_extractor=use_extra_extractor and i == n_inter - 1,
                )
                for i in range(n_inter)
            ]
        )
        self.up = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
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
