"""DPT prediction heads, counterpart of ``siu3r_tpu/models/heads/dpt.py``.

Reassemble (per-hook 1x1 conv to the pyramid dims plus up/down sampling),
four RefineNet fusion blocks, then either the pts3d regression head or the
Gaussian-parameter head with a conv skip from the RGB image; or the
multi-resolution Gaussian-parameter head on the same trunk. Module names are
the reference's (``dpt.act_postprocess``, ``dpt.scratch``, ``dpt.head``,
``dpt.input_merger``), and the multi-resolution head's own parts carry the JAX
package's names (``dpt.input_merger_ds4``, ``dpt.head_ds4_conv1``, ...).
Convolutions run NCHW; tokens come in as [B, N, C] and the outputs leave NHWC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """The deepest block (``refinenet4``) takes no skip input and, as in the
    JAX package, has no ``resConfUnit1``; the reference's unused weights for
    it are dropped when a checkpoint loads. ``skip_upsample`` leaves out the
    2x upsampling (the multi-resolution head's blocks)."""

    def __init__(self, features: int, with_skip: bool = True, skip_upsample: bool = False):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)
        self.skip_upsample = skip_upsample

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if not self.skip_upsample:
            out = _up2(out)
        return self.out_conv(out)


class _Scratch(nn.Module):
    def __init__(self, layer_dims: Sequence[int], feature_dim: int, skip_upsample: bool = False):
        super().__init__()
        for i, d in enumerate(layer_dims, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(d, feature_dim, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}",
                    FeatureFusionBlock(feature_dim, with_skip=i < 4, skip_upsample=skip_upsample))


class _Trunk(nn.Module):
    """Reassemble (per-hook 1x1 convolution to the pyramid dims, then 4x and
    2x up, as is, and 2x down) and the fusion blocks' scratch."""

    def __init__(self, token_dims, layer_dims, feature_dim, skip_upsample: bool = False):
        super().__init__()
        ld = layer_dims
        self.act_postprocess = nn.ModuleList(
            [
                nn.Sequential(nn.Conv2d(token_dims[0], ld[0], 1), nn.ConvTranspose2d(ld[0], ld[0], 4, 4)),
                nn.Sequential(nn.Conv2d(token_dims[1], ld[1], 1), nn.ConvTranspose2d(ld[1], ld[1], 2, 2)),
                nn.Sequential(nn.Conv2d(token_dims[2], ld[2], 1)),
                nn.Sequential(nn.Conv2d(token_dims[3], ld[3], 1), nn.Conv2d(ld[3], ld[3], 3, 2, 1)),
            ]
        )
        self.scratch = _Scratch(layer_dims, feature_dim, skip_upsample)

    def reassemble(self, hooked_tokens: List[torch.Tensor], nh: int, nw: int) -> List[torch.Tensor]:
        """4 x [B, nh*nw, C_i] tokens -> the 4 pyramid levels (NCHW) at 4x,
        2x, 1x and 1/2x the token grid, feature_dim channels each."""
        layers = []
        for idx, tok in enumerate(hooked_tokens):
            b, _, c = tok.shape
            x = tok.transpose(1, 2).reshape(b, c, nh, nw)
            x = self.act_postprocess[idx](x)
            layers.append(getattr(self.scratch, f"layer{idx + 1}_rn")(x))
        return layers


class _DPT(_Trunk):
    def __init__(self, num_channels, token_dims, layer_dims, feature_dim, last_dim, head_type):
        super().__init__(token_dims, layer_dims, feature_dim)
        if head_type == "regression":
            self.head = nn.Sequential(
                nn.Conv2d(feature_dim, feature_dim // 2, 3, 1, 1),
                nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                nn.Conv2d(feature_dim // 2, last_dim, 3, 1, 1),
                nn.ReLU(),
                nn.Conv2d(last_dim, num_channels, 1),
            )
        elif head_type == "gs_params":
            self.input_merger = nn.Sequential(nn.Conv2d(3, feature_dim, 7, 1, 3), nn.ReLU())
            # the reference's indices: conv at 0, conv at 4
            self.head = nn.Sequential(
                nn.Conv2d(feature_dim, feature_dim, 3, 1, 1, bias=False),
                nn.ReLU(),
                nn.Identity(),
                nn.Identity(),
                nn.Conv2d(feature_dim, num_channels, 1),
            )
        else:
            raise ValueError(head_type)


class DPTHead(nn.Module):
    """forward(hooked tokens: 4 x [B, N, C_i], image [B, H, W, 3] or None,
    image_size) -> [B, H, W, num_channels] raw output (NHWC)."""

    def __init__(
        self,
        num_channels: int,
        token_dims: Sequence[int] = (1024, 768, 768, 768),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
        last_dim: int = 128,
        head_type: str = "regression",
        patch_size: int = 16,
    ):
        super().__init__()
        self.head_type = head_type
        self.patch_size = patch_size
        self.dpt = _DPT(num_channels, token_dims, layer_dims, feature_dim, last_dim, head_type)

    def forward(
        self, hooked_tokens: List[torch.Tensor], image: Optional[torch.Tensor],
        image_size: Tuple[int, int],
    ) -> torch.Tensor:
        h, w = image_size
        dpt = self.dpt
        layers = dpt.reassemble(hooked_tokens, h // self.patch_size, w // self.patch_size)

        s = dpt.scratch
        path4 = s.refinenet4(layers[3])
        path4 = path4[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path3 = s.refinenet3(path4, layers[2])
        path2 = s.refinenet2(path3, layers[1])
        path1 = s.refinenet1(path2, layers[0])

        if self.head_type == "regression":
            out = dpt.head(path1)
        else:
            x = _up2(path1) + dpt.input_merger(image.permute(0, 3, 1, 2))
            out = dpt.head(x)
        return out.permute(0, 2, 3, 1)


MULTI_RES_SCALES = (4, 8, 16, 32)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class _MultiResDPT(_Trunk):
    def __init__(self, num_channels, token_dims, layer_dims, feature_dim):
        super().__init__(token_dims, layer_dims, feature_dim, skip_upsample=True)
        for ds in MULTI_RES_SCALES:
            setattr(self, f"input_merger_ds{ds}", nn.Conv2d(3, feature_dim, 7, 1, 3))
            setattr(self, f"head_ds{ds}_conv1", nn.Conv2d(feature_dim, feature_dim, 3, 1, 1, bias=False))
            setattr(self, f"head_ds{ds}_conv2", nn.Conv2d(feature_dim, num_channels, 1))


class MultiResDPTGSHead(nn.Module):
    """The multi-resolution Gaussian-parameter head (counterpart of
    ``siu3r_tpu/models/heads/dpt.py:MultiResDPTGSHead``): the DPT trunk with
    fusion blocks that do not upsample, each deeper path resized to the next
    level (align_corners), and at each of 1/4, 1/8, 1/16 and 1/32 of the
    image its own conv skip from the resized RGB image and its own
    prediction head. No model builds it; ``head_factory`` does.

    forward(hooked tokens: 4 x [B, N, C_i], image [B, H, W, 3], image_size)
    -> raw parameters [B, H/s, W/s, num_channels] for s = 4, 8, 16, 32
    (NHWC)."""

    def __init__(
        self,
        num_channels: int,
        token_dims: Sequence[int] = (1024, 768, 768, 768),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
        patch_size: int = 16,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.dpt = _MultiResDPT(num_channels, token_dims, layer_dims, feature_dim)

    def forward(
        self, hooked_tokens: List[torch.Tensor], image: torch.Tensor, image_size: Tuple[int, int],
    ) -> List[torch.Tensor]:
        h, w = image_size
        dpt = self.dpt
        layers = dpt.reassemble(hooked_tokens, h // self.patch_size, w // self.patch_size)
        s = dpt.scratch
        out = s.refinenet4(layers[3])
        paths = [out]  # 1/32, then 1/16, 1/8, 1/4
        for i in (2, 1, 0):
            out = getattr(s, f"refinenet{i + 1}")(_resize(out, layers[i].shape[2:]), layers[i])
            paths.append(out)
        img = image.permute(0, 3, 1, 2)
        outs = []
        for path, ds in zip(reversed(paths), MULTI_RES_SCALES):
            skip = F.relu(getattr(dpt, f"input_merger_ds{ds}")(_resize(img, (h // ds, w // ds))))
            x = F.relu(getattr(dpt, f"head_ds{ds}_conv1")(path + skip))
            outs.append(getattr(dpt, f"head_ds{ds}_conv2")(x).permute(0, 2, 3, 1))
        return outs


def postprocess_pts3d(raw: torch.Tensor) -> torch.Tensor:
    """'exp' depth mode: pts = dir(xyz) * expm1(||xyz||)."""
    d = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    return raw / d.clamp(min=1e-8) * torch.expm1(d)


def dpt_hooks(dec_depth: int) -> list[int]:
    """[0, l/2, 3l/4, l] into the (dec_depth+1)-entry decoder list."""
    return [0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth]
