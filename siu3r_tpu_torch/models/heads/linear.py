"""Linear (pixel-shuffle) prediction heads, counterpart of
``siu3r_tpu/models/heads/linear.py``: each token of the last decoder output
predicts its patch_size x patch_size patch of outputs through one linear
layer, and a depth-to-space rearrangement gives the pixel map. No model
builds them; ``head_factory`` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siu3r_tpu_torch.models.layers import Linear


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``F.pixel_shuffle`` on NHWC: [B, H, W, C*r*r] -> [B, H*r, W*r, C]
    (torch's channel order: channel c, then row offset, then column offset)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class _LinearHead(nn.Module):
    def __init__(self, in_dim: int, d_out: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(in_dim, d_out * patch_size**2)

    def forward(self, decoder_tokens: List[torch.Tensor], image_size: Tuple[int, int]) -> torch.Tensor:
        """decoder_tokens: a list whose last entry is [B, S, in_dim] ->
        [B, H, W, d_out]."""
        h, w = image_size
        tokens = decoder_tokens[-1]
        feat = self.proj(tokens)
        p = self.patch_size
        return pixel_shuffle(feat.reshape(tokens.shape[0], h // p, w // p, -1), p)


class LinearPts3d(_LinearHead):
    """Token -> patch of 3D points (and a confidence with ``has_conf``)."""

    def __init__(self, in_dim: int, patch_size: int = 16, has_conf: bool = False):
        super().__init__(in_dim, 3 + int(has_conf), patch_size)


class LinearGS(_LinearHead):
    """Token -> patch of raw Gaussian parameters (83 at SH degree 4)."""

    def __init__(self, in_dim: int, patch_size: int = 16, d_out: int = 83):
        super().__init__(in_dim, d_out, patch_size)
