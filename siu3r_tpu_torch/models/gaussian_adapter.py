"""Raw head outputs -> constrained Gaussian parameters, counterpart of
``siu3r_tpu/models/gaussian_adapter.py``: sigmoid opacity,
scale = min(0.001 * softplus(s), 0.3), normalised quaternion for the
covariance, SH bands >= 1 damped by 0.1 * 0.25**degree; the means are the
pts3d head's point map."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from siu3r_tpu_torch.gaussians import Gaussians, build_covariance


def sh_degree_mask(sh_degree: int, device=None) -> torch.Tensor:
    mask = torch.ones((sh_degree + 1) ** 2, dtype=torch.float32, device=device)
    for degree in range(1, sh_degree + 1):
        # fill_ takes the value as a kernel argument; an assigned Python
        # number would be copied from the host and sync the stream
        mask[degree**2 : (degree + 1) ** 2].fill_(0.1 * 0.25**degree)
    return mask


def adapt_gaussians(
    means: torch.Tensor, raw: torch.Tensor, sh_degree: int = 4, eps: float = 1e-8
) -> Gaussians:
    """means [..., 3]; raw [..., 1 + 3 + 4 + 3*d_sh] (opacity, scale, rot, sh)."""
    d_sh = (sh_degree + 1) ** 2
    opacities = torch.sigmoid(raw[..., 0])
    scales = torch.clamp(0.001 * F.softplus(raw[..., 1:4]), max=0.3)
    rotations = raw[..., 4:8]
    rot_norm = rotations / (torch.linalg.vector_norm(rotations, dim=-1, keepdim=True) + eps)
    sh = raw[..., 8 : 8 + 3 * d_sh]
    sh = sh.reshape(sh.shape[:-1] + (3, d_sh)) * sh_degree_mask(sh_degree, raw.device)
    return Gaussians(
        means=means,
        covariances=build_covariance(scales, rot_norm),
        harmonics=sh,
        opacities=opacities,
        scales=scales,
        rotations=rotations,
    )
