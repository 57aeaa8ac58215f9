"""EWA splat projection: 3D Gaussians -> screen-space 2D Gaussians,
counterpart of ``siu3r_tpu/render/projection.py``.

The math of the 3DGS rasterizers: camera-space transform, perspective
Jacobian with the 1.3*tan_fov frustum clamp, 2D covariance + 0.3 low-pass,
conic and 3-sigma radius, and the near/far and off-screen cull to radius 0.
Written in component form over [..., G] tensors, for any number of leading
(batch, view) dimensions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

Bound = Union[float, torch.Tensor]


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor  # [..., G, 2] pixel coords
    conic: torch.Tensor  # [..., G, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # [..., G] camera-space z
    radius: torch.Tensor  # [..., G] pixel radius (0 = culled)


def _per_view(x: Bound) -> Bound:
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def project_gaussians(
    means: torch.Tensor,
    covariances: torch.Tensor,
    viewmat: torch.Tensor,
    intrinsics_px: torch.Tensor,
    image_size: Tuple[int, int],
    near: Bound = 0.2,
    far: Bound = 1000.0,
) -> ProjectedGaussians:
    """means [..., G, 3] world; covariances [..., G, 3, 3]; viewmat [..., 4, 4]
    world-to-camera; intrinsics_px [..., 3, 3] in pixels; image_size (H, W);
    near/far floats or tensors of the views' leading shape. The leading
    dimensions of the Gaussians and of the cameras broadcast."""
    h, w = image_size
    fx = intrinsics_px[..., 0, 0, None]
    fy = intrinsics_px[..., 1, 1, None]
    cx = intrinsics_px[..., 0, 2, None]
    cy = intrinsics_px[..., 1, 2, None]
    rot = viewmat[..., :3, :3]
    trans = viewmat[..., :3, 3]

    t = means @ rot.transpose(-1, -2) + trans.unsqueeze(-2)  # [..., G, 3] camera space
    tx, ty, tz = t.unbind(-1)
    depth = tz

    tan_fovx = w / (2.0 * fx)
    tan_fovy = h / (2.0 * fy)
    # frustum clamp for the Jacobian (3DGS computeCov2D)
    txz = torch.maximum(torch.minimum(tx / tz, 1.3 * tan_fovx), -1.3 * tan_fovx) * tz
    tyz = torch.maximum(torch.minimum(ty / tz, 1.3 * tan_fovy), -1.3 * tan_fovy) * tz

    z2 = tz * tz
    # rows of M = J @ rot: m0 = (fx/tz) r0 - (fx txz/z^2) r2, m1 = (fy/tz) r1 - (fy tyz/z^2) r2
    k0 = fx / tz
    k1 = -fx * txz / z2
    k2 = fy / tz
    k3 = -fy * tyz / z2
    r = [[rot[..., i, j, None] for j in range(3)] for i in range(3)]
    m0 = [k0 * r[0][j] + k1 * r[2][j] for j in range(3)]
    m1 = [k2 * r[1][j] + k3 * r[2][j] for j in range(3)]
    sig = [[covariances[..., i, j] for j in range(3)] for i in range(3)]
    s0 = [sum(m0[i] * sig[i][j] for i in range(3)) for j in range(3)]
    s1 = [sum(m1[i] * sig[i][j] for i in range(3)) for j in range(3)]
    a = sum(s0[j] * m0[j] for j in range(3)) + 0.3
    b = sum(s0[j] * m1[j] for j in range(3))
    c = sum(s1[j] * m1[j] for j in range(3)) + 0.3

    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    # ndc2Pix: pix = ((ndc + 1) * S - 1) / 2 = f * t / z + c - 0.5
    u = fx * tx / tz + cx - 0.5
    v = fy * ty / tz + cy - 0.5
    mean2d = torch.stack([u, v], dim=-1)

    valid = (depth > _per_view(near)) & (depth < _per_view(far)) & (det > 0)
    valid &= (u + radius > 0) & (u - radius < w) & (v + radius > 0) & (v - radius < h)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=depth, radius=radius)
