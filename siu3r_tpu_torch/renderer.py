"""Gaussian scene renderer: counterpart of ``siu3r_tpu/renderer.py``.

  * the scene is rescaled by 1/near = 10 before rendering (translations,
    means, covariances; near becomes 1, far 1000), and depth is returned in
    the scaled space, as the reference does;
  * ``render_gaussians``: SH-shaded RGB, expected depth and alpha per target
    view, colour clamped to [0, 1];
  * ``render_qc_factored`` / ``render_color_and_qc``: novel-view query-class
    confidences from qc[g, s, c] = class_prob[s, c] * mask_prob[s, g]: only
    the S mask channels are splatted and the class term is multiplied in
    after, which is exact since it is constant per slot.

Every batch item's views are flattened into one batch of views, so one render
is one binning launch and one raster launch per channel set. The
camera inverse is ``torch.linalg.inv_ex``, which does not wait for the device.

The renders are differentiable in the Gaussians' means, covariances,
opacities and harmonics (and the pose deltas). The compositing's backward is
a kernel on CUDA (``raster_bwd``, the port of the TPU's
``_raster_bwd_kernel``); the projection, the SH colours and the scene
rescale are plain tensor code that autograd differentiates, as XLA does in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from siu3r_tpu_torch.gaussians import Gaussians
from siu3r_tpu_torch.ops.sh import eval_sh_colors
from siu3r_tpu_torch.render.rasterizer import rasterize, rasterize_multi

NEAR = 0.1
FAR = 100.0
SCALE_FACTOR = 1.0 / NEAR


@dataclasses.dataclass
class RenderOutput:
    color: Optional[torch.Tensor] = None  # [B, V, H, W, 3]
    depth: Optional[torch.Tensor] = None  # [B, V, H, W] (scaled space)
    alpha: Optional[torch.Tensor] = None  # [B, V, H, W]
    qc_logits: Optional[torch.Tensor] = None  # [B, V, Q_lift, C+1, H, W]


def apply_pose_delta(
    viewmats: torch.Tensor,
    cam_rot_delta: Optional[torch.Tensor],
    cam_trans_delta: Optional[torch.Tensor],
) -> torch.Tensor:
    """Camera-pose perturbation W2C' = [R exp([theta]x) | t + rho], the
    rasterizer's theta/rho inputs of the reference. viewmats [..., 4, 4]
    world-to-camera; deltas [..., 3]."""
    if cam_rot_delta is None and cam_trans_delta is None:
        return viewmats
    r = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    if cam_rot_delta is not None:
        th = cam_rot_delta
        zeros = torch.zeros_like(th[..., 0])
        k = torch.stack(
            [
                torch.stack([zeros, -th[..., 2], th[..., 1]], dim=-1),
                torch.stack([th[..., 2], zeros, -th[..., 0]], dim=-1),
                torch.stack([-th[..., 1], th[..., 0], zeros], dim=-1),
            ],
            dim=-2,
        )
        # Rodrigues with Taylor guards at theta = 0
        sq = (th * th).sum(-1)[..., None, None]
        small = sq < 1e-12
        a = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
        c1 = torch.where(small, 1.0 - sq / 6.0, torch.sin(a) / a)
        c2 = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(a)) / (a * a))
        eye = torch.eye(3, dtype=k.dtype, device=k.device).expand_as(k)
        r = r @ (eye + c1 * k + c2 * (k @ k))
    if cam_trans_delta is not None:
        t = t + cam_trans_delta
    top = torch.cat([r, t.unsqueeze(-1)], dim=-1)
    return torch.cat([top, viewmats[..., 3:, :]], dim=-2)


def _scaled_cameras(gaussians: Gaussians, extrinsics, intrinsics, image_shape):
    """The 1/near scene rescale and the pixel intrinsics (reference
    gaussian_renderer.py:42-48). Returns (ext, means, covs, intr_px, viewmats)."""
    h, w = image_shape
    ext = extrinsics.clone()
    ext[..., :3, 3] *= SCALE_FACTOR
    means = gaussians.means * SCALE_FACTOR
    covs = gaussians.covariances * (SCALE_FACTOR**2)
    intr_px = intrinsics.clone()
    intr_px[..., 0, :] *= w
    intr_px[..., 1, :] *= h
    viewmats = torch.linalg.inv_ex(ext).inverse
    return ext, means, covs, intr_px, viewmats


def _sh_degree(harmonics: torch.Tensor) -> int:
    return int(round(harmonics.shape[-1] ** 0.5)) - 1


def _view_colors(means: torch.Tensor, harmonics: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """SH colour of each gaussian as seen from each camera: means [B, G, 3],
    harmonics [B, G, 3, d_sh], ext [B, V, 4, 4] camera-to-world -> [B, V, G, 3]."""
    campos = ext[..., :3, 3]
    dirs = means.unsqueeze(-3) - campos.unsqueeze(-2)
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    return eval_sh_colors(harmonics.unsqueeze(-4), dirs, _sh_degree(harmonics))


def _background(background, like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros(3) if background is None else background


def render_gaussians(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: Tuple[int, int],
    background: Optional[torch.Tensor] = None,
    max_per_tile: int = 4096,
    cam_rot_delta: Optional[torch.Tensor] = None,
    cam_trans_delta: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """gaussians batched [B, G, ...]; extrinsics [B, V, 4, 4] camera-to-world;
    intrinsics [B, V, 3, 3] normalised; the pose deltas [B, V, 3] perturb the
    cameras (rho in the scaled scene space, as the reference)."""
    ext, means, covs, intr_px, viewmats = _scaled_cameras(gaussians, extrinsics, intrinsics, image_shape)
    viewmats = apply_pose_delta(viewmats, cam_rot_delta, cam_trans_delta)
    colors = _view_colors(means, gaussians.harmonics, ext)
    color, depth, alpha = rasterize(
        means, covs, gaussians.opacities, colors, viewmats, intr_px, image_shape,
        near=1.0, far=FAR * SCALE_FACTOR, background=_background(background, means),
        max_per_tile=max_per_tile,
    )
    return RenderOutput(color=color.clamp(0.0, 1.0), depth=depth, alpha=alpha)


def render_gaussians_orthographic(
    extrinsics: torch.Tensor,
    width: torch.Tensor,
    height: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    gaussians: Gaussians,
    image_shape: Tuple[int, int],
    background: Optional[torch.Tensor] = None,
    fov_degrees: float = 0.1,
    max_per_tile: int = 4096,
) -> RenderOutput:
    """Pseudo-orthographic rendering (reference render_cuda_orthographic):
    each camera [B, V, 4, 4] (camera-to-world) is pulled back along its axis
    by d = (width / 2) / tan(fov_x / 2) with a tiny field of view; width,
    height, near, far are [B, V] in world units. No 1/near rescale."""
    h, w = image_shape
    tan_fov_x = float(np.tan(np.float32(0.5) * np.deg2rad(np.float32(fov_degrees))))
    dist = (0.5 * width) / tan_fov_x  # [B, V]
    tan_fov_y = 0.5 * height / dist
    near = near + dist
    far = far + dist
    move = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device).repeat(*dist.shape, 1, 1)
    move[..., 2, 3] = -dist
    ext = extrinsics @ move

    fy = 0.5 * h / tan_fov_y  # [B, V]
    zero, one = torch.zeros_like(fy), torch.ones_like(fy)
    intr_px = torch.stack(
        [
            torch.stack([torch.full_like(fy, 0.5 * w / tan_fov_x), zero, 0.5 * w * one], -1),
            torch.stack([zero, fy, 0.5 * h * one], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )
    viewmats = torch.linalg.inv_ex(ext).inverse
    colors = _view_colors(gaussians.means, gaussians.harmonics, ext)
    color, depth, alpha = rasterize(
        gaussians.means, gaussians.covariances, gaussians.opacities, colors, viewmats, intr_px,
        image_shape, near=near, far=far, background=_background(background, ext),
        max_per_tile=max_per_tile,
    )
    return RenderOutput(color=color.clamp(0.0, 1.0), depth=depth, alpha=alpha)


def render_color_and_qc(
    gaussians: Gaussians,
    qc_class_probs: torch.Tensor,
    qc_mask_cols: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: Tuple[int, int],
    background: Optional[torch.Tensor] = None,
    max_per_tile: int = 4096,
) -> Tuple[RenderOutput, torch.Tensor]:
    """The eval render: SH colour, depth and the factored query-class
    channels composited over one shared projection and binning.
    qc_class_probs [B, S, C+1]; qc_mask_cols [B, G, S]. Returns
    (RenderOutput(color, depth, alpha), qc [B, V, S, C+1, H, W]), equal to
    ``render_gaussians`` + ``render_qc_factored``."""
    ext, means, covs, intr_px, viewmats = _scaled_cameras(gaussians, extrinsics, intrinsics, image_shape)
    sh_colors = _view_colors(means, gaussians.harmonics, ext)
    (color, qc_ch), depth, alpha = rasterize_multi(
        means, covs, gaussians.opacities, [sh_colors, qc_mask_cols], viewmats, intr_px,
        image_shape, near=1.0, far=FAR * SCALE_FACTOR, max_per_tile=max_per_tile,
    )
    color = color + (1.0 - alpha).unsqueeze(-1) * _background(background, color)
    qc = torch.einsum("bvhws,bsc->bvschw", qc_ch, qc_class_probs)
    return RenderOutput(color=color.clamp(0.0, 1.0), depth=depth, alpha=alpha), qc


def render_qc_factored(
    gaussians: Gaussians,
    qc_class_probs: torch.Tensor,
    qc_mask_cols: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: Tuple[int, int],
    max_per_tile: int = 4096,
) -> torch.Tensor:
    """Novel-view query-class confidences from the factored inputs:
    qc_class_probs [B, S, C+1], qc_mask_cols [B, G, S] -> [B, V, S, C+1, H, W]."""
    _, means, covs, intr_px, viewmats = _scaled_cameras(gaussians, extrinsics, intrinsics, image_shape)
    rendered, _, _ = rasterize(
        means, covs, gaussians.opacities, qc_mask_cols, viewmats, intr_px, image_shape,
        near=1.0, far=FAR * SCALE_FACTOR, max_per_tile=max_per_tile,
    )
    return torch.einsum("bvhws,bsc->bvschw", rendered, qc_class_probs)
