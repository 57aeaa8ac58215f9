"""Gaussians container: pixel-aligned 3D Gaussian fields as torch tensors.

Counterpart of ``siu3r_tpu/gaussians.py``: the same fields and shapes, the
same quaternion convention (xyzw) and the same covariance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """Batched Gaussian fields.

    Shapes (after flattening views): ``means [B, G, 3]``,
    ``covariances [B, G, 3, 3]``, ``harmonics [B, G, 3, d_sh]``,
    ``opacities [B, G]``, ``scales [B, G, 3]``, ``rotations [B, G, 4]``
    (xyzw). The panoptic post-process attaches ``semantic_labels`` /
    ``instance_labels`` ``[B, G]`` int32 and ``seg_query_class_logits``
    ``[B, G, Q, C+1]`` (padded to ``max_lift_queries`` slots), with
    ``seg_query_scores`` / ``seg_query_valid`` ``[B, Q]``.
    """

    means: torch.Tensor
    covariances: torch.Tensor
    harmonics: torch.Tensor
    opacities: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    semantic_labels: Optional[torch.Tensor] = None
    instance_labels: Optional[torch.Tensor] = None
    seg_query_class_logits: Optional[torch.Tensor] = None
    seg_query_scores: Optional[torch.Tensor] = None
    seg_query_valid: Optional[torch.Tensor] = None

    def replace(self, **updates: Any) -> "Gaussians":
        return dataclasses.replace(self, **updates)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[-2]

    def _map(self, fn, fields) -> "Gaussians":
        return self.replace(
            **{f: fn(getattr(self, f)) for f in fields if getattr(self, f) is not None}
        )

    def flatten_views(self) -> "Gaussians":
        """[B, V, R, ...] -> [B, V*R, ...] for the per-pixel fields."""

        def flat(x):
            b, v, r = x.shape[:3]
            return x.reshape((b, v * r) + tuple(x.shape[3:]))

        return self._map(
            flat,
            ("means", "covariances", "harmonics", "opacities", "scales", "rotations"),
        )

    def to_host(self) -> "Gaussians":
        """Copy every field to host numpy arrays."""
        return self._map(
            lambda x: x.detach().cpu().numpy(),
            [f.name for f in dataclasses.fields(self)],
        )


def quaternion_to_matrix(quat_xyzw: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion (xyzw, normalised inside by its squared norm) -> [*, 3, 3]."""
    i, j, k, r = quat_xyzw.unbind(-1)
    two_s = 2.0 / ((quat_xyzw * quat_xyzw).sum(-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(o.shape[:-1] + (3, 3))


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """Cov = R diag(s^2) R^T."""
    rot = quaternion_to_matrix(rotation_xyzw)
    return torch.einsum("...ik,...k,...jk->...ij", rot, scale * scale, rot)
