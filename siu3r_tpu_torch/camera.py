"""Camera and projection math, counterpart of ``siu3r_tpu/camera.py``.

Normalised intrinsics (pixel coordinates divided by the image size),
OpenCV-style cameras (x right, y down, z forward), camera-to-world 4x4
extrinsics. Every function takes tensors on any device and broadcasts their
leading dimensions; none syncs with the host. Inverses are
``torch.linalg.inv_ex``'s, which do not check the matrix (a singular one
gives inf or NaN, as ``jnp.linalg.inv`` does, and raises nothing).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def _inv(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(m).inverse


def _apply(matrix: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """``einsum("...ij,...j->...i")`` with broadcast leading dimensions."""
    return (matrix @ vectors.unsqueeze(-1)).squeeze(-1)


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    return _apply(transformation, homogeneous)


def transform_cam2world(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, extrinsics)


def transform_world2cam(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, _inv(extrinsics))


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _EPS,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective division, then the intrinsics: camera-space xyz ->
    normalised image xy."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, nan=0.0, posinf=infinity, neginf=-infinity)
    return _apply(intrinsics, points)[..., :-1]


def project(
    points: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> (normalised image xy, in-front mask)."""
    points = transform_world2cam(homogenize_points(points), extrinsics)[..., :-1]
    in_front = points[..., -1] >= 0
    return project_camera_space(points, intrinsics, epsilon=epsilon), in_front


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalised xy and depth -> camera-space xyz."""
    ray_directions = _apply(_inv(intrinsics), homogenize_points(coordinates))
    return ray_directions * z[..., None]


def get_local_rays(coordinates: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-space unit ray directions through normalised xy."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    return directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)


def get_world_rays(
    coordinates: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised xy -> world-space (ray origins, unit directions)."""
    directions = get_local_rays(coordinates, intrinsics)
    directions = transform_cam2world(homogenize_vectors(directions), extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand_as(directions)
    return origins, directions


def sample_image_grid(shape: Tuple[int, ...], device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised xy coordinates of the pixel centres [*shape, d] in 0..1,
    the last axis first; integer ij indices [*shape, d])."""
    indices = [torch.arange(length, device=device) for length in shape]
    stacked_indices = torch.stack(torch.meshgrid(*indices, indexing="ij"), dim=-1)
    coordinates = [(idx + 0.5) / length for idx, length in zip(indices, shape)]
    coordinates = torch.stack(torch.meshgrid(*reversed(coordinates), indexing="xy"), dim=-1)
    return coordinates, stacked_indices


def intersect_rays(
    origins_x: torch.Tensor,
    directions_x: torch.Tensor,
    origins_y: torch.Tensor,
    directions_y: torch.Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> torch.Tensor:
    """The least-squares intersection of ray pairs (unit directions): the
    point nearest to both lines. A pair whose directions agree within
    ``eps`` (parallel) gives ``inf``.

    ``jnp.linalg.lstsq`` gives the minimum-norm solution, so where the
    system is singular it still returns a point: for lines that are parallel
    with opposite directions, the point of their middle line nearest the
    origin. CUDA's ``torch.linalg.lstsq`` assumes full rank, so here both
    singular cases are set apart before the solve (its matrix replaced by a
    regular one, so that neither its result nor its gradient holds a NaN),
    and pairs whose directions are opposite within ``eps`` take that point
    in closed form."""
    ox, dx, oy, dy = torch.broadcast_tensors(origins_x, directions_x, origins_y, directions_y)
    cos = (dx * dy).sum(dim=-1)
    parallel = cos > 1 - eps
    opposite = cos < eps - 1
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)

    def n_mat(d):
        return d[..., :, None] * d[..., None, :] - eye

    nx, ny = n_mat(dx), n_mat(dy)
    singular = (parallel | opposite)[..., None, None]
    lhs = torch.where(singular, -eye, nx + ny)
    rhs = _apply(nx, ox) + _apply(ny, oy)
    sol = torch.linalg.solve_ex(lhs, rhs).result
    mid = dx - dy
    mid = mid / torch.linalg.vector_norm(mid, dim=-1, keepdim=True).clamp(min=1e-12)
    centre = 0.5 * (ox + oy)
    on_mid_line = centre - (centre * mid).sum(dim=-1, keepdim=True) * mid
    sol = torch.where(opposite[..., None], on_mid_line, sol)
    return torch.where(parallel[..., None], torch.full_like(sol, inf), sol)


def sample_training_rays(
    image: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    num_rays: int,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random rays and their pixels for ray-supervised training. image
    [B, V, H, W, C] (NHWC), intrinsics [B, V, 3, 3], extrinsics
    [B, V, 4, 4] -> (origins, directions [B, num_rays, 3], pixels
    [B, num_rays, C]). The pixel indices (over V x H x W, per batch item)
    are drawn from ``generator``, which lives on the image's device; the
    JAX package draws them with ``jax.random``, so the two draw different
    rays."""
    b, v, h, w, _ = image.shape
    xy, _ = sample_image_grid((h, w), device=image.device)
    origins, directions = get_world_rays(xy[..., None, None, :], extrinsics, intrinsics)
    origins = origins.permute(2, 3, 0, 1, 4).reshape(b, v * h * w, 3)
    directions = directions.permute(2, 3, 0, 1, 4).reshape(b, v * h * w, 3)
    pixels = image.reshape(b, v * h * w, -1)
    idx = torch.randint(0, v * h * w, (b, num_rays), generator=generator, device=image.device)

    def take(t):
        return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))

    return take(origins), take(directions), take(pixels)


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Horizontal and vertical fields of view [..., 2] (radians) from
    normalised intrinsics."""
    intrinsics_inv = _inv(intrinsics)

    def process(x: float, y: float):
        # the inverse times (x, y, 1), column by column: a vector made on
        # the host would be a blocking copy to the device
        ray = intrinsics_inv[..., :, 0] * x + intrinsics_inv[..., :, 1] * y + intrinsics_inv[..., :, 2]
        return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)

    left = process(0.0, 0.5)
    right = process(1.0, 0.5)
    top = process(0.5, 0.0)
    bottom = process(0.5, 1.0)
    fov_x = torch.arccos((left * right).sum(dim=-1))
    fov_y = torch.arccos((top * bottom).sum(dim=-1))
    return torch.stack((fov_x, fov_y), dim=-1)


def get_projection_matrix(
    near: torch.Tensor, far: torch.Tensor, fov_x: torch.Tensor, fov_y: torch.Tensor
) -> torch.Tensor:
    """OpenCV-style frustum projection [B, 4, 4] from [B] near, far and
    fields of view: X and Y to (-1, 1), Z to (0, 1), Z flipped."""
    top = torch.tan(0.5 * fov_y) * near
    right = torch.tan(0.5 * fov_x) * near
    result = torch.zeros((near.shape[0], 4, 4), dtype=torch.float32, device=near.device)
    result[:, 0, 0] = 2 * near / (2 * right)
    result[:, 1, 1] = 2 * near / (2 * top)
    result[:, 3, 2].fill_(1.0)
    result[:, 2, 2] = far / (far - near)
    result[:, 2, 3] = -(far * near) / (far - near)
    return result


def relative_pose(poses: torch.Tensor) -> torch.Tensor:
    """Poses [..., V, 4, 4] made relative to the first: the world frame
    becomes the first camera's."""
    return _inv(poses[..., 0, :, :]).unsqueeze(-3) @ poses
