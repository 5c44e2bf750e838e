"""Geometry: spherical range projection (numpy), camera projection,
occupancy voxel grids and the strict in-range crop.

Counterpart of the JAX package's ``core/geometry.py``.  Camera
projection runs in full float32 (no TF32) because pixel coordinates are
precision-critical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

RANGE_H = 32
RANGE_W = 1024
FOV_UP_DEG = 10.0
FOV_DOWN_DEG = -30.0


def range_projection_np(
    points: np.ndarray,
    proj_h: int = RANGE_H,
    proj_w: int = RANGE_W,
    fov_up_deg: float = FOV_UP_DEG,
    fov_down_deg: float = FOV_DOWN_DEG,
    remove_self_radius: float = 2.0,
):
    """Spherical projection: self-vehicle removal, yaw = atan2(x, y),
    far-to-near write order so the nearest point wins each pixel.

    Returns ``(range_image (H, W), range_points (H, W, 3))`` float32.
    """
    pts = np.asarray(points, dtype=np.float64)
    if remove_self_radius > 0:
        close = (np.abs(pts[:, 0]) < remove_self_radius) & (
            np.abs(pts[:, 1]) < remove_self_radius
        )
        pts = pts[~close]

    fov_up = fov_up_deg / 180.0 * np.pi
    fov_down = fov_down_deg / 180.0 * np.pi
    fov = abs(fov_down) + abs(fov_up)

    depth = np.linalg.norm(pts[:, :3], 2, axis=1)
    yaw = np.arctan2(pts[:, 0], pts[:, 1])
    pitch = np.arcsin(pts[:, 2] / (depth + 1e-8))

    proj_x = 0.5 * (yaw / np.pi + 1.0) * proj_w
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov) * proj_h
    proj_x = np.clip(np.floor(proj_x), 0, proj_w - 1).astype(np.int32)
    proj_y = np.clip(np.floor(proj_y), 0, proj_h - 1).astype(np.int32)

    order = np.argsort(depth)[::-1]
    depth, proj_x, proj_y, pts = (
        depth[order], proj_x[order], proj_y[order], pts[order]
    )
    range_img = np.zeros((proj_h, proj_w), dtype=np.float64)
    range_pts = np.zeros((proj_h, proj_w, 3), dtype=np.float64)
    range_img[proj_y, proj_x] = depth
    range_pts[proj_y, proj_x] = pts[:, :3]
    return range_img.astype(np.float32), range_pts.astype(np.float32)


@dataclasses.dataclass
class CameraAug:
    """Per-camera augmentation: ``resize (B, N)``, ``crop (B, N, 2)``
    offsets (w, h) in resized pixels, ``flip (B, N)`` bool."""

    resize: torch.Tensor
    crop: torch.Tensor
    flip: torch.Tensor

    def to(self, device) -> "CameraAug":
        return CameraAug(*(t.to(device) for t in
                           (self.resize, self.crop, self.flip)))


def project_points_to_cameras(
    points: torch.Tensor,
    lidar2img: torch.Tensor,
    aug: CameraAug,
    image_hw: tuple[int, int],
):
    """Project ``(B, ..., 3)`` LiDAR points into every camera.

    Homogeneous transform, perspective divide with z clamped at 1e-5,
    aug resize, crop subtraction, horizontal flip, bounds check.

    Returns ``coords (B, N, ..., 2)`` (x, y) pixel coords and
    ``valid (B, N, ...)`` bool.
    """
    H, W = image_hw
    B = points.shape[0]
    pt_shape = points.shape[1:-1]
    pts = points.reshape(B, -1, 3).float()
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    # elementwise products + sum: exact f32 on every device (a matmul
    # here could run in TF32 on the card)
    cam = (lidar2img.float()[:, :, None, :, :] * hom[:, None, :, None, :]).sum(-1)
    xy = cam[..., 0:2] / torch.clamp(cam[..., 2:3], min=1e-5)

    resize = aug.resize.float()[:, :, None]
    crop = aug.crop.float()[:, :, None, :]
    x = xy[..., 0] * resize - crop[..., 0]
    y = xy[..., 1] * resize - crop[..., 1]
    x = torch.where(aug.flip.bool()[:, :, None], W - x, x)

    valid = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    coords = torch.stack([x, y], dim=-1)
    N = coords.shape[1]
    return (
        coords.reshape(B, N, *pt_shape, 2),
        valid.reshape(B, N, *pt_shape),
    )


def occupancy_roi(occ_range, voxel_size):
    """Occupancy crop bounds and voxel-center grid: with occ_range
    [-25, 25]^2 x [-5, 3] and 0.5 m voxels the crop is 99 x 99 x 16.

    Returns ``((min_x, min_y, max_x, max_y), ref_3d (X, Y, Z, 3))`` with
    ``ref_3d`` numpy float32.
    """
    min_x = int((abs(-50 - occ_range[0]) + 0.5) / voxel_size[0])
    min_y = int((abs(-50 - occ_range[1]) + 0.5) / voxel_size[1])
    max_x = int((abs(50 - occ_range[0]) - 0.5) / voxel_size[0])
    max_y = int((abs(50 - occ_range[1]) - 0.5) / voxel_size[1])

    X = max_x - min_x + 1
    Y = max_y - min_y + 1
    Z = int((occ_range[5] - occ_range[2]) / voxel_size[2])

    xs = np.arange(X, dtype=np.float32)[:, None, None]
    ys = np.arange(Y, dtype=np.float32)[None, :, None]
    zs = np.arange(Z, dtype=np.float32)[None, None, :]
    ref = np.stack(np.broadcast_arrays(xs, ys, zs), axis=-1)
    ref[..., 0] = (ref[..., 0] + 0.5) * voxel_size[0] + occ_range[0]
    ref[..., 1] = (ref[..., 1] + 0.5) * voxel_size[1] + occ_range[1]
    ref[..., 2] = (ref[..., 2] + 0.5) * voxel_size[2] + occ_range[2]
    return (min_x, min_y, max_x, max_y), ref


def volume_reference_points(volume, voxel_size, pc_range):
    """Voxel-center grid of the elevation model: ``(H, W, Z, 3)`` numpy
    float32 world-frame centers.

    As the reference (``triplane_elev.py:113-133, 258-261``) does, it
    stacks ``(ys, xs, zs)`` (channel 0 varies along the H axis) and then
    scales channel i by ``voxel_size[i]`` and shifts it by
    ``pc_range[i]``.
    """
    H, W, Z = volume
    ys = np.linspace(0.5, H - 0.5, H, dtype=np.float32)[:, None, None]
    xs = np.linspace(0.5, W - 0.5, W, dtype=np.float32)[None, :, None]
    zs = np.linspace(0.5, Z - 0.5, Z, dtype=np.float32)[None, None, :]
    ref = np.stack(np.broadcast_arrays(ys, xs, zs), axis=-1)
    for i in range(3):
        ref[..., i] = ref[..., i] * voxel_size[i] + pc_range[i]
    return ref


def crop_to_range(points: torch.Tensor, pc_range):
    """Strict-inequality in-range mask over the last (xyz) axis."""
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    hi = torch.tensor(pc_range[3:], dtype=points.dtype, device=points.device)
    return ((points > lo) & (points < hi)).all(dim=-1)
