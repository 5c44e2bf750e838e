"""Shared helpers of the point family (counterpart of the JAX package's
``models/point_family.py``): ``voxelize_points`` and ``point_to_cam``.
``cam_rec_feat`` belongs to pretraining and is not ported."""

from __future__ import annotations

import torch

from ..core.geometry import crop_to_range, project_points_to_cameras
from ..ops.sampling import grid_sample_2d_f32


def voxelize_points(points, points_valid, pc_range, voxel_size):
    """Strict in-range crop and integer voxel index.

    The index is ``(xyz - range_min) / voxel_size`` in float32,
    truncated toward zero, as the JAX package computes it.

    Returns ``(grid_idx (B, P, 3) int32, valid (B, P) bool)``; cropped
    and padded rows keep index 0 and are masked.
    """
    xyz = points[..., :3].float()
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=xyz.device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=xyz.device)
    valid = crop_to_range(xyz, pc_range) & points_valid.bool()
    idx = ((xyz - lo) / vs).to(torch.int32)
    return torch.where(valid[..., None], idx, torch.zeros_like(idx)), valid


def point_to_cam(points, points_valid, img_features, lidar2img, cam_aug,
                 image_hw):
    """Camera features bilinearly sampled at each point's projection in
    every camera, zero where the point is invalid or outside the image,
    summed over the cameras.

    Keeps the reference's swapped normalization (the JAX package's
    ``point_family.py:67-70``): the grid's x is ``2 * row / H - 1`` and
    its y ``2 * col / W - 1``, so features are read at transposed
    locations.  The sample is ``F.grid_sample`` in float32, one camera
    at a time (``ops.sampling.grid_sample_2d_f32``); the JAX package's
    one-hot MXU form (``grid_sample_2d_mm``) is a TPU form and is not
    carried over.

    Args:
        points: ``(B, P, >=3)``; points_valid ``(B, P)``.
        img_features: ``(B, N, h, w, C)``.
        lidar2img: ``(B, N, 4, 4)``; cam_aug: ``CameraAug``.
        image_hw: the input images' ``(H, W)``.

    Returns:
        ``(B, P, C)`` in ``img_features``' dtype.
    """
    B, N, h, w, C = img_features.shape
    H, W = image_hw
    coords, in_img = project_points_to_cameras(points[..., :3], lidar2img,
                                               cam_aug, (H, W))
    valid = in_img & points_valid.bool()[:, None, :]
    grid = torch.stack([2.0 * coords[..., 1] / H - 1.0,
                        2.0 * coords[..., 0] / W - 1.0], dim=-1)
    out = None
    for n in range(N):
        s = grid_sample_2d_f32(img_features[:, n], grid[:, n])
        s = s * valid[:, n, :, None]
        out = s if out is None else out + s
    return out.to(img_features.dtype)
