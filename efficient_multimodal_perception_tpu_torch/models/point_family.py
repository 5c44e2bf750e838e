"""Shared helpers of the point family (counterpart of the JAX package's
``models/point_family.py``): ``voxelize_points``, ``point_to_cam``,
``cam_rec_feat``, and ``encode_planes``, the path from points and images
to the three FPN planes that ``PointTriplaneOcc`` and ``PointTriplane``
share."""

from __future__ import annotations

import torch

from ..core.geometry import crop_to_range, project_points_to_cameras
from ..ops.sampling import grid_sample_2d_f32
from ..ops.scatter import scatter_set_2d_batch


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


def cam_rec_feat(point_feats, points, points_valid, lidar2img, cam_aug,
                 image_hw):
    """Per-point features scattered into every camera's pixel canvas.

    A point writes at ``(floor(y), clip(floor(x), 0, W - 1))`` of its
    projection in each camera where it is in the image and valid; the
    last point written to a pixel wins (the reference's advanced-index
    assignment), as ``ops.scatter.scatter_set_2d_batch`` does.

    Args:
        point_feats: ``(B, P, C)``; points ``(B, P, >=3)``;
            points_valid ``(B, P)``.
        lidar2img: ``(B, N, 4, 4)``; cam_aug: ``CameraAug``.
        image_hw: the canvases' ``(H, W)``.

    Returns:
        ``(B, N, H, W, C)`` in ``point_feats``' dtype, zero where no point
        writes.
    """
    B, P, C = point_feats.shape
    N = lidar2img.shape[1]
    H, W = image_hw
    coords, in_img = project_points_to_cameras(points[..., :3], lidar2img,
                                               cam_aug, (H, W))
    valid = in_img & points_valid.bool()[:, None, :]
    rows = torch.floor(coords[..., 1]).to(torch.int64)
    cols = torch.floor(coords[..., 0]).to(torch.int64).clamp(0, W - 1)
    out = scatter_set_2d_batch(rows.reshape(B * N, P),
                               cols.reshape(B * N, P),
                               valid.reshape(B * N, P), point_feats, H, W)
    return out.reshape(B, N, H, W, C)


def encode_planes(model, batch, pc_range, voxel_size,
                  deterministic: bool = True, generator=None):
    """Points and images -> the three planes (the JAX package's
    ``PointTriplane.encode_planes``).

    The points are cropped and voxelized, the camera encoder runs on the
    images and its last stage is sampled at each point's projections
    (``point_to_cam``), the projector pools points and camera features
    into the xy, yz and xz planes, and each plane goes through the shared
    triplane encoder and the FPN.  ``model`` holds
    ``point_triplane_projector``, ``camera_encoder``, ``triplane_encoder``
    and ``fpn``; ``deterministic=False`` draws drop-path from
    ``generator`` and runs BatchNorm on batch statistics.

    Returns ``(planes, valid)``: the NHWC planes and the points' in-range
    validity ``(B, P)``.
    """
    B, N, H, W, _ = batch.img.shape
    train = not deterministic
    grid_idx, valid = voxelize_points(batch.points, batch.points_valid,
                                      pc_range, voxel_size)
    feats = model.camera_encoder(batch.img.reshape(B * N, H, W, 3),
                                 deterministic, generator)
    feats = feats.reshape(B, N, *feats.shape[1:])
    cam_pt = point_to_cam(batch.points, valid, feats, batch.lidar2img,
                          batch.cam_aug, (H, W))
    tpv = model.point_triplane_projector(batch.points, grid_idx, valid,
                                         cam_pt, train=train)
    planes = [model.fpn(model.triplane_encoder(tp, deterministic, generator),
                        train=train) for tp in tpv]
    return planes, valid
