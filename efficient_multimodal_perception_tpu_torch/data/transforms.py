"""Point and box augmentation transforms (numpy, one sample at a time;
copy of the JAX package's ``data/transforms.py``).

The registered pipeline transforms of the reference beyond ImageAug3D /
ImageNormalize (which live in ``nuscenes.py``): GlobalRotScaleTrans,
RandomFlip3D, PointShuffle, PointsRangeFilter, ObjectRangeFilter,
ObjectNameFilter, the LiDAR depth annotation and MultiScaleFlipAug3D.
The shipped configs enable none of them; they are part of the data
layer's surface.

Each transform is ``f(sample: dict, rng) -> dict`` over numpy arrays
with keys ``points (N, D)``, optional ``gt_bboxes_3d (M, 7+)``,
``gt_labels_3d (M,)``.
"""

from __future__ import annotations

import numpy as np


def global_rot_scale_trans(
    sample: dict,
    rng: np.random.Generator,
    rot_range=(-0.78539816, 0.78539816),
    scale_ratio_range=(0.95, 1.05),
    translation_std=(0, 0, 0),
) -> dict:
    """Random global rotation (z), scaling and translation."""
    angle = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_ratio_range)
    trans = rng.normal(scale=translation_std, size=3)

    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    if "points" in sample:
        pts = sample["points"].copy()
        pts[:, :3] = pts[:, :3] @ R.T * scale + trans
        sample["points"] = pts
    if sample.get("gt_bboxes_3d") is not None:
        b = sample["gt_bboxes_3d"].copy()
        b[:, :3] = b[:, :3] @ R.T * scale + trans
        b[:, 3:6] *= scale
        b[:, 6] += angle
        if b.shape[1] > 7:  # velocities
            b[:, 7:9] = b[:, 7:9] @ R[:2, :2].T * scale
        sample["gt_bboxes_3d"] = b
    sample["pcd_rotation"] = R
    sample["pcd_scale_factor"] = scale
    sample["pcd_trans"] = trans
    return sample


def _flip_bev(sample: dict, axis: int) -> None:
    """In-place BEV flip: axis=1 (y) = horizontal, axis=0 (x) = vertical."""
    if "points" in sample:
        pts = sample["points"].copy()
        pts[:, axis] = -pts[:, axis]
        sample["points"] = pts
    if sample.get("gt_bboxes_3d") is not None:
        b = sample["gt_bboxes_3d"].copy()
        b[:, axis] = -b[:, axis]
        b[:, 6] = (-b[:, 6] if axis == 1 else np.pi - b[:, 6])
        if b.shape[1] > 7:
            b[:, 7 + axis] = -b[:, 7 + axis]
        sample["gt_bboxes_3d"] = b


def random_flip_3d(
    sample: dict,
    rng: np.random.Generator,
    flip_ratio_bev_horizontal: float = 0.5,
    flip_ratio_bev_vertical: float = 0.0,
) -> dict:
    """Random BEV flips: horizontal = flip y, vertical = flip x."""
    flip_h = rng.random() < flip_ratio_bev_horizontal
    flip_v = rng.random() < flip_ratio_bev_vertical

    if flip_h:
        _flip_bev(sample, 1)
    if flip_v:
        _flip_bev(sample, 0)
    sample["pcd_horizontal_flip"] = flip_h
    sample["pcd_vertical_flip"] = flip_v
    return sample


def point_shuffle(sample: dict, rng: np.random.Generator) -> dict:
    pts = sample["points"]
    sample["points"] = pts[rng.permutation(len(pts))]
    return sample


def points_range_filter(sample: dict, pc_range) -> dict:
    pts = sample["points"]
    m = (
        (pts[:, 0] > pc_range[0]) & (pts[:, 0] < pc_range[3])
        & (pts[:, 1] > pc_range[1]) & (pts[:, 1] < pc_range[4])
        & (pts[:, 2] > pc_range[2]) & (pts[:, 2] < pc_range[5])
    )
    sample["points"] = pts[m]
    return sample


def object_range_filter(sample: dict, pc_range) -> dict:
    b = sample.get("gt_bboxes_3d")
    if b is None:
        return sample
    m = (
        (b[:, 0] > pc_range[0]) & (b[:, 0] < pc_range[3])
        & (b[:, 1] > pc_range[1]) & (b[:, 1] < pc_range[4])
    )
    sample["gt_bboxes_3d"] = b[m]
    if sample.get("gt_labels_3d") is not None:
        sample["gt_labels_3d"] = sample["gt_labels_3d"][m]
    return sample


def object_name_filter(sample: dict, keep_labels) -> dict:
    lab = sample.get("gt_labels_3d")
    if lab is None:
        return sample
    m = np.isin(lab, list(keep_labels))
    sample["gt_labels_3d"] = lab[m]
    sample["gt_bboxes_3d"] = sample["gt_bboxes_3d"][m]
    return sample


def points_to_image_depth(
    points: np.ndarray,
    lidar2image: np.ndarray,
    lidar2camera: np.ndarray,
    image_hw,
    min_dist: float = 1.0,
) -> np.ndarray:
    """Per-camera 2.5-D depth annotations from the LiDAR cloud.

    Equivalent of ``LoadAnnotations3D``'s depth option
    (``pipelines/loading.py:538-576`` — ``_get_lidar_depth`` /
    ``_map_pointcloud_to_image``): points go through ``lidar2camera``
    for the metric depth (camera-frame z) and ``lidar2image`` for the
    pixel position; points closer than ``min_dist`` or out of frame are
    dropped.  Host-side numpy like the rest of the annotation loaders
    (ragged output — this never feeds a jitted graph; it exists for the
    2.5-D box supervision surface, dead on every triplane hot path).

    Args:
        points: ``(N, >=3)`` LiDAR-frame points.
        lidar2image: ``(4, 4)`` projection for ONE camera.
        lidar2camera: ``(4, 4)`` extrinsics for the same camera.
        image_hw: ``(H, W)`` of the undistorted image.

    Returns:
        ``(M, 3)`` float32 rows of ``(u, v, depth)`` for the kept points.
    """
    H, W = image_hw
    xyz = np.asarray(points, np.float64)[:, :3]
    hom = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=1)
    depth = (hom @ np.asarray(lidar2camera, np.float64).T)[:, 2]
    img = hom @ np.asarray(lidar2image, np.float64).T
    uv = img[:, :2] / np.maximum(img[:, 2:3], 1e-5)
    keep = (
        (depth > min_dist)
        & (uv[:, 0] >= 0) & (uv[:, 0] < W)
        & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    )
    out = np.concatenate([uv[keep], depth[keep, None]], axis=1)
    return out.astype(np.float32)


def multi_scale_flip_aug_3d(
    sample: dict,
    transforms=(),
    img_scale=None,
    pts_scale_ratio=1.0,
    flip: bool = False,
    flip_direction="horizontal",
    pcd_horizontal_flip: bool = False,
    pcd_vertical_flip: bool = False,
) -> dict:
    """Test-time augmentation: enumerate scale/flip variants and collate.

    Equivalent of ``MultiScaleFlipAug3D``
    (``pipelines/test_time_aug.py:10-115``) — unused by every shipped
    reference config but part of the pipeline registry surface.  The
    reference records aug *hints* (``scale``, ``pcd_horizontal_flip``,
    ...) for downstream hint-consuming transforms; this functional
    pipeline has no hidden hint channel, so the point-cloud geometry
    (BEV flips, ``pts_scale_ratio``) is applied directly here with the
    same math as the random train-time transforms, then the caller's
    ``transforms`` run per variant.  Enumeration order and the
    double-flip reduction quirk (``flip_aug = [True] if flip else
    [False]``, test_time_aug.py:80-82) match the reference exactly, so a
    K-variant reference pipeline and this one produce the same K
    variants in the same order.

    Args:
        sample: one un-augmented sample dict (numpy arrays).
        transforms: per-variant callables ``f(sample) -> sample``
            (e.g. ``functools.partial(points_range_filter, ...)``).
        img_scale: tuple or list of tuples — stored as ``scale`` for
            image-resizing transforms downstream (the triplane families
            never resize at test time).
        pts_scale_ratio: float or list of floats.
        flip / flip_direction / pcd_horizontal_flip / pcd_vertical_flip:
            as in the reference.

    Returns:
        dict-of-lists: each key holds one entry per augmentation
        variant (the reference's list-of-dict -> dict-of-list collate).
    """
    import copy

    img_scales = img_scale if isinstance(img_scale, list) else [img_scale]
    pts_ratios = (
        pts_scale_ratio
        if isinstance(pts_scale_ratio, list)
        else [float(pts_scale_ratio)]
    )
    directions = (
        flip_direction
        if isinstance(flip_direction, list)
        else [flip_direction]
    )
    flip_aug = [True] if flip else [False]
    h_aug = [False, True] if flip and pcd_horizontal_flip else [False]
    v_aug = [False, True] if flip and pcd_vertical_flip else [False]

    variants = []
    for scale in img_scales:
        for ratio in pts_ratios:
            for f in flip_aug:
                for h in h_aug:
                    for v in v_aug:
                        for direction in directions:
                            s = copy.deepcopy(sample)
                            s["scale"] = scale
                            s["flip"] = f
                            s["flip_direction"] = direction
                            s["pcd_scale_factor"] = ratio
                            s["pcd_horizontal_flip"] = h
                            s["pcd_vertical_flip"] = v
                            if ratio != 1.0 and "points" in s:
                                pts = s["points"].copy()
                                pts[:, :3] *= ratio
                                s["points"] = pts
                                if s.get("gt_bboxes_3d") is not None:
                                    b = s["gt_bboxes_3d"].copy()
                                    b[:, :6] *= ratio
                                    if b.shape[1] > 7:
                                        b[:, 7:9] *= ratio
                                    s["gt_bboxes_3d"] = b
                            if h:
                                _flip_bev(s, 1)
                            if v:
                                _flip_bev(s, 0)
                            for t in transforms:
                                s = t(s)
                            variants.append(s)

    return {k: [var[k] for var in variants] for k in variants[0]}
