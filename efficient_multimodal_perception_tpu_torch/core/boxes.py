"""3-D box geometry: the subset of the reference's box machinery in use.

Copy of the JAX package's ``core/boxes.py`` (numpy only): the eval
visualisations' box drawers (``utils/visualization.py``) use it.

Numpy rebuild of the essentials of ``mmdet3d/core/bbox`` +
``box_np_ops.py`` (numba) + ``post_processing/box3d_nms.py`` (CUDA): the
reference's triplane models never touch boxes in a loss (SURVEY.md §2h),
but the dataset layer loads them and the detection-eval path formats
them, so the rebuild ships the used primitives:

* LiDAR-frame boxes are ``(N, 7+) = (x, y, z, dx, dy, dz, yaw[, vx, vy])``
  with gravity-center z at the box bottom + dz/2 convention of
  ``LiDARInstance3DBoxes``.
* :func:`corners_bev` / :func:`corners_3d` — ``box_np_ops.py`` corner math.
* :func:`points_in_boxes` — replaces the ``points_in_boxes_gpu`` CUDA op.
* :func:`rotated_iou_bev` — exact polygon-clip rotated IoU (replaces
  ``iou3d_cuda``).
* :func:`nms_bev` / :func:`circle_nms` — ``box3d_nms.py`` ports.
"""

from __future__ import annotations

import numpy as np


def yaw_rotation(yaw: np.ndarray) -> np.ndarray:
    """(N,) yaw -> (N, 2, 2) rotation matrices (LiDAR frame, z-up)."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
    )


def corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) boxes -> (N, 4, 2) BEV corners (counter-clockwise)."""
    b = np.asarray(boxes, np.float64)
    dx, dy = b[:, 3] / 2, b[:, 4] / 2
    base = np.stack(
        [
            np.stack([dx, dy], -1),
            np.stack([-dx, dy], -1),
            np.stack([-dx, -dy], -1),
            np.stack([dx, -dy], -1),
        ],
        axis=1,
    )  # (N, 4, 2)
    R = yaw_rotation(b[:, 6])
    return np.einsum("nij,nkj->nki", R, base) + b[:, None, 0:2]


def corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 8, 3) corners; bottom face first (z at bottom)."""
    bev = corners_bev(boxes)
    z0 = boxes[:, 2:3]
    z1 = boxes[:, 2:3] + boxes[:, 5:6]
    bot = np.concatenate([bev, np.broadcast_to(z0[:, None], bev[..., :1].shape)], -1)
    top = np.concatenate([bev, np.broadcast_to(z1[:, None], bev[..., :1].shape)], -1)
    return np.concatenate([bot, top], axis=1)


def points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 3) x (N, 7) -> (P, N) bool membership.

    Replaces ``mmdet3d.ops.roiaware_pool3d.points_in_boxes_gpu``
    (``core/bbox/structures/lidar_box3d.py:5``).
    """
    p = np.asarray(points, np.float64)
    b = np.asarray(boxes, np.float64)
    rel = p[:, None, 0:2] - b[None, :, 0:2]
    c, s = np.cos(-b[:, 6]), np.sin(-b[:, 6])
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    in_xy = (np.abs(lx) <= b[None, :, 3] / 2) & (
        np.abs(ly) <= b[None, :, 4] / 2
    )
    in_z = (p[:, None, 2] >= b[None, :, 2]) & (
        p[:, None, 2] <= b[None, :, 2] + b[None, :, 5]
    )
    return in_xy & in_z


def _clip_polygon(poly, a, b):
    """Sutherland-Hodgman: clip poly by half-plane left of a->b."""
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        side_p = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        side_q = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
        if (side_p > 0) != (side_q > 0) and side_p != side_q:
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return out


def _poly_area(poly):
    if len(poly) < 3:
        return 0.0
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return 0.5 * abs(
        np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    )


def rotated_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Exact BEV rotated IoU (replaces ``iou3d_cuda.boxes_iou_bev_gpu``)."""
    ca = corners_bev(boxes_a)
    cb = corners_bev(boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    out = np.zeros((len(boxes_a), len(boxes_b)))
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            poly = [c for c in ca[i]]
            clip = cb[j]
            for k in range(4):
                poly = _clip_polygon(poly, clip[k], clip[(k + 1) % 4])
                if not poly:
                    break
            inter = _poly_area(poly)
            union = area_a[i] + area_b[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def nms_bev(
    boxes: np.ndarray, scores: np.ndarray, thresh: float, max_out: int = 500
) -> np.ndarray:
    """Rotated BEV NMS (replaces ``nms_gpu``, ``box3d_nms.py:5``)."""
    order = np.argsort(scores)[::-1]
    keep = []
    while len(order) and len(keep) < max_out:
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        ious = rotated_iou_bev(boxes[i : i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= thresh]
    return np.asarray(keep, np.int64)


def circle_nms(boxes_xy_r, thresh: float, post_max_size: int = 83):
    """Center-distance NMS (port of the numba ``circle_nms``,
    ``box3d_nms.py:278-330``); input ``(N, 3) = (x, y, score-order)``
    already sorted by descending score."""
    b = np.asarray(boxes_xy_r, np.float64)
    n = len(b)
    keep = []
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        d = (b[i + 1 :, 0] - b[i, 0]) ** 2 + (b[i + 1 :, 1] - b[i, 1]) ** 2
        suppressed[i + 1 :] |= d <= thresh
    return keep[:post_max_size]


# ---------------------------------------------------------------------------
# Coordinate-mode conversions (Box3DMode / Coord3DMode)
# ---------------------------------------------------------------------------
# Rebuilds ``core/bbox/structures/box_3d_mode.py:63-170`` and
# ``coord_3d_mode.py:181-260``: LiDAR (x fwd, y left, z up), CAM (x right,
# y down, z fwd), DEPTH (x right, y fwd, z up).  The reference rotates the
# center through a fixed (or caller-supplied) rt matrix and PERMUTES the
# size triplet; everything from column 6 on (yaw, velocity, scores) is
# carried through untouched — including yaw, a known quirk of this
# reference version that we reproduce exactly (the yaw axis changes
# meaning with the frame; downstream consumers re-interpret it).

LIDAR, CAM, DEPTH = 0, 1, 2

# (src, dst) -> (default 3x3 rt, size-permutation over (dx, dy, dz))
_MODE_RULES = {
    (LIDAR, CAM): ([[0, -1, 0], [0, 0, -1], [1, 0, 0]], (1, 2, 0)),
    (CAM, LIDAR): ([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], (2, 0, 1)),
    (DEPTH, CAM): ([[1, 0, 0], [0, 0, 1], [0, -1, 0]], (0, 2, 1)),
    (CAM, DEPTH): ([[1, 0, 0], [0, 0, -1], [0, 1, 0]], (0, 2, 1)),
    (LIDAR, DEPTH): ([[0, -1, 0], [1, 0, 0], [0, 0, 1]], (1, 0, 2)),
    (DEPTH, LIDAR): ([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], (1, 0, 2)),
}


def _apply_rt(xyz: np.ndarray, rt_mat) -> np.ndarray:
    rt = np.asarray(rt_mat, np.float64)
    if rt.shape[-1] == 4:  # homogeneous sensor extrinsics
        hom = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=1)
        return (hom @ rt.T)[:, :3]
    return xyz @ rt.T


def box_mode_convert(
    boxes: np.ndarray, src: int, dst: int, rt_mat=None
) -> np.ndarray:
    """Convert ``(N, >=7)`` boxes between LIDAR/CAM/DEPTH frames.

    ``rt_mat`` overrides the canonical axis swap with real sensor
    extrinsics (3x3 or 4x4), exactly like the reference's optional
    argument.  Returns a new float64-upcast-free array of input dtype.
    """
    b = np.array(boxes, copy=True)
    if src == dst:
        return b
    if (src, dst) not in _MODE_RULES:
        raise NotImplementedError(f"Box3DMode {src} -> {dst}")
    default_rt, perm = _MODE_RULES[(src, dst)]
    xyz = _apply_rt(
        np.asarray(b[:, :3], np.float64),
        default_rt if rt_mat is None else rt_mat,
    )
    b[:, :3] = xyz.astype(b.dtype)
    b[:, 3:6] = b[:, 3:6][:, list(perm)]
    return b


def point_mode_convert(
    points: np.ndarray, src: int, dst: int, rt_mat=None
) -> np.ndarray:
    """Convert ``(N, >=3)`` points between frames; extra dims carried."""
    p = np.array(points, copy=True)
    if src == dst:
        return p
    if (src, dst) not in _MODE_RULES:
        raise NotImplementedError(f"Coord3DMode {src} -> {dst}")
    default_rt, _ = _MODE_RULES[(src, dst)]
    xyz = _apply_rt(
        np.asarray(p[:, :3], np.float64),
        default_rt if rt_mat is None else rt_mat,
    )
    p[:, :3] = xyz.astype(p.dtype)
    return p
