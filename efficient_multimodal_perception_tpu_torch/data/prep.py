"""Offline data preparation: range images, elevation maps, the
occupancy file names (copy of the JAX package's ``data/prep.py``, numpy
end to end).

* :func:`make_range_image`: self-vehicle removal, spherical projection,
  far-to-near z-buffer (``core/geometry.range_projection_np``).
* :func:`make_elevation`: the BEV maximum height in 0.4 m cells over
  [-20, 20] (points sorted by z, so the last write is the maximum).
* :func:`add_occ_filenames`: ``occ_filename`` added to an infos pkl.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.geometry import range_projection_np

ELEV_VOXEL = 0.4
ELEV_RANGE = (-20, -20, -5, 20, 20, 3)


def make_range_image(points: np.ndarray):
    """LiDAR cloud -> ``{range_image (32,1024), range_points}``."""
    img, pts = range_projection_np(points)
    return {"range_image": img.astype(np.float64),
            "range_points": pts.astype(np.float64)}


def make_elevation(
    points: np.ndarray,
    voxel_size: float = ELEV_VOXEL,
    pc_range=ELEV_RANGE,
    remove_self_radius: float = 2.0,
    eps: float = 0.5,
):
    """LiDAR cloud -> ``{elevation (100,100), mask}`` BEV max-height."""
    pts = np.asarray(points, np.float64)
    if remove_self_radius > 0:
        close = (np.abs(pts[:, 0]) < remove_self_radius) & (
            np.abs(pts[:, 1]) < remove_self_radius
        )
        pts = pts[~close]
    m = (
        (pts[:, 0] > pc_range[0] + eps)
        & (pts[:, 1] > pc_range[1] + eps)
        & (pts[:, 2] > pc_range[2] + eps)
        & (pts[:, 0] < pc_range[3] - eps)
        & (pts[:, 1] < pc_range[4] - eps)
        & (pts[:, 2] < pc_range[5] - eps)
    )
    pts = pts[m]
    pts = pts[pts[:, 2].argsort()]  # ascending z -> last write is max

    nx = int((pc_range[3] - pc_range[0]) / voxel_size)
    ny = int((pc_range[4] - pc_range[1]) / voxel_size)
    xy = np.floor(
        (pts[:, 0:2] - np.array(pc_range[0:2])) / voxel_size
    ).astype(np.int64)
    voxel = np.zeros((nx, ny))
    mask = np.zeros((nx, ny))
    voxel[xy[:, 0], xy[:, 1]] = pts[:, 2]
    mask[xy[:, 0], xy[:, 1]] = 1
    return {"elevation": voxel, "mask": mask}


def add_occ_filenames(infos_path: str, out_path: str | None = None):
    """Patch an infos pkl with ``occ_filename = occupancy/<lidar>.npy``."""
    with open(infos_path, "rb") as f:
        data = pickle.load(f)
    for info in data["infos"]:
        name = os.path.split(info["lidar_path"])[-1]
        info["occ_filename"] = os.path.join("occupancy", name + ".npy")
    out = out_path or infos_path
    with open(out, "wb") as f:
        pickle.dump(data, f)
    return out
