"""LiDAR point labelling with SAM masks: the data side of the JAX
package's ``data/sam_masks.py``.

Each point is labelled with the index of the mask its camera projection
falls in, giving the per-camera cluster ids of the (N, 11) point bins
the contrastive loss reads.  The mask generator itself
(``AutomaticMaskGenerator``, ``create_sam_labeled_points``) needs SAM
weights and ``transformers`` and is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np


def label_points_with_masks(
    points_xyz: np.ndarray,
    lidar2image: np.ndarray,
    image_hw,
    masks: List[dict],
) -> np.ndarray:
    """Label each point with the 1-based index of the mask it lands in.

    Project, bounds-check, and take the largest mask index per point
    (later masks in generation order win through ``np.maximum``).

    Returns ``(N,)`` float labels (0 = no mask / not visible).
    """
    H, W = image_hw
    hom = np.concatenate(
        [points_xyz, np.ones_like(points_xyz[:, :1])], axis=1
    )
    cam = hom @ lidar2image.T
    xy = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-5)
    valid = (
        (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    )
    cols = np.clip(xy[:, 0].astype(int), 0, W - 1)
    rows = np.clip(xy[:, 1].astype(int), 0, H - 1)
    labels = np.zeros(len(points_xyz), np.float32)
    for i, ann in enumerate(masks):
        hit = ann["segmentation"][rows, cols] & valid
        labels = np.maximum(labels, (i + 1) * hit.astype(np.float32))
    return labels
