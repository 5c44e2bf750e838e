"""Static-shape batch container (torch tensors, channels-last)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.geometry import CameraAug


@dataclasses.dataclass
class Batch:
    """One batch.

    Attributes:
        img: ``(B, N_cam, H, W, 3)`` normalized images.
        range_image: ``(B, 32, 1024, 1)``.
        range_points: ``(B, 32, 1024, 3)`` per-pixel 3-D points.
        lidar2img: ``(B, N_cam, 4, 4)``.
        cam_aug: per-camera augmentation parameters.
        points: ``(B, P, D)`` padded LiDAR points, or None.
        points_valid: ``(B, P)`` bool, or None.
        occupancy: ``(B, 200, 200, 16)`` int labels (255 = ignore), or None.
        elevation / elevation_mask: ``(B, 100, 100)``, or None.
    """

    img: torch.Tensor
    range_image: torch.Tensor
    range_points: torch.Tensor
    lidar2img: torch.Tensor
    cam_aug: CameraAug
    points: Optional[torch.Tensor] = None
    points_valid: Optional[torch.Tensor] = None
    occupancy: Optional[torch.Tensor] = None
    elevation: Optional[torch.Tensor] = None
    elevation_mask: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.img.shape[0]

    @property
    def num_cams(self) -> int:
        return self.img.shape[1]

    def to(self, device) -> "Batch":
        """A copy with every tensor on ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = None if v is None else v.to(device)
        return Batch(**kw)
