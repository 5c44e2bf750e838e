"""PointTriplaneOcc: 3-D semantic occupancy of the point family.

Counterpart of the JAX package's ``models/point_triplane_occ.py``:

1. the points are cropped and voxelized (``point_family.voxelize_points``),
2. the camera encoder runs on the images; its last stage is sampled at
   each point's projections and summed over the cameras
   (``point_family.point_to_cam``),
3. the projector pools points and camera features into three planes,
4. each plane goes through the shared triplane encoder (all four
   stages) and the FPN,
5. the planes are read out at the occupancy voxel centers
   (``ops.sampling.sample_triplane_list_grid``) and the Mlp head gives
   the logits.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.geometry import occupancy_roi
from ..ops.sampling import sample_triplane_list_grid
from .point_family import encode_planes


class PointTriplaneOcc(nn.Module):
    """``forward(batch, deterministic=True, generator=None)`` returns
    ``(logits (B, X, Y, Z, K), occ_target (B, X, Y, Z) or None,
    losses)``; ``batch`` needs ``points`` and ``points_valid``.

    ``deterministic=False`` is the training forward: stochastic depth in
    both encoders (its draws from ``generator``) and BatchNorm in the
    projector and the FPN on batch statistics, their running statistics
    updated (the JAX package's ``train=not deterministic``)."""

    uses_points = True  # the server sends points with every request

    def __init__(
        self,
        point_triplane_projector: nn.Module,
        camera_encoder: nn.Module,
        triplane_encoder: nn.Module,
        fpn: nn.Module,
        decoder: nn.Module,
        voxel_size=(0.5, 0.5, 0.5),
        occ_range=(-25, -25, -5, 25, 25, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        triplane_voxel_size=(0.4, 0.4, 0.1),
        class_names=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.point_triplane_projector = point_triplane_projector
        self.camera_encoder = camera_encoder
        self.triplane_encoder = triplane_encoder
        self.fpn = fpn
        self.decoder = decoder
        self.triplane_range = tuple(triplane_range)
        self.triplane_voxel_size = tuple(triplane_voxel_size)
        self.class_names = class_names
        self.dtype = dtype
        self.occ_bounds, self.ref_3d = occupancy_roi(occ_range, voxel_size)

    def forward(self, batch, deterministic: bool = True, generator=None):
        planes, _ = encode_planes(self, batch, self.triplane_range,
                                  self.triplane_voxel_size, deterministic,
                                  generator)
        ref = self.ref_3d
        feats = sample_triplane_list_grid(
            planes, ref[:, 0, 0, 0], ref[0, :, 0, 1],
            ref[0, 0, :, 2], self.triplane_range,
            self.point_triplane_projector.grid_size, self.triplane_voxel_size)
        logits = self.decoder(feats)
        losses, occ = {}, None
        if batch.occupancy is not None:
            x0, y0, x1, y1 = self.occ_bounds
            occ = batch.occupancy[:, x0:x1 + 1, y0:y1 + 1]
            losses["loss"] = self.decoder.loss(logits, occ)
        return logits, occ, losses
