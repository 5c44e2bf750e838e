"""PointTriplane: self-supervised pretraining of the point family.

Counterpart of the JAX package's ``models/point_triplane.py``: the
points and images go to three planes as in ``PointTriplaneOcc``
(``point_family.encode_planes``), the planes are sampled at every raw
point (``ops.sampling.sample_triplane_list``, plain: the JAX package runs
no kernel there), and the losses of the configured heads are:

camera_loss       the point features (zero where out of range) scattered
                  into each camera's canvas (``point_family.cam_rec_feat``),
                  decoded by ``camera_decoder``, patch MSE against the images
contrastive_loss  SupCon over the 6 SAM label channels (``losses.sup_con``)
surface_loss      ``surface_decoder`` (``models.interpnet``) over the raw
                  points with their features as latents

The contrastive and surface losses draw from the forward's
``sample_generator`` through :meth:`PointTriplane.draw`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..losses.sup_con import sam_contrastive_loss
from ..ops.sampling import sample_triplane_list
from .point_family import cam_rec_feat, encode_planes


class PointTriplane(nn.Module):
    """``forward(batch, deterministic=True, generator=None,
    sample_generator=None)`` returns the loss dict; ``batch`` needs
    ``points`` and ``points_valid``.  ``deterministic=False`` is the
    training forward (drop-path from ``generator``, BatchNorm on batch
    statistics with the running ones updated).  A ``color_decoder``
    config is accepted and nothing is built of it, as in JAX."""

    def __init__(
        self,
        point_triplane_projector: nn.Module,
        camera_encoder: nn.Module,
        triplane_encoder: nn.Module,
        fpn: nn.Module,
        camera_decoder: nn.Module | None = None,
        surface_decoder: nn.Module | None = None,
        color_decoder: dict | None = None,
        contrastive: bool = False,
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters: int = 256,
        dtype=torch.float32,
    ):
        super().__init__()
        self.point_triplane_projector = point_triplane_projector
        self.camera_encoder = camera_encoder
        self.triplane_encoder = triplane_encoder
        self.fpn = fpn
        self.camera_decoder = camera_decoder
        self.surface_decoder = surface_decoder
        self.contrastive = contrastive
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_sam_clusters = max_sam_clusters
        self.dtype = dtype

    def draw(self, batch, generator) -> dict:
        """The losses' draws from ``generator``: ``contrastive`` anchor
        scores ``(B, 6, P)``, then ``surface`` (``InterpNet.draw``), both
        over the raw points."""
        out = {}
        if not (self.contrastive or self.surface_decoder is not None):
            return out
        if generator is None:
            raise ValueError("the contrastive and surface losses draw from "
                             "sample_generator")
        B, P = batch.points.shape[:2]
        dev = batch.points.device
        if self.contrastive:
            out["contrastive"] = torch.rand((B, 6, P), generator=generator,
                                            device=dev)
        if self.surface_decoder is not None:
            out["surface"] = self.surface_decoder.draw(B, P, generator, dev)
        return out

    def forward(self, batch, deterministic: bool = True, generator=None,
                sample_generator=None):
        draws = self.draw(batch, sample_generator)
        planes, valid = encode_planes(self, batch, self.pc_range,
                                      self.voxel_size, deterministic,
                                      generator)
        B, N, H, W, _ = batch.img.shape
        pts = batch.points[..., :3]
        feats = sample_triplane_list(
            planes, pts, self.pc_range,
            self.point_triplane_projector.grid_size, self.voxel_size)
        losses = {}
        if self.camera_decoder is not None:
            canvas = cam_rec_feat(feats * valid[..., None].to(feats.dtype),
                                  batch.points, valid, batch.lidar2img,
                                  batch.cam_aug, (H, W))
            pred = self.camera_decoder(canvas.reshape(B * N, H, W, -1))
            img = batch.img.reshape(B * N, H, W, 3)
            losses["camera_loss"] = self.camera_decoder.forward_loss(
                img, pred, torch.ones_like(img))
        if self.contrastive:
            losses["contrastive_loss"] = sam_contrastive_loss(
                feats, batch.points, valid, draws["contrastive"],
                self.max_sam_clusters)
        if self.surface_decoder is not None:
            losses["surface_loss"] = self.surface_decoder(
                pts, feats, valid, draws["surface"])
        return losses
