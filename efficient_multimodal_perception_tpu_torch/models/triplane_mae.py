"""TriplaneMAE: camera + range self-supervised pretraining.

Counterpart of the JAX package's ``models/triplane_mae.py`` for the
``triplane_range_cam`` configuration: the shared encoder path to the
triplane, the triplane sampled at every range pixel's point
(``ops.sampling.sample_triplane_auto``: the B7 kernel in bf16 on CUDA),
and two reconstruction losses:

camera_loss   the per-pixel features scattered into each camera's canvas
              (last write wins), decoded by ``camera_decoder``, patch MSE
              against the images
range_loss    the features masked to pixels with a point, decoded by
              ``lidar_decoder``, patch MSE against the range image

The colour, contrastive and surface heads are not ported: configuring
one raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.sampling import sample_triplane_auto
from ..ops.scatter import scatter_set_2d_batch
from .range_family import encode_triplane


def _scatter_points_to_cameras(rc_coors, feats, num_cams, H, W):
    """Per-range-pixel features ``(B, P, C)`` -> per-camera canvases
    ``(B * N, H, W, C)`` at the full-resolution ``(row, col)`` coords
    ``rc_coors (B, N, RH, RW, 2)`` (-1 where invalid).  A point writes
    where its floored row is strictly positive, as the reference's
    ``coors.long(); coors[..., 0] > 0``."""
    B = feats.shape[0]
    rc = rc_coors.reshape(B, num_cams, -1, 2)
    rows = torch.floor(rc[..., 0]).to(torch.int64)
    cols = torch.floor(rc[..., 1]).to(torch.int64)
    G, P = B * num_cams, rc.shape[2]
    return scatter_set_2d_batch(rows.reshape(G, P), cols.reshape(G, P),
                                (rows > 0).reshape(G, P), feats, H, W)


class TriplaneMAE(nn.Module):
    """Encoder -> triplane -> camera and range reconstruction losses.

    ``forward(batch, deterministic, generator)`` returns the loss dict.
    """

    def __init__(
        self,
        encoder: nn.Module,
        neck: nn.Module,
        lidar_decoder: nn.Module | None = None,
        camera_decoder: nn.Module | None = None,
        surface_decoder=None,
        color_decoder=None,
        contrastive: bool = False,
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters: int = 256,
        embed_dim: int = 768,
        dtype=torch.float32,
    ):
        super().__init__()
        if surface_decoder is not None or color_decoder is not None \
                or contrastive:
            raise NotImplementedError(
                "the surface, colour and contrastive losses are not ported")
        self.encoder = encoder
        self.neck = neck
        self.camera_decoder = camera_decoder
        self.lidar_decoder = lidar_decoder
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_sam_clusters = max_sam_clusters
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.fuse_sampler = True  # False sends the sampler to its twin

    def forward(self, batch, deterministic: bool = True, generator=None):
        triplane, aux = encode_triplane(
            self.encoder, self.neck, batch, self.pc_range, self.embed_dim,
            deterministic, generator,
        )
        B, _, S, _, C = triplane.shape
        range_proj = sample_triplane_auto(
            triplane, aux["range_points"], self.pc_range, self.voxel_size,
            self.fuse_sampler,
        )  # (B, RH, RW, C)
        losses = {}
        if self.camera_decoder is not None:
            losses["camera_loss"] = self._camera_loss(batch, aux, range_proj)
        if self.lidar_decoder is not None:
            point_mask = aux["range_active"] & (aux["range_image"] > 0)
            masked = range_proj * point_mask.to(range_proj.dtype)
            pred = self.lidar_decoder(masked)
            ri = aux["range_image"]
            losses["range_loss"] = self.lidar_decoder.forward_loss(
                ri, pred, torch.ones_like(ri))
        return losses

    def _camera_loss(self, batch, aux, range_proj):
        B, N, H, W, _ = batch.img.shape
        C = range_proj.shape[-1]
        canvas = _scatter_points_to_cameras(
            aux["rc_coors"], range_proj.reshape(B, -1, C), N, H, W)
        pred = self.camera_decoder(canvas)
        img = batch.img.reshape(B * N, H, W, 3)
        return self.camera_decoder.forward_loss(img, pred,
                                                torch.ones_like(img))
