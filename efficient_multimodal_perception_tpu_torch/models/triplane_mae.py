"""TriplaneMAE: camera + range self-supervised pretraining.

Counterpart of the JAX package's ``models/triplane_mae.py`` for the
``triplane_range_cam``, ``triplane_surf_sam`` and ``nuscenes_range``
configurations: the shared encoder path to the triplane, the triplane
sampled at every range pixel's point (``ops.sampling.sample_triplane_auto``:
the B7 kernel in bf16 on CUDA), and the losses of the configured heads:

camera_loss       the per-pixel features scattered into each camera's
                  canvas (last write wins), decoded by ``camera_decoder``,
                  patch MSE against the images
contrastive_loss  the triplane sampled at every raw LiDAR point (B7 again,
                  in range or not), SupCon over the 6 SAM label channels
                  (``losses.sup_con``)
surface_loss      ``surface_decoder`` (``models.interpnet``) over the range
                  points with the per-pixel features as latents
range_loss        the features masked to pixels with a point (and, with
                  MAE masking, to the kept range pixels), decoded by
                  ``lidar_decoder``, patch MSE against the range image
color             ``color_decoder`` (``heads.PointMlpHead``) over the
                  per-pixel features, MSE against the image colour each
                  point projects to; logged only, as in JAX and the
                  reference: the key holds no "loss", so the total loss
                  leaves it out and the colour head takes no gradient

The contrastive and surface losses draw (anchor scores, query picks and
radii) from the forward's ``sample_generator`` through :meth:`draw`; the
encoder's MAE masks come from ``mask_generator``
(``joint_encoder.JointEncoder.draw``).  :meth:`reconstructions` decodes
the images the eval CLI's ``--show-dir`` draws.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.geometry import crop_to_range
from ..losses.sup_con import sam_contrastive_loss
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
    """Encoder -> triplane -> reconstruction, contrastive and surface
    losses.

    ``forward(batch, deterministic, generator, sample_generator,
    mask_generator)`` returns the loss dict; ``generator`` gives the
    drop-path draws, ``sample_generator`` the losses' (needed with
    ``contrastive`` or a ``surface_decoder``) and ``mask_generator`` the
    MAE masks (needed with a mask ratio > 0).
    """

    def __init__(
        self,
        encoder: nn.Module,
        neck: nn.Module,
        lidar_decoder: nn.Module | None = None,
        camera_decoder: nn.Module | None = None,
        surface_decoder: nn.Module | None = None,
        color_decoder=None,
        contrastive: bool = False,
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters: int = 256,
        embed_dim: int = 768,
        dtype=torch.float32,
    ):
        super().__init__()
        self.encoder = encoder
        self.neck = neck
        self.camera_decoder = camera_decoder
        self.lidar_decoder = lidar_decoder
        self.surface_decoder = surface_decoder
        self.color_decoder = color_decoder
        self.contrastive = contrastive
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_sam_clusters = max_sam_clusters
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.fuse_sampler = True  # False sends the sampler to its twin

    def draw(self, batch, generator) -> dict:
        """The losses' draws from ``generator``: ``contrastive`` anchor
        scores ``(B, 6, P)`` over the raw points, then ``surface``
        (``InterpNet.draw`` over the range pixels)."""
        out = {}
        if not (self.contrastive or self.surface_decoder is not None):
            return out
        if generator is None:
            raise ValueError("the contrastive and surface losses draw from "
                             "sample_generator")
        B, RH, RW, _ = batch.range_points.shape
        dev = batch.range_points.device
        if self.contrastive:
            out["contrastive"] = torch.rand(
                (B, 6, batch.points.shape[1]), generator=generator,
                device=dev)
        if self.surface_decoder is not None:
            out["surface"] = self.surface_decoder.draw(B, RH * RW, generator,
                                                       dev)
        return out

    def forward(self, batch, deterministic: bool = True, generator=None,
                sample_generator=None, mask_generator=None):
        draws = self.draw(batch, sample_generator)
        triplane, aux = encode_triplane(
            self.encoder, self.neck, batch, self.pc_range, self.embed_dim,
            deterministic, generator, mask_generator=mask_generator,
        )
        B, _, S, _, C = triplane.shape
        range_proj = sample_triplane_auto(
            triplane, aux["range_points"], self.pc_range, self.voxel_size,
            self.fuse_sampler,
        )  # (B, RH, RW, C)
        losses = {}
        if self.camera_decoder is not None:
            losses["camera_loss"] = self._camera_loss(batch, aux, range_proj)
        if self.color_decoder is not None:
            losses["color"] = self._color_loss(batch, aux, range_proj)
        if self.contrastive:
            pts = batch.points[..., :3]
            feats = sample_triplane_auto(triplane, pts, self.pc_range,
                                         self.voxel_size, self.fuse_sampler)
            base = crop_to_range(pts, self.pc_range) & batch.points_valid
            losses["contrastive_loss"] = sam_contrastive_loss(
                feats, batch.points, base, draws["contrastive"],
                self.max_sam_clusters)
        if self.surface_decoder is not None:
            RH, RW = aux["range_image"].shape[1:3]
            pts = aux["range_points"].reshape(B, RH * RW, 3)
            losses["surface_loss"] = self.surface_decoder(
                pts, range_proj.reshape(B, RH * RW, C), (pts != 0).any(-1),
                draws["surface"])
        if self.lidar_decoder is not None:
            ri = aux["range_image"]
            losses["range_loss"] = self.lidar_decoder.forward_loss(
                ri, self._range_pred(aux, range_proj), torch.ones_like(ri))
        return losses

    @torch.no_grad()
    def reconstructions(self, batch, mask_generator=None) -> dict:
        """The decoded images of a deterministic forward, for the eval
        CLI's ``--show-dir`` (JAX ``reconstructions``): ``triplane`` ``(B,
        3, S, S, C)`` and, where the decoders exist, ``cam_recon`` ``(B *
        N, H, W, 3)`` and ``range_recon`` ``(B, RH, RW, 1)``."""
        triplane, aux = encode_triplane(
            self.encoder, self.neck, batch, self.pc_range, self.embed_dim,
            mask_generator=mask_generator)
        range_proj = sample_triplane_auto(
            triplane, aux["range_points"], self.pc_range, self.voxel_size,
            self.fuse_sampler)
        out = {"triplane": triplane}
        if self.camera_decoder is not None:
            out["cam_recon"] = self.camera_decoder.unpatchify(
                self._camera_pred(batch, aux, range_proj))
        if self.lidar_decoder is not None:
            out["range_recon"] = self.lidar_decoder.unpatchify(
                self._range_pred(aux, range_proj))
        return out

    def _range_pred(self, aux, range_proj):
        """``lidar_decoder`` over the features of the kept pixels that
        hold a point."""
        point_mask = aux["range_active"] & (aux["range_image"] > 0)
        return self.lidar_decoder(range_proj * point_mask.to(
            range_proj.dtype))

    def _camera_pred(self, batch, aux, range_proj):
        """``camera_decoder`` over the per-camera canvases."""
        B, N, H, W, _ = batch.img.shape
        C = range_proj.shape[-1]
        return self.camera_decoder(_scatter_points_to_cameras(
            aux["rc_coors"], range_proj.reshape(B, -1, C), N, H, W))

    def _camera_loss(self, batch, aux, range_proj):
        B, N, H, W, _ = batch.img.shape
        img = batch.img.reshape(B * N, H, W, 3)
        return self.camera_decoder.forward_loss(
            img, self._camera_pred(batch, aux, range_proj),
            torch.ones_like(img))

    def _color_loss(self, batch, aux, range_proj):
        """Per-point colour regression (JAX ``_color_loss``): a point's
        colour is the image pixel at its floored ``(row, col)`` (clamped
        into the image) in each camera where its floored row is > 0;
        the MSE over those points and 3 channels, in float32.  The head
        runs once a point; every camera compares the same prediction."""
        B, N, H, W, _ = batch.img.shape
        C = range_proj.shape[-1]
        rc = aux["rc_coors"].reshape(B, N, -1, 2)
        rows = torch.floor(rc[..., 0])
        valid = rows > 0
        r = rows.clamp(0, H - 1).long()
        c = torch.floor(rc[..., 1]).clamp(0, W - 1).long()
        colors = torch.gather(batch.img.reshape(B, N, H * W, 3), 2,
                              (r * W + c)[..., None].expand(-1, -1, -1, 3))
        pred = self.color_decoder(range_proj.reshape(B, 1, -1, C))
        m = valid[..., None].float()
        return (((pred.float() - colors.float()) ** 2 * m).sum()
                / (m.sum() * 3).clamp(min=1.0))
