"""Joint camera + range encoder with the cross-modal exchange.

Counterpart of the JAX package's ``models/joint_encoder.py``:

1. every range pixel's 3-D point is projected into every camera,
2. camera features are gathered at the projected coords and summed over
   cameras onto the range image (masked gather-sum; the B8 kernel,
   ``ops.kernels.cam_gather_sum_op``, for bf16 features on CUDA),
3. a 3-layer MLP positional encoding of the points is written into the
   camera feature maps with LAST-write-wins semantics on collisions
   (``ops.scatter.last_write_winner_batch`` then a row gather).

MAE masking (mask ratios > 0) belongs to the pretrain path and is not
ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.geometry import project_points_to_cameras
from ..ops import kernels as K
from ..ops.scatter import last_write_winner_batch
from .convnext import MaskConvNeXt


def project_to_features(range_image, range_points, lidar2img, cam_aug,
                        image_hw, feat_hw):
    """Step (1) of the interact: every range pixel's point projected into
    every camera.

    Returns ``(coords (B, N, P, 2)`` image xy, ``valid (B, N, P)`` (in the
    image and the pixel holds a point), ``active_valid`` (valid and not
    masked), ``flat_f (B, N, P)`` int32 row of the ``feat_hw`` feature
    map the point lands in)``.
    """
    B, RH, RW, _ = range_image.shape
    P = RH * RW
    IH, IW = image_hw
    h1, w1 = feat_hw
    pts = range_points.reshape(B, P, 3)
    coords, in_img = project_points_to_cameras(
        pts, lidar2img, cam_aug, (IH, IW)
    )  # (B, N, P, 2) xy, (B, N, P)
    has_point = (pts != 0).any(-1)
    unmasked = (range_image > 0).reshape(B, P)
    valid = in_img & has_point[:, None, :]
    active_valid = valid & unmasked[:, None, :]
    # feature-scale integer coords (floor == trunc for valid >= 0);
    # clamped in float first so out-of-image values stay defined
    col_f = torch.floor(coords[..., 0] * (w1 / IW)).clamp(0, w1 - 1)
    row_f = torch.floor(coords[..., 1] * (h1 / IH)).clamp(0, h1 - 1)
    flat_f = (row_f * w1 + col_f).to(torch.int32)
    return coords, valid, active_valid, flat_f


def gather_kernel_active(feats) -> bool:
    """Whether the interact's gather-sum runs B8: bf16 features on CUDA.

    The JAX package runs its kernel for bf16 on the TPU while the camera
    block is <= 10 MB and the one-hot work <= 4e11 flop a row
    (``joint_encoder.py:273-280``).  Those two limits bound the TPU form:
    its VMEM-resident ``(K, C)`` block and its one-hot MXU work.  B8 is a
    direct gather with neither, so only the dtype and device remain.
    """
    return feats.is_cuda and feats.dtype == torch.bfloat16


class JointEncoder(nn.Module):
    """Camera ConvNeXt ``forward1`` -> interact -> range ConvNeXt over
    the fused ``1 + C`` channel range image -> camera ``forward2``."""

    def __init__(
        self,
        lidar_encoder: dict,
        camera_encoder: dict,
        lidar_mask_ratio: float = 0.0,
        camera_mask_ratio: float = 0.0,
        image_hw=(256, 512),
        embed_dims: int = 192,
        int8: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        if lidar_mask_ratio or camera_mask_ratio:
            raise NotImplementedError("MAE masking is not ported")
        self.image_hw = tuple(image_hw)
        self.dtype = dtype
        self.lidar_encoder = MaskConvNeXt(**lidar_encoder, int8=int8,
                                          dtype=dtype)
        self.camera_encoder = MaskConvNeXt(**camera_encoder, int8=int8,
                                           dtype=dtype)
        self.fuse_gather = True  # False sends B8's site to the plain math
        self.position_encoder = nn.Sequential(
            nn.Linear(3, embed_dims * 4),
            nn.ReLU(),
            nn.Linear(embed_dims * 4, embed_dims),
        )

    def encode_positions(self, pts):
        """``(..., 3)`` points -> ``(..., D)`` encodings in ``dtype``."""
        dt = self.dtype
        fc1, fc2 = self.position_encoder[0], self.position_encoder[2]
        x = F.relu(F.linear(pts.to(dt), fc1.weight.to(dt), fc1.bias.to(dt)))
        return F.linear(x, fc2.weight.to(dt), fc2.bias.to(dt))

    def forward(self, img, range_image, range_points, lidar2img, cam_aug,
                deterministic: bool = True, generator=None):
        """Args:
            img: ``(B, N, H, W, 3)``; range_image ``(B, RH, RW, 1)``;
            range_points ``(B, RH, RW, 3)``; lidar2img ``(B, N, 4, 4)``.
            deterministic / generator: drop-path off, or its draws.

        Returns the JAX package's six-tuple ``(range_features (B, h, w,
        C), range_active (B, RH, RW, 1) bool, image_features (B, N, h',
        w', C), img_active (None: no masking), range_cam_coors (B, N, RH,
        RW, 2), range_cam_valid (B, N, RH, RW))``.
        """
        B, N, H, W, _ = img.shape
        mid = self.camera_encoder.forward1(img.reshape(B * N, H, W, 3),
                                           deterministic, generator)
        _, h1, w1, c1 = mid.shape
        mid = mid.reshape(B, N, h1, w1, c1)
        range_active = torch.ones_like(range_image, dtype=torch.bool)
        fused, mid, coors, coors_valid = self.interact(
            mid, range_image, range_points, lidar2img, cam_aug
        )
        range_features = self.lidar_encoder(fused, deterministic, generator)
        image_features = self.camera_encoder.forward2(
            mid.reshape(B * N, h1, w1, c1), deterministic, generator
        )
        image_features = image_features.reshape(
            B, N, *image_features.shape[1:]
        )
        return (range_features, range_active, image_features, None, coors,
                coors_valid)

    def interact(self, img_features, range_image, range_points, lidar2img,
                 cam_aug):
        """Returns the fused ``(B, RH, RW, 1 + C)`` range input, the
        updated camera features, full-resolution ``(row, col)`` coords
        ``(B, N, RH, RW, 2)`` (-1 where invalid; the pretrain decoders'
        input) and their validity."""
        B, N, h1, w1, C = img_features.shape
        _, RH, RW, _ = range_image.shape
        P = RH * RW
        pts = range_points.reshape(B, P, 3)
        coords, valid, active_valid, flat_f = project_to_features(
            range_image, range_points, lidar2img, cam_aug, self.image_hw,
            (h1, w1))

        # (2) gather camera features onto range pixels, sum over cameras
        feats = img_features.reshape(B, N, h1 * w1, C)
        if self.fuse_gather and gather_kernel_active(feats):
            cam_range = K.cam_gather_sum_op(
                feats.contiguous(), flat_f,
                active_valid.to(torch.uint8)).reshape(B, RH, RW, C)
        else:
            gathered = torch.gather(
                feats, 2, flat_f.long()[..., None].expand(B, N, P, C)
            )
            cam_range = (
                gathered * active_valid[..., None].to(gathered.dtype)
            ).sum(1).reshape(B, RH, RW, C)

        # (3) last-write positional-encoding scatter into the camera maps
        pe = self.encode_positions(pts)  # (B, P, C)
        flat_bn = flat_f.reshape(B * N, P)
        winner = last_write_winner_batch(
            flat_bn // w1, flat_bn % w1, active_valid.reshape(B * N, P),
            h1, w1,
        ).reshape(B, N, h1 * w1)
        vals = torch.gather(
            pe[:, None].expand(B, N, P, C), 2,
            winner.clamp(min=0)[..., None].expand(B, N, h1 * w1, C),
        )
        add = torch.where(winner[..., None] >= 0,
                          vals.to(img_features.dtype),
                          torch.zeros((), dtype=img_features.dtype,
                                      device=img_features.device))
        img_features = img_features + add.reshape(B, N, h1, w1, C)

        rc = torch.stack([coords[..., 1], coords[..., 0]], dim=-1)
        rc = torch.where(valid[..., None], rc, torch.full_like(rc, -1.0))
        rc = rc.reshape(B, N, RH, RW, 2)

        fused = torch.cat(
            [range_image, cam_range.to(range_image.dtype)], dim=-1
        )
        return fused, img_features, rc, valid.reshape(B, N, RH, RW)
