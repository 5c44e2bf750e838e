"""Joint camera + range encoder with the cross-modal exchange.

Counterpart of the JAX package's ``models/joint_encoder.py``:

1. every range pixel's 3-D point is projected into every camera,
2. camera features are gathered at the projected coords and summed over
   cameras onto the range image (masked gather-sum; the B8 kernel,
   ``ops.kernels.cam_gather_sum_op``, for bf16 features on CUDA),
3. a 3-layer MLP positional encoding of the points is written into the
   camera feature maps with LAST-write-wins semantics on collisions
   (``ops.scatter.last_write_winner_batch`` then a row gather).

MAE masking (SparK, mask ratios > 0): the camera images get a keep-mask
at ``camera_mask_scale`` (16 x 16 pixels a cell) over ``forward1`` and
``forward2``, and the range image one at ``lidar_mask_scale`` (1 x 32),
applied to the range image before the interact (a masked pixel sends
and receives nothing there) and over the range encoder.  The masks come
from :meth:`JointEncoder.draw` and a ``mask_generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.geometry import project_points_to_cameras
from ..ops import kernels as K
from ..ops.scatter import last_write_winner_batch
from .convnext import MaskConvNeXt, random_active_mask, upsample_mask


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
    the fused ``1 + C`` channel range image -> camera ``forward2``.
    ``int8`` (``False``, ``True`` or ``"static"``, ``joint_encoder.py:73``)
    passes to both ConvNeXts."""

    def __init__(
        self,
        lidar_encoder: dict,
        camera_encoder: dict,
        lidar_mask_ratio: float = 0.0,
        camera_mask_ratio: float = 0.0,
        lidar_mask_scale=(1, 32),
        camera_mask_scale=(16, 16),
        image_hw=(256, 512),
        embed_dims: int = 192,
        int8=False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.lidar_mask_ratio = lidar_mask_ratio
        self.camera_mask_ratio = camera_mask_ratio
        self.lidar_mask_scale = tuple(lidar_mask_scale)
        self.camera_mask_scale = tuple(camera_mask_scale)
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

    @property
    def masked(self) -> bool:
        """Whether the forward draws MAE masks."""
        return self.lidar_mask_ratio > 0.0 or self.camera_mask_ratio > 0.0

    def draw(self, B: int, N: int, image_hw, range_hw, generator) -> dict:
        """The keep-masks of one forward from ``generator``: ``camera``
        ``(B * N, H / 16, W / 16, 1)`` and ``lidar`` ``(B, RH, RW / 32,
        1)`` bool (at the mask scales), each present when its ratio is
        > 0; the camera's is drawn first."""
        out = {}
        if not self.masked:
            return out
        if generator is None:
            raise ValueError("a mask ratio > 0 draws its masks from "
                             "mask_generator")
        dev = self.position_encoder[0].weight.device
        if self.camera_mask_ratio > 0.0:
            out["camera"] = random_active_mask(
                generator, B * N, image_hw[0] // self.camera_mask_scale[0],
                image_hw[1] // self.camera_mask_scale[1],
                self.camera_mask_ratio, dev)
        if self.lidar_mask_ratio > 0.0:
            out["lidar"] = random_active_mask(
                generator, B, range_hw[0] // self.lidar_mask_scale[0],
                range_hw[1] // self.lidar_mask_scale[1],
                self.lidar_mask_ratio, dev)
        return out

    def forward(self, img, range_image, range_points, lidar2img, cam_aug,
                deterministic: bool = True, generator=None,
                mask_generator=None):
        """Args:
            img: ``(B, N, H, W, 3)``; range_image ``(B, RH, RW, 1)``;
            range_points ``(B, RH, RW, 3)``; lidar2img ``(B, N, 4, 4)``.
            deterministic / generator: drop-path off, or its draws.
            mask_generator: the MAE masks' draws (:meth:`draw`).

        Returns the JAX package's six-tuple ``(range_features (B, h, w,
        C), range_active (B, RH, RW, 1) bool, image_features (B, N, h',
        w', C), img_active ((B * N, H / 16, W / 16, 1) bool, or None
        without camera masking), range_cam_coors (B, N, RH, RW, 2),
        range_cam_valid (B, N, RH, RW))``.
        """
        B, N, H, W, _ = img.shape
        masks = self.draw(B, N, (H, W), range_image.shape[1:3],
                          mask_generator)
        img_active = masks.get("camera")
        mid = self.camera_encoder.forward1(img.reshape(B * N, H, W, 3),
                                           deterministic, generator,
                                           img_active)
        _, h1, w1, c1 = mid.shape
        mid = mid.reshape(B, N, h1, w1, c1)
        range_low = masks.get("lidar")
        if range_low is None:
            range_active = torch.ones_like(range_image, dtype=torch.bool)
        else:
            range_active = upsample_mask(range_low, range_image.shape[1:3])
            range_image = range_image * range_active.to(range_image.dtype)
        fused, mid, coors, coors_valid = self.interact(
            mid, range_image, range_points, lidar2img, cam_aug
        )
        range_features = self.lidar_encoder(fused, deterministic, generator,
                                            range_low)
        image_features = self.camera_encoder.forward2(
            mid.reshape(B * N, h1, w1, c1), deterministic, generator,
            img_active
        )
        image_features = image_features.reshape(
            B, N, *image_features.shape[1:]
        )
        return (range_features, range_active, image_features, img_active,
                coors, coors_valid)

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
