"""Shared encoder path of the range family: range + camera -> fused
strip -> neck -> ``(B, 3, S, S, C)`` triplane."""

from __future__ import annotations

import torch

from ..core.geometry import crop_to_range
from ..core.pos_embed import pos_embed_nhwc


def _pos_embed(embed_dim, hw, like):
    return torch.from_numpy(pos_embed_nhwc(embed_dim, hw)).to(
        device=like.device, dtype=like.dtype
    )


def encode_triplane(encoder_net, neck_net, batch, crop_range,
                    embed_dim: int = 768, deterministic: bool = True,
                    generator=None):
    """Returns ``(triplane (B, 3, S, S, C), aux)``.

    ``crop_range`` drives the strict-inequality point crop; range pixels
    outside it are zeroed in both the range image and the points.
    ``aux`` holds the cropped ``range_image`` and ``range_points``,
    ``range_active``, ``img_active`` and the per-camera projection coords
    ``rc_coors`` / ``rc_valid`` for the MAE decoders.
    """
    m = crop_to_range(batch.range_points, crop_range)[..., None]
    range_image = batch.range_image * m.to(batch.range_image.dtype)
    range_points = batch.range_points * m.to(batch.range_points.dtype)

    (range_feat, range_active, image_feat, img_active, rc_coors,
     rc_valid) = encoder_net(
        batch.img, range_image, range_points, batch.lidar2img, batch.cam_aug,
        deterministic, generator,
    )
    range_feat = range_feat + _pos_embed(embed_dim, range_feat.shape[1:3],
                                         range_feat)
    image_feat = image_feat + _pos_embed(embed_dim, image_feat.shape[2:4],
                                         image_feat)

    B, N, h, w, C = image_feat.shape
    combined = torch.cat(
        [range_feat, image_feat.reshape(B, N * h, w, C)], dim=1
    )
    tri = neck_net(combined)
    B, S, _, C3 = tri.shape
    triplane = tri.reshape(B, S, S, 3, C3 // 3).permute(0, 3, 1, 2, 4)
    aux = dict(range_image=range_image, range_points=range_points,
               range_active=range_active, img_active=img_active,
               rc_coors=rc_coors, rc_valid=rc_valid)
    return triplane, aux
