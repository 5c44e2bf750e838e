"""Point -> triplane projector (counterpart of the JAX package's
``models/point_projector.py``).

Per point: BatchNorm -> (Linear, BatchNorm, ReLU) x 3 -> Linear, plus
the camera features reduced to the same width.  Then three masked
segment-max pools straight into the plane layouts
(``ops.scatter.point_plane_pools_batch``) and a per-plane MLP
(K -> C, ReLU, C -> C) over the pooled axis flattened into channels:

    xy: (B, X, Y, sz*C)   yz: (B, Y, Z, sx*C)   xz: (B, X, Z, sy*C)

Module names follow the reference ``state_dict``: ``point_mlp.{0..10}``
(BatchNorm at 0, 2, 5, 8; Linear at 1, 4, 7, 10), ``reduce_cam_channels``
and ``mlp_xy|mlp_yz|mlp_xz.{0,2}``.

On CUDA in bfloat16 at width 128 the pools keep ``-inf`` in empty cells
and each plane MLP is the B9 kernel (``ops.kernels.finite_mlp_fused``),
which zeroes them as it reads; otherwise the pools are cleaned to 0 and
the plane MLPs run as two plain products.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import FINITE_MLP_WIDTH, finite_mlp_fused
from ..ops.scatter import point_plane_pools_batch
from .batch_norm import update_running_stats


def linear(x, lin: nn.Linear, dtype):
    """``lin`` applied in ``dtype`` (the JAX package's ``nn.Dense(dtype)``)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if lin.bias is None else lin.bias.to(dtype))


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the channels of padded point rows, eps 1e-5.

    ``(x - mean) * rsqrt(var + eps) * weight + bias`` in float32,
    returned in ``dtype``.  In eval the statistics are the running ones;
    with ``train`` they are the float32 mean and biased variance over the
    valid rows of all samples together (``n = max(valid.sum(), 1)``), and
    the running statistics move toward them
    (``batch_norm.update_running_stats``).
    """

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x, valid=None, train: bool = False):
        xf = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            m = valid.float()[..., None]
            n = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(dims) / n
            var = (((xf - mean) ** 2) * m).sum(dims) / n
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean) * inv * self.weight.float()
        return (y + self.bias.float()).to(self.compute_dtype)


class PointTriplaneProjector(nn.Module):
    """Arguments mirror the reference's (``base_channels`` is accepted for
    config parity and unused, as there); ``cam_channels`` is the width of
    the per-point camera features (the camera encoder's last stage)."""

    def __init__(self, grid_size=(128, 128, 80), in_channels: int = 5,
                 out_channels: int = 128, base_channels: int = 128,
                 split=(25, 25, 20), cam_channels: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.split = tuple(split)
        self.in_channels = in_channels
        self.out_channels = C = out_channels
        self.dtype = dtype
        self.fuse_mlp = True  # False sends the plane MLPs to plain products
        dims = (in_channels, 64, 128, 256)
        layers = [MaskedBatchNorm(in_channels, dtype)]
        for i in range(3):
            layers += [nn.Linear(dims[i], dims[i + 1]),
                       MaskedBatchNorm(dims[i + 1], dtype), nn.ReLU()]
        layers.append(nn.Linear(256, C))
        self.point_mlp = nn.Sequential(*layers)
        self.reduce_cam_channels = nn.Linear(cam_channels, C)
        sx, sy, sz = self.split
        self.mlp_xy, self.mlp_yz, self.mlp_xz = (
            nn.Sequential(nn.Linear(k * C, C), nn.ReLU(), nn.Linear(C, C))
            for k in (sz, sx, sy))

    def kernel_on(self, x) -> bool:
        """The B9 gate: bf16 on CUDA at the kernel's width."""
        return (self.fuse_mlp and x.is_cuda and self.dtype == torch.bfloat16
                and self.out_channels == FINITE_MLP_WIDTH)

    def plane_mlp(self, t, mlp: nn.Sequential, fused: bool):
        fc1, fc2 = mlp[0], mlp[2]
        if fused:
            out = finite_mlp_fused(
                t.reshape(-1, t.shape[-1]),
                fc1.weight.to(t.dtype).contiguous(), fc1.bias.float(),
                fc2.weight.to(t.dtype).contiguous(), fc2.bias.float())
            return out.reshape(*t.shape[:3], self.out_channels)
        return linear(torch.relu(linear(t, fc1, self.dtype)), fc2, self.dtype)

    def forward(self, points, grid_idx, valid, cam_feats, train: bool = False):
        """Args:
            points: ``(B, P, >=in_channels)`` padded points (xyzir used).
            grid_idx: ``(B, P, 3)`` integer voxel indices.
            valid: ``(B, P)`` bool (in range and real).
            cam_feats: ``(B, P, cam_channels)`` per-point camera features.
            train: BatchNorm on the valid rows' batch statistics (and
                their running statistics updated) instead of the running
                ones.

        Returns the three NHWC planes: xy ``(B, X, Y, C)``, yz
        ``(B, Y, Z, C)``, xz ``(B, X, Z, C)``.
        """
        B = points.shape[0]
        dt = self.dtype
        m = self.point_mlp
        x = m[0](points[..., :self.in_channels], valid, train)
        for i in (1, 4, 7):
            x = torch.relu(m[i + 1](linear(x, m[i], dt), valid, train))
        cam = linear(cam_feats, self.reduce_cam_channels, dt)
        feats = linear(x, m[10], dt) + cam
        fused = self.kernel_on(feats)
        xy, yz, xz = point_plane_pools_batch(feats, grid_idx, valid,
                                             self.grid_size, self.split,
                                             raw=fused)
        X, Y, Z = self.grid_size
        return [self.plane_mlp(t.reshape(B, h, w, -1), mlp, fused)
                for t, (h, w), mlp in ((xy, (X, Y), self.mlp_xy),
                                       (yz, (Y, Z), self.mlp_yz),
                                       (xz, (X, Z), self.mlp_xz))]
