"""Generalized LSS FPN (channels-last), the point family's neck.

Counterpart of the JAX package's ``models/fpn.py``: top-down bilinear
upsample -> concat -> 1x1 ConvModule -> 3x3 ConvModule, returning only
the finest level.  A ConvModule is conv (no bias) -> BatchNorm -> ReLU.
Module names follow the reference ``state_dict``
(``lateral_convs.{i}.{conv,bn}``, ``fpn_convs.{i}.{conv,bn}``).

BatchNorm (eps 1e-5) normalizes in float32 and rounds to the compute
dtype.  In eval it uses the running statistics; with ``train`` it uses
flax ``nn.BatchNorm``'s batch statistics over (B, H, W) (float32 mean,
variance as ``max(E[x^2] - E[x]^2, 0)``, biased) and moves the running
statistics toward them (``batch_norm.batch_norm_train``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batch_norm import batch_norm_eval, batch_norm_train
from .convnext import conv_nhwc


def resize_bilinear(x, hw, align_corners: bool = False):
    """NHWC bilinear resize to ``hw``: ``F.interpolate`` (the JAX
    package's ``_resize_bilinear`` restates it)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


class _ConvModule(nn.Module):
    """conv (no bias) -> BatchNorm2d -> ReLU."""

    def __init__(self, cin: int, dim: int, kernel: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, dim, kernel, padding=kernel // 2,
                              bias=False)
        self.bn = nn.BatchNorm2d(dim, eps=1e-5)

    def forward(self, x, train: bool = False):
        norm = batch_norm_train if train else batch_norm_eval
        return torch.relu(norm(conv_nhwc(x, self.conv, self.dtype), self.bn,
                               self.dtype))


class GeneralizedLSSFPN(nn.Module):
    """Arguments mirror the reference's; ``num_outs`` and
    ``start_level`` are kept for config parity (the shipped configs use
    their defaults)."""

    def __init__(self, in_channels=(96, 192, 384, 768), out_channels=96,
                 num_outs=3, start_level=0, align_corners=False,
                 dtype=torch.float32):
        super().__init__()
        self.align_corners = align_corners
        used = len(in_channels) - 1
        cin = [in_channels[i] + (in_channels[i + 1] if i == used - 1
                                 else out_channels) for i in range(used)]
        self.lateral_convs = nn.ModuleList(
            _ConvModule(c, out_channels, 1, dtype) for c in cin)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3, dtype)
            for _ in range(used))

    def forward(self, inputs, train: bool = False):
        """``inputs``: the four NHWC stage outputs, finest first;
        ``train``: BatchNorm on batch statistics."""
        laterals = list(inputs)
        for i in range(len(laterals) - 2, -1, -1):
            up = resize_bilinear(laterals[i + 1], laterals[i].shape[1:3],
                                 self.align_corners)
            x = torch.cat([laterals[i], up.to(laterals[i].dtype)], dim=-1)
            laterals[i] = self.fpn_convs[i](self.lateral_convs[i](x, train),
                                            train)
        return laterals[0]
