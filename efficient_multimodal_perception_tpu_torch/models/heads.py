"""Occupancy head and its loss."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import quant_dense


def cross_entropy_ignore(logits, targets, ignore_index: int = 255):
    """Mean cross-entropy over non-ignored voxels (f32 log-softmax)."""
    valid = targets != ignore_index
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    v = valid.to(nll.dtype)
    return (nll * v).sum() / v.sum().clamp(min=1.0)


class OccMlpHead(nn.Module):
    """C -> 2C -> C -> num_classes per-voxel MLP (bias-free, ReLU).

    The JAX package applies these weights as block-diagonal
    ``kron(I_Z, W)`` products on a z-packed tensor to avoid TPU lane
    padding; here the same weights apply per voxel on ``(..., C)``,
    which gives the same logits without the Z-fold extra work.  Names
    follow the reference (``conv1.0``, ``conv2.0``, ``conv3.0``).

    With ``int8`` each product is a dynamic int8 product whose activation
    scale covers a whole z-column ``(Z, C)`` of an ``(B, X, Y, Z, C)``
    input: the JAX package quantizes the z-packed ``(B, X, Y, Z*C)`` rows,
    and the weight scales of ``kron(I_Z, W)`` are those of ``W``.
    """

    def __init__(self, input_dim: int, num_classes: int, int8: bool = False,
                 dtype=torch.float32):
        super().__init__()
        C = input_dim
        self.int8 = int8
        self.dtype = dtype
        self.conv1 = nn.Sequential(nn.Linear(C, 2 * C, bias=False), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Linear(2 * C, C, bias=False), nn.ReLU())
        self.conv3 = nn.Sequential(nn.Linear(C, num_classes, bias=False))

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.int8:
            x = F.relu(quant_dense(x, self.conv1[0].weight, scale_dims=2))
            x = F.relu(quant_dense(x, self.conv2[0].weight, scale_dims=2))
            return quant_dense(x, self.conv3[0].weight, scale_dims=2)
        x = F.relu(F.linear(x, self.conv1[0].weight.to(dt)))
        x = F.relu(F.linear(x, self.conv2[0].weight.to(dt)))
        return F.linear(x, self.conv3[0].weight.to(dt))

    def loss(self, pred, target):
        return cross_entropy_ignore(pred, target)
