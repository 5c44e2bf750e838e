"""Task heads and their losses: the occupancy Mlp head (cross-entropy),
the per-point MLP (the MAE colour head) and the elevation heads, the
U-Net and the one-block head (masked MSE)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import add_site, quant_dense, quant_dense_site
from .batch_norm import FLAX_DEFAULT, batch_norm_eval, batch_norm_train
from .convnext import conv_nhwc


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

    With ``int8=True`` each product is a dynamic int8 product whose
    activation scale covers a whole z-column ``(Z, C)`` of an ``(B, X, Y,
    Z, C)`` input: the JAX package quantizes the z-packed ``(B, X, Y,
    Z*C)`` rows, and the weight scales of ``kron(I_Z, W)`` are those of
    ``W``.  With ``int8="static"`` the three products are the static
    sites ``mm1``, ``mm2`` and ``mm3`` (amax buffers of this module, as
    ``heads.py:74-80``): one amax over the whole tensor, packed or not.
    """

    def __init__(self, input_dim: int, num_classes: int, int8=False,
                 dtype=torch.float32):
        super().__init__()
        C = input_dim
        self.int8 = int8
        self.dtype = dtype
        self.conv1 = nn.Sequential(nn.Linear(C, 2 * C, bias=False), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Linear(2 * C, C, bias=False), nn.ReLU())
        self.conv3 = nn.Sequential(nn.Linear(C, num_classes, bias=False))
        if int8 == "static":
            for name in ("mm1", "mm2", "mm3"):
                add_site(self, name)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.int8:
            if self.int8 == "static":
                def mm(i, a, w):
                    return quant_dense_site(self, f"mm{i}", a, w,
                                            scale_dims=2)
            else:
                def mm(i, a, w):
                    return quant_dense(a, w, scale_dims=2)
            x = F.relu(mm(1, x, self.conv1[0].weight))
            x = F.relu(mm(2, x, self.conv2[0].weight))
            return mm(3, x, self.conv3[0].weight)
        x = F.relu(F.linear(x, self.conv1[0].weight.to(dt)))
        x = F.relu(F.linear(x, self.conv2[0].weight.to(dt)))
        return F.linear(x, self.conv3[0].weight.to(dt))

    def loss(self, pred, target):
        return cross_entropy_ignore(pred, target)


class PointMlpHead(nn.Module):
    """Per-point MLP (``PointMlp``, the MAE colour head): two ReLU then
    ``Linear(C, C)`` layers, the activation BEFORE each hidden product as
    in the reference, then ``fc_out``.  Names follow the reference
    (``mlp_layers.i``, ``fc_out``)."""

    def __init__(self, input_dim: int, num_classes: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp_layers = nn.ModuleList(nn.Linear(input_dim, input_dim)
                                        for _ in range(2))
        self.fc_out = nn.Linear(input_dim, num_classes)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        for lin in self.mlp_layers:
            x = F.linear(F.relu(x), lin.weight.to(dt), lin.bias.to(dt))
        return F.linear(x, self.fc_out.weight.to(dt), self.fc_out.bias.to(dt))


def masked_mse_loss(pred, target, mask):
    """Masked MSE in float32: the squared masked difference summed over
    the mask count (+ 1e-8), as the reference's ``unet.py:66-82``."""
    m = mask.float()
    loss = (pred.float() * m - target.float() * m) ** 2
    return loss.sum() / (m.sum() + 1e-8)


def _bn(dim: int) -> nn.BatchNorm2d:
    """The elevation heads' BatchNorm: eps 1e-5 and flax's default decay
    0.99 (the JAX package sets no ``momentum`` there), PyTorch's
    ``momentum`` 0.01."""
    return nn.BatchNorm2d(dim, eps=1e-5, momentum=FLAX_DEFAULT)


def _norm(train: bool):
    return batch_norm_train if train else batch_norm_eval


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock`` over NHWC maps: conv3x3 (stride) -> BN
    -> ReLU -> conv3x3 -> BN, plus the input, or its 1x1 conv + BN
    (``downsample``) when the shape changes, then ReLU.  Reference names
    (``conv1 / bn1 / conv2 / bn2 / downsample.0 / downsample.1``)."""

    def __init__(self, cin: int, dim: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, dim, 3, stride, 1, bias=False)
        self.bn1 = _bn(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, 1, 1, bias=False)
        self.bn2 = _bn(dim)
        self.downsample = None
        if stride != 1 or cin != dim:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, dim, 1, stride, bias=False), _bn(dim))

    def forward(self, x, train: bool = False):
        dt, norm = self.dtype, _norm(train)
        y = torch.relu(norm(conv_nhwc(x, self.conv1, dt), self.bn1, dt))
        y = norm(conv_nhwc(y, self.conv2, dt), self.bn2, dt)
        r = x
        if self.downsample is not None:
            conv, bn = self.downsample
            r = norm(conv_nhwc(x, conv, dt), bn, dt)
        return torch.relu(y + r)


def _collapse(x, proj: nn.Sequential, dtype):
    """``(B, X, Y, Z, C)`` voxel features -> the 3x3x3 conv to one channel
    and ReLU, ``(B, X, Y, Z)``: an NHWC map with the heights as channels."""
    conv = proj[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), conv.weight.to(dtype),
                 None, conv.stride, conv.padding)
    return torch.relu(y[:, 0])


def _upsample2x(x):
    """NHWC nearest-neighbour 2x upsampling (``jax.image.resize``
    "nearest" at an exact factor of 2: output pixel i reads i // 2)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


class _ConvBnRelu(nn.Sequential):
    """smp's ``Conv2dReLU``: conv3x3 (no bias), BN, ReLU; names ``0`` /
    ``1``."""

    def __init__(self, cin: int, dim: int):
        super().__init__(nn.Conv2d(cin, dim, 3, padding=1, bias=False),
                         _bn(dim))

    def run(self, x, train: bool, dtype):
        return torch.relu(_norm(train)(conv_nhwc(x, self[0], dtype), self[1],
                                       dtype))


ENC_DEPTHS = (3, 4, 6, 3)
ENC_DIMS = (64, 128, 256, 512)
DEC_DIMS = (256, 128, 64, 32, 16)


class _SmpUnet(nn.Module):
    """``segmentation_models_pytorch.Unet(resnet34, classes=1)``'s modules
    under its state names: ``encoder.{conv1, bn1, layer1..4}``,
    ``decoder.blocks.{i}.conv{1,2}.{0,1}``, ``segmentation_head.0``."""

    def __init__(self, in_channels: int, dtype=torch.float32):
        super().__init__()
        enc = nn.Module()
        enc.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        enc.bn1 = _bn(64)
        cin = 64
        for i, (depth, dim) in enumerate(zip(ENC_DEPTHS, ENC_DIMS)):
            setattr(enc, f"layer{i + 1}", nn.Sequential(*(
                BasicBlock(cin if j == 0 else dim, dim,
                           2 if (j == 0 and i > 0) else 1, dtype)
                for j in range(depth))))
            cin = dim
        self.encoder = enc
        # skips, deepest first: layer3, layer2, layer1, the stem; smp drops
        # the full-resolution input, so the last block has none
        skip_dims = ENC_DIMS[-2::-1] + (64, 0)
        dec = nn.Module()
        dec.blocks = nn.ModuleList()
        prev = ENC_DIMS[-1]
        for dim, skip in zip(DEC_DIMS, skip_dims):
            blk = nn.Module()
            blk.conv1 = _ConvBnRelu(prev + skip, dim)
            blk.conv2 = _ConvBnRelu(dim, dim)
            dec.blocks.append(blk)
            prev = dim
        self.decoder = dec
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(DEC_DIMS[-1], 1, 3, padding=1))


class ElevUNetHead(nn.Module):
    """Elevation head (counterpart of the JAX package's ``ElevUNetHead``,
    the reference's ``dense_heads/unet.py``): a 3x3x3 conv collapses the
    voxel features to one channel (ReLU), the heights become the channels,
    the map is zero-padded by ``pad`` (100 -> 128), then smp's resnet34
    U-Net: a 7x7/s2 stem (BN, ReLU), a 3/s2/p1 max pool (-inf padding),
    the stages (3, 4, 6, 3) x (64, 128, 256, 512), the decoder (256, 128,
    64, 32, 16) whose blocks each upsample 2x (nearest), concatenate a
    skip (the last block none) and run two conv-BN-ReLU, a 3x3 head with
    bias, and the crop back.

    Every tensor is NHWC; each conv runs in ``dtype`` and each BatchNorm
    in float32 (``batch_norm.batch_norm_eval``, or with ``train`` its
    batch statistics and running update at flax's decay 0.99).  Names
    are the reference ``state_dict``'s: ``proj.0``, ``decoder.encoder.*``,
    ``decoder.decoder.blocks.*``, ``decoder.segmentation_head.0``.
    """

    def __init__(self, input_dim: int, height_dim: int, pad: int = 14,
                 dtype=torch.float32):
        super().__init__()
        self.pad = pad
        self.dtype = dtype
        self.proj = nn.Sequential(
            nn.Conv3d(input_dim, 1, 3, 1, 1, bias=False), nn.ReLU())
        self.decoder = _SmpUnet(height_dim, dtype)

    def forward(self, x, train: bool = False):
        """x: ``(B, X, Y, Z, C)`` voxel features -> ``(B, X, Y)`` heights
        in ``dtype``."""
        _, X, Y, _, _ = x.shape
        dt, p = self.dtype, self.pad
        y = F.pad(_collapse(x, self.proj, dt), (0, 0, p, p, p, p))
        enc = self.decoder.encoder
        stem = torch.relu(_norm(train)(conv_nhwc(y, enc.conv1, dt), enc.bn1,
                                       dt))
        h = F.max_pool2d(stem.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        feats = [stem]
        for i in range(len(ENC_DEPTHS)):
            for blk in getattr(enc, f"layer{i + 1}"):
                h = blk(h, train)
            feats.append(h)
        skips = feats[-2::-1]  # layer3, layer2, layer1, stem
        for i, blk in enumerate(self.decoder.decoder.blocks):
            h = _upsample2x(h)
            if i < len(skips):
                h = torch.cat([h, skips[i]], dim=-1)
            h = blk.conv2.run(blk.conv1.run(h, train, dt), train, dt)
        out = conv_nhwc(h, self.decoder.segmentation_head[0], dt)[..., 0]
        return out[:, p:p + X, p:p + Y]

    def loss(self, pred, target, mask):
        return masked_mse_loss(pred, target, mask)


class ResnetBasicBlockHead(nn.Module):
    """Lighter elevation head (the JAX package's ``ResnetBasicBlockHead``,
    the reference's ``resnet_basic_block.py``): the same 3x3x3 collapse
    (``proj.0``), one :class:`BasicBlock` over the heights as channels
    (``block``; the JAX names are flax's automatic ``Conv_0``,
    ``_ResBlock_0``, ``Conv_1``) and a 1x1 conv with bias to one channel
    (``head``)."""

    def __init__(self, input_dim: int, height_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Sequential(
            nn.Conv3d(input_dim, 1, 3, 1, 1, bias=False), nn.ReLU())
        self.block = BasicBlock(height_dim, height_dim, 1, dtype)
        self.head = nn.Conv2d(height_dim, 1, 1)

    def forward(self, x, train: bool = False):
        y = self.block(_collapse(x, self.proj, self.dtype), train)
        return conv_nhwc(y, self.head, self.dtype)[..., 0]

    def loss(self, pred, target, mask):
        return masked_mse_loss(pred, target, mask)
