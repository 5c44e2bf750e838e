"""ConvNeXt backbone (channels-last at every boundary).

Counterpart of the JAX package's ``models/convnext.py``: ``MaskConvNeXt``
with the ``forward1``/``forward2`` split, kernel==stride stem and
downsample convs, and ``ConvNeXtBlock`` with layer scale and per-sample
stochastic depth.  LayerNorm eps is 1e-6 everywhere.  The out-norm that
the reference registers but never applies is not built.  Module names
follow the reference ``state_dict`` (``downsample_layers.i.j``,
``stages.i.j``).  SparK masking is not ported.

Parameters are float32; ``dtype`` is the compute dtype.  On CUDA in
bfloat16, at the ConvNeXt widths the kernels are built for, a block
that is deterministic (inference, or a zero drop-path rate as in frozen
stages) runs K1 (``ops.kernels.convnext_block``) and any other block the
residual-free B5 epilogue (``ops.kernels.epilogue``) with drop-path and
the residual outside, as ``convnext.py:165-244`` dispatches; otherwise
the plain twins.  Drop-path rates are ``linspace(0, rate, sum(depths))``
over the blocks, zero in the first ``frozen_stages`` stages.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (
    CONVNEXT_WIDTHS,
    convnext_block,
    convnext_block_plain,
    dwconv7,
    epilogue,
    epilogue_plain,
)

ARCH_SETTINGS = {
    "tiny": {"depths": (3, 3, 9, 3), "channels": (96, 192, 384, 768)},
    "small": {"depths": (3, 3, 27, 3), "channels": (96, 192, 384, 768)},
    "base": {"depths": (3, 3, 27, 3), "channels": (128, 256, 512, 1024)},
    "large": {"depths": (3, 3, 27, 3), "channels": (192, 384, 768, 1536)},
}


def layer_norm(x, ln: nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics, output in
    ``x``'s dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def conv_nhwc(x, conv: nn.Conv2d, dtype):
    """``conv`` applied to NHWC ``x`` in ``dtype``; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                 None if conv.bias is None else conv.bias.to(dtype),
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def drop_path(x, rate: float, deterministic: bool, generator=None):
    """Per-sample stochastic depth (timm ``DropPath``): each sample along
    the leading axis is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``, or zeroed.  Identity when ``deterministic`` or at
    rate 0.  The keep draws come from ``generator`` (on ``x``'s device)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> Linear C->4C -> GELU -> Linear 4C->C -> gamma
    -> drop-path -> residual."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.layer_scale_init = layer_scale_init
        self.drop_path_rate = drop_path_rate
        self.gamma = (
            nn.Parameter(layer_scale_init * torch.ones(dim))
            if layer_scale_init > 0 else None
        )

    def forward(self, x, fused: bool = False, deterministic: bool = True,
                generator=None):
        mlp = (self.norm.weight, self.norm.bias, self.pwconv1.weight,
               self.pwconv1.bias, self.pwconv2.weight, self.pwconv2.bias,
               self.gamma)
        if deterministic or self.drop_path_rate == 0.0:
            return (convnext_block if fused else convnext_block_plain)(
                x, self.dwconv.weight, self.dwconv.bias, *mlp)
        y = dwconv7(x, self.dwconv.weight, self.dwconv.bias)
        f = (epilogue if fused else epilogue_plain)(y, *mlp)
        return x + drop_path(f, self.drop_path_rate, False, generator)


class _Stem(nn.Sequential):
    """kernel==stride patch conv then LN (``downsample_layers.0``)."""

    def __init__(self, cin, dim, kernel):
        super().__init__(
            nn.Conv2d(cin, dim, kernel, stride=kernel),
            nn.LayerNorm(dim, eps=1e-6),
        )

    def forward(self, x, dtype):
        return layer_norm(conv_nhwc(x, self[0], dtype), self[1])


class _Downsample(nn.Sequential):
    """LN then kernel==stride conv (``downsample_layers.i``, i > 0)."""

    def __init__(self, cin, dim, kernel):
        super().__init__(
            nn.LayerNorm(cin, eps=1e-6),
            nn.Conv2d(cin, dim, kernel, stride=kernel),
        )

    def forward(self, x, dtype):
        return conv_nhwc(layer_norm(x, self[0]), self[1], dtype)


class MaskConvNeXt(nn.Module):
    """4-stage ConvNeXt with a non-square stem (dense).

    ``norm_out`` is accepted for config parity (the out-norm is dead in
    the reference).  ``frozen_stages`` zeroes the drop-path rate of the
    first stages; freezing their parameters is the trainer's concern
    (``train.trainer.freeze``).
    """

    def __init__(
        self,
        arch="tiny",
        in_channels: int = 3,
        stem_patch_size=(4, 4),
        downsample_height: bool = True,
        drop_path_rate: float = 0.0,
        out_indices: int = 3,
        norm_out: bool = False,
        frozen_stages: int = 0,
        dtype=torch.float32,
    ):
        super().__init__()
        cfg = ARCH_SETTINGS[arch] if isinstance(arch, str) else dict(arch)
        depths, channels = cfg["depths"], cfg["channels"]
        self.out_indices = out_indices
        self.frozen_stages = frozen_stages
        self.fuse_inference = True  # False sends every block to the twin
        self.dtype = dtype
        down = (2, 2) if downsample_height else (1, 2)
        self.downsample_layers = nn.ModuleList(
            [_Stem(in_channels, channels[0], tuple(stem_patch_size))]
            + [_Downsample(channels[i - 1], channels[i], down)
               for i in range(1, 4)]
        )
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        first = np.cumsum((0,) + tuple(depths))
        self.stages = nn.ModuleList(
            nn.Sequential(*[
                ConvNeXtBlock(
                    channels[i],
                    drop_path_rate=(float(dpr[first[i] + j])
                                    if i >= frozen_stages else 0.0),
                )
                for j in range(depths[i])
            ])
            for i in range(4)
        )

    def kernels_on(self, x) -> bool:
        """The fused-block gate: bf16 on CUDA at a width the kernels are
        built for."""
        return (self.fuse_inference and x.is_cuda
                and self.dtype == torch.bfloat16
                and x.shape[-1] in CONVNEXT_WIDTHS)

    def run_stages(self, x, start: int, end: int, deterministic=True,
                   generator=None):
        for i in range(start, end):
            x = self.downsample_layers[i](x, self.dtype)
            fused = self.kernels_on(x)
            for blk in self.stages[i]:
                x = blk(x, fused, deterministic, generator)
        return x

    def forward(self, x, deterministic=True, generator=None):
        return self.run_stages(x, 0, 4, deterministic, generator)

    def forward1(self, x, deterministic=True, generator=None):
        """Stages ``0..out_indices`` inclusive."""
        return self.run_stages(x, 0, self.out_indices + 1, deterministic,
                               generator)

    def forward2(self, x, deterministic=True, generator=None):
        """The remaining stages."""
        return self.run_stages(x, self.out_indices + 1, 4, deterministic,
                               generator)
