"""ConvNeXt backbone (channels-last at every boundary).

Counterpart of the JAX package's ``models/convnext.py``: ``MaskConvNeXt``
with the ``forward1``/``forward2`` split, kernel==stride stem and
downsample convs, and ``ConvNeXtBlock`` with layer scale and per-sample
stochastic depth.  LayerNorm eps is 1e-6 everywhere.  The out-norm that
the reference registers but never applies is not built.  Module names
follow the reference ``state_dict`` (``downsample_layers.i.j``,
``stages.i.j``).

SparK masking (the reference's ``sparse_utils.py``): an ``active_mask``
``(B, h, w, 1)`` at the coarsest resolution is nearest-upsampled to each
stage (:func:`upsample_mask`), multiplied into the downsampled features
and, in every block, after the depthwise conv and after the MLP branch;
:func:`random_active_mask` draws it.

Parameters are float32; ``dtype`` is the compute dtype.  On CUDA in
bfloat16, at the ConvNeXt widths the kernels are built for, a block
that is deterministic (inference, or a zero drop-path rate as in frozen
stages) runs K1 (``ops.kernels.convnext_block``) and any other block the
residual-free B5 epilogue (``ops.kernels.epilogue``) with drop-path and
the residual outside, as ``convnext.py:165-244`` dispatches; otherwise
the plain twins.  A masked block never runs K1, frozen or not: it is
the depthwise conv, the mask, B5, the mask again, then drop-path and the
residual (both mask multiplies commute with B5's per-pixel epilogue).
Drop-path rates are ``linspace(0, rate, sum(depths))`` over the blocks,
zero in the first ``frozen_stages`` stages.

With ``int8`` (``ops.quant.enable_int8``) both MLP products are int8,
as ``convnext.py:165-215`` dispatches: a dynamic (``int8=True``)
block that is unmasked and deterministic (or at a zero drop-path rate)
runs B10 (``ops.kernels.convnext_block_int8``, with its
straight-through backward) where K1's gate is open and B10's twin
elsewhere; every other int8 block, and every static
(``int8="static"``) block, runs the unfused route: the depthwise conv,
the mask, LayerNorm in float32 cast to the compute dtype, fc1 as an
int8 product, exact GELU, fc2 as an int8 product, gamma, the mask,
drop-path and the residual.  Dynamic products take the
straight-through backward (``ops.quant.int8_matmul``); a static block
owns the amax buffers ``fc1`` and ``fc2`` of its two product sites
(``ops.quant.quant_dense_site``) and never runs B10, which has no
static form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (
    CONVNEXT_WIDTHS,
    convnext_block,
    convnext_block_int8,
    convnext_block_int8_plain,
    convnext_block_plain,
    dwconv7,
    epilogue,
    epilogue_plain,
)
from ..ops.quant import add_site, quant_dense, quant_dense_site

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


def upsample_mask(mask, hw):
    """Nearest-upsample an active mask ``(B, h, w, 1)`` to ``hw`` (the
    reference's ``repeat_interleave``)."""
    H, W = hw
    _, h, w, _ = mask.shape
    return mask.repeat_interleave(H // h, 1).repeat_interleave(W // w, 2)


def random_active_mask(generator, batch: int, h: int, w: int,
                       mask_ratio: float, device="cpu"):
    """``(B, h, w, 1)`` bool, True = kept: exactly ``round(h * w * (1 -
    mask_ratio))`` cells of each sample, uniformly at random from
    ``generator`` (``sparse_utils.random_masking``)."""
    len_keep = round(h * w * (1.0 - mask_ratio))
    noise = torch.rand((batch, h * w), generator=generator, device=device)
    rank = noise.argsort(1).argsort(1)
    return (rank < len_keep).reshape(batch, h, w, 1)


class SparseBatchNorm2d(nn.Module):
    """BatchNorm over the active pixels of NHWC ``x`` (the reference's
    ``SparseBatchNorm2d``), masked pixels zero on output.  No shipped
    config reaches it.  The statistics are those of
    ``point_projector.MaskedBatchNorm`` (``bn``)."""

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__()
        from .point_projector import MaskedBatchNorm

        self.bn = MaskedBatchNorm(num_features, dtype)

    def forward(self, x, active_mask, train: bool = False):
        m = upsample_mask(active_mask, x.shape[1:3])[..., 0]
        y = self.bn(x, m, train)
        return y * m[..., None].to(y.dtype)


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
    -> drop-path -> residual; ``int8`` (``True`` or ``"static"``) runs
    both Linears as int8 products."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path_rate: float = 0.0, int8=False):
        super().__init__()
        self.int8 = int8
        if int8 == "static":
            add_site(self, "fc1")
            add_site(self, "fc2")
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
                generator=None, mask=None):
        """``mask`` (``(B, H, W, 1)`` in ``x``'s dtype) is SparK's: it
        multiplies the depthwise conv's output and the MLP branch."""
        mlp = (self.norm.weight, self.norm.bias, self.pwconv1.weight,
               self.pwconv1.bias, self.pwconv2.weight, self.pwconv2.bias,
               self.gamma)
        plain = deterministic or self.drop_path_rate == 0.0
        if self.int8:
            if self.int8 != "static" and mask is None and plain:
                return (convnext_block_int8 if fused
                        else convnext_block_int8_plain)(
                    x, self.dwconv.weight, self.dwconv.bias, *mlp)
            return x + drop_path(self.int8_branch(x, mask),
                                 self.drop_path_rate, deterministic,
                                 generator)
        if mask is None and plain:
            return (convnext_block if fused else convnext_block_plain)(
                x, self.dwconv.weight, self.dwconv.bias, *mlp)
        y = dwconv7(x, self.dwconv.weight, self.dwconv.bias)
        if mask is not None:
            y = y * mask
        f = (epilogue if fused else epilogue_plain)(y, *mlp)
        if mask is not None:
            f = f * mask
        return x + drop_path(f, self.drop_path_rate, deterministic,
                             generator)

    def int8_branch(self, x, mask=None):
        """The unfused int8 route's branch, before drop-path and the
        residual (``convnext.py:187-209``): dynamic or static products as
        ``int8`` says."""
        dt = x.dtype
        if self.int8 == "static":
            def dense(name, a, lin):
                return quant_dense_site(self, name, a, lin.weight, lin.bias)
        else:
            def dense(name, a, lin):
                return quant_dense(a, lin.weight, lin.bias)
        y = dwconv7(x, self.dwconv.weight, self.dwconv.bias)
        if mask is not None:
            y = y * mask
        z = F.layer_norm(y.float(), self.norm.normalized_shape,
                         self.norm.weight.float(), self.norm.bias.float(),
                         self.norm.eps).to(dt)
        h = F.gelu(dense("fc1", z, self.pwconv1))
        o = dense("fc2", h, self.pwconv2)
        if self.gamma is not None:
            o = o * self.gamma.to(dt)
        if mask is not None:
            o = o * mask
        return o


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
    the reference), and so are ``multiscale`` and ``mae_cfg``'s
    ``learnable``: they register the reference's ``reduce_dim.i`` 1x1
    convs and ``mtoken{out_indices}``, which no forward reads.
    ``out_all_scale`` makes ``forward`` return every stage's output (the
    point family's triplane encoder).
    ``frozen_stages`` zeroes the drop-path rate of the first stages;
    freezing their parameters is the trainer's concern
    (``train.trainer.freeze``).  ``int8`` (``True`` or ``"static"``) makes
    every block an int8 block.
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
        out_all_scale: bool = False,
        layer_scale_init: float = 1e-6,
        multiscale: bool = False,
        mae_cfg=None,
        int8=False,
        dtype=torch.float32,
    ):
        super().__init__()
        cfg = ARCH_SETTINGS[arch] if isinstance(arch, str) else dict(arch)
        depths, channels = cfg["depths"], cfg["channels"]
        self.out_indices = out_indices
        self.out_all_scale = out_all_scale
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
                    layer_scale_init=layer_scale_init,
                    drop_path_rate=(float(dpr[first[i] + j])
                                    if i >= frozen_stages else 0.0),
                    int8=int8,
                )
                for j in range(depths[i])
            ])
            for i in range(4)
        )
        if multiscale:  # 768 is fixed in the reference too
            self.reduce_dim = nn.ModuleList(nn.Conv2d(c, 768, 1)
                                            for c in channels)
        mae_cfg = dict(mae_cfg or {})
        if mae_cfg.get("learnable"):
            i = out_indices
            c = mae_cfg.get("downsample_dim", 768) // 2 ** (4 - i - 1)
            self.register_parameter(f"mtoken{i}", nn.Parameter(
                torch.zeros(1, c, 1, 1)))

    def kernels_on(self, x) -> bool:
        """The fused-block gate: bf16 on CUDA at a width the kernels are
        built for."""
        return (self.fuse_inference and x.is_cuda
                and self.dtype == torch.bfloat16
                and x.shape[-1] in CONVNEXT_WIDTHS)

    def run_stages(self, x, start: int, end: int, deterministic=True,
                   generator=None, active_mask=None):
        """Stages ``[start, end)``; ``active_mask`` (``(B, h, w, 1)``
        bool, SparK) is upsampled to and applied at every stage."""
        for i in range(start, end):
            x = self.downsample_layers[i](x, self.dtype)
            m = None
            if active_mask is not None:
                m = upsample_mask(active_mask, x.shape[1:3]).to(x.dtype)
                x = x * m
            fused = self.kernels_on(x)
            for blk in self.stages[i]:
                x = blk(x, fused, deterministic, generator, m)
        return x

    def forward(self, x, deterministic=True, generator=None,
                active_mask=None):
        """The last stage's output, or with ``out_all_scale`` the list of
        the four stages' outputs (finest first)."""
        outs = []
        for i in range(4):
            x = self.run_stages(x, i, i + 1, deterministic, generator,
                                active_mask)
            outs.append(x)
        return outs if self.out_all_scale else x

    def forward1(self, x, deterministic=True, generator=None,
                 active_mask=None):
        """Stages ``0..out_indices`` inclusive."""
        return self.run_stages(x, 0, self.out_indices + 1, deterministic,
                               generator, active_mask)

    def forward2(self, x, deterministic=True, generator=None,
                 active_mask=None):
        """The remaining stages."""
        return self.run_stages(x, self.out_indices + 1, 4, deterministic,
                               generator, active_mask)
