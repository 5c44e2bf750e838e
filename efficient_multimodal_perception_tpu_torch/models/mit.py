"""MixVisionTransformer neck and MAE decoder head (channels-last at the
public boundary).

Counterpart of the JAX package's ``models/mit.py``: the neck (1x1 patch
embed, two MiT blocks with 4 heads and sr_ratio 1, MixFFN with a 3x3
depthwise conv, the square token reshape, pixel shuffle and two 3x3
convs) and ``MixVisionTransformerHead``, the reconstruction decoder
(overlapping patch embed, two sr_ratio=4 blocks whose keys and values
come from a strided conv of the token grid, a 1x1 prediction conv,
``patchify``/``unpatchify`` and the patch MSE).  LayerNorm eps is 1e-6
(flax's default), not torch's 1e-5.  Module names follow the reference
``state_dict`` (``transformer_block.i.attn.q``, ``attn.sr``,
``attn.norm`` for the reduced tokens' LayerNorm ...).

Dispatch mirrors the JAX gates with "on TPU" read as "tensor on CUDA":
the fused LN->GEMM / GELU->GEMM route needs bf16, ``(B*N) % 1024 == 0``,
``C % 128 == 0`` and sr_ratio 1; the attention kernel needs bf16,
``Nq % 512 == 0``, ``Nk % 128 == 0`` and ``Nq*Nk >= 1e6``.  Closed gates
run the kernels' plain twins.  The kernel routes are differentiable:
the attention backward is the B6 kernel, the prologues' backward is
autograd of their plain math, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (
    attention_op,
    attention_plain,
    gelu_dense,
    gelu_dense_plain,
    ln_dense,
    ln_dense_plain,
)
from .convnext import conv_nhwc, layer_norm


def fused_prologue_active(shape, x) -> bool:
    B, N, C = shape
    return (x.is_cuda and x.dtype == torch.bfloat16
            and (B * N) % 1024 == 0 and C % 128 == 0)


def fused_attention_active(x, n_q: int, n_kv: int) -> bool:
    return (x.is_cuda and x.dtype == torch.bfloat16 and n_q % 512 == 0
            and n_kv % 128 == 0 and n_q * n_kv >= 1_000_000)


def _linear(x, lin: nn.Linear):
    dt = x.dtype
    return F.linear(x, lin.weight.to(dt),
                    None if lin.bias is None else lin.bias.to(dt))


def _heads(t, B, h, hd):
    """(B, N, h*hd) -> (B*h, N, hd), contiguous: at B=1 the reshape can
    return a strided view and the kernels take contiguous rows only."""
    return t.reshape(B, -1, h, hd).transpose(1, 2).reshape(
        B * h, -1, hd).contiguous()


class EfficientAttention(nn.Module):
    """SegFormer attention, no q/kv bias.  With sr_ratio 1 it is fed by a
    fused LN -> q|kv product; with sr_ratio > 1 the keys and values come
    from the LN'd tokens reduced by an ``sr_ratio``-strided conv and a
    LayerNorm (``attn.norm``, the JAX package's ``sr_norm``)."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.fuse_attention: Optional[bool] = None  # None = auto
        self.q = nn.Linear(dim, dim, bias=False)
        self.kv = nn.Linear(dim, 2 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, ln: nn.LayerNorm, fused: bool, hw=None):
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        if self.sr_ratio == 1:
            w = torch.cat([self.q.weight, self.kv.weight], 0)
            qkv = (ln_dense if fused else ln_dense_plain)(
                x.reshape(B * N, C), ln.weight, ln.bias, w, None, ln.eps,
            ).reshape(B, N, 3 * C)
            q, k, v = qkv.split(C, dim=-1)
        else:
            xn = layer_norm(x, ln)
            q = _linear(xn, self.q)
            xr = conv_nhwc(xn.reshape(B, *hw, C), self.sr, x.dtype)
            k, v = _linear(layer_norm(xr.reshape(B, -1, C), self.norm),
                           self.kv).split(C, dim=-1)
        q, k, v = (_heads(t, B, h, hd) for t in (q, k, v))
        use = self.fuse_attention
        if use is None:
            use = fused_attention_active(x, N, k.shape[1])
        scale = hd**-0.5
        out = (attention_op(q, k, v, scale) if use
               else attention_plain(q, k, v, scale)[0])
        out = out.reshape(B, h, N, hd).transpose(1, 2).reshape(B, N, C)
        return _linear(out, self.proj)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)


class MixFFN(nn.Module):
    """LN -> fc1 -> 3x3 depthwise conv on the token grid -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, hw, ln: nn.LayerNorm, fused: bool):
        B, N, C = x.shape
        H, W = hw
        hid = self.fc1.out_features
        y = (ln_dense if fused else ln_dense_plain)(
            x.reshape(B * N, C), ln.weight, ln.bias, self.fc1.weight,
            self.fc1.bias, ln.eps,
        )
        y = conv_nhwc(y.reshape(B, H, W, hid), self.dwconv.dwconv, x.dtype)
        return (gelu_dense if fused else gelu_dense_plain)(
            y.reshape(B * N, hid), self.fc2.weight, self.fc2.bias,
        ).reshape(B, N, C)


class MiTBlock(nn.Module):
    """Pre-norm attention + MixFFN block.  The fused prologues stay off
    when ``sr_ratio != 1`` (the LN'd tokens feed the sr conv too)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 fuse_prologue: Optional[bool] = None, sr_ratio: int = 1):
        super().__init__()
        self.fuse_prologue = fuse_prologue  # None = auto, False = never
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))

    def forward(self, x, hw):
        fused = self.fuse_prologue
        if fused is None:
            fused = fused_prologue_active(x.shape, x)
        fused = fused and self.attn.sr_ratio == 1
        x = x + self.attn(x, self.norm1, fused, hw)
        return x + self.mlp(x, hw, self.norm2, fused)


class OverlapPatchEmbed(nn.Module):
    """Conv patch embed (padding ``patch // 2``) + LN."""

    def __init__(self, patch_size, stride, in_chans, embed_dim):
        super().__init__()
        ph, pw = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, (ph, pw), stride,
                              padding=(ph // 2, pw // 2))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x, dtype):
        x = conv_nhwc(x, self.proj, dtype)
        B, H, W, C = x.shape
        return layer_norm(x.reshape(B, H * W, C), self.norm), (H, W)


def pixel_shuffle(x, r: int):
    """NHWC pixel shuffle in ``torch.nn.PixelShuffle``'s channel order."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


class MixVisionTransformer(nn.Module):
    """(B, 128, 32, in_chans) strip -> (B, 128, 128, 96) triplane map."""

    def __init__(self, img_size=(128, 32), patch_size: int = 1,
                 in_chans: int = 768, embed_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.patch_embed = OverlapPatchEmbed(
            (patch_size, patch_size), (1, 1), in_chans, embed_dim
        )
        self.transformer_block = nn.ModuleList(
            MiTBlock(embed_dim, 4, 2) for _ in range(2)
        )
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.conv1 = nn.Conv2d(embed_dim // 4, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 96, 3, padding=1)

    def forward(self, x):
        B = x.shape[0]
        x, (H, W) = self.patch_embed(x, self.dtype)
        dim = int(math.isqrt(H * W))
        if dim * dim != H * W:
            raise ValueError(f"token count {H * W} is not square")
        for blk in self.transformer_block:
            x = blk(x, (H, W))
        x = layer_norm(x, self.norm1).reshape(B, dim, dim, self.embed_dim)
        x = pixel_shuffle(x, 2)
        x = F.relu(conv_nhwc(x, self.conv1, self.dtype))
        return conv_nhwc(x, self.conv2, self.dtype)


class MixVisionTransformerHead(nn.Module):
    """MAE reconstruction decoder: ``(B, H, W, in_chans)`` canvases ->
    ``(B, h, w, p0*p1*img_in_chans)`` patch predictions."""

    def __init__(self, patch_size=(7, 7), stride=(4, 4), in_chans: int = 32,
                 embed_dim: int = 96, actual_patch_size=(4, 4),
                 img_in_chans: int = 3, norm_pix_loss: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if norm_pix_loss:
            raise NotImplementedError("norm_pix_loss is not ported")
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.actual_patch_size = tuple(actual_patch_size)
        self.img_in_chans = img_in_chans
        self.patch_embed = OverlapPatchEmbed(
            tuple(patch_size), tuple(stride), in_chans, embed_dim
        )
        self.transformer_block = nn.ModuleList(
            MiTBlock(embed_dim, 4, 2, sr_ratio=4) for _ in range(2)
        )
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        p0, p1 = self.actual_patch_size
        self.decoder_pred = nn.Conv2d(embed_dim, p0 * p1 * img_in_chans, 1)

    def forward(self, x):
        B = x.shape[0]
        x, (H, W) = self.patch_embed(x, self.dtype)
        for blk in self.transformer_block:
            x = blk(x, (H, W))
        x = layer_norm(x, self.norm1).reshape(B, H, W, self.embed_dim)
        return conv_nhwc(x, self.decoder_pred, self.dtype)

    def patchify(self, imgs):
        """(B, H, W, C) -> (B, h, w, p0*p1*C) in (p0, p1, C) order."""
        p0, p1 = self.actual_patch_size
        B, H, W, C = imgs.shape
        x = imgs.reshape(B, H // p0, p0, W // p1, p1, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, H // p0, W // p1, p0 * p1 * C)

    def unpatchify(self, x):
        """Inverse of :meth:`patchify`."""
        p0, p1 = self.actual_patch_size
        B, h, w, _ = x.shape
        C = self.img_in_chans
        x = x.reshape(B, h, w, p0, p1, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h * p0, w * p1, C)

    def forward_loss(self, imgs, pred, mask):
        """Masked patch MSE: ``sum((pred - patchify(imgs))^2 * m) /
        sum(m)`` with ``m = patchify(mask)``, in float32."""
        target = self.patchify(imgs).float()
        m = self.patchify(mask).float()
        return ((pred.float() - target) ** 2 * m).sum() / m.sum()
