"""MixVisionTransformer neck and MAE decoder head (channels-last at the
public boundary).

Counterpart of the JAX package's ``models/mit.py``: the neck (1x1 patch
embed, two MiT blocks with 4 heads and sr_ratio 1, MixFFN with a 3x3
depthwise conv, the square token reshape, pixel shuffle and two 3x3
convs, or with ``high`` three and a transposed conv) and ``MixVisionTransformerHead``, the reconstruction decoder
(overlapping patch embed, two sr_ratio=4 blocks whose keys and values
come from a strided conv of the token grid, a 1x1 prediction conv,
``patchify``/``unpatchify`` and the patch MSE).  LayerNorm eps is 1e-6
(flax's default), not torch's 1e-5.  Module names follow the reference
``state_dict`` (``transformer_block.i.attn.q``, ``attn.sr``,
``attn.norm`` for the reduced tokens' LayerNorm ...).

Dispatch mirrors the JAX gates with "on TPU" read as "tensor on CUDA":
the fused LN->GEMM / GELU->GEMM route needs bf16, ``(B*N) % 1024 == 0``,
``C % 128 == 0`` and sr_ratio 1; the attention kernel needs bf16,
``Nq % 512 == 0``, ``Nk % 128 == 0`` and ``Nq*Nk >= 1e6``.  A closed
prologue gate runs JAX's unfused block (LayerNorm, then each product in
the compute dtype), a closed attention gate the kernel's plain twin.
The kernel routes are differentiable: the attention backward is the B6
kernel, the prologues' backward replays the JAX package's XLA math in
the compute dtype (``ops.kernels.ln_dense_xla``, ``gelu_dense_xla``).
With ``int8``
the q, kv, proj, fc1 and fc2 products are int8 after a plain LayerNorm
and an exact GELU, the fused prologues stay off and attention keeps its
gate: dynamic products (``int8=True``, ``ops.quant.quant_dense``, with
the straight-through backward), or with ``int8="static"`` calibrated
ones (``ops.quant.quant_dense_site``), each Linear owning the amax
buffer ``amax_in`` of its site, as the JAX package's
``Int8Dense(static=True)`` (``quant.py:214-242``).
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
    ln_dense,
)
from ..ops.quant import add_site, quant_dense, quant_dense_site
from .convnext import conv_nhwc, layer_norm


def fused_prologue_active(shape, x, int8=False) -> bool:
    B, N, C = shape
    return (not int8 and x.is_cuda and x.dtype == torch.bfloat16
            and (B * N) % 1024 == 0 and C % 128 == 0)


def fused_attention_active(x, n_q: int, n_kv: int) -> bool:
    return (x.is_cuda and x.dtype == torch.bfloat16 and n_q % 512 == 0
            and n_kv % 128 == 0 and n_q * n_kv >= 1_000_000)


def _linear(x, lin: nn.Linear):
    dt = x.dtype
    return F.linear(x, lin.weight.to(dt),
                    None if lin.bias is None else lin.bias.to(dt))


def _dense(x, lin: nn.Linear, int8):
    """``lin`` applied to ``x``: in ``x``'s dtype, or a dynamic or static
    int8 product."""
    if int8 == "static":
        return quant_dense_site(lin, "amax_in", x, lin.weight, lin.bias)
    return quant_dense(x, lin.weight, lin.bias) if int8 else _linear(x, lin)


def _static_sites(int8, *linears) -> None:
    """With ``int8="static"``, the amax buffer ``amax_in`` on each
    Linear."""
    if int8 == "static":
        for lin in linears:
            add_site(lin, "amax_in")


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

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 1,
                 int8=False):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.int8 = int8
        self.fuse_attention: Optional[bool] = None  # None = auto
        self.q = nn.Linear(dim, dim, bias=False)
        self.kv = nn.Linear(dim, 2 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        _static_sites(int8, self.q, self.kv, self.proj)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, ln: nn.LayerNorm, fused: bool, hw=None):
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        if fused and not self.int8:  # sr_ratio 1 (MiTBlock's gate)
            w = torch.cat([self.q.weight, self.kv.weight], 0)
            qkv = ln_dense(x.reshape(B * N, C), ln.weight, ln.bias, w, None,
                           ln.eps).reshape(B, N, 3 * C)
            q, k, v = qkv.split(C, dim=-1)
        else:
            xn = layer_norm(x, ln)
            q = _dense(xn, self.q, self.int8)
            if self.sr_ratio > 1:
                xr = conv_nhwc(xn.reshape(B, *hw, C), self.sr, x.dtype)
                xn = layer_norm(xr.reshape(B, -1, C), self.norm)
            k, v = _dense(xn, self.kv, self.int8).split(C, dim=-1)
        q, k, v = (_heads(t, B, h, hd) for t in (q, k, v))
        use = self.fuse_attention
        if use is None:
            use = fused_attention_active(x, N, k.shape[1])
        scale = hd**-0.5
        out = (attention_op(q, k, v, scale) if use
               else attention_plain(q, k, v, scale, with_lse=False)[0])
        out = out.reshape(B, h, N, hd).transpose(1, 2).reshape(B, N, C)
        return _dense(out, self.proj, self.int8)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)


class MixFFN(nn.Module):
    """LN -> fc1 -> 3x3 depthwise conv on the token grid -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, int8=False):
        super().__init__()
        self.int8 = int8
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        _static_sites(int8, self.fc1, self.fc2)

    def forward(self, x, hw, ln: nn.LayerNorm, fused: bool):
        B, N, C = x.shape
        H, W = hw
        hid = self.fc1.out_features
        if self.int8 or not fused:
            # JAX's unfused MixFFN: LayerNorm, then nn.Dense, GELU and
            # nn.Dense in the compute dtype (mit.py:265-287)
            y = _dense(layer_norm(x, ln), self.fc1, self.int8)
            y = conv_nhwc(y.reshape(B, H, W, hid), self.dwconv.dwconv,
                          x.dtype)
            return _dense(F.gelu(y).reshape(B, N, hid), self.fc2, self.int8)
        y = ln_dense(x.reshape(B * N, C), ln.weight, ln.bias,
                     self.fc1.weight, self.fc1.bias, ln.eps)
        y = conv_nhwc(y.reshape(B, H, W, hid), self.dwconv.dwconv, x.dtype)
        return gelu_dense(y.reshape(B * N, hid), self.fc2.weight,
                          self.fc2.bias).reshape(B, N, C)


class MiTBlock(nn.Module):
    """Pre-norm attention + MixFFN block.  The fused prologues stay off
    when ``sr_ratio != 1`` (the LN'd tokens feed the sr conv too)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 fuse_prologue: Optional[bool] = None, sr_ratio: int = 1,
                 int8=False):
        super().__init__()
        self.fuse_prologue = fuse_prologue  # None = auto, False = never
        self.int8 = int8
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio, int8)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), int8)

    def forward(self, x, hw):
        fused = self.fuse_prologue
        if fused is None:
            fused = fused_prologue_active(x.shape, x, self.int8)
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
    """(B, 128, 32, in_chans) strip -> (B, 128, 128, 96) triplane map, or
    with ``high`` (``MixVisionTransformerHigh``) (B, 256, 256, 96): conv
    256, ReLU, a stride-2 3x3 transposed conv (PyTorch's padding 1,
    output padding 1), conv 128, ReLU, conv 96."""

    def __init__(self, img_size=(128, 32), patch_size: int = 1,
                 in_chans: int = 768, embed_dim: int = 768,
                 high: bool = False, int8=False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.high = high
        self.embed_dim = embed_dim
        self.patch_embed = OverlapPatchEmbed(
            (patch_size, patch_size), (1, 1), in_chans, embed_dim
        )
        self.transformer_block = nn.ModuleList(
            MiTBlock(embed_dim, 4, 2, int8=int8) for _ in range(2)
        )
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        c1 = 256 if high else 128
        self.conv1 = nn.Conv2d(embed_dim // 4, c1, 3, padding=1)
        if high:
            self.conv_transpose = nn.ConvTranspose2d(
                256, 256, 3, stride=2, padding=1, output_padding=1)
            self.conv2 = nn.Conv2d(256, 128, 3, padding=1)
            self.conv3 = nn.Conv2d(128, 96, 3, padding=1)
        else:
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
        if not self.high:
            return conv_nhwc(x, self.conv2, self.dtype)
        ct = self.conv_transpose
        x = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), ct.weight.to(self.dtype),
            ct.bias.to(self.dtype), ct.stride, ct.padding, ct.output_padding,
        ).permute(0, 2, 3, 1)
        x = F.relu(conv_nhwc(x, self.conv2, self.dtype))
        return conv_nhwc(x, self.conv3, self.dtype)


class MixVisionTransformerHead(nn.Module):
    """MAE reconstruction decoder: ``(B, H, W, in_chans)`` canvases ->
    ``(B, h, w, p0*p1*img_in_chans)`` patch predictions.

    ``norm_pix_loss`` is accepted and changes nothing: the JAX package
    declares it and reads it nowhere, so its loss is the plain patch MSE
    either way (the reference normalises each target patch; ROADMAP C6).
    """

    def __init__(self, patch_size=(7, 7), stride=(4, 4), in_chans: int = 32,
                 embed_dim: int = 96, actual_patch_size=(4, 4),
                 img_in_chans: int = 3, norm_pix_loss: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.norm_pix_loss = norm_pix_loss
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
