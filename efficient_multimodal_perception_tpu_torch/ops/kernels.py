"""The hand-written Hopper kernels of the port, each beside its plain
PyTorch twin and a launch count, and the ``emp::`` operators built on them.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

=========================  ==============================  ===========================
wrapper                    TPU kernel it replaces          CUDA source
=========================  ==============================  ===========================
convnext_block_fused       convnext_block_fused            csrc/convnext_block.cu
epilogue_fused             epilogue_fused                  csrc/epilogue_fwd.cu
post_epilogue_bwd          post_epilogue_bwd (C <= 384)    csrc/epilogue_bwd.cu
post_epilogue_bwd_wide     post_epilogue_bwd_wide (C=768)  csrc/epilogue_bwd.cu
attention                  attention_pallas (forward)      csrc/attention.cu
attention_bwd              attention_pallas (backward)     csrc/attention.cu
ln_dense_fused             ln_dense_fused                  csrc/prologue_dense.cu
gelu_dense_fused           gelu_dense_fused                csrc/prologue_dense.cu
triplane_sample            triplane_sample_pallas (fwd)    csrc/triplane_sample.cu
triplane_sample_bwd        triplane_sample_pallas (bwd)    csrc/triplane_sample.cu
finite_mlp_fused           finite_mlp_fused (forward)      csrc/finite_mlp.cu
convnext_block_int8_fused  convnext_block_int8_fused       csrc/convnext_block_int8.cu
int8_dot                   int8 dot probe (tools/)         csrc/int8_gemm.cu
cam_gather_sum             cam_gather_sum (forward)        csrc/cam_gather.cu
cam_gather_sum_bwd         cam_gather_sum (backward)       csrc/cam_gather.cu
=========================  ==============================  ===========================

A wrapper given CPU tensors runs its plain twin (the CPU tests use this).
Given CUDA tensors it launches its kernel or raises on a dtype, shape or
layout the kernel does not take; it never falls back.  The twins compute
in float32 and round to the working type at the points the kernels do
(normalized rows, GELU outputs, ``g * gamma``, softmax probabilities and
``ds`` before their products, the result at the end).  Weights use the
``nn.Linear`` layout ``(out, in)``; a twin takes them in any float dtype
and rounds them to the working type.

Every kernel a model path launches is an operator of the ``emp``
namespace (``torch.library.custom_op``), named as its ``LAUNCHES`` key:
``emp::convnext_block_fused``, ``epilogue_fused``,
``post_epilogue_bwd(_wide)``, ``attention``, ``attention_bwd``,
``ln_dense_fused``, ``gelu_dense_fused``, ``triplane_sample(_bwd)``,
``finite_mlp_fused``, ``convnext_block_int8_fused`` and
``cam_gather_sum(_bwd)``.  An op's implementation is the wrapper (the
kernel on CUDA tensors, the twin on CPU tensors); its fake
implementation gives the output's shape, dtype and (contiguous)
strides, so ``torch.export`` traces through it and an exported program
calls the kernels; ``register_autograd`` gives the ops their backward,
the kernel where the TPU kernel had one, or else the JAX package's VJP
math in tensor ops: written out for B9 (``finite_mlp_bwd``) and B10
(``convnext_block_int8_bwd``, the straight-through VJP of the int8
block), autograd of the plain math replayed elsewhere.  The
functions the models call (``convnext_block``, ``epilogue``,
``attention_op``, ``ln_dense``, ``gelu_dense``, ``triplane_sample_op``,
``cam_gather_sum_op``, ``finite_mlp_fused``, ``convnext_block_int8``)
take float32 parameters and call ``torch.ops.emp.*``; the models call
them only on CUDA (their gates exclude CPU tensors).  Importing this
module registers the ops; an exported program that holds them loads
only after it (``tools/export.load_artifact``).  The int8 dot probe
(``int8_dot``) is on no model path and stays a plain wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ._build import DEFINES as _build_defines
from .quant import (cached_quantize_weight, int_mm, mm_f32 as _mm_f32,
                    quant_dense, quantize_weight, sym_quant)
from .sampling import grid_sample_2d, grid_sample_2d_adjoint

# launches of each kernel, counted where the kernel is launched
LAUNCHES = {
    "convnext_block_fused": 0,
    "epilogue_fused": 0,
    "post_epilogue_bwd": 0,
    "post_epilogue_bwd_wide": 0,
    "attention": 0,
    "attention_bwd": 0,
    "ln_dense_fused": 0,
    "gelu_dense_fused": 0,
    "triplane_sample": 0,
    "triplane_sample_bwd": 0,
    "finite_mlp_fused": 0,
    "convnext_block_int8_fused": 0,
    "int8_dot": 0,
    "cam_gather_sum": 0,
    "cam_gather_sum_bwd": 0,
}

CONVNEXT_WIDTHS = (96, 192, 384, 768)
NARROW_WIDTHS = (96, 192, 384)  # post_epilogue_bwd; 768 is the wide variant


def reset_launches() -> None:
    for counts in (LAUNCHES, VJP_CALLS):
        for k in counts:
            counts[k] = 0


def _lib():
    from ._build import load

    return load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _require(name, cond, what):
    if not cond:
        raise ValueError(f"{name}: kernel does not take {what}")


def _check_tensors(name, device, **tensors):
    """Every tensor on ``device`` (CUDA), contiguous, of its dtype, and
    16-byte aligned (the kernels load 8 bf16 values at a time)."""
    for key, (t, dtype) in tensors.items():
        if t is None:
            continue
        _require(name, t.device == device,
                 f"{key} on {t.device} (expected {device})")
        _require(name, t.dtype == dtype, f"{key} of dtype {t.dtype}")
        _require(name, t.is_contiguous(), f"non-contiguous {key}")
        _require(name, t.data_ptr() % 16 == 0, f"{key} not 16-byte aligned")


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _f32(t):
    return None if t is None else t.float()


def _fresh(out):
    """An op's outputs laid out as its fake implementation says:
    contiguous (the kernels' outputs are; a twin's may not be)."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _wt(w, dt):
    """A weight rounded to the working type, as float32."""
    return w.to(dt).float()


def _replay(fn, inputs, grad_out):
    """Gradients of ``fn(*inputs)`` for the inputs that need them: the
    plain math replayed under autograd (the JAX package's XLA-replay
    VJPs)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               if isinstance(t, torch.Tensor) and t.is_floating_point()
               else t for t in inputs]
        out = fn(*ins)
        wrt = [t for t in ins if isinstance(t, torch.Tensor)
               and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad_out,
                                         allow_unused=True))
    return tuple(next(grads) if isinstance(t, torch.Tensor) and t.requires_grad
                 else None for t in ins)


# --------------------------------------------------------------------------
# K1 / B5: ConvNeXt block (depthwise 7x7 outside, LN + MLP + scale in)
# --------------------------------------------------------------------------

def dwconv7(x, dw_k, dw_b):
    """Depthwise 7x7 conv of NHWC ``x`` with a ``(C, 1, 7, 7)`` kernel,
    in ``x``'s dtype."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw_k.to(x.dtype), dw_b.to(x.dtype),
                 padding=3, groups=C)
    return y.permute(0, 2, 3, 1).contiguous()


def _layer_norm_f32(xf, s, b, eps):
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()


def _epilogue_f32(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """``gamma * (fc2(GELU(fc1(LN(y)))))`` in float32, rounded to ``y``'s
    dtype where the kernels round."""
    dt = y.dtype
    z = _layer_norm_f32(y.float(), ln_s, ln_b, 1e-6).to(dt)
    h = F.gelu(z.float() @ _wt(w1, dt).t() + b1.float()).to(dt)
    o = h.float() @ _wt(w2, dt).t() + b2.float()
    return o if gamma is None else o * gamma.float()


def convnext_block_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Plain twin of :func:`convnext_block_fused`."""
    y = dwconv7(x, dw_k, dw_b)
    return (x.float() + _epilogue_f32(y, ln_s, ln_b, w1, b1, w2, b2,
                                      gamma)).to(x.dtype)


def epilogue_plain(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Plain twin of :func:`epilogue_fused`."""
    return _epilogue_f32(y, ln_s, ln_b, w1, b1, w2, b2, gamma).to(y.dtype)


def _check_block(name, x, ln_s, ln_b, w1, b1, w2, b2, gamma, widths):
    C = x.shape[-1]
    _require(name, C in widths, f"C={C} (takes {widths})")
    f32, bf = torch.float32, torch.bfloat16
    _check_tensors(name, x.device, x=(x, bf), ln_s=(ln_s, f32),
                   ln_b=(ln_b, f32), w1=(w1, bf), b1=(b1, f32), w2=(w2, bf),
                   b2=(b2, f32), gamma=(gamma, f32))
    _require(name, w1.shape == (4 * C, C) and w2.shape == (C, 4 * C),
             f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} at C={C}")
    return C


# Rows of an output tile of the Hopper GEMMs (csrc/gemm_sm90.cuh), and the
# column-tile widths the MLP chain's GEMMs (K1, the B5 forward) are built
# for (fc1, fc2).
GEMM_BM = 128
FC1_WIDTHS = (256, 192)
FC2_WIDTHS = (192, 128)
# the int8 GEMM's column-tile widths (csrc/int8_gemm.cu)
INT8_WIDTHS = (256, 192, 128, 96)
# K1 runs its chain over row chunks whose z and h scratch (10 C bytes a
# row) stays under this many bytes, reused chunk after chunk
K1_CHUNK_BYTES = 128 << 20
# B10 runs over row chunks whose zq and hq scratch (5 C bytes a row) stays
# under this many bytes, as K1's z and h do.  Chunks small enough for hq
# to stay in the H100's 50 MiB L2 (24 MiB) took 13-18% more device time
# at camera stages 0-3 than this budget (an H100 80GB HBM3 at 700 W,
# ``tools/ab_trees.py --suite serve``): the passes are bound by their
# epilogues' f32 work, not by device memory, and each chunk adds four
# launches and their partial last waves
B10_CHUNK_BYTES = 128 << 20


def plan_tile_width(M: int, N: int, sms: int, widths=FC2_WIDTHS) -> int:
    """Column-tile width of a 128-row TN GEMM with output ``(M, N)``: the
    width in ``widths`` whose rounds of tiles over ``sms`` persistent CTAs
    take the least time, a tile's time taken as proportional to the bytes
    of operand tiles it loads (128 + width rows a k-tile; the GEMMs are
    bound by the L2 cache's bandwidth), the widest on a tie.  At the
    train shapes it gives fc1 / fc2 256 / 192 for the camera rows and
    192 / 128 for the lidar rows, where an H100 ran them in 16-27% less
    device time than 256 / 192 (``python -m
    efficient_multimodal_perception_tpu_torch.tools.ab_trees``)."""
    best = None
    for bn in widths:
        tiles = -(-M // GEMM_BM) * -(-N // bn)
        cost = -(-tiles // sms) * (GEMM_BM + bn)
        if best is None or cost < best[0]:
            best = (cost, bn)
    return best[1]


def plan_k1_chunks(M: int, C: int) -> list[tuple[int, int]]:
    """K1's row chunks ``(first row, rows)``: as few as keep each chunk's
    z and h scratch under ``K1_CHUNK_BYTES``, of equal rows rounded up to
    the GEMM's 128-row tile (the last takes the rest)."""
    cap = max(GEMM_BM, K1_CHUNK_BYTES // (10 * C) // GEMM_BM * GEMM_BM)
    n = -(-M // cap)
    rows = -(-M // (n * GEMM_BM)) * GEMM_BM
    return [(r, min(rows, M - r)) for r in range(0, M, rows)]


_SMS = []


def _sm_count() -> int:
    """The card's SM count, as the kernel library reports it."""
    if not _SMS:
        _SMS.append(_lib().emp_sm_count())
    return _SMS[0]


def convnext_block_fused(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """One inference ConvNeXt block.

    Args:
        x: ``(N, H, W, C)`` bf16 (CUDA) input.
        dw_k, dw_b: depthwise ``(C, 1, 7, 7)`` kernel and ``(C,)`` bias.
        ln_s, ln_b, b1, b2, gamma: f32; ``gamma`` may be None.
        w1: ``(4C, C)`` bf16; w2: ``(C, 4C)`` bf16.

    The depthwise conv runs in PyTorch; the rest is the kernel's chain (LN
    row pass, fc1 with GELU, fc2 with bias, gamma and the residual) over
    the row chunks of :func:`plan_k1_chunks`, counted as one call.
    """
    if x.device.type == "cpu":
        return convnext_block_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2,
                                    b2, gamma)
    name = "convnext_block_fused"
    C = _check_block(name, x, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     CONVNEXT_WIDTHS)
    y = dwconv7(x, dw_k, dw_b)
    out = torch.empty_like(x)
    M = x.numel() // C
    chunks = plan_k1_chunks(M, C)
    rows = chunks[0][1]
    z = torch.empty((rows, C), dtype=x.dtype, device=x.device)
    h = torch.empty((rows, 4 * C), dtype=x.dtype, device=x.device)
    lib, st, sms, step = _lib(), _stream(x), _sm_count(), C * x.element_size()
    for r0, n in chunks:
        _raise_on(lib.emp_convnext_block(
            x.data_ptr() + r0 * step, y.data_ptr() + r0 * step,
            ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), _ptr(gamma), z.data_ptr(),
            h.data_ptr(), out.data_ptr() + r0 * step, n, C,
            plan_tile_width(n, 4 * C, sms, FC1_WIDTHS),
            plan_tile_width(n, C, sms, FC2_WIDTHS), st), name)
    LAUNCHES[name] += 1
    return out


def epilogue_fused(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """``gamma * MLP(LN(y))`` (no residual) over ``(..., C)`` bf16 rows;
    argument types as :func:`convnext_block_fused`.  Three launches (the
    LN row pass into a bf16 scratch ``z``, fc1 with GELU into a bf16
    scratch ``h``, fc2 with bias and gamma), counted as one call."""
    if y.device.type == "cpu":
        return epilogue_plain(y, ln_s, ln_b, w1, b1, w2, b2, gamma)
    name = "epilogue_fused"
    C = _check_block(name, y, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     CONVNEXT_WIDTHS)
    M = y.numel() // C
    out = torch.empty_like(y)
    z = torch.empty((M, C), dtype=y.dtype, device=y.device)
    h = torch.empty((M, 4 * C), dtype=y.dtype, device=y.device)
    sms = _sm_count()
    rc = _lib().emp_epilogue_fwd(
        y.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(gamma),
        z.data_ptr(), h.data_ptr(), out.data_ptr(), M, C,
        plan_tile_width(M, 4 * C, sms, FC1_WIDTHS),
        plan_tile_width(M, C, sms, FC2_WIDTHS), _stream(y),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def post_epilogue_bwd_plain(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Plain twin of :func:`post_epilogue_bwd` (and of the wide variant):
    the TPU kernel's backward chain in float32, rounding ``z``, ``h``,
    ``g * gamma`` and ``dhpre`` to ``y``'s dtype before their products.

    Returns ``(dy, dln_s, dln_b, dw1 (4C, C), db1, dw2 (C, 4C), db2,
    dgamma)``, all float32 except ``dy`` (``y``'s dtype).
    """
    dt = y.dtype
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-6)
    zhat = (yf - mu) * rstd
    zc = (zhat * ln_s.float() + ln_b.float()).to(dt).float()
    w1f, w2f = _wt(w1, dt), _wt(w2, dt)
    hpre = zc @ w1f.t() + b1.float()
    phi = 0.5 * (1.0 + torch.erf(hpre * 0.7071067811865476))
    h = (hpre * phi).to(dt).float()
    opre = h @ w2f.t() + b2.float()
    gf = g.float()
    do = gf * gamma.float()
    doc = do.to(dt).float()
    dw2 = doc.t() @ h
    dh = doc @ w2f
    pdf = 0.3989422804014327 * torch.exp(-0.5 * hpre * hpre)
    dhpre = dh * (phi + hpre * pdf)
    dhc = dhpre.to(dt).float()
    dw1 = dhc.t() @ zc
    dz = dhc @ w1f
    dzhat = dz * ln_s.float()
    m1 = dzhat.mean(-1, keepdim=True)
    m2 = (dzhat * zhat).mean(-1, keepdim=True)
    dy = (rstd * (dzhat - m1 - zhat * m2)).to(dt)
    return (dy, (dz * zhat).sum(0), dz.sum(0), dw1, dhpre.sum(0), dw2,
            do.sum(0), (gf * opre).sum(0))


def _check_bwd(name, widths, y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    _require(name, y.dim() == 2 and g.shape == y.shape,
             f"y {tuple(y.shape)} / g {tuple(g.shape)} (two equal (M, C))")
    _require(name, gamma is not None, "gamma=None")
    C = _check_block(name, y, ln_s, ln_b, w1, b1, w2, b2, gamma, widths)
    _check_tensors(name, y.device, g=(g, torch.bfloat16))
    return y.shape[0], C


# The backward chain's tile widths: dual GEMM 2 (out (M, C)) and the
# weight gradients' A^T B GEMM; the fewest rows of M a split of the
# latter takes.
DUAL2_WIDTHS = (128, 96)
ATB_BN = 256
ATB_MIN_ROWS = 256


def plan_dual_width(C: int) -> int:
    """Dual GEMM 2's tile width: the one that pads C the least, the wider
    on a tie (96 at C = 96 and 192, 128 at C = 384 and 768)."""
    return min(DUAL2_WIDTHS, key=lambda bn: (-(-C // bn) * bn, -bn))


def plan_atb_splits(M: int, N1: int, N2: int, sms: int) -> int:
    """Ranges of M for the weight gradient ``(N1, N2) = A^T B`` over ``M``
    rows: enough that its 128 x 256 tiles times the ranges fill ``sms``
    SMs once, each range at least ``ATB_MIN_ROWS`` rows; one where the
    tiles alone fill the card."""
    tiles = -(-N1 // GEMM_BM) * -(-N2 // ATB_BN)
    return max(1, min(sms // tiles, M // ATB_MIN_ROWS))


def bwd_scratch(M: int, C: int, splits=(1, 1)):
    """The backward chain's scratch, ``{name: (shape, dtype)}``.  ``part``
    holds 8 partial rows per 128 rows (a GEMM tile's 8 warps; the row
    passes' 16-row blocks fill the same rows) over the 8C columns db1 |
    db2 | dlns | dlnb | dgamma; ``wpart`` the weight gradients' partial
    products for ``splits`` (dW1's and dW2's ranges of M), absent when
    both are 1."""
    H = 4 * C
    bf, f32 = torch.bfloat16, torch.float32
    sc = {
        "w1t": ((C, H), bf), "w2t": ((H, C), bf),
        "z": ((M, C), bf), "doc": ((M, C), bf),
        "h": ((M, H), bf), "dhpre": ((M, H), bf),
        "dz": ((M, C), f32), "stats": ((2 * M,), f32),
        "part": ((8 * -(-M // GEMM_BM), 8 * C), f32),
    }
    if max(splits) > 1:
        sc["wpart"] = ((max(splits) * H * C,), f32)
    return sc


def _post_epilogue_bwd_kernel(name, widths, y, g, ln_s, ln_b, w1, b1, w2,
                              b2, gamma):
    """B5's backward chain: ``(dy, dw1, dw2, vec)``, ``vec`` the 8C float32
    vector ``db1 | db2 | dln_s | dln_b | dgamma`` (the twin's on CPU
    tensors)."""
    if y.device.type == "cpu":
        dy, dlns, dlnb, dw1, db1, dw2, db2, dgm = post_epilogue_bwd_plain(
            y, g, ln_s, ln_b, w1, b1, w2, b2, gamma)
        return dy, dw1, dw2, torch.cat([db1, db2, dlns, dlnb, dgm])
    M, C = _check_bwd(name, widths, y, g, ln_s, ln_b, w1, b1, w2, b2, gamma)
    sms = _sm_count()
    splits = (plan_atb_splits(M, 4 * C, C, sms),
              plan_atb_splits(M, C, 4 * C, sms))
    buf = {k: torch.empty(shape, dtype=dt, device=y.device)
           for k, (shape, dt) in bwd_scratch(M, C, splits).items()}
    f32 = dict(dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    vec = torch.empty(8 * C, **f32)
    dw1 = torch.empty((4 * C, C), **f32)
    dw2 = torch.empty((C, 4 * C), **f32)
    _raise_on(_lib().emp_epilogue_bwd(
        y.data_ptr(), g.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        gamma.data_ptr(), *(buf[k].data_ptr() for k in ("w1t", "w2t")),
        dy.data_ptr(),
        *(buf[k].data_ptr() for k in ("z", "doc", "h", "dhpre", "dz",
                                       "stats", "part")),
        vec.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        _ptr(buf.get("wpart")), M, C, plan_dual_width(C), *splits,
        _stream(y)), name)
    LAUNCHES[name] += 1
    return dy, dw1, dw2, vec


def _split_bwd(dy, dw1, dw2, vec):
    """``(dy, dln_s, dln_b, dw1, db1, dw2, db2, dgamma)`` from the chain's
    outputs."""
    C = dy.shape[-1]
    db1, db2, dlns, dlnb, dgamma = vec.split([4 * C, C, C, C, C])
    return dy, dlns, dlnb, dw1, db1, dw2, db2, dgamma


def _bwd_fake(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    C = y.shape[-1]
    f32 = torch.float32
    return (torch.empty_like(y, memory_format=torch.contiguous_format),
            y.new_empty((4 * C, C), dtype=f32),
            y.new_empty((C, 4 * C), dtype=f32),
            y.new_empty((8 * C,), dtype=f32))


@torch.library.custom_op("emp::post_epilogue_bwd", mutates_args=())
def _post_epilogue_bwd_op(y: Tensor, g: Tensor, ln_s: Tensor, ln_b: Tensor,
                          w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                          gamma: Tensor) -> tuple[Tensor, Tensor, Tensor,
                                                  Tensor]:
    return _fresh(_post_epilogue_bwd_kernel(
        "post_epilogue_bwd", NARROW_WIDTHS, y, g, ln_s, ln_b, w1, b1, w2, b2,
        gamma))


@torch.library.custom_op("emp::post_epilogue_bwd_wide", mutates_args=())
def _post_epilogue_bwd_wide_op(y: Tensor, g: Tensor, ln_s: Tensor,
                               ln_b: Tensor, w1: Tensor, b1: Tensor,
                               w2: Tensor, b2: Tensor,
                               gamma: Tensor) -> tuple[Tensor, Tensor,
                                                       Tensor, Tensor]:
    return _fresh(_post_epilogue_bwd_kernel(
        "post_epilogue_bwd_wide", (768,), y, g, ln_s, ln_b, w1, b1, w2, b2,
        gamma))


_post_epilogue_bwd_op.register_fake(_bwd_fake)
_post_epilogue_bwd_wide_op.register_fake(_bwd_fake)


def post_epilogue_bwd(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Backward of :func:`epilogue_fused` for C in (96, 192, 384).

    Args:
        y, g: ``(M, C)`` bf16 depthwise-conv output and upstream gradient.
        others: as :func:`epilogue_fused`; ``gamma`` is required.

    Returns ``(dy, dln_s, dln_b, dw1 (4C, C), db1, dw2 (C, 4C), db2,
    dgamma)``: ``dy`` bf16, the rest float32.  One chain of two row
    passes, two dual GEMMs, a column sum and the two weight-gradient
    GEMMs split over M (``csrc/epilogue_bwd.cu``), counted as one call;
    every partial sum is reduced in a fixed order, so two calls give the
    same bits.  Runs as ``emp::post_epilogue_bwd``.
    """
    return _split_bwd(*torch.ops.emp.post_epilogue_bwd(
        y, g, ln_s, ln_b, w1, b1, w2, b2, gamma))


def post_epilogue_bwd_wide(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """:func:`post_epilogue_bwd` for C = 768 (the same chain),
    ``emp::post_epilogue_bwd_wide``."""
    return _split_bwd(*torch.ops.emp.post_epilogue_bwd_wide(
        y, g, ln_s, ln_b, w1, b1, w2, b2, gamma))


def _epilogue_grads(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """The epilogue's parameter grads and ``dy`` through B5 (flattened
    rows), cast back to each parameter's dtype."""
    C = y.shape[-1]
    dt = y.dtype
    fn = post_epilogue_bwd if C <= 384 else post_epilogue_bwd_wide
    dy, dlns, dlnb, dw1, db1, dw2, db2, dgm = fn(
        y.reshape(-1, C), g.contiguous().reshape(-1, C), ln_s.float(),
        ln_b.float(), w1.to(dt).contiguous(), b1.float(),
        w2.to(dt).contiguous(), b2.float(), gamma.float())
    return dy.reshape(y.shape), tuple(
        d.to(p.dtype) for d, p in ((dlns, ln_s), (dlnb, ln_b), (dw1, w1),
                                   (db1, b1), (dw2, w2), (db2, b2),
                                   (dgm, gamma)))


def _dense_params(dt, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """The MLP chain's parameters as the kernels take them: LN, biases
    and gamma float32, weights contiguous in the working type ``dt``."""
    return (ln_s.float(), ln_b.float(), w1.to(dt).contiguous(), b1.float(),
            w2.to(dt).contiguous(), b2.float(), _f32(gamma))


@torch.library.custom_op("emp::convnext_block_fused", mutates_args=())
def _convnext_block_op(x: Tensor, dw_k: Tensor, dw_b: Tensor, ln_s: Tensor,
                       ln_b: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                       b2: Tensor, gamma: Optional[Tensor]) -> Tensor:
    return _fresh(convnext_block_fused(
        x, dw_k, dw_b, *_dense_params(x.dtype, ln_s, ln_b, w1, b1, w2, b2,
                                      gamma)))


@_convnext_block_op.register_fake
def _(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _convnext_block_bwd(ctx, g):
    """The depthwise conv's VJP after B5's ``post_epilogue_bwd`` for C <=
    384 with gamma, else autograd of the plain math replayed
    (``pallas_kernels.py:545-581``)."""
    saved = ctx.saved_tensors
    x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma = saved
    if gamma is None or x.shape[-1] not in NARROW_WIDTHS:
        return _replay(convnext_block_plain, saved, g)
    with torch.enable_grad():
        conv_in = [t.detach().requires_grad_(need) for t, need in
                   zip((x, dw_k, dw_b), ctx.needs_input_grad[:3])]
        y = dwconv7(*conv_in)
    dy, pgrads = _epilogue_grads(y.detach(), g, ln_s, ln_b, w1, b1, w2, b2,
                                 gamma)
    wrt = [t for t in conv_in if t.requires_grad]
    got = iter(torch.autograd.grad(y, wrt, dy) if wrt else ())
    dx, dk, db = (next(got) if t.requires_grad else None for t in conv_in)
    if dx is not None:
        dx = g + dx
    return (dx, dk, db) + pgrads


_convnext_block_op.register_autograd(_convnext_block_bwd,
                                     setup_context=_save_inputs)


@torch.library.custom_op("emp::epilogue_fused", mutates_args=())
def _epilogue_op(y: Tensor, ln_s: Tensor, ln_b: Tensor, w1: Tensor,
                 b1: Tensor, w2: Tensor, b2: Tensor,
                 gamma: Optional[Tensor]) -> Tensor:
    return _fresh(epilogue_fused(
        y, *_dense_params(y.dtype, ln_s, ln_b, w1, b1, w2, b2, gamma)))


@_epilogue_op.register_fake
def _(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    return torch.empty_like(y, memory_format=torch.contiguous_format)


def _epilogue_bwd(ctx, g):
    """``post_epilogue_bwd`` / ``post_epilogue_bwd_wide``; autograd
    replay without gamma, as ``pallas_kernels.py:1439-1443``."""
    saved = ctx.saved_tensors
    if saved[-1] is None:
        return _replay(epilogue_plain, saved, g)
    dy, pgrads = _epilogue_grads(saved[0], g, *saved[1:])
    return (dy,) + pgrads


_epilogue_op.register_autograd(_epilogue_bwd, setup_context=_save_inputs)


def convnext_block(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Differentiable K1 (float32 parameters): ``emp::convnext_block_fused``,
    the kernel with its fused backward."""
    return torch.ops.emp.convnext_block_fused(x, dw_k, dw_b, ln_s, ln_b, w1,
                                              b1, w2, b2, gamma)


def epilogue(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Differentiable B5 (float32 parameters), ``emp::epilogue_fused``,
    as :func:`convnext_block`."""
    return torch.ops.emp.epilogue_fused(y, ln_s, ln_b, w1, b1, w2, b2, gamma)


# --------------------------------------------------------------------------
# K2 / B6: exact softmax attention over flattened heads (+ logsumexp)
# --------------------------------------------------------------------------

def attention_plain(q, k, v, scale, with_lse: bool = True):
    """Plain twin of :func:`attention` (``torch.softmax``, whose backward
    is one pass where a written-out max / exp / sum / divide takes five);
    ``with_lse=False`` gives None for the logsumexp, which costs the
    softmax's time again and which the models' plain route does not
    read."""
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    p = torch.softmax(s, -1).to(v.dtype)
    out = (p.float() @ v.float()).to(q.dtype)
    return out, torch.logsumexp(s, -1, keepdim=True) if with_lse else None


def _check_attention(name, q, k, v):
    bf = torch.bfloat16
    _check_tensors(name, q.device, q=(q, bf), k=(k, bf), v=(v, bf))
    G, Nq, hd = q.shape
    Nk = k.shape[1]
    _require(name, k.shape == v.shape == (G, Nk, hd),
             f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    _require(name, Nq % 64 == 0 and Nk % 64 == 0,
             f"Nq={Nq}, Nk={Nk} (multiples of 64)")
    _require(name, hd % 8 == 0 and hd <= 256, f"hd={hd} (multiple of 8)")
    return G, Nq, Nk, hd


def attention_plan(hd: int) -> dict:
    """The tile plan ``csrc/attention.cu`` picks for head dim ``hd`` (its
    ``FwdPlan`` / ``DqPlan`` / ``DkvPlan``; ``emp_attention_config``
    reports the same numbers from the library).  The head dim is padded
    to ``fwd_hdp`` / ``bwd_hdp`` (64, 128 or 256); ``*_bn`` are keys a
    tile, ``*_smem`` the dynamic shared memory bytes of a block (with 1
    KB of alignment slack and the mbarriers); at HDP 256 the dk / dv
    kernel also holds the P^T and dS^T tiles it exchanges."""
    if hd <= 0 or hd % 8 or hd > 256:
        raise ValueError(f"attention: hd={hd} (multiple of 8 up to 256)")
    f = b = 64 if hd <= 64 else 128 if hd <= 128 else 256
    fwd_bn = 64 if f == 256 else 128
    fwd_stages = 2 if f >= 128 else 3
    dq_bn, dq_stages, dkv_stages = (32 if b == 256 else 64), 2, 2
    return dict(
        fwd_hdp=f, fwd_bn=fwd_bn, fwd_stages=fwd_stages,
        fwd_smem=128 * f * 2 + fwd_stages * 2 * fwd_bn * f * 2 + 1024
        + 8 * (1 + 3 * fwd_stages),
        bwd_hdp=b, dq_bn=dq_bn, dq_stages=dq_stages,
        dq_smem=2 * 128 * b * 2 + dq_stages * 2 * dq_bn * b * 2 + 1024
        + 8 * (1 + 2 * dq_stages),
        dkv_stages=dkv_stages,
        dkv_smem=2 * 64 * b * 2 + dkv_stages * (2 * 64 * b * 2 + 2 * 64 * 4)
        + (2 * 64 * 64 * 2 if b == 256 else 0) + 1024
        + 8 * (1 + 2 * dkv_stages),
    )


def attention_launch_config(hd: int) -> dict:
    """:func:`attention_plan`'s numbers as the library reports them."""
    import ctypes

    cfg = (ctypes.c_int * 10)()
    _raise_on(_lib().emp_attention_config(hd, cfg), "attention_config")
    return dict(zip(("fwd_hdp", "fwd_bn", "fwd_stages", "fwd_smem",
                     "bwd_hdp", "dq_bn", "dq_stages", "dq_smem",
                     "dkv_stages", "dkv_smem"), cfg))


def attention(q, k, v, scale: float):
    """``softmax(q k^T * scale) v`` over ``(G, N, hd)`` flattened heads.

    Returns ``(out (G, Nq, hd), lse (G, Nq, 1) f32)``.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    name = "attention"
    G, Nq, Nk, hd = _check_attention(name, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((G, Nq, 1), dtype=torch.float32, device=q.device)
    rc = _lib().emp_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), G, Nq, Nk, hd, float(scale), _stream(q),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out, lse


def attention_bwd_plain(q, k, v, out, lse, dout, scale):
    """Plain twin of :func:`attention_bwd`: the TPU backward in float32,
    rounding ``p`` and ``ds`` to the working type before their products."""
    dt = q.dtype
    D = (dout.float() * out.float()).sum(-1, keepdim=True)
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse)
    dp = dout.float() @ v.float().transpose(1, 2)
    ds = (p * (dp - D) * scale).to(dt).float()
    dq = (ds @ k.float()).to(dt)
    dk = (ds.transpose(1, 2) @ q.float()).to(dt)
    dv = (p.to(dt).float().transpose(1, 2) @ dout.float()).to(dt)
    return dq, dk, dv


def attention_bwd(q, k, v, out, lse, dout, scale: float):
    """``(dq, dk, dv)`` of :func:`attention` from its saved ``out`` and
    ``lse`` and the output gradient ``dout``.  ``D = rowsum(dout *
    out)``, which the JAX package forms in XLA, is the library's first
    pass (into a scratch the wrapper allocates)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, scale)
    name = "attention_bwd"
    G, Nq, Nk, hd = _check_attention(name, q, k, v)
    _check_tensors(name, q.device, out=(out, torch.bfloat16),
                   dout=(dout, torch.bfloat16), lse=(lse, torch.float32))
    _require(name, out.shape == dout.shape == q.shape
             and lse.shape == (G, Nq, 1), "out / dout / lse shapes")
    D = torch.empty((G, Nq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _lib().emp_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), G, Nq, Nk, hd, float(scale),
        _stream(q),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq, dk, dv


@torch.library.custom_op("emp::attention", mutates_args=())
def _attention_op(q: Tensor, k: Tensor, v: Tensor,
                  scale: float) -> tuple[Tensor, Tensor]:
    return _fresh(attention(q, k, v, scale))


@_attention_op.register_fake
def _(q, k, v, scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:2] + (1,), dtype=torch.float32))


@torch.library.custom_op("emp::attention_bwd", mutates_args=())
def _attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                      lse: Tensor, dout: Tensor,
                      scale: float) -> tuple[Tensor, Tensor, Tensor]:
    return _fresh(attention_bwd(q, k, v, out, lse, dout, scale))


@_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, scale):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _attention_setup(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.scale = scale


def _attention_grads(ctx, g, g_lse):
    """B6 from the saved ``out`` and ``lse``; the logsumexp output is not
    differentiated (the models use the attention output only)."""
    q, k, v, out, lse = ctx.saved_tensors
    return torch.ops.emp.attention_bwd(q, k, v, out, lse, g.contiguous(),
                                       ctx.scale) + (None,)


_attention_op.register_autograd(_attention_grads,
                                setup_context=_attention_setup)


def attention_op(q, k, v, scale: float):
    """Differentiable attention output: ``emp::attention`` (K2 forward,
    B6 backward)."""
    return torch.ops.emp.attention(q, k, v, scale)[0]


# --------------------------------------------------------------------------
# K3/K4: LN -> GEMM and GELU -> GEMM
# --------------------------------------------------------------------------

def ln_dense_plain(x, s, b, w, bias, eps=1e-6):
    """Plain twin of :func:`ln_dense_fused`."""
    dt = x.dtype
    z = _layer_norm_f32(x.float(), s, b, eps).to(dt)
    o = z.float() @ _wt(w, dt).t()
    if bias is not None:
        o = o + bias.float()
    return o.to(dt)


def gelu_dense_plain(x, w, bias):
    """Plain twin of :func:`gelu_dense_fused`."""
    dt = x.dtype
    z = F.gelu(x.float()).to(dt)
    o = z.float() @ _wt(w, dt).t()
    if bias is not None:
        o = o + bias.float()
    return o.to(dt)


def ln_dense_xla(x, s, b, w, bias, eps=1e-6):
    """The math K3's backward differentiates, as the JAX package's
    ``_xla_ln_dense`` (``pallas_kernels.py:1815``) writes it: float32 LN
    statistics and affine, then the product and the bias in ``x``'s
    dtype, so the gradients' matrix products run in bf16 on the bf16
    paths, as JAX's do."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    z = ((xf - mu) * torch.rsqrt(var + eps) * s + b).to(dt)
    o = z @ w.to(dt).t()
    return o if bias is None else o + bias.to(dt)


def gelu_dense_xla(x, w, bias):
    """The math K4's backward differentiates, as ``_xla_gelu_dense``
    (``pallas_kernels.py:1824``): exact GELU, product and bias in ``x``'s
    dtype."""
    dt = x.dtype
    o = F.gelu(x) @ w.to(dt).t()
    return o if bias is None else o + bias.to(dt)


def _check_dense(name, x, w, bias):
    bf, f32 = torch.bfloat16, torch.float32
    _check_tensors(name, x.device, x=(x, bf), w=(w, bf), bias=(bias, f32))
    M, K = x.shape
    N = w.shape[0]
    _require(name, w.shape == (N, K), f"w {tuple(w.shape)} for K={K}")
    _require(name, M > 0 and N > 0 and K > 0 and N % 8 == 0 and K % 8 == 0,
             f"(M, K, N)=({M}, {K}, {N}) (N%8, K%8)")
    _require(name, bias is None or bias.shape == (N,), "bias shape")
    return M, K, N


def dense_launch_config() -> dict:
    """The K3/K4 GEMM's launch configuration, as the library reports it:
    ring stages, dynamic shared memory bytes, CTA tile and threads."""
    import ctypes

    cfg = (ctypes.c_int * 6)()
    _lib().emp_dense_config(cfg)
    return dict(zip(("stages", "smem_bytes", "bm", "bn", "bk", "threads"),
                    cfg))


def ln_dense_fused(x, s, b, w, bias, eps=1e-6):
    """``LN(x; s, b) @ w.T + bias`` for ``x (M, K)`` bf16, ``w (N, K)``
    bf16, LN params and ``bias`` (or None) f32.  Two launches (the LN
    pass into a bf16 scratch, then the GEMM), counted as one call."""
    if x.device.type == "cpu":
        return ln_dense_plain(x, s, b, w, bias, eps)
    name = "ln_dense_fused"
    M, K, N = _check_dense(name, x, w, bias)
    _check_tensors(name, x.device, s=(s, torch.float32),
                   b=(b, torch.float32))
    z = torch.empty((M, K), dtype=x.dtype, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_ln_dense(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(), _ptr(bias),
        z.data_ptr(), out.data_ptr(), M, K, N, float(eps), _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def gelu_dense_fused(x, w, bias):
    """``gelu(x) @ w.T + bias`` (exact erf) for ``x (M, K)`` bf16; two
    launches (GELU pass, GEMM), counted as one call."""
    if x.device.type == "cpu":
        return gelu_dense_plain(x, w, bias)
    name = "gelu_dense_fused"
    M, K, N = _check_dense(name, x, w, bias)
    z = torch.empty((M, K), dtype=x.dtype, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_gelu_dense(
        x.data_ptr(), w.data_ptr(), _ptr(bias), z.data_ptr(),
        out.data_ptr(), M, K, N, _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


@torch.library.custom_op("emp::ln_dense_fused", mutates_args=())
def _ln_dense_op(x: Tensor, s: Tensor, b: Tensor, w: Tensor,
                 bias: Optional[Tensor], eps: float) -> Tensor:
    return _fresh(ln_dense_fused(x, s.float(), b.float(),
                                 w.to(x.dtype).contiguous(), _f32(bias), eps))


@_ln_dense_op.register_fake
def _(x, s, b, w, bias, eps):
    return x.new_empty((x.shape[0], w.shape[0]))


def _ln_dense_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.eps = inputs[5]


def _ln_dense_grads(ctx, g):
    """Autograd of :func:`ln_dense_xla`, as JAX's ``_ln_dense_bwd``
    (``pallas_kernels.py:1852``) replays ``_xla_ln_dense``."""
    return _replay(lambda *a: ln_dense_xla(*a, ctx.eps), ctx.saved_tensors,
                   g) + (None,)


_ln_dense_op.register_autograd(_ln_dense_grads, setup_context=_ln_dense_setup)


@torch.library.custom_op("emp::gelu_dense_fused", mutates_args=())
def _gelu_dense_op(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    return _fresh(gelu_dense_fused(x, w.to(x.dtype).contiguous(),
                                   _f32(bias)))


@_gelu_dense_op.register_fake
def _(x, w, bias):
    return x.new_empty((x.shape[0], w.shape[0]))


def _gelu_dense_grads(ctx, g):
    """Autograd of :func:`gelu_dense_xla`, as JAX's ``_gelu_dense_bwd``
    (``pallas_kernels.py:1875``) replays ``_xla_gelu_dense``."""
    return _replay(gelu_dense_xla, ctx.saved_tensors, g)


_gelu_dense_op.register_autograd(_gelu_dense_grads,
                                 setup_context=_save_inputs)


def ln_dense(x, s, b, w, bias, eps=1e-6):
    """Differentiable K3 (float32 parameters): ``emp::ln_dense_fused``."""
    return torch.ops.emp.ln_dense_fused(x, s, b, w, bias, eps)


def gelu_dense(x, w, bias):
    """Differentiable K4 (float32 parameters): ``emp::gelu_dense_fused``."""
    return torch.ops.emp.gelu_dense_fused(x, w, bias)


# --------------------------------------------------------------------------
# B7: per-point triplane sampling
# --------------------------------------------------------------------------

def triplane_sample_plain(triplane, coords):
    """Plain twin of :func:`triplane_sample`: three bilinear samples
    (``ops.sampling.grid_sample_2d``) in float32, summed, cast to the
    triplane's dtype."""
    t = triplane.float()
    xy = grid_sample_2d(t[:, 0], coords[..., [0, 1]])
    yz = grid_sample_2d(t[:, 1], coords[..., [1, 2]])
    xz = grid_sample_2d(t[:, 2], coords[..., [0, 2]])
    return (xy + yz + xz).to(triplane.dtype)


def triplane_sample_bwd_plain(coords, g, S: int):
    """Plain twin of :func:`triplane_sample_bwd`: the adjoint of the plain
    sample (``ops.sampling.grid_sample_2d_adjoint`` of each plane; the
    sample is linear in the planes) in float32, returned in float32."""
    return torch.stack([
        grid_sample_2d_adjoint(coords[..., list(axes)], g, S, S)
        for axes in TRI_PLANE_AXES], 1)


# The B7 backward sums a cell with more than TRI_BWD_LIGHT entries in
# chunks of TRI_BWD_CHUNK entries from its list's start, each by
# TRI_BWD_LANES lanes and a tree; the kernel is compiled with the same
# values (ops/_build.DEFINES).
_TRI_ORDER = _build_defines["triplane_sample.cu"]
TRI_BWD_LIGHT = _TRI_ORDER["EMP_TB_LIGHT"]
TRI_BWD_LANES = _TRI_ORDER["EMP_TB_LANES"]
TRI_BWD_CHUNK = _TRI_ORDER["EMP_TB_CHUNK"]
TRI_BWD_MAX_S = 1022
TRI_PLANE_AXES = ((0, 1), (1, 2), (0, 2))  # (u -> W, v -> H) of each plane


def triplane_bwd_scratch_words(B: int, P: int, S: int, C: int) -> int:
    """int32 words of the B7 backward's scratch, as the kernel library
    lays it out (``tri_bwd_scratch`` in ``csrc/triplane_sample.cu``)."""
    import ctypes

    words = ctypes.c_longlong()
    rc = _lib().emp_triplane_bwd_scratch_words(B, P, S, C,
                                               ctypes.byref(words))
    _raise_on(rc, "triplane_sample_bwd")
    return words.value


def triplane_footprints(coords, S: int):
    """Each point's bilinear footprint on each plane, as the B7 kernels
    compute it (``footprint`` in ``csrc/triplane_sample.cu``): float32
    numpy, one rounded step at a time.  ``coords (B, P, 3)``; returns the
    cells ``(B, 3, P)`` int64, ``(y0 + 1) (S + 1) + x0 + 1`` or -1 when
    no corner is on the plane (NaN coordinates included), and the weights
    ``(B, 3, P, 4)`` float32 of the corners (y0, x0), (y0, x0 + 1),
    (y0 + 1, x0), (y0 + 1, x0 + 1)."""
    f32 = np.float32
    c = np.asarray(coords, f32)
    u = c[..., [a for a, _ in TRI_PLANE_AXES]].transpose(0, 2, 1)
    v = c[..., [a for _, a in TRI_PLANE_AXES]].transpose(0, 2, 1)
    ix = ((u + f32(1)) * f32(S) - f32(1)) * f32(0.5)
    iy = ((v + f32(1)) * f32(S) - f32(1)) * f32(0.5)
    x0, y0 = np.floor(ix), np.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = f32(1) - wx1, f32(1) - wy1
    w = np.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1)
    with np.errstate(invalid="ignore"):
        on = (x0 >= -1) & (x0 <= S - 1) & (y0 >= -1) & (y0 <= S - 1)
    cell = np.where(on, (np.where(on, y0, 0) + 1) * (S + 1)
                    + np.where(on, x0, 0) + 1, -1).astype(np.int64)
    return cell, w


def _lane_tree(x):
    """Sum over axis 1 (the lanes, a power of two) as the kernel's block
    tree does: x[l] + x[l + n / 2], then n / 4, ... 1 apart."""
    off = x.shape[1] // 2
    while off:
        x = x[:, :off] + x[:, off:2 * off]
        off //= 2
    return x[:, 0]


def triplane_sample_bwd_reference(coords, g, S: int):
    """The B7 backward kernel's gradient before its one rounding to bf16,
    on the host: float32 numpy in the kernel's order.

    ``coords (B, P, 3)`` and ``g (B, P, C)`` are numpy arrays (g's values
    as the kernel reads them: bf16 widened to float32).  Per (b, plane),
    each point's footprint cell ``(x0, y0)`` and corner weights are
    computed one rounded float32 step at a time (a point with no corner on
    the plane, NaN included, is dropped), and the points are listed by
    cell, ascending in p.  A cell's sum ``s_k`` for corner k: with at most
    ``TRI_BWD_LIGHT`` entries, ``0 + g * w_k`` over them in list order;
    with more, its list splits into chunks of ``TRI_BWD_CHUNK`` entries
    from its start, each chunk's sum is ``TRI_BWD_LANES`` lane sums (lane
    ``i % TRI_BWD_LANES`` of the chunk's entry i, in list order) added by
    :func:`_lane_tree`, and ``s_k`` is ``0 +`` the chunk sums in order.
    A texel is ``0 + s_k`` over its corners k = 0..3 of the cells (y, x),
    (y, x - 1), (y - 1, x), (y - 1, x - 1).  Returns ``(B, 3, S, S, C)``
    float32."""
    f32 = np.float32
    g = np.asarray(g, f32)
    B, P, C = g.shape
    ncell = (S + 1) ** 2
    cy, cx = np.divmod(np.arange(ncell), S + 1)
    cells, weights = triplane_footprints(coords, S)
    out = np.zeros((B, 3, S * S, C), f32)
    for b in range(B):
        for pl in range(3):
            pts = np.nonzero(cells[b, pl] >= 0)[0]
            order = np.argsort(cells[b, pl, pts], kind="stable")
            lp = pts[order]  # the entries' points, in list order
            lc = cells[b, pl, lp]
            cnt = np.bincount(lc, minlength=ncell)
            terms = g[b, lp][:, None, :] * weights[b, pl, lp][:, :, None]
            sums = np.zeros((ncell, 4, C), f32)
            heavy = cnt[lc] > TRI_BWD_LIGHT
            np.add.at(sums, lc[~heavy], terms[~heavy])
            he = np.nonzero(heavy)[0]
            if he.size:
                # an entry's rank in its cell's list: its chunk and lane
                rank = he - (np.cumsum(cnt) - cnt)[lc[he]]
                nq = lp.size // TRI_BWD_CHUNK + 1
                ck, cinv = np.unique(lc[he] * nq + rank // TRI_BWD_CHUNK,
                                     return_inverse=True)
                lanes = np.zeros((ck.size, TRI_BWD_LANES, 4, C), f32)
                np.add.at(lanes, (cinv.ravel(), rank % TRI_BWD_LANES),
                          terms[he])
                # chunks in (cell, chunk) order: each cell's in order
                np.add.at(sums, ck // nq, _lane_tree(lanes))
            plane = out[b, pl]
            for k in range(4):
                ty, tx = cy - 1 + (k >> 1), cx - 1 + (k & 1)
                on = (tx >= 0) & (tx < S) & (ty >= 0) & (ty < S)
                plane[ty[on] * S + tx[on]] += sums[on, k]
    return out.reshape(B, 3, S, S, C)


def _check_sample(name, coords, C):
    _require(name, coords.dim() == 3 and coords.shape[-1] == 3,
             f"coords {tuple(coords.shape)} (B, P, 3)")
    _require(name, C % 8 == 0, f"C={C} (multiple of 8)")
    _check_tensors(name, coords.device, coords=(coords, torch.float32))


def triplane_sample(triplane, coords):
    """Sum of the three planes of ``triplane (B, 3, S, S, C)`` bf16,
    bilinearly sampled (zero padding, align_corners=False) at normalized
    ``coords (B, P, 3)`` f32; returns ``(B, P, C)`` bf16.  The kernel
    takes ``C % 8 == 0`` and ``3 S^2 C < 2^31``."""
    if triplane.device.type == "cpu":
        return triplane_sample_plain(triplane, coords)
    name = "triplane_sample"
    B, _, S, S2, C = triplane.shape
    _require(name, triplane.shape[1] == 3 and S == S2,
             f"triplane {tuple(triplane.shape)}")
    _check_sample(name, coords, C)
    _check_tensors(name, coords.device,
                   triplane=(triplane, torch.bfloat16))
    _require(name, coords.shape[0] == B, "batch of coords")
    P = coords.shape[1]
    _require(name, P > 0 and 3 * S * S * C < 2**31,
             f"P={P}, S={S}, C={C} (P > 0, 3 S^2 C < 2^31)")
    out = torch.empty((B, P, C), dtype=triplane.dtype, device=coords.device)
    rc = _lib().emp_triplane_sample_fwd(
        triplane.data_ptr(), coords.data_ptr(), out.data_ptr(), B, P, S, C,
        _stream(coords))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def triplane_sample_bwd(coords, g, S: int):
    """Gradient of :func:`triplane_sample` with respect to the triplane,
    ``(B, 3, S, S, C)`` in ``g``'s dtype, from ``g (B, P, C)`` (bf16 on
    CUDA).  The kernel gathers each texel's terms in a fixed order and
    writes it once (:func:`triplane_sample_bwd_reference` gives the same
    bits on the host), so the result is the same from call to call; it
    takes ``S <= TRI_BWD_MAX_S``, ``C % 8 == 0`` and ``3 B <= 65535``."""
    if g.device.type == "cpu":
        return triplane_sample_bwd_plain(coords, g, S).to(g.dtype)
    name = "triplane_sample_bwd"
    _require(name, g.dim() == 3, f"g of shape {tuple(g.shape)} (B, P, C)")
    B, P, C = g.shape
    _check_sample(name, coords, C)
    _check_tensors(name, coords.device, g=(g, torch.bfloat16))
    _require(name, coords.shape[:2] == (B, P), "coords / g shapes")
    _require(name, P > 0 and 0 < S <= TRI_BWD_MAX_S and 3 * B <= 65535,
             f"P={P}, S={S}, B={B} (P > 0, S <= {TRI_BWD_MAX_S}, "
             "3B <= 65535)")
    words = triplane_bwd_scratch_words(B, P, S, C)
    meta = torch.empty(words, dtype=torch.int32, device=g.device)
    grad = torch.empty((B, 3, S, S, C), dtype=g.dtype, device=g.device)
    rc = _lib().emp_triplane_sample_bwd(
        coords.data_ptr(), g.data_ptr(), meta.data_ptr(), words,
        grad.data_ptr(), B, P, S, C, _stream(g))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return grad


@torch.library.custom_op("emp::triplane_sample", mutates_args=())
def _triplane_sample_op(triplane: Tensor, coords: Tensor) -> Tensor:
    return _fresh(triplane_sample(triplane, coords))


@_triplane_sample_op.register_fake
def _(triplane, coords):
    return triplane.new_empty(coords.shape[:2] + triplane.shape[-1:])


@torch.library.custom_op("emp::triplane_sample_bwd", mutates_args=())
def _triplane_sample_bwd_op(coords: Tensor, g: Tensor, S: int) -> Tensor:
    return _fresh(triplane_sample_bwd(coords, g, S))


@_triplane_sample_bwd_op.register_fake
def _(coords, g, S):
    B, _, C = g.shape
    return g.new_empty((B, 3, S, S, C))


def _triplane_sample_setup(ctx, inputs, output):
    triplane, coords = inputs
    ctx.save_for_backward(coords)
    ctx.S = triplane.shape[2]


def _triplane_sample_grads(ctx, g):
    """B7's backward; coords get no gradient (``:204``).  The gradient
    comes in g's dtype, the triplane's (the forward returns the
    triplane's dtype)."""
    (coords,) = ctx.saved_tensors
    return torch.ops.emp.triplane_sample_bwd(coords, g.contiguous(),
                                             ctx.S), None


_triplane_sample_op.register_autograd(_triplane_sample_grads,
                                      setup_context=_triplane_sample_setup)


def triplane_sample_op(triplane, coords):
    """Differentiable :func:`triplane_sample`: ``emp::triplane_sample``."""
    return torch.ops.emp.triplane_sample(triplane, coords)


# --------------------------------------------------------------------------
# B9: the point projector's plane MLP over raw (-inf in empty cells) pools
# --------------------------------------------------------------------------

FINITE_MLP_WIDTH = 128


def finite_mlp_plain(x, w1, b1, w2, b2):
    """Plain twin of :func:`finite_mlp_fused`: -inf -> 0, both products
    in float32 on working-type operands, ``h`` rounded to the working
    type before the second (``pallas_kernels.py:_xla_finite_mlp``)."""
    dt = x.dtype
    xf = x.float()
    z = torch.where(xf == float("-inf"), torch.zeros((), device=x.device),
                    xf).to(dt).float()
    h = torch.relu(z @ _wt(w1, dt).t() + b1.float()).to(dt).float()
    return (h @ _wt(w2, dt).t() + b2.float()).to(dt)


def finite_mlp_launch(x, w1, b1, w2, b2):
    """``relu(finite0(x) @ w1.T + b1) @ w2.T + b2``, ``finite0`` turning
    the -inf of empty pool cells into 0: the B9 kernel, no autograd
    (:func:`finite_mlp_fused` is the differentiable op).

    Args:
        x: ``(M, K)`` bf16 raw pools, ``K % 8 == 0`` (TMA moves rows of a
            multiple of 16 bytes).
        w1: ``(128, K)`` bf16; w2: ``(128, 128)`` bf16 (``nn.Linear``
            layout); b1, b2: ``(128,)`` float32.

    Returns ``(M, 128)`` in ``x``'s dtype.
    """
    if x.device.type == "cpu":
        return finite_mlp_plain(x, w1, b1, w2, b2)
    name = "finite_mlp_fused"
    bf, f32 = torch.bfloat16, torch.float32
    _check_tensors(name, x.device, x=(x, bf), w1=(w1, bf), b1=(b1, f32),
                   w2=(w2, bf), b2=(b2, f32))
    _require(name, x.dim() == 2, f"x of shape {tuple(x.shape)} (M, K)")
    M, K = x.shape
    N = FINITE_MLP_WIDTH
    _require(name, w1.shape == (N, K) and w2.shape == (N, N)
             and b1.shape == (N,) and b2.shape == (N,),
             f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} for K={K} "
             f"(width {N})")
    _require(name, K > 0 and K % 8 == 0 and M > 0, f"(M, K)=({M}, {K}) (K%8)")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_finite_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), M, K, _stream(x))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def finite_mlp_bwd(x, w1, b1, w2, b2, g):
    """The VJP of :func:`finite_mlp_fused` at ``g``: ``(dx, dw1, db1,
    dw2, db2)``, the JAX package's ``_finite_mlp_bwd`` (``jax.vjp`` of
    ``_xla_finite_mlp``) written out.

    Products take working-type operands (``x``'s dtype) with float32
    accumulation; ``h``'s pre-activation is recomputed in float32 and
    the ReLU output rounded where the forward rounds it; ``dh`` and the
    weight gradients and ``dx`` are rounded to the working type, as the
    transposes of the forward's casts round them.  ``dx`` is 0 wherever
    ``x`` is -inf: the -inf never enters a product.  Bias gradients are
    float32 column sums.

    One deliberate difference: the ReLU's slope at a pre-activation of
    exactly 0 is 0, as ``nn.ReLU`` (the reference) and the JAX package's
    unfused plane MLP (``nn.relu``) take it, where ``_xla_finite_mlp``'s
    ``jnp.maximum`` gives 1/2.  Every empty cell's row is such a tie
    wherever ``b1`` is 0, as at initialisation, and there the 1/2 sums
    over the empty rows into ``db1``, which then dominates the clipped
    global norm."""
    dt = x.dtype
    empty = x == float("-inf")
    z = x.masked_fill(empty, 0.0)
    w1c, w2c, g = w1.to(dt), w2.to(dt), g.to(dt)
    pre = _mm_f32(z, w1c.t()) + b1.float()
    a = torch.relu(pre).to(dt)
    dw2 = g.t() @ a
    db2 = g.float().sum(0)
    dpre = (g @ w2c).masked_fill(pre <= 0, 0.0)
    db1 = dpre.float().sum(0)
    dw1 = dpre.t() @ z
    dx = (dpre @ w1c).masked_fill(empty, 0.0)
    return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), \
        db2.to(b2.dtype)


@torch.library.custom_op("emp::finite_mlp_fused", mutates_args=())
def _finite_mlp_op(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                   b2: Tensor) -> Tensor:
    return _fresh(finite_mlp_launch(x, w1, b1, w2, b2))


@_finite_mlp_op.register_fake
def _(x, w1, b1, w2, b2):
    return x.new_empty((x.shape[0], FINITE_MLP_WIDTH))


def _finite_mlp_grads(ctx, g):
    """:func:`finite_mlp_bwd` (torch products, as the JAX package's VJP
    is XLA math, no Pallas kernel)."""
    return finite_mlp_bwd(*ctx.saved_tensors, g)


_finite_mlp_op.register_autograd(_finite_mlp_grads,
                                 setup_context=_save_inputs)


def finite_mlp_fused(x, w1, b1, w2, b2):
    """Differentiable B9 (arguments as :func:`finite_mlp_launch`):
    ``emp::finite_mlp_fused``, the kernel forward, :func:`finite_mlp_bwd`
    backward."""
    return torch.ops.emp.finite_mlp_fused(x, w1, b1, w2, b2)


# --------------------------------------------------------------------------
# B10: the int8 ConvNeXt block (depthwise 7x7 outside; LN + int8 MLP in)
# --------------------------------------------------------------------------

def _block_int8_twin(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    C = x.shape[-1]
    y = dwconv7(x, dw_k, dw_b)
    yd = y.double().reshape(-1, C)
    mu = yd.mean(-1, keepdim=True)
    rs = 1.0 / torch.sqrt(((yd - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
    z = ((yd.float() - mu.float()) * rs.float() * ln_s.float()
         + ln_b.float())
    zq, zs = sym_quant(z, -1)
    w1q, w1s = quantize_weight(w1)
    h = F.gelu(int_mm(zq, w1q).float() * zs * w1s + b1.float())
    hq, hs = sym_quant(h, -1)
    w2q, w2s = quantize_weight(w2)
    o = int_mm(hq, w2q).float() * hs * w2s + b2.float()
    if gamma is not None:
        o = o * gamma.float()
    return (x.float() + o.reshape(x.shape)).to(x.dtype)


def _gelu_grad(h):
    """The derivative of the exact-erf GELU at float32 ``h``."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    pdf = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return cdf + h * pdf


def convnext_block_int8_bwd(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                            gamma, g, needs=(True,) * 10):
    """The VJP of the int8 ConvNeXt block at ``g``: the gradients of ``(x,
    dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)``, each in its input's
    dtype (None where ``needs`` says so).

    The JAX package's ``_block_int8_bwd`` (``pallas_kernels.py:1627``),
    ``jax.vjp`` of ``_xla_block_int8_math`` (``:1577-1602``), written out
    in tensor ops, since autograd does not run inside an op's
    implementation.  The forward is recomputed as that math, not as the
    kernel's twin: the depthwise conv in ``x``'s dtype (the compute
    dtype), LayerNorm statistics in float32, ``z`` cast to the compute
    dtype before fc1's dynamic int8 product, the bias added in float32
    and cast back, exact-erf GELU on float32, cast back before fc2's
    product, gamma in the compute dtype, then the residual.  The two
    products take the straight-through rule (``ops.quant.int8_matmul``):
    ``dz = dh @ w1`` and ``da = do @ w2`` in the compute dtype, ``dw1 =
    dh.T @ z`` and ``dw2 = do.T @ a`` summed in float32.  Bias, gamma and
    LayerNorm gradients are float32 sums; the depthwise conv's input,
    weight and bias gradients come from ``aten.convolution_backward``."""
    dt = x.dtype
    N, H, W, C = x.shape
    with torch.no_grad():
        xc = x.permute(0, 3, 1, 2)
        wk = dw_k.to(dt)
        y = F.conv2d(xc, wk, dw_b.to(dt), padding=3, groups=C)
        yf = y.permute(0, 2, 3, 1).reshape(-1, C).float()
        mu = yf.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((yf - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
        xhat = (yf - mu) * rstd
        z = (xhat * ln_s.float() + ln_b.float()).to(dt)
        h = quant_dense(z, w1, b1).float()
        a = F.gelu(h).to(dt)
        g2 = g.reshape(-1, C).to(dt)
        grads = [None] * 10
        if gamma is not None:
            if needs[9]:
                o = quant_dense(a, w2, b2)
                grads[9] = (g2.float() * o.float()).sum(0).to(gamma.dtype)
            do = g2 * gamma.to(dt)
        else:
            do = g2
        if needs[8]:
            grads[8] = do.float().sum(0).to(b2.dtype)
        if needs[7]:
            grads[7] = _mm_f32(do.t(), a).to(w2.dtype)
        da = _mm_f32(do, w2.to(dt)).to(dt)
        dh = (da.float() * _gelu_grad(h)).to(dt)
        if needs[6]:
            grads[6] = dh.float().sum(0).to(b1.dtype)
        if needs[5]:
            grads[5] = _mm_f32(dh.t(), z).to(w1.dtype)
        dz = _mm_f32(dh, w1.to(dt)).to(dt).float()
        if needs[3]:
            grads[3] = (dz * xhat).sum(0).to(ln_s.dtype)
        if needs[4]:
            grads[4] = dz.sum(0).to(ln_b.dtype)
        dxh = dz * ln_s.float()
        dy = (rstd * (dxh - dxh.mean(-1, keepdim=True) - xhat * (
            dxh * xhat).mean(-1, keepdim=True))).to(dt)
        if any(needs[:3]):
            dyc = dy.reshape(N, H, W, C).permute(0, 3, 1, 2)
            dxc, dk, db = torch.ops.aten.convolution_backward(
                dyc, xc, wk, [C], [1, 1], [3, 3], [1, 1], False, [0, 0], C,
                [needs[0], needs[1], needs[2]])
            if needs[0]:
                grads[0] = g + dxc.permute(0, 2, 3, 1).to(dt)
            if needs[1]:
                grads[1] = dk.to(dw_k.dtype)
            if needs[2]:
                grads[2] = db.to(dw_b.dtype)
    return tuple(grads)


def block_int8_xla(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """The JAX package's ``_xla_block_int8_math`` (``pallas_kernels.py:
    1577-1602``) in tensor ops, differentiable through the
    straight-through products of ``ops.quant.quant_dense``: autograd of it
    is the VJP that :func:`convnext_block_int8_bwd` writes out."""
    dt, C = x.dtype, x.shape[-1]
    y = dwconv7(x, dw_k, dw_b)
    z = F.layer_norm(y.float(), (C,), ln_s.float(), ln_b.float(),
                     1e-6).to(dt)
    a = F.gelu(quant_dense(z, w1, b1).float()).to(dt)
    o = quant_dense(a, w2, b2)
    if gamma is not None:
        o = o * gamma.to(dt)
    return x + o


def convnext_block_int8_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                              gamma):
    """Plain twin of :func:`convnext_block_int8_fused`, at B10's rounding
    points: LN's mean and variance in float64 rounded to float32, ``z``
    and ``h`` quantized per row from float32, weights per output channel,
    int32 sums dequantized as ``acc * row_scale * col_scale + bias``,
    exact-erf GELU.  Each step is one eager op, so on the card this twin
    rounds where the kernel does and matches it bit for bit.  Under
    autograd its value is the twin's and its gradient that of
    :func:`block_int8_xla` (the op's VJP, by autograd)."""
    args = (x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    with torch.no_grad():
        out = _block_int8_twin(*args)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        ste = block_int8_xla(*args)
        out = out + (ste - ste.detach())
    return out


def plan_b10_chunks(M: int, C: int) -> list[tuple[int, int]]:
    """B10's row chunks ``(first row, rows)``: as few as keep each chunk's
    zq and hq scratch (5 C bytes a row) under ``B10_CHUNK_BYTES``; equal
    rows rounded up to the GEMM's 128-row tile (the last takes the
    rest)."""
    cap = max(GEMM_BM, B10_CHUNK_BYTES // (5 * C) // GEMM_BM * GEMM_BM)
    n = -(-M // cap)
    rows = -(-M // (n * GEMM_BM)) * GEMM_BM
    return [(r, min(rows, M - r)) for r in range(0, M, rows)]


def convnext_block_int8_fused(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                              gamma):
    """One ConvNeXt block with both MLP products in int8 (forward).

    Args:
        x: ``(N, H, W, C)`` bf16 (CUDA) input.
        dw_k, dw_b: depthwise ``(C, 1, 7, 7)`` kernel and ``(C,)`` bias.
        ln_s, ln_b, b1, b2, gamma: f32; ``gamma`` may be None.
        w1: ``(4C, C)``, w2: ``(C, 4C)`` float weights, quantized per
            output channel (int8 codes and f32 scales) once per weight
            state (``ops.quant.cached_quantize_weight``).

    The depthwise conv runs in PyTorch; the rest is the kernel's chain
    (row pass, fc1's amax and quantize passes, fc2) over the row chunks
    of :func:`plan_b10_chunks`, counted as one call.  The backward is the
    op's (:func:`convnext_block_int8`).
    """
    if x.device.type == "cpu":
        return _block_int8_twin(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                                gamma)
    name = "convnext_block_int8_fused"
    C = x.shape[-1]
    _require(name, C in CONVNEXT_WIDTHS, f"C={C} (takes {CONVNEXT_WIDTHS})")
    _require(name, w1.shape == (4 * C, C) and w2.shape == (C, 4 * C)
             and b1.shape == (4 * C,) and b2.shape == (C,),
             f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} at C={C}")
    f32 = torch.float32
    _check_tensors(name, x.device, x=(x, torch.bfloat16), ln_s=(ln_s, f32),
                   ln_b=(ln_b, f32), b1=(b1, f32), b2=(b2, f32),
                   gamma=(gamma, f32), w1=(w1, w1.dtype), w2=(w2, w2.dtype))
    w1q, w1s = cached_quantize_weight(w1)
    w2q, w2s = cached_quantize_weight(w2)
    y = dwconv7(x, dw_k, dw_b)
    out = torch.empty_like(x)
    M = x.numel() // C
    rows = plan_b10_chunks(M, C)[0][1]
    dev = x.device
    zq = torch.empty((rows, C), dtype=torch.int8, device=dev)
    zs = torch.empty((rows,), dtype=f32, device=dev)
    hmax = torch.empty((rows,), dtype=torch.int32, device=dev)
    hq = torch.empty((rows, 4 * C), dtype=torch.int8, device=dev)
    rc = _lib().emp_convnext_block_int8(
        x.data_ptr(), y.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
        w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        w2s.data_ptr(), b2.data_ptr(), _ptr(gamma), out.data_ptr(),
        zq.data_ptr(), zs.data_ptr(), hmax.data_ptr(), hq.data_ptr(), M, C,
        rows, plan_tile_width(rows, C, _sm_count(), INT8_WIDTHS), _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


@torch.library.custom_op("emp::convnext_block_int8_fused", mutates_args=())
def _convnext_block_int8_op(x: Tensor, dw_k: Tensor, dw_b: Tensor,
                            ln_s: Tensor, ln_b: Tensor, w1: Tensor,
                            b1: Tensor, w2: Tensor, b2: Tensor,
                            gamma: Optional[Tensor]) -> Tensor:
    return _fresh(convnext_block_int8_fused(x, dw_k, dw_b, ln_s, ln_b, w1,
                                            b1, w2, b2, gamma))


@_convnext_block_int8_op.register_fake
def _(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# calls of the backward of emp::convnext_block_int8_fused (torch ops, no
# kernel: the JAX package's VJP is XLA math)
VJP_CALLS = {"convnext_block_int8_fused": 0}


def _convnext_block_int8_grads(ctx, g):
    VJP_CALLS["convnext_block_int8_fused"] += 1
    return convnext_block_int8_bwd(*ctx.saved_tensors, g,
                                   needs=ctx.needs_input_grad)


_convnext_block_int8_op.register_autograd(_convnext_block_int8_grads,
                                          setup_context=_save_inputs)


def convnext_block_int8(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Differentiable B10 as the models call it (float32 parameters):
    ``emp::convnext_block_int8_fused``, the kernel forward and
    :func:`convnext_block_int8_bwd` backward.  The weight codes are cached
    inside the implementation, so traced code never reads a weight's
    pointer or version."""
    return torch.ops.emp.convnext_block_int8_fused(x, dw_k, dw_b, ln_s, ln_b,
                                                   w1, b1, w2, b2, gamma)


# --------------------------------------------------------------------------
# the int8 dot probe: the int8 wgmma GEMM of csrc/int8_gemm.cu
# --------------------------------------------------------------------------

def int8_dot_plain(x, w):
    """Plain twin of :func:`int8_dot` (exact)."""
    return int_mm(x, w)


def int8_dot(x, w):
    """Exact ``x (M, K) @ w (N, K).T`` for int8 operands, int32 ``(M,
    N)``; the kernel takes any ``M > 0``, ``N % 8 == 0`` and ``K % 16 ==
    0`` (TMA moves rows of 16 bytes and zero-fills the K tail), in
    128-row tiles of the width :func:`plan_tile_width` picks."""
    if x.device.type == "cpu":
        return int8_dot_plain(x, w)
    name = "int8_dot"
    _check_tensors(name, x.device, x=(x, torch.int8), w=(w, torch.int8))
    _require(name, x.dim() == 2 and w.dim() == 2
             and x.shape[1] == w.shape[1], f"x {tuple(x.shape)} / w "
             f"{tuple(w.shape)} ((M, K) and (N, K))")
    M, K = x.shape
    N = w.shape[0]
    _require(name, M > 0 and N > 0 and N % 8 == 0 and K > 0 and K % 16 == 0,
             f"(M, N, K)=({M}, {N}, {K}) (N%8, K%16)")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    bn = plan_tile_width(M, N, _sm_count(), INT8_WIDTHS)
    rc = _lib().emp_int8_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), M,
                              N, K, bn, _stream(x))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------------
# B8: the interact's camera -> range gather, summed over cameras
# --------------------------------------------------------------------------

def _gather_rows(idx, valid, K):
    """In-range valid entries (an index outside ``[0, K)`` contributes 0,
    as a one-hot row with no match does in the TPU kernel) and the
    indices clamped for ``torch.gather``."""
    idx = idx.long()
    keep = valid.bool() & (idx >= 0) & (idx < K)
    return keep, idx.clamp(0, K - 1)


def cam_gather_sum_plain(feats, idx, valid):
    """Plain twin of :func:`cam_gather_sum`, in float32."""
    B, N, K, C = feats.shape
    keep, idx = _gather_rows(idx, valid, K)
    rows = torch.gather(feats.float(), 2,
                        idx[..., None].expand(B, N, idx.shape[-1], C))
    return (rows * keep[..., None].float()).sum(1)


def cam_gather_sum_bwd_plain(g, idx, valid, K: int, dtype=torch.bfloat16):
    """Plain twin of :func:`cam_gather_sum_bwd`: ``g`` rounded to
    ``dtype``, ``index_add_`` into float32, then a cast to ``dtype``."""
    B, P, C = g.shape
    N = idx.shape[1]
    keep, idx = _gather_rows(idx, valid, K)
    dst = (torch.arange(B * N, device=g.device).reshape(B, N, 1) * K
           + idx)[keep]
    src = g.to(dtype).float()[:, None].expand(B, N, P, C)[keep]
    out = torch.zeros((B * N * K, C), dtype=torch.float32, device=g.device)
    return out.index_add_(0, dst, src).reshape(B, N, K, C).to(dtype)


def _check_gather(name, idx, valid, C):
    _require(name, idx.dim() == 3 and valid.shape == idx.shape,
             f"idx {tuple(idx.shape)} / valid {tuple(valid.shape)} "
             "(two equal (B, N, P))")
    _require(name, C % 8 == 0, f"C={C} (multiple of 8)")
    _check_tensors(name, idx.device, idx=(idx, torch.int32),
                   valid=(valid, torch.uint8))


def cam_gather_sum(feats, idx, valid):
    """``out[b, p] = sum_n valid[b, n, p] * feats[b, n, idx[b, n, p]]``.

    Args:
        feats: ``(B, N, K, C)`` bf16 camera feature rows, ``C % 8 == 0``.
        idx: ``(B, N, P)`` int32 row of each range pixel in its camera.
        valid: ``(B, N, P)`` uint8 (0 / 1); invalid pixels contribute 0.

    Returns ``(B, P, C)`` float32, summed over cameras in float32.
    """
    if feats.device.type == "cpu":
        return cam_gather_sum_plain(feats, idx, valid)
    name = "cam_gather_sum"
    B, N, K, C = feats.shape
    _check_gather(name, idx, valid, C)
    _check_tensors(name, idx.device, feats=(feats, torch.bfloat16))
    _require(name, idx.shape[:2] == (B, N), "idx / feats shapes")
    P = idx.shape[2]
    _require(name, N > 0 and P > 0 and K > 0,
             f"N={N}, P={P}, K={K} (each > 0)")
    out = torch.empty((B, P, C), dtype=torch.float32, device=feats.device)
    rc = _lib().emp_cam_gather_fwd(
        feats.data_ptr(), idx.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, N, P, K, C, _stream(feats))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# the B8 backward buckets pixels in slices of CAM_BWD_SLICE; its row pass
# holds K + 1 row counts and a count a slice in shared memory
CAM_BWD_SLICE = 2048
CAM_BWD_MAX_K = 32768
CAM_BWD_MAX_P = CAM_BWD_SLICE * 4096


def cam_gather_sum_bwd(g, idx, valid, K: int, dtype=torch.bfloat16):
    """Gradient of :func:`cam_gather_sum` with respect to ``feats``,
    ``(B, N, K, C)`` in ``dtype`` (bf16 on CUDA), from ``g (B, P, C)``
    float32: each row the float32 sum of its pixels' bf16-rounded ``g``
    rows in ascending pixel order, rounded once (0 where no pixel hits),
    so the result is the same bit for bit from call to call.  The kernel
    takes ``K <= CAM_BWD_MAX_K``, ``P <= CAM_BWD_MAX_P``, ``C <= 2048``
    and ``B N <= 65535``."""
    if g.device.type == "cpu":
        return cam_gather_sum_bwd_plain(g, idx, valid, K, dtype)
    name = "cam_gather_sum_bwd"
    _require(name, g.dim() == 3, f"g of shape {tuple(g.shape)} (B, P, C)")
    B, P, C = g.shape
    _check_gather(name, idx, valid, C)
    _check_tensors(name, idx.device, g=(g, torch.float32))
    _require(name, dtype == torch.bfloat16, f"a {dtype} gradient")
    _require(name, idx.shape[0] == B and idx.shape[2] == P,
             "idx / g shapes")
    N = idx.shape[1]
    _require(name, 0 < K <= CAM_BWD_MAX_K and P <= CAM_BWD_MAX_P
             and C <= 2048 and B * N <= 65535,
             f"K={K}, P={P}, C={C}, B*N={B * N} (K <= {CAM_BWD_MAX_K}, "
             f"P <= {CAM_BWD_MAX_P}, C <= 2048, B*N <= 65535)")
    # per (b, n): row offsets (K + 1), the rows' pixel lists (P), the
    # valid entries' rows and pixels compacted slice by slice (2 P), and
    # each slice's count
    slices = -(-P // CAM_BWD_SLICE)
    meta = torch.empty(B * N * (K + 1 + 3 * P + slices), dtype=torch.int32,
                       device=g.device)
    out = torch.empty((B, N, K, C), dtype=dtype, device=g.device)
    rc = _lib().emp_cam_gather_bwd(
        g.data_ptr(), idx.data_ptr(), valid.data_ptr(), meta.data_ptr(),
        out.data_ptr(), B, N, P, K, C, _stream(g))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


@torch.library.custom_op("emp::cam_gather_sum", mutates_args=())
def _cam_gather_sum_op(feats: Tensor, idx: Tensor, valid: Tensor) -> Tensor:
    return _fresh(cam_gather_sum(feats, idx, valid))


@_cam_gather_sum_op.register_fake
def _(feats, idx, valid):
    B, _, _, C = feats.shape
    return feats.new_empty((B, idx.shape[2], C), dtype=torch.float32)


@torch.library.custom_op("emp::cam_gather_sum_bwd", mutates_args=())
def _cam_gather_sum_bwd_op(g: Tensor, idx: Tensor, valid: Tensor, K: int,
                           dtype: torch.dtype) -> Tensor:
    return _fresh(cam_gather_sum_bwd(g, idx, valid, K, dtype))


@_cam_gather_sum_bwd_op.register_fake
def _(g, idx, valid, K, dtype):
    B, N, _ = idx.shape
    return g.new_empty((B, N, K, g.shape[-1]), dtype=dtype)


def _cam_gather_setup(ctx, inputs, output):
    feats, idx, valid = inputs
    ctx.save_for_backward(idx, valid)
    ctx.K, ctx.dtype = feats.shape[2], feats.dtype


def _cam_gather_grads(ctx, g):
    """B8's backward; ``idx`` and ``valid`` get no gradient
    (``pallas_kernels.py:330``)."""
    idx, valid = ctx.saved_tensors
    return (torch.ops.emp.cam_gather_sum_bwd(
        g.float().contiguous(), idx, valid, ctx.K, ctx.dtype), None, None)


_cam_gather_sum_op.register_autograd(_cam_gather_grads,
                                     setup_context=_cam_gather_setup)


def cam_gather_sum_op(feats, idx, valid):
    """Differentiable :func:`cam_gather_sum`: ``emp::cam_gather_sum``."""
    return torch.ops.emp.cam_gather_sum(feats, idx, valid)
