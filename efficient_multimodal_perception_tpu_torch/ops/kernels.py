"""The hand-written Hopper kernels of the port, each beside its plain
PyTorch twin and a launch count, and the autograd functions built on them.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

=========================  ==============================  ===========================
wrapper                    TPU kernel it replaces          CUDA source
=========================  ==============================  ===========================
convnext_block_fused       convnext_block_fused            csrc/convnext_block.cu
epilogue_fused             epilogue_fused                  csrc/convnext_block.cu
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
int8_dot                   int8 dot probe (tools/)         csrc/convnext_block_int8.cu
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

The differentiable ops the models call (``convnext_block``, ``epilogue``,
``attention_op``, ``ln_dense``, ``gelu_dense``, ``triplane_sample_op``,
``cam_gather_sum_op``)
take float32 parameters and are ``torch.autograd.Function``\\ s whose
forward is the kernel and whose backward is the kernel where the TPU
kernel had one, or else autograd of the plain math replayed, as the JAX
package's VJPs do.  The models call them only on CUDA (their gates
exclude CPU tensors); on the CPU the raw wrappers inside run the twins.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import int_mm, quantize_weight, refuse_grad, sym_quant
from .sampling import grid_sample_2d

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
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def convnext_block_fused(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """One inference ConvNeXt block.

    Args:
        x: ``(N, H, W, C)`` bf16 (CUDA) input.
        dw_k, dw_b: depthwise ``(C, 1, 7, 7)`` kernel and ``(C,)`` bias.
        ln_s, ln_b, b1, b2, gamma: f32; ``gamma`` may be None.
        w1: ``(4C, C)`` bf16; w2: ``(C, 4C)`` bf16.
    """
    if x.device.type == "cpu":
        return convnext_block_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2,
                                    b2, gamma)
    name = "convnext_block_fused"
    C = _check_block(name, x, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     CONVNEXT_WIDTHS)
    y = dwconv7(x, dw_k, dw_b)
    out = torch.empty_like(x)
    rc = _lib().emp_convnext_block_post(
        x.data_ptr(), y.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        _ptr(gamma), out.data_ptr(), x.numel() // C, C, _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def epilogue_fused(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """``gamma * MLP(LN(y))`` (no residual) over ``(..., C)`` bf16 rows;
    argument types as :func:`convnext_block_fused`."""
    if y.device.type == "cpu":
        return epilogue_plain(y, ln_s, ln_b, w1, b1, w2, b2, gamma)
    name = "epilogue_fused"
    C = _check_block(name, y, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     CONVNEXT_WIDTHS)
    out = torch.empty_like(y)
    rc = _lib().emp_epilogue_fwd(
        y.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(gamma),
        out.data_ptr(), y.numel() // C, C, _stream(y),
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


def _atb(A, B, out, stream):
    """``out (N1, N2) f32 = A^T B`` for bf16 ``A (M, N1)``, ``B (M, N2)``
    (hand-written kernel; split over M when the output has few tiles)."""
    M, N1 = A.shape
    N2 = B.shape[1]
    tiles = (N1 // (64 if N1 % 64 == 0 else 32)) * (
        N2 // (64 if N2 % 64 == 0 else 32))
    splits = max(1, min(-(-264 // tiles), M // 512))
    part = (torch.empty((splits, N1, N2), dtype=torch.float32,
                        device=A.device) if splits > 1 else None)
    return _lib().emp_atb(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                          _ptr(part), M, N1, N2, splits, stream)


def _post_epilogue_bwd_kernel(name, widths, y, g, ln_s, ln_b, w1, b1, w2,
                              b2, gamma):
    if y.device.type == "cpu":
        return post_epilogue_bwd_plain(y, g, ln_s, ln_b, w1, b1, w2, b2,
                                       gamma)
    _require(name, y.dim() == 2 and g.shape == y.shape,
             f"y {tuple(y.shape)} / g {tuple(g.shape)} (two equal (M, C))")
    _require(name, gamma is not None, "gamma=None")
    C = _check_block(name, y, ln_s, ln_b, w1, b1, w2, b2, gamma, widths)
    _check_tensors(name, y.device, g=(g, torch.bfloat16))
    M = y.shape[0]
    lib, st = _lib(), _stream(y)
    bm = lib.emp_epilogue_bwd_block_rows(C)
    nblk = -(-M // bm)
    dy, z, do = (torch.empty_like(y) for _ in range(3))
    h, dhpre = (torch.empty((M, 4 * C), dtype=y.dtype, device=y.device)
                for _ in range(2))
    f32 = dict(dtype=torch.float32, device=y.device)
    part = torch.empty((nblk, 8 * C), **f32)
    vec = torch.empty(8 * C, **f32)
    dw1 = torch.empty((4 * C, C), **f32)
    dw2 = torch.empty((C, 4 * C), **f32)
    _raise_on(lib.emp_epilogue_bwd_rows(
        y.data_ptr(), g.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        gamma.data_ptr(), dy.data_ptr(), z.data_ptr(), h.data_ptr(),
        dhpre.data_ptr(), do.data_ptr(), part.data_ptr(), M, C, st), name)
    _raise_on(lib.emp_colsum(part.data_ptr(), vec.data_ptr(), nblk, 8 * C,
                             st), name)
    _raise_on(_atb(dhpre, z, dw1, st), name)
    _raise_on(_atb(do, h, dw2, st), name)
    LAUNCHES[name] += 1
    db1, db2, dlns, dlnb, dgamma = vec.split([4 * C, C, C, C, C])
    return dy, dlns, dlnb, dw1, db1, dw2, db2, dgamma


def post_epilogue_bwd(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Backward of :func:`epilogue_fused` for C in (96, 192, 384).

    Args:
        y, g: ``(M, C)`` bf16 depthwise-conv output and upstream gradient.
        others: as :func:`epilogue_fused`; ``gamma`` is required.

    Returns ``(dy, dln_s, dln_b, dw1 (4C, C), db1, dw2 (C, 4C), db2,
    dgamma)``: ``dy`` bf16, the rest float32 (the partial sums are
    reduced in a fixed order, so two runs give the same gradients).
    """
    return _post_epilogue_bwd_kernel("post_epilogue_bwd", NARROW_WIDTHS, y,
                                     g, ln_s, ln_b, w1, b1, w2, b2, gamma)


def post_epilogue_bwd_wide(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """:func:`post_epilogue_bwd` for C = 768."""
    return _post_epilogue_bwd_kernel("post_epilogue_bwd_wide", (768,), y, g,
                                     ln_s, ln_b, w1, b1, w2, b2, gamma)


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


class _ConvNeXtBlockFn(torch.autograd.Function):
    """K1 forward; backward = the depthwise conv's VJP after B5's
    ``post_epilogue_bwd`` for C <= 384 with gamma, else autograd of the
    plain math replayed (``pallas_kernels.py:545-581``)."""

    @staticmethod
    def forward(ctx, x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
        dt = x.dtype
        ctx.save_for_backward(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                              gamma)
        return convnext_block_fused(
            x, dw_k, dw_b, ln_s.float(), ln_b.float(),
            w1.to(dt).contiguous(), b1.float(), w2.to(dt).contiguous(),
            b2.float(), _f32(gamma))

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma = saved
        if gamma is None or x.shape[-1] not in NARROW_WIDTHS:
            return _replay(convnext_block_plain, saved, g)
        with torch.enable_grad():
            conv_in = [t.detach().requires_grad_(need) for t, need in
                       zip((x, dw_k, dw_b), ctx.needs_input_grad[:3])]
            y = dwconv7(*conv_in)
        dy, pgrads = _epilogue_grads(y.detach(), g, ln_s, ln_b, w1, b1, w2,
                                     b2, gamma)
        wrt = [t for t in conv_in if t.requires_grad]
        got = iter(torch.autograd.grad(y, wrt, dy) if wrt else ())
        dx, dk, db = (next(got) if t.requires_grad else None
                      for t in conv_in)
        if dx is not None:
            dx = g + dx
        return (dx, dk, db) + pgrads


class _EpilogueFn(torch.autograd.Function):
    """B5: forward ``epilogue_fused``, backward ``post_epilogue_bwd`` /
    ``post_epilogue_bwd_wide`` (autograd replay without gamma, as
    ``pallas_kernels.py:1439-1443``)."""

    @staticmethod
    def forward(ctx, y, ln_s, ln_b, w1, b1, w2, b2, gamma):
        dt = y.dtype
        ctx.save_for_backward(y, ln_s, ln_b, w1, b1, w2, b2, gamma)
        return epilogue_fused(y, ln_s.float(), ln_b.float(),
                              w1.to(dt).contiguous(), b1.float(),
                              w2.to(dt).contiguous(), b2.float(),
                              _f32(gamma))

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        y, ln_s, ln_b, w1, b1, w2, b2, gamma = saved
        if gamma is None:
            return _replay(epilogue_plain, saved, g)
        dy, pgrads = _epilogue_grads(y, g, *saved[1:])
        return (dy,) + pgrads


def convnext_block(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Differentiable K1 (float32 parameters): the kernel with its fused
    backward."""
    return _ConvNeXtBlockFn.apply(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                                  gamma)


def epilogue(y, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Differentiable B5 (float32 parameters), as :func:`convnext_block`."""
    return _EpilogueFn.apply(y, ln_s, ln_b, w1, b1, w2, b2, gamma)


# --------------------------------------------------------------------------
# K2 / B6: exact softmax attention over flattened heads (+ logsumexp)
# --------------------------------------------------------------------------

def attention_plain(q, k, v, scale):
    """Plain twin of :func:`attention`."""
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True)
    p = (e / denom).to(v.dtype)
    out = (p.float() @ v.float()).to(q.dtype)
    return out, m + torch.log(denom)


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
    ``lse`` and the output gradient ``dout``; ``D = rowsum(dout * out)``
    is formed here in PyTorch, as the JAX package forms it in XLA."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, scale)
    name = "attention_bwd"
    G, Nq, Nk, hd = _check_attention(name, q, k, v)
    _check_tensors(name, q.device, out=(out, torch.bfloat16),
                   dout=(dout, torch.bfloat16), lse=(lse, torch.float32))
    _require(name, out.shape == dout.shape == q.shape
             and lse.shape == (G, Nq, 1), "out / dout / lse shapes")
    D = (dout.float() * out.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _lib().emp_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), G, Nq, Nk, hd, float(scale), _stream(q),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """K2 forward (saves ``out`` and ``lse``), B6 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return attention_bwd(q, k, v, out, lse, g.contiguous(),
                             ctx.scale) + (None,)


def attention_op(q, k, v, scale: float):
    """Differentiable attention output: K2 forward, B6 backward."""
    return _AttentionFn.apply(q, k, v, scale)


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


def _check_dense(name, x, w, bias):
    bf, f32 = torch.bfloat16, torch.float32
    _check_tensors(name, x.device, x=(x, bf), w=(w, bf), bias=(bias, f32))
    M, K = x.shape
    N = w.shape[0]
    _require(name, w.shape == (N, K), f"w {tuple(w.shape)} for K={K}")
    _require(name, M % 64 == 0 and N % 128 == 0 and K % 32 == 0,
             f"(M, K, N)=({M}, {K}, {N}) (M%64, N%128, K%32)")
    _require(name, bias is None or bias.shape == (N,), "bias shape")
    return M, K, N


def ln_dense_fused(x, s, b, w, bias, eps=1e-6):
    """``LN(x; s, b) @ w.T + bias`` for ``x (M, K)`` bf16, ``w (N, K)``
    bf16, LN params and ``bias`` (or None) f32."""
    if x.device.type == "cpu":
        return ln_dense_plain(x, s, b, w, bias, eps)
    name = "ln_dense_fused"
    M, K, N = _check_dense(name, x, w, bias)
    _check_tensors(name, x.device, s=(s, torch.float32),
                   b=(b, torch.float32))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_ln_dense(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(), _ptr(bias),
        out.data_ptr(), M, K, N, float(eps), _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def gelu_dense_fused(x, w, bias):
    """``gelu(x) @ w.T + bias`` (exact erf) for ``x (M, K)`` bf16."""
    if x.device.type == "cpu":
        return gelu_dense_plain(x, w, bias)
    name = "gelu_dense_fused"
    M, K, N = _check_dense(name, x, w, bias)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_gelu_dense(
        x.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(), M, K, N,
        _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


class _LnDenseFn(torch.autograd.Function):
    """K3 forward; backward = autograd of the plain math
    (``pallas_kernels.py:1852``)."""

    @staticmethod
    def forward(ctx, x, s, b, w, bias, eps):
        ctx.save_for_backward(x, s, b, w, bias)
        ctx.eps = eps
        return ln_dense_fused(x, s.float(), b.float(),
                              w.to(x.dtype).contiguous(), _f32(bias), eps)

    @staticmethod
    def backward(ctx, g):
        grads = _replay(lambda *a: ln_dense_plain(*a, ctx.eps),
                        ctx.saved_tensors, g)
        return grads + (None,)


class _GeluDenseFn(torch.autograd.Function):
    """K4 forward; backward = autograd of the plain math
    (``pallas_kernels.py:1875``)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return gelu_dense_fused(x, w.to(x.dtype).contiguous(), _f32(bias))

    @staticmethod
    def backward(ctx, g):
        return _replay(gelu_dense_plain, ctx.saved_tensors, g)


def ln_dense(x, s, b, w, bias, eps=1e-6):
    """Differentiable K3 (float32 parameters)."""
    return _LnDenseFn.apply(x, s, b, w, bias, eps)


def gelu_dense(x, w, bias):
    """Differentiable K4 (float32 parameters)."""
    return _GeluDenseFn.apply(x, w, bias)


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
    """Plain twin of :func:`triplane_sample_bwd`: autograd of the plain
    sample in float32 (the sample is linear in the planes, so any plane
    values give the same gradient)."""
    B, P, C = g.shape
    zeros = torch.zeros((B, 3, S, S, C), dtype=torch.float32,
                        device=g.device)
    return _replay(lambda t: triplane_sample_plain(t, coords), (zeros,),
                   g.float())[0]


def _check_sample(name, coords, C):
    _require(name, coords.dim() == 3 and coords.shape[-1] == 3,
             f"coords {tuple(coords.shape)} (B, P, 3)")
    _require(name, C % 32 == 0, f"C={C} (multiple of 32)")
    _check_tensors(name, coords.device, coords=(coords, torch.float32))


def triplane_sample(triplane, coords):
    """Sum of the three planes of ``triplane (B, 3, S, S, C)`` bf16,
    bilinearly sampled (zero padding, align_corners=False) at normalized
    ``coords (B, P, 3)`` f32; returns ``(B, P, C)`` bf16."""
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
    out = torch.empty((B, P, C), dtype=triplane.dtype, device=coords.device)
    rc = _lib().emp_triplane_sample_fwd(
        triplane.data_ptr(), coords.data_ptr(), out.data_ptr(), B, P, S, C,
        _stream(coords))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def triplane_sample_bwd(coords, g, S: int):
    """Gradient of :func:`triplane_sample` with respect to the triplane,
    ``(B, 3, S, S, C)`` float32, from ``g (B, P, C)`` bf16.  f32 atomics:
    the result may differ in its last bits from run to run."""
    if g.device.type == "cpu":
        return triplane_sample_bwd_plain(coords, g, S)
    name = "triplane_sample_bwd"
    B, P, C = g.shape
    _check_sample(name, coords, C)
    _check_tensors(name, coords.device, g=(g, torch.bfloat16))
    _require(name, coords.shape[:2] == (B, P), "coords / g shapes")
    grad = torch.zeros((B, 3, S, S, C), dtype=torch.float32,
                       device=g.device)
    rc = _lib().emp_triplane_sample_bwd(
        coords.data_ptr(), g.data_ptr(), grad.data_ptr(), B, P, S, C,
        _stream(g))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return grad


class _TriplaneSampleFn(torch.autograd.Function):
    """B7 forward and backward; coords get no gradient (``:204``)."""

    @staticmethod
    def forward(ctx, triplane, coords):
        ctx.save_for_backward(coords)
        ctx.S, ctx.dtype = triplane.shape[2], triplane.dtype
        return triplane_sample(triplane, coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        grad = triplane_sample_bwd(coords, g.contiguous(), ctx.S)
        return grad.to(ctx.dtype), None


def triplane_sample_op(triplane, coords):
    """Differentiable :func:`triplane_sample`."""
    return _TriplaneSampleFn.apply(triplane, coords)


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


def finite_mlp_fused(x, w1, b1, w2, b2):
    """``relu(finite0(x) @ w1.T + b1) @ w2.T + b2``, ``finite0`` turning
    the -inf of empty pool cells into 0.

    Args:
        x: ``(M, K)`` bf16 raw pools, ``K % 32 == 0``.
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
    _require(name, K % 32 == 0 and M > 0, f"(M, K)=({M}, {K}) (K%32)")
    _require(name, w2.data_ptr() % 32 == 0, "w2 not 32-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().emp_finite_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), M, K, _stream(x))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------------
# B10: the int8 ConvNeXt block (depthwise 7x7 outside; LN + int8 MLP in)
# --------------------------------------------------------------------------

def convnext_block_int8_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                              gamma):
    """Plain twin of :func:`convnext_block_int8_fused`, at B10's rounding
    points: LN's mean and variance in float64 rounded to float32, ``z``
    and ``h`` quantized per row from float32, weights per output channel,
    int32 sums dequantized as ``acc * row_scale * col_scale + bias``,
    exact-erf GELU.  Each step is one eager op, so on the card this twin
    rounds where the kernel does and matches it bit for bit."""
    refuse_grad("convnext_block_int8", x, w1, w2)
    C = x.shape[-1]
    yd = dwconv7(x, dw_k, dw_b).double().reshape(-1, C)
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


def convnext_block_int8_fused(x, dw_k, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                              gamma):
    """One inference ConvNeXt block with both MLP products in int8.

    Args:
        x: ``(N, H, W, C)`` bf16 (CUDA) input.
        dw_k, dw_b: depthwise ``(C, 1, 7, 7)`` kernel and ``(C,)`` bias.
        ln_s, ln_b, b1, b2, gamma: f32; ``gamma`` may be None.
        w1: ``(4C, C)``, w2: ``(C, 4C)`` float weights, quantized here per
            output channel (int8 codes and f32 scales) for the kernel.

    No backward: the straight-through VJP is not ported.
    """
    if x.device.type == "cpu":
        return convnext_block_int8_plain(x, dw_k, dw_b, ln_s, ln_b, w1, b1,
                                         w2, b2, gamma)
    name = "convnext_block_int8_fused"
    refuse_grad(name, x, w1, w2)
    C = x.shape[-1]
    _require(name, C in CONVNEXT_WIDTHS, f"C={C} (takes {CONVNEXT_WIDTHS})")
    _require(name, w1.shape == (4 * C, C) and w2.shape == (C, 4 * C)
             and b1.shape == (4 * C,) and b2.shape == (C,),
             f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} at C={C}")
    f32 = torch.float32
    _check_tensors(name, x.device, x=(x, torch.bfloat16), ln_s=(ln_s, f32),
                   ln_b=(ln_b, f32), b1=(b1, f32), b2=(b2, f32),
                   gamma=(gamma, f32), w1=(w1, w1.dtype), w2=(w2, w2.dtype))
    w1q, w1s = quantize_weight(w1)
    w2q, w2s = quantize_weight(w2)
    y = dwconv7(x, dw_k, dw_b)
    out = torch.empty_like(x)
    rc = _lib().emp_convnext_block_int8(
        x.data_ptr(), y.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
        w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        w2s.data_ptr(), b2.data_ptr(), _ptr(gamma), out.data_ptr(),
        x.numel() // C, C, _stream(x),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------------
# the int8 dot probe: B10's int8 tile routine on its own
# --------------------------------------------------------------------------

def int8_dot_plain(x, w):
    """Plain twin of :func:`int8_dot` (exact)."""
    return int_mm(x, w)


def int8_dot(x, w):
    """Exact ``x (M, K) @ w (N, K).T`` for int8 operands, int32 ``(M,
    N)``; the kernel takes ``M % 16 == N % 8 == K % 32 == 0``."""
    if x.device.type == "cpu":
        return int8_dot_plain(x, w)
    name = "int8_dot"
    _check_tensors(name, x.device, x=(x, torch.int8), w=(w, torch.int8))
    _require(name, x.dim() == 2 and w.dim() == 2
             and x.shape[1] == w.shape[1], f"x {tuple(x.shape)} / w "
             f"{tuple(w.shape)} ((M, K) and (N, K))")
    M, K = x.shape
    N = w.shape[0]
    _require(name, M % 16 == 0 and N % 8 == 0 and K % 32 == 0 and M > 0,
             f"(M, N, K)=({M}, {N}, {K}) (M%16, N%8, K%32)")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    rc = _lib().emp_int8_dot(x.data_ptr(), w.data_ptr(), out.data_ptr(), M,
                             N, K, _stream(x))
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
    out = torch.empty((B, P, C), dtype=torch.float32, device=feats.device)
    rc = _lib().emp_cam_gather_fwd(
        feats.data_ptr(), idx.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, N, P, K, C, _stream(feats))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def cam_gather_sum_bwd(g, idx, valid, K: int, dtype=torch.bfloat16):
    """Gradient of :func:`cam_gather_sum` with respect to ``feats``,
    ``(B, N, K, C)`` in ``dtype`` (bf16 on CUDA), from ``g (B, P, C)``
    float32.  f32 atomics: the result may differ in its last bits from
    run to run."""
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
    grad = torch.zeros((B, N, K, C), dtype=torch.float32, device=g.device)
    out = torch.empty((B, N, K, C), dtype=dtype, device=g.device)
    rc = _lib().emp_cam_gather_bwd(
        g.data_ptr(), idx.data_ptr(), valid.data_ptr(), grad.data_ptr(),
        out.data_ptr(), B, N, P, K, C, _stream(g))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


class _CamGatherFn(torch.autograd.Function):
    """B8 forward and backward; ``idx`` and ``valid`` get no gradient
    (``pallas_kernels.py:330``)."""

    @staticmethod
    def forward(ctx, feats, idx, valid):
        ctx.save_for_backward(idx, valid)
        ctx.K, ctx.dtype = feats.shape[2], feats.dtype
        return cam_gather_sum(feats, idx, valid)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        return (cam_gather_sum_bwd(g.float().contiguous(), idx, valid, ctx.K,
                                   ctx.dtype), None, None)


def cam_gather_sum_op(feats, idx, valid):
    """Differentiable :func:`cam_gather_sum`."""
    return _CamGatherFn.apply(feats, idx, valid)
