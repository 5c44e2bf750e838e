"""Int8 quantized products: dynamic and calibrated static scales, with
the straight-through backward.

Counterpart of the JAX package's ``ops/quant.py``:

* dynamic (``int8=True``): activations are quantized per row (one scale
  per token, pixel or, in the occupancy head, per z-column of voxels),
  from float32;
* static (``int8="static"``): one calibrated scale per tensor, from a
  float32 scalar ``amax`` buffer per product site
  (:func:`quant_dense_site`, the JAX package's ``"quant"`` collection),
  filled by :func:`calibrate`;
* weights are quantized per output channel: per row of the ``nn.Linear``
  ``(out, in)`` weight, the JAX package's ``axis=0`` of ``(in, out)``;
* the int8 x int8 -> int32 product is exact (``torch._int_mm``, as the
  JAX package leaves it to XLA's ``dot_general``), so the only error is
  the two roundings.

A scale is ``max(amax, 1e-12) / 127`` and a code is
``clip(round(x / scale), -127, 127)``: a true division, rounded half to
even (``torch.round``), as ``jnp.round`` does.  The dynamic product is
differentiable through a straight-through estimator: its backward is
the exact product's (``_int8_matmul_bwd``), so int8 frozen parts run
inside a training step and int8 models train (quantization-aware).  The
static product has no such rule, as in the JAX package: autograd sees
its rounding.  Dynamic int8 adds no parameters and no buffers:
``enable_int8`` only sets flags, so a config's weights load unchanged;
static int8 adds the amax buffers, which a state dict carries.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

INT8_PARTS = ("encoder", "neck", "camera_encoder", "triplane_encoder",
              "decoder")


def enable_int8(model_cfg: dict, parts=None, mode: str = "dynamic") -> dict:
    """Set ``int8`` on every submodule config that has an int8 path: the
    encoders and the MiT neck always, of the decoders only the occupancy
    ``Mlp`` head.  ``mode="dynamic"`` sets ``True``, ``mode="static"``
    sets ``"static"`` (calibrated per-tensor scales, see
    :func:`calibrate`).  ``parts`` restricts the flip to those submodule
    keys; an unknown name raises.  Mutates and returns ``model_cfg``."""
    if mode not in ("dynamic", "static"):
        raise ValueError(f"int8 mode must be dynamic|static, got {mode!r}")
    flag = True if mode == "dynamic" else "static"
    if parts is not None:
        parts = tuple(p.strip() for p in parts)
        unknown = sorted(set(parts) - set(INT8_PARTS))
        if unknown:
            raise ValueError(
                f"unknown int8 parts {unknown}; valid: {INT8_PARTS}")
    for part in INT8_PARTS[:4]:
        if part in model_cfg and (parts is None or part in parts):
            model_cfg[part]["int8"] = flag
    if model_cfg.get("decoder", {}).get("type") == "Mlp" and (
            parts is None or "decoder" in parts):
        model_cfg["decoder"]["int8"] = flag
    return model_cfg


def sym_quant(x, axis):
    """Symmetric int8 quantization along ``axis`` (an int or a tuple).

    Returns ``(q int8, scale f32)``, ``scale`` shaped like ``x`` with
    ``axis`` kept at size 1, so ``q * scale ~= x``.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    # a true division on every device: CUDA divides by a Python scalar
    # through its reciprocal, which moves some scales by an ulp
    scale = amax.clamp(min=1e-12) / amax.new_full((), 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w):
    """Per-output-channel int8 of an ``(out, in)`` weight: ``(int8 (out,
    in), f32 (out,))``."""
    q, s = sym_quant(w, axis=1)
    return q.contiguous(), s[:, 0].contiguous()


# id(weight) -> (its state when quantized, (codes, scales)); an entry goes
# when its weight does
_WEIGHT_CODES: dict[int, tuple] = {}


def cached_quantize_weight(w):
    """:func:`quantize_weight` of ``w``, computed once per state of the
    weight: served weights do not change, so B10 quantizes each once, not
    on every call.  The state is ``w``'s storage pointer, version counter
    (bumped by every in-place update: ``mul_``, ``copy_``,
    ``load_state_dict``, an optimizer's ``_foreach_add_``), shape, dtype
    and device; one entry per weight tensor, replaced when the state
    moves.  An inference-mode tensor has no version counter and is
    quantized on every call; a write through ``w.data`` bypasses the
    counter and is not seen."""
    if w.is_inference():
        return quantize_weight(w)
    state = (w.data_ptr(), w._version, tuple(w.shape), w.dtype, w.device)
    key = id(w)
    hit = _WEIGHT_CODES.get(key)
    if hit is not None and hit[0] == state:
        return hit[1]
    if hit is None:
        weakref.finalize(w, _WEIGHT_CODES.pop, key, None)
    with torch.no_grad():
        codes = quantize_weight(w)
    _WEIGHT_CODES[key] = (state, codes)
    return codes


def int_mm(a, b):
    """Exact ``a (M, K) @ b.T`` for int8 ``a`` and ``b (N, K)``, int32
    ``(M, N)``.  Zero rows and columns pad the operands to the shapes
    ``torch._int_mm`` takes on CUDA (M > 16, K and N multiples of 8);
    zeros add nothing to an exact sum."""
    M, K = a.shape
    N = b.shape[0]
    pk, pn, pm = -K % 8, -N % 8, max(0, 17 - M)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:M, :N]


def mm_f32(a, b):
    """``a @ b`` of working-type operands with a float32 result (float32
    accumulation, no rounding of the sums)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _int8_product(x, w, scale_dims):
    xq, xs = sym_quant(x, tuple(range(-scale_dims, 0)))
    wq, ws = quantize_weight(w)
    K = x.shape[-1]
    acc = int_mm(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], -1)
    return (acc.float() * xs * ws).to(x.dtype)


class _Int8MatmulSTE(torch.autograd.Function):
    """The dynamic product forward, the exact product's VJP backward (the
    JAX package's ``_int8_matmul_bwd``, ``quant.py:124-135``)."""

    @staticmethod
    def forward(ctx, x, w, scale_dims):
        ctx.save_for_backward(x, w)
        return _int8_product(x, w, scale_dims)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dt, K = x.dtype, x.shape[-1]
        g2 = g.reshape(-1, g.shape[-1]).to(dt)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g2, w.to(dt)).to(dt).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(g2.t(), x.reshape(-1, K)).to(w.dtype)
        return dx, dw, None


def int8_matmul(x, w, scale_dims: int = 1):
    """``x @ w.T`` through a dynamic int8 product, in ``x``'s dtype.

    Args:
        x: ``(..., K)`` activations; each activation scale covers the last
            ``scale_dims`` axes (2 for the occupancy head's z-columns).
        w: ``(N, K)`` weight (``nn.Linear`` layout), any float dtype.

    Differentiable by the straight-through estimator: ``dx = g @ w`` in
    ``x``'s dtype, ``dw = g.T @ x`` summed over every leading axis in
    float32, then cast to ``w``'s dtype.  Both products take operands in
    ``x``'s dtype with float32 accumulation (the JAX package promotes
    ``g`` to the float32 weight for ``dx``; in float32 they agree).
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Int8MatmulSTE.apply(x, w, scale_dims)
    # outside autograd the plain ops, which torch.export traces
    return _int8_product(x, w, scale_dims)


def quant_dense(x, w, bias=None, scale_dims: int = 1):
    """Drop-in for ``F.linear(x, w, bias)`` on the int8 path; the bias is
    added in float32, then the sum is cast to ``x``'s dtype."""
    y = int8_matmul(x, w, scale_dims)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y


def static_quant_matmul(x, w, amax):
    """``x @ w.T`` with a calibrated per-tensor activation scale
    ``max(amax, 1e-12) / 127`` (a true division), weights per output
    channel, the exact int32 sum dequantized as ``acc * scale *
    w_scale``, in ``x``'s dtype (``quant.py:157-177``).  No
    straight-through rule, as in the JAX package: the rounding stops
    the gradient of ``x``."""
    scale = amax.float().clamp(min=1e-12) / amax.new_full(
        (), 127.0, dtype=torch.float32)
    xq = torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)
    wq, ws = quantize_weight(w)
    K = x.shape[-1]
    acc = int_mm(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], -1)
    return (acc.float() * scale * ws).to(x.dtype)


def add_site(module, name: str) -> None:
    """Register the float32 scalar ``amax`` buffer ``name`` of a static
    product site on ``module`` (the JAX package's ``"quant"`` leaf of the
    same name and path), at 0 until :func:`calibrate` fills it."""
    module.register_buffer(name, torch.zeros((), dtype=torch.float32))
    module.quant_sites = getattr(module, "quant_sites", ()) + (name,)
    module.quant_calibrating = False


def quant_dense_site(module, name: str, x, w, bias=None, scale_dims=1):
    """A static product site (``quant.py:180-211``): while ``module``
    calibrates it raises its ``amax`` buffer ``name`` to ``max |x|`` and
    returns the dynamic product (``scale_dims`` as
    :func:`int8_matmul`'s); otherwise :func:`static_quant_matmul` with the
    stored amax, the bias added in float32."""
    amax = getattr(module, name)
    if module.quant_calibrating:
        with torch.no_grad():
            amax.copy_(torch.maximum(amax, x.detach().float().abs().amax()))
        return quant_dense(x, w, bias, scale_dims)
    y = static_quant_matmul(x, w, amax)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y


def static_sites(model) -> dict:
    """``{buffer name: amax}`` of every static site of ``model``."""
    return {f"{prefix}.{name}" if prefix else name: getattr(m, name)
            for prefix, m in model.named_modules()
            for name in getattr(m, "quant_sites", ())}


def calibrate(model, batches) -> dict:
    """Fill a static int8 model's amaxes: forwards of ``model`` (its
    defaults: deterministic) over ``batches`` under ``no_grad`` with every
    site calibrating, as the JAX package's ``apply(...,
    mutable=["quant"])`` passes (``quant.py:189-196``, ``bench.py:287-301``).
    The amaxes are running maxima, so it continues from what they hold.
    Raises if the model has no site, or if a site's amax is still 0
    afterwards (a site no batch reached).  Returns ``static_sites``."""
    owners = [m for m in model.modules() if getattr(m, "quant_sites", ())]
    if not owners:
        raise ValueError("calibrate: the model has no static int8 site "
                         "(enable_int8(cfg, mode='static'))")
    for m in owners:
        m.quant_calibrating = True
    try:
        with torch.no_grad():
            for batch in batches:
                model(batch)
    finally:
        for m in owners:
            m.quant_calibrating = False
    sites = static_sites(model)
    zero = sorted(k for k, v in sites.items() if float(v) == 0.0)
    if zero:
        raise RuntimeError(f"calibrate: {len(zero)} of {len(sites)} sites "
                           f"saw no activation: {zero[:8]}")
    return sites
