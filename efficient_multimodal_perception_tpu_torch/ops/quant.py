"""Dynamic int8 quantized products for the serving path.

Counterpart of the JAX package's ``ops/quant.py``, dynamic mode only:

* activations are quantized per row (one scale per token, pixel or, in
  the occupancy head, per z-column of voxels), from float32;
* weights are quantized per output channel: per row of the ``nn.Linear``
  ``(out, in)`` weight, the JAX package's ``axis=0`` of ``(in, out)``;
* the int8 x int8 -> int32 product is exact (``torch._int_mm``, as the
  JAX package leaves it to XLA's ``dot_general``), so the only error is
  the two roundings.

A scale is ``max(amax, 1e-12) / 127`` and a code is
``clip(round(x / scale), -127, 127)``: a true division, rounded half to
even (``torch.round``), as ``jnp.round`` does.  Int8 adds no parameters:
``enable_int8`` only sets flags, so a config's weights load unchanged.
The straight-through backward and the calibrated static scales are not
ported (ROADMAP A12): the products here refuse to run under autograd.
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
    ``Mlp`` head.  ``parts`` restricts the flip to those submodule keys;
    an unknown name raises.  Mutates and returns ``model_cfg``."""
    if mode == "static":
        raise NotImplementedError(
            "static (calibrated) int8 scales are not ported (ROADMAP A12)")
    if mode != "dynamic":
        raise ValueError(f"int8 mode must be dynamic|static, got {mode!r}")
    if parts is not None:
        parts = tuple(p.strip() for p in parts)
        unknown = sorted(set(parts) - set(INT8_PARTS))
        if unknown:
            raise ValueError(
                f"unknown int8 parts {unknown}; valid: {INT8_PARTS}")
    for part in INT8_PARTS[:4]:
        if part in model_cfg and (parts is None or part in parts):
            model_cfg[part]["int8"] = True
    if model_cfg.get("decoder", {}).get("type") == "Mlp" and (
            parts is None or "decoder" in parts):
        model_cfg["decoder"]["int8"] = True
    return model_cfg


def refuse_grad(name: str, *tensors) -> None:
    """The int8 paths have no backward here: raise rather than return an
    output that silently carries no gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the int8 straight-through backward is not ported "
            "(ROADMAP A12); run under torch.no_grad()")


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
    ``load_state_dict``), shape, dtype and device; one entry per weight
    tensor, replaced when the state moves.  An inference-mode tensor
    has no version counter and is quantized on every call; a write
    through ``w.data`` bypasses the counter and is not seen."""
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


def int8_matmul(x, w, scale_dims: int = 1):
    """``x @ w.T`` through a dynamic int8 product, in ``x``'s dtype.

    Args:
        x: ``(..., K)`` activations; each activation scale covers the last
            ``scale_dims`` axes (2 for the occupancy head's z-columns).
        w: ``(N, K)`` weight (``nn.Linear`` layout), any float dtype.
    """
    refuse_grad("int8_matmul", x, w)
    xq, xs = sym_quant(x, tuple(range(-scale_dims, 0)))
    wq, ws = quantize_weight(w)
    K = x.shape[-1]
    acc = int_mm(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], -1)
    return (acc.float() * xs * ws).to(x.dtype)


def quant_dense(x, w, bias=None, scale_dims: int = 1):
    """Drop-in for ``F.linear(x, w, bias)`` on the int8 path; the bias is
    added in float32, then the sum is cast to ``x``'s dtype."""
    y = int8_matmul(x, w, scale_dims)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y
