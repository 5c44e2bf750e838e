"""The port's int8 training paths against the JAX package, on the CPU.

* B10's VJP (``ops.kernels.convnext_block_int8_bwd``, the backward of
  ``emp::convnext_block_int8_fused`` and of its twin) against ``jax.grad``
  of the JAX package's ``convnext_block_int8_fused`` (the Pallas kernel in
  interpret mode, its VJP the XLA int8 math), all ten gradients;
* the unfused int8 ConvNeXt block (dynamic and static, with drop-path)
  against the JAX package's XLA route, forward and gradients;
* ``ops.quant.calibrate``'s refusals, the weight-code cache after the flat
  AdamW's update, and the int8 fine-tune through the train CLI.

The static products, the straight-through ``int8_matmul`` and
calibrate-then-serve of whole models are in ``test_torch_port_int8.py``.
Every JAX apply is jitted and runs under full matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.models.convnext import (
    ConvNeXtBlock as JConvNeXtBlock,
)
from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    convnext_block_int8_fused as j_block_int8,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.models import convnext
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops import quant as Q
from efficient_multimodal_perception_tpu_torch.train import cli
from efficient_multimodal_perception_tpu_torch.train.flat_opt import FlatAdamW
from test_torch_port_int8 import FORCED_TOL, _block_params, _rel, _t
from test_torch_port_train_cli import _run, _steps
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

HIGHEST = "highest"
GRAD_TOL = 1e-3   # each gradient's max abs error over its max abs
NAMES = ("x", "dw_k", "dw_b", "ln_s", "ln_b", "w1", "b1", "w2", "b2",
         "gamma")


def _grad_errs(got, want):
    """Each gradient's max abs error over its max abs (JAX layout
    ``want``; over 1 where JAX's gradient is exactly 0)."""
    return {n: float(np.abs(g - w).max() / (np.abs(w).max() or 1.0))
            for n, g, w in zip(NAMES, got, want)}


def _to_jax_layout(name, t):
    """``t``'s gradient in the JAX layout; zeros where autograd left it
    None (a parameter the rounding cuts off, as JAX's zero gradient)."""
    g = (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
    if name == "dw_k":
        return g.transpose(2, 3, 1, 0)
    if name in ("w1", "w2"):
        return g.T
    return g


def test_b10_vjp_matches_jax():
    """The ten gradients of ``emp::convnext_block_int8_fused`` on CPU
    tensors (its twin forward, ``convnext_block_int8_bwd`` backward) and of
    the twin (autograd of ``block_int8_xla``) against ``jax.grad`` of the
    JAX package's B10 (Pallas in interpret mode; its VJP is ``jax.vjp`` of
    ``_xla_block_int8_math``), at C = 32 on 8 x 8, in float32, within
    GRAD_TOL of each gradient's max abs.  A random cotangent and gamma
    away from 1e-6 make every gradient carry signal."""
    rng = np.random.default_rng(21)
    C = 32
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    jargs, pargs = _block_params(rng, C)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    jargs[-1], pargs[-1] = jnp.asarray(gamma), _t(gamma)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def loss(*a):
        return (j_block_int8(*a) * jnp.asarray(r)).sum()

    with jax.default_matmul_precision(HIGHEST):
        want = [np.asarray(g) for g in jax.jit(jax.grad(
            loss, argnums=tuple(range(10))))(jnp.asarray(x), *jargs)]
    for fn in (torch.ops.emp.convnext_block_int8_fused,
               K.convnext_block_int8_plain):
        ins = [t.clone().requires_grad_(True) for t in [_t(x)] + pargs]
        (fn(*ins) * _t(r)).sum().backward()
        errs = _grad_errs([_to_jax_layout(n, t)
                           for n, t in zip(NAMES, ins)], want)
        print(f"{getattr(fn, '__name__', fn)} VJP vs JAX: "
              + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()))
        assert max(errs.values()) <= GRAD_TOL
    assert K.LAUNCHES["convnext_block_int8_fused"] == 0  # CPU: the twin


def _jax_block_variables(jargs, quant=None):
    params = dict(zip(("dwconv_kernel", "dwconv_bias", "norm_scale",
                       "norm_bias", "pwconv1_kernel", "pwconv1_bias",
                       "pwconv2_kernel", "pwconv2_bias", "gamma"), jargs))
    v = {"params": params}
    if quant is not None:
        v["quant"] = quant
    return v


@pytest.mark.parametrize("mode", [True, "static"], ids=["dynamic", "static"])
def test_unfused_int8_block_matches_jax(mode, monkeypatch):
    """The unfused int8 block at drop-path rate 0.5 in training
    (``deterministic=False``: the route B10 does not take), forward and
    the gradients of the input and every parameter, against the JAX
    package's XLA route (``convnext.py:187-215``) with the same kept
    samples: the output within 1e-5 relative, each gradient within
    GRAD_TOL of its max abs.  Static uses calibrated amaxes from JAX's
    ``"quant"`` collection; its rounding stops the branch's gradient, as
    in JAX (no straight-through rule)."""
    rng = np.random.default_rng(22)
    C, rate = 16, 0.5
    x = rng.standard_normal((4, 8, 8, C)).astype(np.float32)
    jargs, pargs = _block_params(rng, C)
    r = rng.standard_normal(x.shape).astype(np.float32)
    jblk = JConvNeXtBlock(C, drop_path_rate=rate, int8=mode)
    quant = None
    if mode == "static":
        quant = jax.jit(lambda v, a: jblk.apply(v, a, mutable=["quant"])[1][
            "quant"])(_jax_block_variables(jargs, {}), jnp.asarray(x))
    key = jax.random.key(5)

    def fwd(xx, *a):
        return jblk.apply(_jax_block_variables(a, quant), xx,
                          deterministic=False, rngs={"droppath": key})

    def loss(*a):
        out = fwd(*a)
        return (out * jnp.asarray(r)).sum(), out

    with jax.default_matmul_precision(HIGHEST):
        (_, want), jgrads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(10)), has_aux=True))(
                jnp.asarray(x), *jargs)
    want, jgrads = np.asarray(want), [np.asarray(g) for g in jgrads]
    kept = torch.from_numpy((want != x).any(axis=(1, 2, 3)))
    assert 0 < int(kept.sum()) < len(kept)  # the key keeps some, drops some

    def replay(f, p, deterministic, generator=None):
        return torch.where(kept[:, None, None, None], f / (1 - p),
                           torch.zeros((), dtype=f.dtype))

    monkeypatch.setattr(convnext, "drop_path", replay)
    blk = convnext.ConvNeXtBlock(C, drop_path_rate=rate, int8=mode)
    names = ("dwconv.weight", "dwconv.bias", "norm.weight", "norm.bias",
             "pwconv1.weight", "pwconv1.bias", "pwconv2.weight",
             "pwconv2.bias", "gamma")
    sd = dict(zip(names, pargs))
    if quant is not None:
        sd.update(fc1=_t(np.asarray(quant["fc1"])),
                  fc2=_t(np.asarray(quant["fc2"])))
    blk.load_state_dict(sd)
    xt = _t(x).requires_grad_(True)
    out = blk(xt, fused=False, deterministic=False)
    (out * _t(r)).sum().backward()
    err = _rel(out.detach().numpy(), want)
    params = dict(blk.named_parameters())
    got = [_to_jax_layout(n, t) for n, t in zip(
        NAMES, [xt] + [params[k] for k in names])]
    errs = _grad_errs(got, jgrads)
    print(f"unfused {mode} block vs JAX: forward {err:.3g}; gradients "
          + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()))
    assert err <= FORCED_TOL
    assert max(errs.values()) <= GRAD_TOL
    if mode == "static":  # the rounding stops the branch: dx is g alone
        np.testing.assert_array_equal(got[0], r)


def test_ste_dx_takes_the_weight_in_the_working_type():
    """In bf16 the straight-through ``dx`` is ``g @ w`` with the float32
    weight rounded to bf16 and float32 sums rounded once to bf16, and
    ``dw`` the float32 sum of bf16 products, cast to the weight's dtype
    (ROADMAP C8: JAX's backward promotes ``dx``'s product to float32)."""
    rng = np.random.default_rng(24)
    bf = torch.bfloat16
    x = _t(rng.standard_normal((3, 7, 40)).astype(np.float32)).to(bf)
    w = _t((rng.standard_normal((24, 40)) / 6).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    g = _t(rng.standard_normal((3, 7, 24)).astype(np.float32)).to(bf)
    Q.int8_matmul(x, w).backward(g)
    g2 = g.reshape(-1, 24).float()
    want_dx = (g2 @ w.detach().to(bf).float()).to(bf).reshape(x.shape)
    want_dw = g2.t() @ x.detach().reshape(-1, 40).float()
    assert x.grad.dtype == bf and w.grad.dtype == torch.float32
    assert torch.equal(x.grad, want_dx) and torch.equal(w.grad, want_dw)


def test_calibrate_refuses_a_site_no_batch_reaches():
    """``calibrate`` raises on a model without static sites and on a site
    whose amax stays 0; serving an uncalibrated model does not raise."""
    cfg = get_config("tiny_occ")["model"]
    with pytest.raises(ValueError, match="no static int8 site"):
        Q.calibrate(build_model(cfg, device="cpu"), [])
    model = build_model(Q.enable_int8(cfg, mode="static"), device="cpu")
    with pytest.raises(RuntimeError, match="29 of 29 sites saw no"):
        Q.calibrate(model, [])
    assert not any(m.quant_calibrating for m in model.modules()
                   if hasattr(m, "quant_calibrating"))


def test_weight_codes_miss_after_the_flat_adamw_update():
    """B10's cached weight codes (``ops.quant.cached_quantize_weight``)
    are those of the weight as the flat AdamW left it: its
    ``_foreach_add_`` bumps each parameter's version counter."""
    rng = np.random.default_rng(23)
    w = torch.nn.Parameter(_t(rng.standard_normal((64, 16))
                              .astype(np.float32)))
    opt = FlatAdamW([w], lambda count: 0.5)
    before = Q.cached_quantize_weight(w)
    assert Q.cached_quantize_weight(w) is before
    opt.step([_t(rng.standard_normal((64, 16)).astype(np.float32))])
    after = Q.cached_quantize_weight(w)
    want = Q.quantize_weight(w.detach())
    assert after is not before
    assert torch.equal(after[0], want[0]) and torch.equal(after[1], want[1])
    assert not torch.equal(after[1], before[1])


def test_int8_frozen_parts_train_through_the_cli(tmp_path):
    """The train CLI as it is: the ``tiny_occ`` fine-tune with an int8
    frozen encoder and neck and the head in float (the JAX bench's
    ``bench_occ_train(int8=True)``), two steps through ``--cfg-options``:
    finite losses; the encoder and neck stay as built, the head moves."""
    out = _run(cli.main, ["tiny_occ", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "2", "--device",
                          "cpu", "--cfg-options", "model.encoder.int8=True",
                          "model.neck.int8=True"])
    lines = _steps(out)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in lines)
    cfg = get_config("tiny_occ")
    Q.enable_int8(cfg["model"], parts=("encoder", "neck"))
    fresh = build_model(cfg["model"], device="cpu", seed=0).state_dict()
    saved = torch.load(tmp_path / "checkpoints" / "step_2.pt",
                       weights_only=True)["params"]
    moved = {k for k, v in saved.items() if not torch.equal(v, fresh[k])}
    assert moved == {f"decoder.conv{i}.0.weight" for i in (1, 2, 3)}
