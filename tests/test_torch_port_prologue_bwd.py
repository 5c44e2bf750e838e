"""K3 / K4's backward against the JAX package's VJPs, in the working
dtype.

JAX differentiates ``ln_dense_fused`` and ``gelu_dense_fused`` by
replaying ``_xla_ln_dense`` / ``_xla_gelu_dense`` (``ops/pallas_kernels.py``
``_ln_dense_bwd``, ``_gelu_dense_bwd``), whose products run in the
activations' dtype: bf16 on the training path.  The port's ops
(``emp::ln_dense_fused``, ``emp::gelu_dense_fused``) replay
``ops.kernels.ln_dense_xla`` / ``gelu_dense_xla``, the same math; every
matrix product of their backward takes bf16 operands when the
activations are bf16, and the gradients agree with ``jax.vjp`` of the
JAX functions on the same bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    _xla_gelu_dense,
    _xla_ln_dense,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

TOL = 1e-2  # relative Frobenius: bf16 products summed in other orders
_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.matmul}


class _ProductDtypes(TorchDispatchMode):
    """The operand dtypes of every matrix product run under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _PRODUCTS:
            self.seen.append({a.dtype for a in args
                              if isinstance(a, torch.Tensor)})
        return func(*args, **(kwargs or {}))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind", ["ln", "gelu"])
def test_prologue_dense_backward_runs_in_the_working_dtype(kind):
    rng = np.random.default_rng(12 if kind == "ln" else 13)
    M, Kd, N = 64, 48, 40
    f32, bf = np.float32, torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((M, Kd)).astype(f32)).to(bf)
    w = rng.normal(0, Kd**-0.5, (N, Kd)).astype(f32)
    bias = rng.normal(0, 0.1, N).astype(f32)
    g = torch.from_numpy(rng.standard_normal((M, N)).astype(f32)).to(bf)
    s = (1 + rng.normal(0, 0.1, Kd)).astype(f32)
    b = rng.normal(0, 0.1, Kd).astype(f32)
    xt = x.clone().requires_grad_(True)
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in ((s, b, w, bias) if kind == "ln" else (w, bias))]
    out = (K.ln_dense(xt, *params) if kind == "ln"
           else K.gelu_dense(xt, *params))
    with _ProductDtypes() as mode:
        out.backward(g)
    assert mode.seen and all(d == {bf} for d in mode.seen), mode.seen

    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw, jbias = jnp.asarray(w.T), jnp.asarray(bias)
    if kind == "ln":
        fn = lambda *a: _xla_ln_dense(*a, 1e-6)  # noqa: E731
        args = (jx, jnp.asarray(s), jnp.asarray(b), jw, jbias)
    else:
        fn, args = _xla_gelu_dense, (jx, jw, jbias)
    _, vjp = jax.vjp(fn, *args)
    want = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    got = [xt.grad] + [p.grad for p in params]
    for i, (a, j) in enumerate(zip(got, want)):
        a = a.float().numpy()
        j = np.asarray(j.astype(jnp.float32))
        if a.shape != j.shape:  # w: (N, K) here, (K, N) in JAX
            j = j.T
        assert _rel(a, j) < TOL, (kind, i, _rel(a, j))
