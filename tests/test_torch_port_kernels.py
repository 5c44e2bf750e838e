"""The port's kernel twins against the JAX package's Pallas kernels.

Each plain PyTorch twin in ``efficient_multimodal_perception_tpu_torch/
ops/kernels.py`` is held, on the same numpy-seeded inputs, against the
Pallas kernel it replaces run in interpret mode (f32, full matmul
precision), at 1e-5.  The Pallas kernels use an erf approximation with
~1.5e-7 absolute error; the twins use exact erf.  The CUDA kernels
themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    _attn_impl,
    _block_fused_impl,
    _prologue_dense_impl,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two PyTorch intra-op threads while a port test module runs (the
    other port test modules import this fixture).  The suite runs six
    pytest workers on one host; PyTorch's default of one OpenMP thread per
    core in each of them oversubscribes the cores, and the spinning
    threads slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_inputs(rng, N, H, W, C):
    return dict(
        x=rng.standard_normal((N, H, W, C)).astype(np.float32),
        dw_k=(rng.standard_normal((7, 7, 1, C)) / 7).astype(np.float32),
        dw_b=(0.1 * rng.standard_normal(C)).astype(np.float32),
        ln_s=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(C)).astype(np.float32),
        w1=(rng.standard_normal((C, 4 * C)) / np.sqrt(C)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * C)).astype(np.float32),
        w2=(rng.standard_normal((4 * C, C)) / np.sqrt(4 * C)).astype(
            np.float32),
        b2=(0.1 * rng.standard_normal(C)).astype(np.float32),
        gamma=rng.uniform(0.1, 1.0, C).astype(np.float32),
    )


def _port_block_args(p, gamma=True):
    """JAX layouts -> the port's: depthwise HWIO -> (C, 1, 7, 7), Dense
    (in, out) -> nn.Linear (out, in)."""
    return (
        _t(p["x"]), _t(np.transpose(p["dw_k"], (3, 2, 0, 1))), _t(p["dw_b"]),
        _t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), _t(p["b2"]), _t(p["gamma"]) if gamma else None,
    )


@pytest.mark.parametrize("gamma", [True, False])
def test_convnext_block_twin_matches_pallas(gamma):
    rng = np.random.default_rng(5)
    p = _block_inputs(rng, 2, 8, 16, 32)
    with jax.default_matmul_precision("highest"):
        ref = _block_fused_impl(
            *(jnp.asarray(p[k]) for k in
              ("x", "dw_k", "dw_b", "ln_s", "ln_b", "w1", "b1", "w2", "b2")),
            jnp.asarray(p["gamma"]) if gamma else None,
            interpret=True,
        )
    out = K.convnext_block_plain(*_port_block_args(p, gamma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_attention_twin_matches_pallas():
    rng = np.random.default_rng(7)
    G, N, hd = 2, 128, 32
    q, k, v = (rng.standard_normal((G, N, hd)).astype(np.float32)
               for _ in range(3))
    scale = hd**-0.5
    with jax.default_matmul_precision("highest"):
        ref_out, ref_lse = _attn_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale, interpret=True)
    out, lse = K.attention_plain(_t(q), _t(k), _t(v), scale)
    assert lse.shape == (G, N, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=TOL, rtol=TOL)


def _dense_inputs(rng, M, K_, N):
    return dict(
        x=rng.standard_normal((M, K_)).astype(np.float32),
        s=(1 + 0.2 * rng.standard_normal(K_)).astype(np.float32),
        b=(0.1 * rng.standard_normal(K_)).astype(np.float32),
        w=(rng.standard_normal((K_, N)) / np.sqrt(K_)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(N)).astype(np.float32),
    )


@pytest.mark.parametrize("with_bias", [True, False])
def test_ln_dense_twin_matches_pallas(with_bias):
    p = _dense_inputs(np.random.default_rng(0), 64, 128, 256)
    bias = p["bias"] if with_bias else None
    with jax.default_matmul_precision("highest"):
        ref = _prologue_dense_impl(
            jnp.asarray(p["x"]), (jnp.asarray(p["s"]), jnp.asarray(p["b"])),
            jnp.asarray(p["w"]),
            None if bias is None else jnp.asarray(bias),
            mode="ln", eps=1e-6, interpret=True,
        )
    out = K.ln_dense_plain(_t(p["x"]), _t(p["s"]), _t(p["b"]),
                           _t(p["w"].T), None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_gelu_dense_twin_matches_pallas(with_bias):
    p = _dense_inputs(np.random.default_rng(1), 64, 256, 128)
    bias = p["bias"] if with_bias else None
    with jax.default_matmul_precision("highest"):
        ref = _prologue_dense_impl(
            jnp.asarray(p["x"]), (), jnp.asarray(p["w"]),
            None if bias is None else jnp.asarray(bias),
            mode="gelu", eps=0.0, interpret=True,
        )
    out = K.gelu_dense_plain(_t(p["x"]), _t(p["w"].T),
                             None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_wrappers_run_their_twins_on_cpu():
    """A CPU tensor takes the twin, bit for bit, and launches nothing."""
    rng = np.random.default_rng(3)
    K.reset_launches()
    blk = _port_block_args(_block_inputs(rng, 1, 8, 8, 16))
    assert torch.equal(K.convnext_block_fused(*blk),
                       K.convnext_block_plain(*blk))
    q, k, v = (_t(rng.standard_normal((2, 64, 16)).astype(np.float32))
               for _ in range(3))
    for a, b in zip(K.attention(q, k, v, 0.25),
                    K.attention_plain(q, k, v, 0.25)):
        assert torch.equal(a, b)
    p = _dense_inputs(rng, 64, 32, 128)
    x, s, b, w, bias = (_t(p[n]) for n in ("x", "s", "b", "w", "bias"))
    w = w.t().contiguous()
    assert torch.equal(K.ln_dense_fused(x, s, b, w, bias),
                       K.ln_dense_plain(x, s, b, w, bias))
    assert torch.equal(K.gelu_dense_fused(x, w, None),
                       K.gelu_dense_plain(x, w, None))
    assert all(n == 0 for n in K.LAUNCHES.values())
