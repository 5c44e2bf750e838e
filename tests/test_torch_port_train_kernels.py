"""The training-path kernel twins and autograd functions of the port
against the JAX package's Pallas kernels and their VJPs.

Each twin in ``efficient_multimodal_perception_tpu_torch/ops/kernels.py``
is held, on the same numpy-seeded inputs in float32, against the Pallas
kernel it replaces run in interpret mode (full matmul precision), at
1e-5.  The port's ``emp::`` operators run here too: given CPU tensors
their forward and backward implementations take the twins, so the ops'
gradient wiring is held to ``jax.vjp`` of the Pallas ops.
The Pallas kernels use an erf approximation with ~1.5e-7 absolute error;
the twins use exact erf.  The CUDA kernels run only on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    _epilogue_impl,
    attention_pallas,
    convnext_block_fused,
    epilogue_fused,
    post_epilogue_bwd,
    post_epilogue_bwd_wide,
    triplane_sample_pallas,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

TOL = 1e-5
# XLA:CPU options that pin a reference to IEEE float32 math (no fast-math
# division, rsqrt or transcendental approximations), whatever the flags
# of the process that compiles it, and its dots to one thread (a dot
# split over XLA's intra-op thread pool sums in another order)
STRICT_MATH = {
    "xla_cpu_enable_fast_math": False,
    "xla_cpu_fast_math_honor_nans": True,
    "xla_cpu_fast_math_honor_infs": True,
    "xla_cpu_fast_math_honor_division": True,
    "xla_cpu_fast_math_honor_functions": True,
    "xla_cpu_enable_fast_min_max": False,
    "xla_cpu_multi_thread_eigen": False,
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp_inputs(rng, M, C):
    """JAX-layout epilogue inputs: y, g (M, C) and the block params."""
    return dict(
        y=rng.standard_normal((M, C)).astype(np.float32),
        g=rng.standard_normal((M, C)).astype(np.float32),
        ln_s=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(C)).astype(np.float32),
        w1=(rng.standard_normal((C, 4 * C)) / np.sqrt(C)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * C)).astype(np.float32),
        w2=(rng.standard_normal((4 * C, C)) / np.sqrt(4 * C)).astype(
            np.float32),
        b2=(0.1 * rng.standard_normal(C)).astype(np.float32),
        gamma=rng.uniform(0.1, 1.0, C).astype(np.float32),
    )


PARAMS = ("ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma")


def _jax_params(p):
    return tuple(jnp.asarray(p[k]) for k in PARAMS)


def _port_params(p):
    """nn.Linear layout: w1 (4C, C), w2 (C, 4C)."""
    return tuple(_t(p[k].T if k in ("w1", "w2") else p[k]) for k in PARAMS)


def _reference(fn, *args, **static):
    """A jitted Pallas op run as the reference: compiled with
    ``STRICT_MATH`` under full matmul precision into an executable of its
    own (apart from the one the op's jit cache shares with other tests of
    the worker, and never read from or written to the persistent
    compilation cache that the suite's processes share), and run to
    completion before the twin starts."""
    cache = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        with jax.default_matmul_precision("highest"):
            compiled = fn.lower(*args, **static).compile(
                compiler_options=STRICT_MATH)
    finally:
        jax.config.update("jax_enable_compilation_cache", cache)
    return jax.block_until_ready(compiled(*args))


def _twin(fn, *args):
    """A twin run as the reference's counterpart: on one PyTorch thread,
    with float32 products in full precision, whatever the worker's thread
    count or matmul settings were before (restored after)."""
    threads, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)
        torch.set_float32_matmul_precision(prec)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("C", [32, 768])
def test_epilogue_twin_matches_pallas(C):
    """``epilogue_plain`` (the twin the card holds ``epilogue_fused`` to)
    against the Pallas forward, at a narrow width and at the wide one."""
    p = _mlp_inputs(np.random.default_rng(0), 64 if C < 768 else 16, C)
    ref = _reference(_epilogue_impl, jnp.asarray(p["y"]), *_jax_params(p))
    _close(_twin(K.epilogue_plain, _t(p["y"]), *_port_params(p)).numpy(),
           ref)


@pytest.mark.parametrize("C", [32, 768])
def test_epilogue_bwd_twin_matches_pallas(C):
    """``post_epilogue_bwd`` (C <= 384) and ``post_epilogue_bwd_wide``
    (C = 768) against the twin: dy and all seven parameter grads."""
    p = _mlp_inputs(np.random.default_rng(1), 64 if C < 768 else 16, C)
    fn = post_epilogue_bwd if C <= 384 else post_epilogue_bwd_wide
    ref = _reference(fn, jnp.asarray(p["y"]), jnp.asarray(p["g"]),
                     *_jax_params(p), interpret=True)
    got = _twin(K.post_epilogue_bwd_plain, _t(p["y"]), _t(p["g"]),
                *_port_params(p))
    names = ("dy", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")
    for name, a, b in zip(names, got, ref):
        b = np.asarray(b)
        if name in ("dw1", "dw2"):
            b = b.T  # (in, out) -> nn.Linear (out, in)
        _close(a.numpy(), b.reshape(a.shape), tol=TOL)


def test_epilogue_function_vjp_matches_jax():
    """``emp::epilogue_fused`` (B5 forward and backward wrappers) against
    ``jax.vjp(epilogue_fused)`` on an NHWC input."""
    rng = np.random.default_rng(2)
    p = _mlp_inputs(rng, 2 * 4 * 8, 32)
    y = p["y"].reshape(2, 4, 8, 32)
    g = p["g"].reshape(2, 4, 8, 32)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(epilogue_fused, jnp.asarray(y), *_jax_params(p))
        ref = vjp(jnp.asarray(g))
    ins = [_t(y).requires_grad_()] + [t.requires_grad_()
                                      for t in _port_params(p)]
    res = K.epilogue(*ins)
    _close(res.detach().numpy(), out)
    grads = torch.autograd.grad(res, ins, _t(g))
    for name, a, b in zip(("y",) + PARAMS, grads, ref):
        b = np.asarray(b)
        _close(a.numpy(), b.T if name in ("w1", "w2") else b)


def test_convnext_block_function_vjp_matches_jax():
    """K1's op (``emp::convnext_block_fused``) at C = 96: the depthwise conv's VJP after
    B5's backward, against ``jax.vjp(convnext_block_fused)``."""
    rng = np.random.default_rng(3)
    C = 96
    p = _mlp_inputs(rng, 1, C)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    dw_k = (rng.standard_normal((7, 7, 1, C)) / 7).astype(np.float32)
    dw_b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(convnext_block_fused, jnp.asarray(x),
                           jnp.asarray(dw_k), jnp.asarray(dw_b),
                           *_jax_params(p))
        ref = vjp(jnp.asarray(g))
    ins = ([_t(x).requires_grad_(),
            _t(np.transpose(dw_k, (3, 2, 0, 1))).requires_grad_(),
            _t(dw_b).requires_grad_()]
           + [t.requires_grad_() for t in _port_params(p)])
    res = K.convnext_block(*ins)
    _close(res.detach().numpy(), out)
    grads = torch.autograd.grad(res, ins, _t(g))
    for name, a, b in zip(("x", "dw_k", "dw_b") + PARAMS, grads, ref):
        b = np.asarray(b)
        if name in ("w1", "w2"):
            b = b.T
        elif name == "dw_k":
            b = np.transpose(b, (3, 2, 0, 1))
        _close(a.numpy(), b)


@pytest.mark.parametrize("nq,nk", [(128, 128), (256, 128)])
def test_attention_vjp_matches_pallas(nq, nk):
    """B6 at head dim 24, square and rectangular: ``emp::attention``
    (forward twin, backward twin ``attention_bwd_plain``) against
    ``jax.vjp(attention_pallas)`` in interpret mode."""
    rng = np.random.default_rng(4)
    G, hd = 2, 24
    q = rng.standard_normal((G, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((G, nk, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((G, nq, hd)).astype(np.float32)
    scale = hd**-0.5
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda a, b, c: attention_pallas(a, b, c, scale, True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    res = K.attention_op(*ins, scale)
    _close(res.detach().numpy(), out)
    for a, b in zip(torch.autograd.grad(res, ins, _t(g)), ref):
        _close(a.numpy(), b)


def test_triplane_sample_and_vjp_match_pallas():
    """B7 forward and backward with points padded out of range (P is
    not a multiple of the Pallas block, and a fifth of the points lie
    outside [-1, 1] on some axis)."""
    rng = np.random.default_rng(5)
    B, S, C, P = 2, 16, 32, 300
    tri = rng.standard_normal((B, 3, S, S, C)).astype(np.float32)
    coords = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    coords[:, ::5] *= 1.4
    g = rng.standard_normal((B, P, C)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda t: triplane_sample_pallas(t, jnp.asarray(coords),
                                             interpret=True),
            jnp.asarray(tri))
        (ref,) = vjp(jnp.asarray(g))
    t = _t(tri).requires_grad_()
    res = K.triplane_sample_op(t, _t(coords))
    _close(res.detach().numpy(), out)
    (got,) = torch.autograd.grad(res, [t], _t(g))
    _close(got.numpy(), ref)
    _close(K.triplane_sample_bwd(_t(coords), _t(g), S).numpy(), ref)


def test_training_wrappers_run_twins_on_cpu():
    """CPU tensors take the twins, bit for bit, and launch nothing."""
    rng = np.random.default_rng(6)
    K.reset_launches()
    p = _mlp_inputs(rng, 32, 16)
    y, g, prm = _t(p["y"]), _t(p["g"]), _port_params(p)
    assert torch.equal(K.epilogue_fused(y, *prm), K.epilogue_plain(y, *prm))
    for fn in (K.post_epilogue_bwd, K.post_epilogue_bwd_wide):
        for a, b in zip(fn(y, g, *prm), K.post_epilogue_bwd_plain(y, g, *prm)):
            assert torch.equal(a, b)
    q, k, v, do = (_t(rng.standard_normal((2, 64, 8)).astype(np.float32))
                   for _ in range(4))
    out, lse = K.attention(q, k, v, 0.3)
    for a, b in zip(K.attention_bwd(q, k, v, out, lse, do, 0.3),
                    K.attention_bwd_plain(q, k, v, out, lse, do, 0.3)):
        assert torch.equal(a, b)
    tri = _t(rng.standard_normal((1, 3, 8, 8, 32)).astype(np.float32))
    c = _t(rng.uniform(-1, 1, (1, 10, 3)).astype(np.float32))
    assert torch.equal(K.triplane_sample(tri, c),
                       K.triplane_sample_plain(tri, c))
    assert all(n == 0 for n in K.LAUNCHES.values())


@pytest.mark.parametrize("M", [16, 1000, 6181])
def test_wide_bwd_scratch_sizes(M):
    """The wide backward's scratch: 8 partial rows per 128-row tile,
    enough for every 16-row block of the row passes; the transposed
    weights."""
    C, H = 768, 3072
    sc = K.bwd_scratch(M, C)
    P = sc["part"][0][0]
    assert P == 8 * -(-M // 128) and P * 16 >= M and sc["part"][0][1] == 8 * C
    assert sc["w1t"][0] == (C, H) and sc["w2t"][0] == (H, C)
    assert sc["h"][0] == sc["dhpre"][0] == (M, H)
    assert sc["z"][0] == sc["doc"][0] == sc["dz"][0] == (M, C)
    assert sc["stats"][0] == (2 * M,)
    assert sc["dz"][1] == torch.float32 and sc["h"][1] == torch.bfloat16


@pytest.mark.parametrize("M,C,fc1,fc2", [
    (98304, 192, 256, 192), (24576, 384, 256, 192), (6144, 768, 256, 192),
    (8192, 192, 192, 128), (4096, 384, 192, 128), (2048, 768, 192, 128),
])
def test_fc_tile_width_plan_at_the_train_shapes(M, C, fc1, fc2):
    """The forward chain's column-tile widths at each train shape of
    ``triplane_range_cam`` at batch 2 on a 132-SM H100: the camera rows
    keep the wide tiles; the lidar rows take the narrow ones, which an
    A/B on the card measured faster than the wide ones at those rows."""
    assert K.plan_tile_width(M, 4 * C, 132, K.FC1_WIDTHS) == fc1
    assert K.plan_tile_width(M, C, 132, K.FC2_WIDTHS) == fc2


@pytest.mark.parametrize("M,C,s1,s2,bn2", [
    (98304, 192, 22, 22, 96), (24576, 384, 5, 7, 128),
    (16384, 96, 44, 64, 96), (8192, 192, 22, 22, 96), (4096, 384, 5, 7, 128),
    (6144, 768, 1, 1, 128), (2048, 768, 1, 1, 128),
])
def test_bwd_plan_at_the_train_shapes(M, C, s1, s2, bn2):
    """The backward chain's plan at each train shape of
    ``triplane_range_cam`` at batch 2 on a 132-SM H100 (the five narrow
    ones, then the two wide ones): dW1's and dW2's ranges of M, which
    times their 128 x 256 tiles fill the SMs at most once (one range where
    the tiles alone fill them, as at C = 768), and dual GEMM 2's width,
    which tiles C without a partly empty tile."""
    assert K.plan_atb_splits(M, 4 * C, C, 132) == s1
    assert K.plan_atb_splits(M, C, 4 * C, 132) == s2
    assert K.plan_dual_width(C) == bn2 and C % bn2 == 0
    tiles1 = (4 * C // 128) * -(-C // 256)
    tiles2 = -(-C // 128) * (4 * C // 256)
    assert s1 * tiles1 <= max(132, tiles1) and s2 * tiles2 <= max(132, tiles2)
    assert M // s1 >= K.ATB_MIN_ROWS and M // s2 >= K.ATB_MIN_ROWS


@pytest.mark.parametrize("C", [96, 192, 384])
def test_narrow_bwd_scratch_sizes(C):
    """The chain's scratch at the narrow widths, at a ragged M whose
    weight gradients split over M: ``wpart`` holds the larger split's
    partial products (both weights have 4C^2 entries); with no split it
    is absent."""
    M, H = 1000, 4 * C
    splits = (K.plan_atb_splits(M, H, C, 132), K.plan_atb_splits(M, C, H, 132))
    assert splits == (3, 3)
    sc = K.bwd_scratch(M, C, splits)
    assert sc["wpart"] == ((3 * H * C,), torch.float32)
    assert sc["part"][0] == (8 * 8, 8 * C)
    assert sc["h"][0] == sc["dhpre"][0] == (M, H)
    assert sc["w1t"][0] == (C, H) and sc["w2t"][0] == (H, C)
    assert "wpart" not in K.bwd_scratch(M, C)


@pytest.mark.parametrize("M,C,n", [
    (786432, 96, 6), (196608, 192, 3), (49152, 384, 2), (12288, 768, 1),
    (65536, 96, 1), (40960, 96, 1), (640, 768, 1), (160, 768, 1),
])
def test_k1_chunk_plan_at_the_serve_shapes(M, C, n):
    """K1's row chunks at the serve shapes of batch 4 (the camera's four
    stages, the point family's xy and yz planes at stage 0, its yz / xz
    planes at stage 3) and at one sample's xz stage 3: as few chunks as
    keep z and h under ``K1_CHUNK_BYTES``, in order, covering every row,
    all but the last a whole number of 128-row tiles."""
    chunks = K.plan_k1_chunks(M, C)
    assert len(chunks) == n
    assert [r for r, _ in chunks] == list(range(0, M, chunks[0][1]))
    assert sum(rows for _, rows in chunks) == M
    assert all(rows * 10 * C <= K.K1_CHUNK_BYTES for _, rows in chunks)
    assert all(rows % 128 == 0 for _, rows in chunks[:-1])
