"""The port's CUDA kernels against their plain twins, on the card.

Skipped without an NVIDIA GPU: a CUDA kernel has no CPU mode.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from efficient_multimodal_perception_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cuda_device):
    """Each CUDA kernel against its twin in bf16 on the card, at small
    shapes the kernels take (relative Frobenius error <= 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    C = 96
    blk = (rn(2, 8, 16, C), rn(C, 1, 7, 7, scale=0.15, dtype=torch.float32),
           rn(C, scale=0.1, dtype=torch.float32),
           1 + rn(C, scale=0.1, dtype=torch.float32),
           rn(C, scale=0.1, dtype=torch.float32), rn(4 * C, C, scale=0.1),
           rn(4 * C, scale=0.1, dtype=torch.float32),
           rn(C, 4 * C, scale=0.05), rn(C, scale=0.1, dtype=torch.float32),
           torch.rand(C, generator=g, device=cuda_device) + 0.1)
    assert rel(K.convnext_block_fused(*blk), K.convnext_block_plain(*blk)) < 1e-2
    q, k, v = rn(2, 128, 64), rn(2, 128, 64), rn(2, 128, 64)
    (o, lse), (o_p, lse_p) = K.attention(q, k, v, 0.125), K.attention_plain(
        q, k, v, 0.125)
    assert rel(o, o_p) < 1e-2 and float((lse - lse_p).abs().max()) < 1e-2
    x, w = rn(128, 256), rn(128, 256, scale=1 / 16)
    s, b = 1 + rn(256, scale=0.1, dtype=torch.float32), rn(
        256, scale=0.1, dtype=torch.float32)
    bias = rn(128, scale=0.1, dtype=torch.float32)
    assert rel(K.ln_dense_fused(x, s, b, w, bias),
               K.ln_dense_plain(x, s, b, w, bias)) < 1e-2
    assert rel(K.gelu_dense_fused(x, w, bias),
               K.gelu_dense_plain(x, w, bias)) < 1e-2
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,N", [
    (1024, 384, 384), (1024, 384, 768), (1024, 384, 1152),  # ragged tile
    (4096, 1024, 3072), (4096, 1024, 2048),                  # batch 1
    (1024, 1536, 1536), (1024, 2560, 2560),  # LN rows past 1024 and 2048
    (4133, 1024, 2048),  # ragged M through the shared GEMM header
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_prologue_dense_matches_twins_on_card(cuda_device, M, C, N,
                                              with_bias):
    """K3 and K4 at shapes the neck's gate admits: widths N of C, 2C and
    3C whose last 256-wide column tile is half empty at C = 384, the
    neck's batch-1 rows, and widths whose LN rows take the row pass's
    other two forms (relative Frobenius error < 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(M + N)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    x, w = rn(M, C), rn(N, C, scale=C**-0.5)
    s, b = 1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32)
    bias = rn(N, scale=0.1, dtype=f32) if with_bias else None
    assert rel(K.ln_dense_fused(x, s, b, w, bias),
               K.ln_dense_plain(x, s, b, w, bias)) < 1e-2
    xh, wh = rn(M, 2 * C), rn(N, 2 * C, scale=(2 * C)**-0.5)
    assert rel(K.gelu_dense_fused(xh, wh, bias),
               K.gelu_dense_plain(xh, wh, bias)) < 1e-2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tiny_occ_bf16_on_card(cuda_device):
    """tiny_occ in bf16 on the card: the attention kernel (head dim 16)
    and B8 (16 channels) are on its path, the other gates stay closed at
    tiny widths, and the result agrees with the all-plain run."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )

    model = build_model(get_config("tiny_occ")["model"], device=cuda_device,
                        dtype=torch.bfloat16)
    batch = synthetic_batch(1, point_budget=2048, seed=3, device=cuda_device)
    K.reset_launches()
    with torch.inference_mode():
        got = model(batch)[0].float()
        launches = dict(K.LAUNCHES)
        set_kernels(model, False)
        want = model(batch)[0].float()
    on_path = {"attention": 2, "cam_gather_sum": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert got.shape == (1, 99, 99, 16, 5) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < 3e-2


@pytest.mark.cuda
def test_training_kernels_match_twins_on_card(cuda_device):
    """The training kernels against their twins in bf16 on the card at
    small shapes, ragged row counts included (relative Frobenius error
    <= 1e-2 for every output)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    # the last four row counts are ragged past one 128-row GEMM tile
    for C, M in ((96, 100), (192, 64), (384, 40), (768, 48), (192, 300),
                 (384, 259), (768, 129), (768, 300)):
        prm = (1 + rn(C, scale=0.1, dtype=torch.float32),
               rn(C, scale=0.1, dtype=torch.float32), rn(4 * C, C, scale=C**-0.5),
               rn(4 * C, scale=0.1, dtype=torch.float32),
               rn(C, 4 * C, scale=(4 * C)**-0.5),
               rn(C, scale=0.1, dtype=torch.float32),
               torch.rand(C, generator=g, device=cuda_device) + 0.1)
        y, gy = rn(M, C), rn(M, C)
        assert rel(K.epilogue_fused(y, *prm), K.epilogue_plain(y, *prm)) < 1e-2
        bwd = K.post_epilogue_bwd if C <= 384 else K.post_epilogue_bwd_wide
        for a, b in zip(bwd(y, gy, *prm), K.post_epilogue_bwd_plain(y, gy, *prm)):
            assert rel(a, b) < 1e-2
    for G, nq, nk, hd in ((2, 128, 64, 24), (1, 64, 64, 256), (2, 64, 128, 8)):
        q, k, v, do = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd), rn(G, nq, hd)
        (o, lse), (o_p, _) = K.attention(q, k, v, hd**-0.5), K.attention_plain(
            q, k, v, hd**-0.5)
        assert rel(o, o_p) < 1e-2
        for a, b in zip(K.attention_bwd(q, k, v, o, lse, do, hd**-0.5),
                        K.attention_bwd_plain(q, k, v, o, lse, do, hd**-0.5)):
            assert rel(a, b) < 1e-2
    tri = rn(2, 3, 16, 16, 32)
    c = (torch.rand(2, 500, 3, generator=g, device=cuda_device) * 2.4 - 1.2)
    gs = rn(2, 500, 32)
    assert rel(K.triplane_sample(tri, c), K.triplane_sample_plain(tri, c)) < 1e-2
    assert rel(K.triplane_sample_bwd(c, gs, 16),
               K.triplane_sample_bwd_plain(c, gs, 16)) < 1e-2
    torch.cuda.synchronize()


# one head dim per instantiation, and those the paths and tiny models
# use: the forward pads hd to 64 / 128 / 256, the backward to 128 / 256
ATTENTION_HDS = (8, 16, 24, 64, 128, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", ATTENTION_HDS)
def test_attention_matches_twins_on_card(cuda_device, hd):
    """K2 and B6 against their twins at every head-dim instantiation:
    one 64-row tile each way (smaller than the 128-query block), Nq !=
    Nk both ways with G > 1, and a ragged last key tile of the forward's
    128-key tiles (Nk = 320).  Outputs within rel 1e-2, lse within 1e-2
    max-abs, and the backward bit-identical on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(hd)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    for G, nq, nk in ((1, 64, 64), (2, 128, 64), (3, 192, 320)):
        q, k, v, do = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd), rn(
            G, nq, hd)
        sc = hd**-0.5
        (o, lse), (o_p, lse_p) = K.attention(q, k, v, sc), K.attention_plain(
            q, k, v, sc)
        assert rel(o, o_p) < 1e-2, (G, nq, nk)
        assert float((lse - lse_p).abs().max()) < 1e-2, (G, nq, nk)
        got = K.attention_bwd(q, k, v, o, lse, do, sc)
        again = K.attention_bwd(q, k, v, o, lse, do, sc)
        want = K.attention_bwd_plain(q, k, v, o, lse, do, sc)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert rel(a, b) < 1e-2, (G, nq, nk)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_attention_plan_matches_library_on_card(cuda_device):
    """``ops.kernels.attention_plan`` (the Python mirror the CPU tests
    check) equals the plan the library reports, at every head dim."""
    for hd in range(8, 257, 8):
        assert K.attention_launch_config(hd) == K.attention_plan(hd), hd


@pytest.mark.cuda
@pytest.mark.parametrize("M", [300, 6144 + 37])
def test_wide_backward_is_deterministic_on_card(cuda_device, M):
    """Two calls of ``post_epilogue_bwd_wide`` give the same bits (no
    float atomics; the partial sums add in a fixed order) and match the
    twin."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    C, f32 = 768, torch.float32

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    prm = (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
           rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
           rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
           torch.rand(C, generator=g, device=cuda_device) + 0.1)
    y, gy = rn(M, C), rn(M, C, scale=0.05)
    first = K.post_epilogue_bwd_wide(y, gy, *prm)
    second = K.post_epilogue_bwd_wide(y, gy, *prm)
    want = K.post_epilogue_bwd_plain(y, gy, *prm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, want):
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_gamma", [
    ((1, 16, 10, 768), True), ((1, 16, 10, 768), False),
    ((3, 7, 11, 96), True), ((3, 7, 11, 96), False),
])
def test_convnext_block_chain_matches_twin_on_card(cuda_device, shape,
                                                    with_gamma):
    """K1's GEMM chain against its twin at row counts that leave the last
    128-row tile ragged (160 rows: one sample's xz plane at stage 3; 231
    rows at C = 96, whose fc2 tile is partly past C), with layer-scale
    gamma and without (relative Frobenius error <= 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    C, f32 = shape[-1], torch.float32

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device=cuda_device)
                * scale).to(dtype)

    gamma = (torch.rand(C, generator=g, device=cuda_device) + 0.1
             if with_gamma else None)
    blk = (rn(*shape), rn(C, 1, 7, 7, scale=7**-1, dtype=f32),
           rn(C, scale=0.1, dtype=f32), 1 + rn(C, scale=0.1, dtype=f32),
           rn(C, scale=0.1, dtype=f32), rn(4 * C, C, scale=C**-0.5),
           rn(4 * C, scale=0.1, dtype=f32), rn(C, 4 * C, scale=(4 * C)**-0.5),
           rn(C, scale=0.1, dtype=f32), gamma)
    got, want = K.convnext_block_fused(*blk), K.convnext_block_plain(*blk)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("M,C", [(1000, 96), (777, 384)])
def test_narrow_backward_is_deterministic_on_card(cuda_device, M, C):
    """Two calls of ``post_epilogue_bwd`` give the same bits at a ragged
    M whose weight gradients split over M (three ranges, summed in a
    fixed order), and match the twin."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    f32 = torch.float32

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    prm = (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
           rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
           rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
           torch.rand(C, generator=g, device=cuda_device) + 0.1)
    y, gy = rn(M, C), rn(M, C, scale=0.05)
    first = K.post_epilogue_bwd(y, gy, *prm)
    second = K.post_epilogue_bwd(y, gy, *prm)
    want = K.post_epilogue_bwd_plain(y, gy, *prm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, want):
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 1e-2


@pytest.mark.cuda
def test_tiny_range_cam_train_step_on_card(cuda_device):
    """One tiny range-cam forward and backward at B=1 in bf16 with the
    kernels and with ``set_kernels(model, False)``, same batch and
    drop-path generator.  At tiny widths the attention (head dims 16 and
    8), sampler and B8 kernels are on the path, forward and backward, and
    must take the strided-at-B=1 tensors the model hands them."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
        loss_and_grads,
    )

    cfg = get_config("tiny_range_cam")
    model = build_model(cfg["model"], device=cuda_device, dtype=torch.bfloat16)
    trainer = build_trainer(cfg, model, total_steps=2)
    batch = synthetic_batch(1, point_budget=2048, seed=3, device=cuda_device)
    K.reset_launches()
    lk, _, gk = loss_and_grads(model, trainer.params, batch, trainer.generator(0))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    set_kernels(model, False)
    lp, _, gp = loss_and_grads(model, trainer.params, batch, trainer.generator(0))
    set_kernels(model, True)
    on_path = {"attention": 6, "attention_bwd": 6, "triplane_sample": 1,
               "triplane_sample_bwd": 1, "cam_gather_sum": 1,
               "cam_gather_sum_bwd": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-2 * abs(float(lp[k]))
    a = torch.cat([x.float().flatten() for x in gk])
    b = torch.cat([x.float().flatten() for x in gp])
    assert bool(torch.isfinite(a).all())
    assert float((a - b).norm() / b.norm()) < 5e-2
    logs = trainer.train_step(batch)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())


@pytest.mark.cuda
def test_finite_mlp_matches_twin_on_card(cuda_device):
    """B9 against its twin at width 128: a ragged row count (not a
    multiple of the kernel's 128-row tile), whole -inf rows and scattered
    -inf values (relative Frobenius error <= 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    M, Kd, N = 300, 320, 128
    x = torch.randn(M, Kd, generator=g, device=cuda_device)
    x[torch.rand(M, generator=g, device=cuda_device) < 0.3] = float("-inf")
    x[torch.rand(M, Kd, generator=g, device=cuda_device) < 0.1] = float("-inf")
    x = x.to(bf)
    w1 = (torch.randn(N, Kd, generator=g, device=cuda_device) * Kd**-0.5).to(bf)
    w2 = (torch.randn(N, N, generator=g, device=cuda_device) * N**-0.5).to(bf)
    b1 = torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1
    b2 = torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1
    K.reset_launches()
    got = K.finite_mlp_fused(x, w1, b1, w2, b2)
    want = K.finite_mlp_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["finite_mlp_fused"] == 1
    assert got.shape == (M, N) and bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert float(err) < 1e-2
    with pytest.raises(ValueError, match="finite_mlp_fused"):
        K.finite_mlp_fused(x[:, :300].contiguous(), w1[:, :300].contiguous(),
                           b1, w2, b2)


@pytest.mark.cuda
def test_tiny_point_occ_bf16_on_card(cuda_device):
    """tiny point_triplane_occ in bf16 on the card, its projector at the
    kernel's width 128 so the plane MLPs run B9 over bf16 raw pools (the
    tiny ConvNeXt widths keep K1 closed); the result agrees with the
    all-plain run."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )

    cfg = get_config("tiny_point_occ")["model"]
    cfg["point_triplane_projector"]["out_channels"] = 128
    cfg["triplane_encoder"]["in_channels"] = 128
    model = build_model(cfg, device=cuda_device, dtype=torch.bfloat16)
    batch = synthetic_batch(2, point_budget=2048, seed=3, device=cuda_device)
    K.reset_launches()
    with torch.inference_mode():
        got = model(batch)[0].float()
        launches = dict(K.LAUNCHES)
        set_kernels(model, False)
        want = model(batch)[0].float()
    assert launches == {k: 3 if k == "finite_mlp_fused" else 0
                        for k in K.LAUNCHES}
    assert got.shape == (2, 99, 99, 16, 5) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < 3e-2


def probe_operands(device):
    """The int8 dot probe's operands (``tools/measure_int8.py``): x (256,
    128), w (128, 256) as JAX's (K, N), returned as ``(x, w.T)``."""
    x = (torch.arange(256 * 128).reshape(256, 128) % 13 - 6).to(torch.int8)
    w = (torch.arange(128 * 256).reshape(128, 256) % 7 - 3).to(torch.int8)
    return x.to(device), w.t().contiguous().to(device)


@pytest.mark.cuda
def test_int8_kernels_match_twins_on_card(cuda_device, monkeypatch):
    """The int8 probe is exact, on the JAX tool's operands and, through
    the int8 wgmma GEMM, at ragged M, N and K (the K tail past a
    128-value stage zero-filled) at every tile width, and at a shape of
    many tiles with K > 128; N % 8 or K % 16 off raises.  B10 equals its
    twin bit for bit at a ragged row count and at the widest width (it
    rounds where the twin does); a dtype the kernel does not take
    raises."""
    x8, w8 = probe_operands(cuda_device)
    want = x8.cpu().long() @ w8.cpu().long().t()
    K.reset_launches()
    got = K.int8_dot(x8, w8)
    torch.cuda.synchronize()
    assert K.LAUNCHES["int8_dot"] == 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), want)

    g = torch.Generator(device=cuda_device).manual_seed(3)

    def ri(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             device=cuda_device, dtype=torch.int8)

    shapes = ((17, 48, 24), (200, 160, 40), (1000, 384, 520),
              (4133, 272, 392))
    for bn in K.INT8_WIDTHS:  # every tile width at the ragged shapes
        monkeypatch.setattr(K, "plan_tile_width", lambda *a, bn=bn: bn)
        for M, Kd, N in shapes:
            x, w = ri(M, Kd), ri(N, Kd)
            assert torch.equal(K.int8_dot(x, w), K.int8_dot_plain(x, w)), (
                bn, M, Kd, N)
    monkeypatch.undo()
    x, w = ri(2048, 1040), ri(2048, 1040)  # 128 tiles, 9 k-stages
    assert torch.equal(K.int8_dot(x, w), K.int8_dot_plain(x, w))
    for x, w in ((ri(32, 40), ri(16, 40)), (ri(32, 48), ri(12, 48))):
        with pytest.raises(ValueError, match="int8_dot"):
            K.int8_dot(x, w)
    f32 = torch.float32

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale

    for shape in ((2, 5, 7, 96), (1, 4, 8, 768)):
        C = shape[-1]
        blk = (rn(*shape).to(torch.bfloat16), rn(C, 1, 7, 7, scale=1 / 7),
               rn(C, scale=0.1), 1 + rn(C, scale=0.1), rn(C, scale=0.1),
               rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1),
               rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1),
               torch.rand(C, generator=g, device=cuda_device) + 0.1)
        out = K.convnext_block_int8_fused(*blk)
        ref = K.convnext_block_int8_plain(*blk)
        assert torch.equal(out, ref) and not torch.equal(out, blk[0])
    with pytest.raises(ValueError, match="convnext_block_int8_fused"):
        K.convnext_block_int8_fused(blk[0].float(), *blk[1:])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tiny_int8_forward_on_card(cuda_device):
    """tiny_occ with ConvNeXt-tiny widths (one block a stage) and int8 on,
    in bf16 on the card: every block runs B10 and none K1, the neck's
    prologue kernels stay off, attention and B8 run; the result agrees
    with the all-plain run."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.ops.quant import enable_int8

    cfg = enable_int8(get_config("tiny_occ")["model"])
    arch = {"depths": (1, 1, 1, 1), "channels": (96, 192, 384, 768)}
    cfg["encoder"]["camera_encoder"]["arch"] = arch
    cfg["encoder"]["lidar_encoder"].update(arch=arch, in_channels=1 + 192)
    cfg["encoder"]["embed_dims"] = 192
    cfg["neck"]["in_chans"] = cfg["embed_dim"] = 768
    model = build_model(cfg, device=cuda_device, dtype=torch.bfloat16)
    batch = synthetic_batch(1, point_budget=2048, seed=3, device=cuda_device)
    K.reset_launches()
    with torch.inference_mode():
        got = model(batch)[0].float()
        launches = dict(K.LAUNCHES)
        set_kernels(model, False)
        want = model(batch)[0].float()
    on_path = {"convnext_block_int8_fused": 8, "attention": 2,
               "cam_gather_sum": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert got.shape == (1, 99, 99, 16, 5) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < 3e-2


def host_cam_gather_bwd(g, idx, valid, Kr):
    """B8's gradient on the host: ``g`` rounded to bf16, float32
    ``np.add.at`` in (b, n, p) order, rounded to bf16 once."""
    B, P, C = g.shape
    N = idx.shape[1]
    i, v = idx.cpu().numpy().astype(np.int64), valid.cpu().numpy() > 0
    keep = v & (i >= 0) & (i < Kr)
    rows = (np.arange(B * N).reshape(B, N, 1) * Kr + i)[keep]
    src = np.broadcast_to(g.to(torch.bfloat16).float().cpu().numpy()[:, None],
                          (B, N, P, C))[keep]
    out = np.zeros((B * N * Kr, C), np.float32)
    np.add.at(out, rows, src)
    return torch.from_numpy(out).to(torch.bfloat16).reshape(B, N, Kr, C)


@pytest.mark.cuda
def test_cam_gather_matches_twins_on_card(cuda_device):
    """B8 forward against its twin on the card (relative Frobenius error
    <= 1e-2), and the backward bit for bit against the host ``np.add.at``
    reference and against itself on a second call (it sums each row in
    ascending pixel order): at B=1 and B=2, with many points on one
    feature row and indices outside ``[0, K)``, at C = 2048, and with more
    than 4096 valid entries a camera (ranked by one warp); the wrappers
    refuse what the kernels do not take."""
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    for B, N, Kr, C, P in ((1, 6, 32, 16, 700), (2, 3, 8, 192, 300),
                           (1, 1, 3, 2048, 40), (1, 2, 5, 8, 12000)):
        feats = torch.randn(B, N, Kr, C, generator=g, device=cuda_device).to(
            torch.bfloat16)
        idx = torch.randint(-1, Kr + 1, (B, N, P), generator=g,
                            device=cuda_device, dtype=torch.int32)
        valid = (torch.rand(B, N, P, generator=g, device=cuda_device)
                 > 0.3).to(torch.uint8)
        gr = torch.randn(B, P, C, generator=g, device=cuda_device)
        assert rel(K.cam_gather_sum(feats, idx, valid),
                   K.cam_gather_sum_plain(feats, idx, valid)) < 1e-2
        got = K.cam_gather_sum_bwd(gr, idx, valid, Kr)
        assert torch.equal(got, K.cam_gather_sum_bwd(gr, idx, valid, Kr))
        assert torch.equal(got.cpu(), host_cam_gather_bwd(gr, idx, valid, Kr))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="int64"):
        K.cam_gather_sum(feats, idx.long(), valid)
    with pytest.raises(ValueError, match="bool"):
        K.cam_gather_sum(feats, idx, valid.bool())
    with pytest.raises(ValueError, match="float32"):
        K.cam_gather_sum(feats.float(), idx, valid)
    with pytest.raises(ValueError, match="non-contiguous"):
        K.cam_gather_sum(feats.transpose(2, 3).contiguous().transpose(2, 3),
                         idx, valid)
    with pytest.raises(ValueError, match="bfloat16"):
        K.cam_gather_sum_bwd(gr.to(torch.bfloat16), idx, valid, Kr)


def b10_block(device, shape, seed, gamma=True, flat_rows=0):
    """B10's arguments at ``shape`` (N, H, W, C) from ``seed``, weights
    in float32 as the models hold them.  ``flat_rows`` > 0 zeroes the
    first rows of x and makes the depthwise bias constant, LN's shift
    and fc1's bias zero: the pixels whose 7x7 window sees only those rows
    get z = 0 and h = 0, rows whose codes take the 1e-12 scale floor."""
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[-1]

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    x = rn(*shape)
    dw_b, ln_b, b1 = rn(C, scale=0.1), rn(C, scale=0.1), rn(4 * C, scale=0.1)
    if flat_rows:
        x[:, :flat_rows] = 0
        dw_b, ln_b, b1 = torch.full_like(dw_b, 0.5), ln_b * 0, b1 * 0
    return (x.to(torch.bfloat16), rn(C, 1, 7, 7, scale=1 / 7), dw_b,
            1 + rn(C, scale=0.1), ln_b, rn(4 * C, C, scale=C**-0.5), b1,
            rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1),
            torch.rand(C, generator=g, device=device) + 0.1 if gamma
            else None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,gamma,flat_rows", [
    ((1, 823, 15, 96), True, 0),    # 12345 rows: a ragged last tile
    ((1, 16, 10, 768), False, 0),   # 160 rows, gamma None
    ((2, 5, 7, 96), True, 0),       # M < 128 at every width
    ((2, 5, 7, 192), True, 0),
    ((2, 5, 7, 384), True, 0),
    ((2, 5, 7, 768), True, 0),
    ((1, 16, 16, 192), True, 8),    # rows of all-equal y: the scale floor
])
def test_b10_matches_twin_bit_for_bit_on_card(cuda_device, shape, gamma,
                                              flat_rows):
    """B10 (row pass, fc1's amax and quantize passes, fc2 on the int8
    wgmma GEMM) equals its twin bit for bit: it rounds where the twin
    rounds, and its int32 sums are exact.  One call is one launch count;
    the output moved off x."""
    blk = b10_block(cuda_device, shape, sum(shape), gamma, flat_rows)
    K.reset_launches()
    out = K.convnext_block_int8_fused(*blk)
    torch.cuda.synchronize()
    assert K.LAUNCHES["convnext_block_int8_fused"] == 1
    assert torch.equal(out, K.convnext_block_int8_plain(*blk))
    assert not torch.equal(out, blk[0])


@pytest.mark.cuda
def test_b10_every_fc2_width_and_chunking_on_card(cuda_device, monkeypatch):
    """B10 bit for bit at every tile width of fc2 (two CTAs an SM at 96
    and 128 columns, one at 192 and 256), at a ragged row count, and over
    many row chunks with a ragged last one (a budget of 1024 rows at
    C = 96)."""
    blk = b10_block(cuda_device, (1, 823, 15, 96), 5)
    want = K.convnext_block_int8_plain(*blk)
    for bn in K.INT8_WIDTHS:
        monkeypatch.setattr(K, "plan_tile_width", lambda *a, bn=bn: bn)
        assert torch.equal(K.convnext_block_int8_fused(*blk), want), bn
    monkeypatch.undo()
    monkeypatch.setattr(K, "B10_CHUNK_BYTES", 5 * 96 * 1024)
    assert len(K.plan_b10_chunks(12345, 96)) == 13
    assert torch.equal(K.convnext_block_int8_fused(*blk), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kd", [(300, 8), (77, 200), (1000, 3200)])
def test_finite_mlp_special_values_on_card(cuda_device, M, Kd):
    """B9 (TMA + wgmma) against its twin at ragged M, the smallest K and
    a K that ends inside a 64-value stage: a row all -inf reads as zeros;
    a NaN or a +inf entry is not zeroed, so its row comes out NaN or
    infinite where the twin's does; the finite rows within the relative
    Frobenius error 1e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(M + Kd)
    bf, f32 = torch.bfloat16, torch.float32
    N = K.FINITE_MLP_WIDTH
    x = torch.randn(M, Kd, generator=g, device=cuda_device)
    x[torch.rand(M, Kd, generator=g, device=cuda_device) < 0.3] = float("-inf")
    x[1] = float("-inf")
    x[2, Kd // 2] = float("nan")
    x[3, Kd - 1] = float("inf")
    x = x.to(bf)
    w1 = (torch.randn(N, Kd, generator=g, device=cuda_device)
          * Kd**-0.5).to(bf)
    w2 = (torch.randn(N, N, generator=g, device=cuda_device) * N**-0.5).to(bf)
    b1 = torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1
    b2 = torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1
    K.reset_launches()
    got = K.finite_mlp_fused(x, w1, b1, w2, b2).float()
    want = K.finite_mlp_plain(x, w1, b1, w2, b2).float()
    torch.cuda.synchronize()
    assert K.LAUNCHES["finite_mlp_fused"] == 1 and got.shape == (M, N)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    assert bool(torch.isnan(got[2]).any()) and bool(torch.isfinite(got[1]).all())
    rows = torch.isfinite(want).all(1)
    rows[:4] = False
    err = (got[rows] - want[rows]).norm() / want[rows].norm()
    assert float(err) < 1e-2


def b7_coords(case, B, P, device, seed):
    """B7 coordinates (B, P, 3) f32 on ``device``: ``"path"`` (a third
    of the points at the world origin, as the empty range pixels of the
    pretraining path, so one cell a plane holds thousands), ``"edges"``
    (on texel edges and texel centres, inside and just outside [-1, 1],
    where weights are 0 or 1), ``"outside"`` (most points off the planes),
    ``"nan"`` (NaN on some axes), ``"ground"`` (z in one texel row of a
    128 plane, so the yz and xz planes hold a row of heavy cells side by
    side, tens to hundreds of points each) and ``"uniform"``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    if case == "path":
        c[:, rng.random(P) < 0.35] = (-0.0234375, -0.0234375, -0.21875)
    elif case == "edges":
        S = 16
        edge = (2 * rng.integers(-1, S + 2, (B, P, 3)) + 1) / S - 1
        centre = (2 * rng.integers(-1, S + 2, (B, P, 3)) + 2) / S - 1
        c = np.where(rng.random((B, P, 3)) < 0.5, edge, centre).astype(
            np.float32)
        c[:, ::7] = rng.choice([-1.0, 1.0, -1.0625, 1.0625], (B, c[:, ::7].shape[1], 3))
    elif case == "outside":
        c *= 3.0
    elif case == "nan":
        c[:, ::5, 0] = np.nan
        c[:, ::11] = np.nan
    elif case == "ground":
        c[..., 2] = (2 * 40 + 1 + rng.uniform(-0.9, 0.9, (B, P))) / 128 - 1
    return torch.from_numpy(c).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,P,S,C", [
    ("path", 2, 9000, 32, 32),     # a heavy cell a plane, 3 sort slices
    ("path", 1, 4099, 16, 64),     # P one past a slice, C = 64
    ("edges", 2, 1001, 16, 32),    # P not a multiple of 8 points a warp
    ("outside", 1, 777, 16, 32),
    ("nan", 2, 500, 16, 64),
    ("uniform", 3, 300, 8, 8),
    ("uniform", 1, 20000, 8, 32),  # 81 heavy cells of ~250 points a plane
    ("ground", 2, 20000, 128, 32),  # a row of ~160-point cells, yz and xz
])
def test_triplane_sample_matches_reference_on_card(cuda_device, case, B, P,
                                                   S, C):
    """B7 on the card: the backward bit-identical on a second call and to
    the float32 host reference in its order
    (``triplane_sample_bwd_reference``), at heavy cells, texel edges,
    points off the planes, NaN coordinates, P that is not a multiple of a
    warp's points and C in {8, 32, 64}; forward and backward within 1e-2
    of their twins on the points the twins take (NaN coordinates give the
    twins NaN weights; the kernels drop such corners)."""
    g = torch.Generator(device=cuda_device).manual_seed(P)
    bf = torch.bfloat16
    coords = b7_coords(case, B, P, cuda_device, P)
    tri = torch.randn(B, 3, S, S, C, generator=g, device=cuda_device).to(bf)
    gs = torch.randn(B, P, C, generator=g, device=cuda_device).to(bf)
    K.reset_launches()
    got = K.triplane_sample_bwd(coords, gs, S)
    again = K.triplane_sample_bwd(coords, gs, S)
    out = K.triplane_sample(tri, coords)
    torch.cuda.synchronize()
    assert K.LAUNCHES["triplane_sample_bwd"] == 2
    assert got.dtype == bf and got.shape == (B, 3, S, S, C)
    assert torch.equal(got, again)
    want = torch.from_numpy(K.triplane_sample_bwd_reference(
        coords.cpu().numpy(), gs.float().cpu().numpy(), S)).to(bf)
    assert torch.equal(got.cpu(), want)
    assert bool(torch.isfinite(out.float()).all())
    keep = ~torch.isnan(coords).any(-1)
    cf, gf = coords[:, keep.all(0)], gs[:, keep.all(0)]
    plain = K.triplane_sample_plain(tri, cf).float()
    assert float((out[:, keep.all(0)].float() - plain).norm()
                 / plain.norm()) < 1e-2
    twin = K.triplane_sample_bwd_plain(cf, gf, S)
    mine = K.triplane_sample_bwd(cf.contiguous(), gf.contiguous(), S).float()
    assert float((mine - twin).norm() / twin.norm()) < 1e-2
    with pytest.raises(ValueError, match="float32"):
        K.triplane_sample_bwd(coords, gs.float(), S)
    with pytest.raises(ValueError, match="S="):
        K.triplane_sample_bwd(coords, gs, K.TRI_BWD_MAX_S + 1)


@pytest.mark.cuda
def test_triplane_bwd_scratch_is_what_the_entry_checks_on_card(cuda_device):
    """The scratch the wrapper asks the library for is the least the C
    entry takes: one word fewer is refused, that many run and write every
    gradient value."""
    lib = K._lib()
    for B, P, S, C in ((2, 32768, 128, 32), (1, 4099, 16, 64), (1, 20, 8, 8)):
        words = K.triplane_bwd_scratch_words(B, P, S, C)
        coords = torch.zeros(B, P, 3, device=cuda_device)
        g = torch.zeros(B, P, C, dtype=torch.bfloat16, device=cuda_device)
        meta = torch.empty(words, dtype=torch.int32, device=cuda_device)
        grad = torch.empty(B, 3, S, S, C, dtype=torch.bfloat16,
                           device=cuda_device)
        stream = K._stream(g)
        args = (coords.data_ptr(), g.data_ptr(), meta.data_ptr())
        rest = (grad.data_ptr(), B, P, S, C, stream)
        assert lib.emp_triplane_sample_bwd(*args, words - 1, *rest) != 0
        assert lib.emp_triplane_sample_bwd(*args, words, *rest) == 0
        torch.cuda.synchronize()  # every point at the centre, g = 0
        assert torch.equal(grad, torch.zeros_like(grad))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K_,C,P", [
    (6, 64, 192, 1000),    # P not a multiple of 32
    (2, 16, 8, 300),       # C = 8: one chunk a row
    (3, 40, 96, 32),       # one tile
    (1, 5, 192, 4133),
    (17, 24, 32, 500),     # more cameras than a warp holds in shared memory
    (40, 8, 64, 97),
])
def test_cam_gather_forward_edges_on_card(cuda_device, N, K_, C, P):
    """B8's forward against its twin: rows no camera sees (zeros), indices
    outside [0, K) (they add 0), P not a multiple of a warp's 32 pixels
    and C in {8, 96, 192}, up to 40 cameras; summed in f32 in camera
    order, so the rows that one camera sees equal the feature row
    exactly."""
    g = torch.Generator(device=cuda_device).manual_seed(P + C)
    B = 2
    feats = torch.randn(B, N, K_, C, generator=g, device=cuda_device).to(
        torch.bfloat16)
    idx = torch.randint(-2, K_ + 2, (B, N, P), generator=g,
                        device=cuda_device, dtype=torch.int32)
    valid = (torch.rand(B, N, P, generator=g, device=cuda_device)
             < 0.3).to(torch.uint8)
    valid[:, :, : P // 3] = 0  # a third of the pixels: no camera
    got = K.cam_gather_sum(feats, idx, valid)
    want = K.cam_gather_sum_plain(feats, idx, valid)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, P, C)
    assert torch.equal(got[:, : P // 3], torch.zeros_like(got[:, : P // 3]))
    keep = (valid > 0) & (idx >= 0) & (idx < K_)
    one = keep.sum(1) == 1
    assert torch.equal(got[one], want[one])
    assert float((got - want).norm() / want.norm()) < 1e-2


@pytest.mark.cuda
def test_finite_mlp_function_grads_match_twin_on_card(cuda_device):
    """B9's op ``emp::finite_mlp_fused`` (kernel forward, ``finite_mlp_bwd``
    backward) against autograd of its twin at the yz / xz plane shape of
    the point train (M = 20480 rows of K = 3200), with whole -inf rows,
    scattered -inf values and zeros in b1 (ReLU ties): every gradient
    within 1e-2 relative, no NaN, dx exactly 0 at -inf."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    M, Kd, N = 20480, 3200, 128
    x = torch.randn(M, Kd, generator=g, device=cuda_device)
    x[torch.rand(M, generator=g, device=cuda_device) < 0.5] = float("-inf")
    x[torch.rand(M, Kd, generator=g, device=cuda_device) < 0.2] = float("-inf")
    x = x.to(bf)
    b1 = torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1
    b1[::4] = 0.0
    args = (x, (torch.randn(N, Kd, generator=g, device=cuda_device)
                * Kd**-0.5).to(bf), b1,
            (torch.randn(N, N, generator=g, device=cuda_device)
             * N**-0.5).to(bf),
            torch.randn(N, generator=g, device=cuda_device, dtype=f32) * 0.1)
    gy = (torch.randn(M, N, generator=g, device=cuda_device) * 0.05).to(bf)
    ins = [a.clone().requires_grad_(True) for a in args]
    K.reset_launches()
    out = K.finite_mlp_fused(*ins)
    assert out.grad_fn is not None and K.LAUNCHES["finite_mlp_fused"] == 1
    got = torch.autograd.grad(out, ins, gy)
    ref = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(K.finite_mlp_plain(*ref), ref, gy)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and bool(torch.isfinite(a.float()).all())
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 1e-2
    assert float(got[0][x == float("-inf")].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_k1_gradient_to_its_input_on_card(cuda_device):
    """K1 (``convnext_block``) with frozen float32 parameters and an input
    that requires grad, at the triplane encoder's frozen stage 0 in the
    point train (C = 96, M = 2 x 128 x 80 = 20480 rows): the forward and
    dx against autograd of the twin (relative Frobenius error <= 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    C = 96

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dtype)

    prm = (rn(C, 1, 7, 7, scale=1 / 7), rn(C, scale=0.1),
           1 + rn(C, scale=0.1), rn(C, scale=0.1), rn(4 * C, C, scale=C**-0.5),
           rn(4 * C, scale=0.1), rn(C, 4 * C, scale=(4 * C)**-0.5),
           rn(C, scale=0.1),
           torch.rand(C, generator=g, device=cuda_device) * 0.9 + 0.1)
    x = rn(2, 128, 80, C, dtype=bf)
    gy = rn(2, 128, 80, C, scale=0.05, dtype=bf)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    K.reset_launches()
    yk = K.convnext_block(xk, *prm)
    (dk,) = torch.autograd.grad(yk, xk, gy)
    yp = K.convnext_block_plain(xp, *prm)
    (dp,) = torch.autograd.grad(yp, xp, gy)
    torch.cuda.synchronize()
    assert K.LAUNCHES["convnext_block_fused"] == 1
    assert K.LAUNCHES["post_epilogue_bwd"] == 1
    for a, b in ((yk, yp), (dk, dp)):
        assert bool(torch.isfinite(a.float()).all())
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 1e-2


@pytest.mark.cuda
def test_tiny_point_occ_train_step_on_card(cuda_device):
    """One ``tiny_point_occ`` training step on the card, its encoders at
    the ConvNeXt widths (one block a stage, stage 0 frozen, drop-path 0.1)
    and its projector at B9's width, so K1 (with its backward in the
    triplane encoder), B5 both ways and B9 run; the flat AdamW.  One
    forward and backward with the kernels, one with the bf16 twins and
    one with float32 twins (the same weights), each from the same
    BatchNorm statistics and drop-path draws: the kernels' losses and
    running statistics within 1e-2 of the bf16 twins', their gradient's
    error against the float32 run within 1.25 times the bf16 twins' own
    (``chip_smoke.TWIN_FACTOR``: training BatchNorm makes these gradients
    ill-conditioned, so both bf16 runs are far from the float32 one);
    then a ``train_step``: finite logs, every trainable tensor moved,
    frozen ones bit-identical, every running statistic moved."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
        loss_and_grads,
    )

    cfg = get_config("tiny_point_occ")
    m = cfg["model"]
    widths = (96, 192, 384, 768)
    for k in ("camera_encoder", "triplane_encoder"):
        m[k].update(arch={"depths": (1, 1, 1, 1), "channels": widths},
                    frozen_stages=1, drop_path_rate=0.1)
    m["point_triplane_projector"]["out_channels"] = 128
    m["triplane_encoder"]["in_channels"] = 128
    m["fpn"]["in_channels"] = widths
    model = build_model(m, device=cuda_device, dtype=torch.bfloat16)
    trainer = build_trainer(cfg, model, total_steps=2)
    m32 = build_model(m, device=cuda_device, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    trainable = {n for n, _ in trainer.named}
    for n, p in m32.named_parameters():
        p.requires_grad_(n in trainable)
    params32 = [dict(m32.named_parameters())[n] for n, _ in trainer.named]
    batch = synthetic_batch(2, point_budget=4096, with_occ=True, seed=3,
                            device=cuda_device)

    def stats(mod=model):
        return {k: v.clone() for k, v in mod.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    s0 = stats()
    K.reset_launches()
    lk, _, gk = loss_and_grads(model, trainer.params, batch,
                               trainer.generator(0))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    sk = stats()
    model.load_state_dict(s0, strict=False)
    set_kernels(model, False)
    lp, _, gp = loss_and_grads(model, trainer.params, batch,
                               trainer.generator(0))
    sp = stats()
    set_kernels(model, True)
    model.load_state_dict(s0, strict=False)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, _, g32 = loss_and_grads(m32, params32, batch,
                                   trainer.generator(0))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # K1: camera stage 0 and the triplane encoder's, once a plane, with
    # its backward (narrow B5) there; B5 at stages 1-3 of both encoders
    on_path = {"convnext_block_fused": 4, "epilogue_fused": 12,
               "post_epilogue_bwd": 3 + 8, "post_epilogue_bwd_wide": 4,
               "finite_mlp_fused": 3}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-2 * abs(float(lp[k]))
    a, b, f = (torch.cat([x.float().flatten() for x in gr])
               for gr in (gk, gp, g32))
    assert bool(torch.isfinite(a).all())
    assert rel(a, f) <= 1.25 * rel(b, f), (rel(a, f), rel(b, f), rel(a, b))
    for k in s0:
        assert rel(sk[k], sp[k]) < 1e-2, k
    frozen = {n: p.clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    before = [p.clone() for p in trainer.params]
    logs = trainer.train_step(batch)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())
    assert not any(torch.equal(p, q) for p, q in zip(trainer.params, before))
    assert frozen and all(torch.equal(p, frozen[n])
                          for n, p in model.named_parameters() if n in frozen)
    after = stats()
    assert not any(torch.equal(after[k], s0[k]) for k in s0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_tiny_elev_on_card(cuda_device, int8):
    """tiny_elev in bf16 (and with int8 on) on the card through the
    server's function: float32 ``(B, 100, 100)`` heights, attention and B8
    on the path (the tiny widths keep the other gates closed; int8 blocks
    there run their twin), the one-block head in bf16; the result agrees
    with the all-plain run."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.ops.quant import enable_int8
    from efficient_multimodal_perception_tpu_torch.serve import build_infer_fn

    cfg = get_config("tiny_elev")["model"]
    if int8:
        enable_int8(cfg)
    model = build_model(cfg, device=cuda_device, dtype=torch.bfloat16)
    infer = build_infer_fn(model)
    batch = synthetic_batch(2, point_budget=2048, seed=3, device=cuda_device)
    K.reset_launches()
    got = infer(batch)
    launches = dict(K.LAUNCHES)
    set_kernels(model, False)
    want = infer(batch)
    on_path = {"attention": 2, "cam_gather_sum": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert got.shape == (2, 100, 100) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < 3e-2


@pytest.mark.cuda
def test_elev_unet_finetune_step_on_card(cuda_device):
    """tiny_elev with the U-Net head of ``triplane_elev`` (32 channels, 80
    heights, pad 14) takes one fine-tune step at B=2 in bf16 on the card:
    the encoder and neck launch their forward kernels only, every head
    tensor and running statistic moves, the frozen tensors stay
    bit-identical."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
    )
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
    )

    cfg = get_config("tiny_elev")
    cfg["model"]["decoder"] = get_config("triplane_elev")["model"]["decoder"]
    model = build_model(cfg["model"], device=cuda_device,
                        dtype=torch.bfloat16)
    trainer = build_trainer(cfg, model, total_steps=2)
    assert all(n.startswith("decoder.") for n, _ in trainer.named)
    frozen = {n: p.clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    before = [p.clone() for p in trainer.params]
    batch = synthetic_batch(2, point_budget=2048, with_elev=True, seed=3,
                            device=cuda_device)
    K.reset_launches()
    logs = trainer.train_step(batch)
    torch.cuda.synchronize()
    on_path = {"attention": 2, "cam_gather_sum": 1}
    assert dict(K.LAUNCHES) == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())
    assert not any(torch.equal(p, q) for p, q in zip(trainer.params, before))
    assert frozen and all(torch.equal(p, frozen[n])
                          for n, p in model.named_parameters() if n in frozen)
    after = model.state_dict()
    assert len(stats) == 92
    assert not any(torch.equal(after[k], v) for k, v in stats.items())


@pytest.mark.cuda
def test_triplane_sample_on_raw_cloud_on_card(cuda_device):
    """B7 at the coordinates the contrastive loss hands it: every raw
    point of two synthetic samples (``tools.ab_trees.b7_raw_coords``:
    36864 a sample, the points beyond the 25 m range off the planes or on
    their edge cells, the padding rows at the origin, one heavy cell a
    plane).  The backward bit-identical on a second call and to the host
    reference in its order; forward and backward within 1e-2 of their
    twins."""
    from efficient_multimodal_perception_tpu_torch.tools.ab_trees import (
        b7_raw_coords,
    )

    S, C = 128, 32
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bf = torch.bfloat16
    coords = b7_raw_coords(2, cuda_device, S)
    B, P, _ = coords.shape
    assert float((coords.abs() > 1).any(-1).float().mean()) > 0.05
    tri = torch.randn(B, 3, S, S, C, generator=g, device=cuda_device).to(bf)
    gs = torch.randn(B, P, C, generator=g, device=cuda_device).to(bf)
    got = K.triplane_sample_bwd(coords, gs, S)
    again = K.triplane_sample_bwd(coords, gs, S)
    out = K.triplane_sample(tri, coords)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = torch.from_numpy(K.triplane_sample_bwd_reference(
        coords.cpu().numpy(), gs.float().cpu().numpy(), S)).to(bf)
    assert torch.equal(got.cpu(), want)
    plain = K.triplane_sample_plain(tri, coords).float()
    assert float((out.float() - plain).norm() / plain.norm()) < 1e-2
    twin = K.triplane_sample_bwd_plain(coords, gs, S)
    assert float((got.float() - twin).norm() / twin.norm()) < 1e-2


@pytest.mark.cuda
def test_tiny_surf_sam_train_step_on_card(cuda_device):
    """One ``tiny_surf_sam`` forward and backward at B=2 in bf16 with the
    kernels and with ``set_kernels(model, False)``, the same batch and the
    same drop-path and loss generators: B7 runs twice each way (the range
    points, then every raw point for the contrastive loss), the neck's
    attention and B8 once each way; losses within 1e-2 relative, the
    gradient within 5e-2; then a ``train_step`` with finite logs."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
        loss_and_grads,
    )

    cfg = get_config("tiny_surf_sam")
    model = build_model(cfg["model"], device=cuda_device, dtype=torch.bfloat16)
    trainer = build_trainer(cfg, model, total_steps=2)
    batch = synthetic_batch(2, point_budget=4096, seed=3, device=cuda_device)

    def run():
        return loss_and_grads(model, trainer.params, batch,
                              trainer.generator(0),
                              sample_generator=trainer.sample_generator(0))

    K.reset_launches()
    lk, _, gk = run()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    set_kernels(model, False)
    lp, _, gp = run()
    set_kernels(model, True)
    on_path = {"attention": 2, "attention_bwd": 2, "triplane_sample": 2,
               "triplane_sample_bwd": 2, "cam_gather_sum": 1,
               "cam_gather_sum_bwd": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert set(lk) == {"contrastive_loss", "surface_loss"}
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-2 * abs(float(lp[k]))
    a = torch.cat([x.float().flatten() for x in gk])
    b = torch.cat([x.float().flatten() for x in gp])
    assert bool(torch.isfinite(a).all())
    assert float((a - b).norm() / b.norm()) < 5e-2
    logs = trainer.train_step(batch)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())


@pytest.mark.cuda
def test_tiny_point_triplane_train_step_on_card(cuda_device):
    """One ``tiny_point`` (``PointTriplane``: camera, contrastive and
    surface losses) training step on the card, its encoders at the
    ConvNeXt widths and its projector at B9's width, as
    ``test_tiny_point_occ_train_step_on_card`` widens them, so K1, B5
    both ways, B9 and the camera decoder's attention run.  Kernels, bf16
    twins and float32 twins from the same BatchNorm statistics and the
    same drop-path and loss draws: losses and running statistics within
    1e-2 of the bf16 twins', the gradient's error against float32 within
    1.25 times the bf16 twins' own; then a ``train_step`` moves every
    trainable tensor and no frozen one."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch,
    )
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
        set_kernels,
    )
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock,
    )
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
        loss_and_grads,
    )

    cfg = get_config("tiny_point")
    m = cfg["model"]
    widths = (96, 192, 384, 768)
    for k in ("camera_encoder", "triplane_encoder"):
        m[k].update(arch={"depths": (1, 1, 1, 1), "channels": widths},
                    frozen_stages=1, drop_path_rate=0.1)
    m["point_triplane_projector"]["out_channels"] = 128
    m["triplane_encoder"]["in_channels"] = 128
    m["fpn"]["in_channels"] = widths
    model = build_model(m, device=cuda_device, dtype=torch.bfloat16)
    # layer-scale gamma from U(0.1, 1), as chip_smoke.py draws it: at its
    # 1e-6 init the blocks' gradients, clipped with the ~1e9 norm that the
    # camera decoder's LayerNorms over empty canvas pixels give at init,
    # fall below Adam's eps and the first step moves no block weight
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvNeXtBlock):
                mod.gamma.copy_(torch.rand(mod.gamma.shape, generator=g)
                                * 0.9 + 0.1)
    trainer = build_trainer(cfg, model, total_steps=2)
    m32 = build_model(m, device=cuda_device, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    trainable = {n for n, _ in trainer.named}
    for n, p in m32.named_parameters():
        p.requires_grad_(n in trainable)
    params32 = [dict(m32.named_parameters())[n] for n, _ in trainer.named]
    # 256 x 512 canvases: the decoder's 8192 x 512 attention opens its gate
    batch = synthetic_batch(2, point_budget=4096, seed=3, device=cuda_device)

    def stats(mod=model):
        return {k: v.clone() for k, v in mod.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    def run(mod, params):
        return loss_and_grads(mod, params, batch, trainer.generator(0),
                              sample_generator=trainer.sample_generator(0))

    s0 = stats()
    K.reset_launches()
    lk, _, gk = run(model, trainer.params)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    sk = stats()
    model.load_state_dict(s0, strict=False)
    set_kernels(model, False)
    lp, _, gp = run(model, trainer.params)
    sp = stats()
    set_kernels(model, True)
    model.load_state_dict(s0, strict=False)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, _, g32 = run(m32, params32)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    on_path = {"convnext_block_fused": 4, "epilogue_fused": 12,
               "post_epilogue_bwd": 3 + 8, "post_epilogue_bwd_wide": 4,
               "finite_mlp_fused": 3, "attention": 2, "attention_bwd": 2}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    assert set(lk) == {"camera_loss", "contrastive_loss", "surface_loss"}
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-2 * abs(float(lp[k]))
    a, b, f = (torch.cat([x.float().flatten() for x in gr])
               for gr in (gk, gp, g32))
    assert bool(torch.isfinite(a).all())
    assert rel(a, f) <= 1.25 * rel(b, f), (rel(a, f), rel(b, f), rel(a, b))
    for k in s0:
        assert rel(sk[k], sp[k]) < 1e-2, k
    frozen = {n: p.clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    before = [p.clone() for p in trainer.params]
    logs = trainer.train_step(batch)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())
    assert not any(torch.equal(p, q) for p, q in zip(trainer.params, before))
    assert frozen and all(torch.equal(p, frozen[n])
                          for n, p in model.named_parameters() if n in frozen)


def card_op_cases(device):
    """``{op: inputs}`` for every ``emp::`` op at small shapes its kernel
    takes, bf16 activations and float32 parameters as the models pass
    them (the ops cast the weights themselves)."""
    g = torch.Generator(device=device).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32

    def r(*s, dtype=f32):
        return torch.randn(*s, generator=g, device=device).to(dtype)

    def mlp(C, wdt=f32):
        return [1 + 0.1 * r(C), 0.1 * r(C), r(4 * C, C, dtype=wdt) * C**-0.5,
                0.1 * r(4 * C), r(C, 4 * C, dtype=wdt) * (4 * C)**-0.5,
                0.1 * r(C), torch.rand(C, generator=g, device=device) + 0.1]

    C = 96
    dw = [r(C, 1, 7, 7) / 7, 0.1 * r(C)]
    q, k, v = (r(2, 128, 32, dtype=bf) for _ in range(3))
    out, lse = K.attention(q, k, v, 32**-0.5)
    coords = torch.rand(2, 300, 3, generator=g, device=device) * 2.2 - 1.1
    pools = r(256, 64, dtype=bf)
    pools[::4] = float("-inf")
    feats = r(2, 3, 40, 16, dtype=bf)
    idx = torch.randint(-2, 42, (2, 3, 300), generator=g, device=device,
                        dtype=torch.int32)
    valid = (torch.rand(2, 3, 300, generator=g, device=device)
             < 0.7).to(torch.uint8)
    return {
        "convnext_block_fused": [r(2, 8, 8, C, dtype=bf)] + dw + mlp(C),
        "epilogue_fused": [r(2, 8, 8, C, dtype=bf)] + mlp(C),
        "post_epilogue_bwd": [r(256, C, dtype=bf), r(256, C, dtype=bf)]
        + mlp(C, bf),
        "post_epilogue_bwd_wide": [r(256, 768, dtype=bf),
                                   r(256, 768, dtype=bf)] + mlp(768, bf),
        "attention": [q, k, v, 32**-0.5],
        "attention_bwd": [q, k, v, out, lse, r(2, 128, 32, dtype=bf),
                          32**-0.5],
        "ln_dense_fused": [r(256, 128, dtype=bf), 1 + 0.1 * r(128),
                           0.1 * r(128), r(384, 128) / 12, None, 1e-6],
        "gelu_dense_fused": [r(256, 512, dtype=bf), r(128, 512) / 23,
                             0.1 * r(128)],
        "triplane_sample": [r(2, 3, 16, 16, 32, dtype=bf), coords],
        "triplane_sample_bwd": [coords, r(2, 300, 32, dtype=bf), 16],
        "finite_mlp_fused": [pools, r(128, 64, dtype=bf) / 8, 0.1 * r(128),
                             r(128, 128, dtype=bf) / 12, 0.1 * r(128)],
        "convnext_block_int8_fused": [r(1, 8, 8, C, dtype=bf)] + dw
        + mlp(C),
        "cam_gather_sum": [feats, idx, valid],
        "cam_gather_sum_bwd": [r(2, 300, 16), idx, valid, 40, bf],
    }


@pytest.mark.cuda
def test_every_op_passes_opcheck_on_card(cuda_device):
    """``torch.library.opcheck`` (schema, fake tensor, autograd
    registration) of every ``emp::`` op on CUDA tensors: the kernels'
    outputs have the shapes, dtypes and strides the fake implementations
    give, and no op mutates or aliases its inputs."""
    cases = card_op_cases(cuda_device)
    assert set(cases) == set(K.LAUNCHES) - {"int8_dot"}
    for name, args in cases.items():
        args = [a.clone().requires_grad_(a.is_floating_point())
                if isinstance(a, torch.Tensor) else a for a in args]
        K.reset_launches()
        torch.library.opcheck(getattr(torch.ops.emp, name).default,
                              tuple(args),
                              test_utils=("test_schema",
                                          "test_autograd_registration",
                                          "test_faketensor"))
        assert K.LAUNCHES[name] > 0, name


def wide_tiny_occ(device):
    """tiny_occ at ConvNeXt-tiny widths (one block a stage) and a 128-wide
    MiT neck, in bf16: K1, K2, K3, K4 and B8 all open."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
    )

    cfg = get_config("tiny_occ")["model"]
    arch = {"depths": (1, 1, 1, 1), "channels": (96, 192, 384, 768)}
    cfg["encoder"]["camera_encoder"]["arch"] = arch
    cfg["encoder"]["lidar_encoder"].update(arch=arch, in_channels=1 + 192)
    cfg["encoder"]["embed_dims"] = 192
    cfg["neck"]["in_chans"] = cfg["embed_dim"] = 768
    cfg["neck"]["embed_dim"] = 128
    return build_model(cfg, device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
def test_bf16_occ_artifact_runs_the_kernels_on_card(cuda_device, tmp_path):
    """A tiny bf16 occupancy artifact exported on the card holds ``emp::``
    K1-K4 and B8 nodes, as many as the live forward launches; loaded
    back, it launches the same kernels the same number of times and gives
    the live model's class map bit for bit."""
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_arrays,
    )
    from efficient_multimodal_perception_tpu_torch.tools import export as X

    module = X.InferModule(wide_tiny_occ(cuda_device).requires_grad_(False))
    arrs = synthetic_arrays(1, point_budget=2048, seed=3)
    inputs = {k: torch.from_numpy(arrs[k]).to(cuda_device)
              for k in module.keys}
    K.reset_launches()
    want = X.run(module, inputs)
    live = {k: n for k, n in K.LAUNCHES.items() if n}
    assert live == {"convnext_block_fused": 8, "attention": 2,
                    "ln_dense_fused": 4, "gelu_dense_fused": 2,
                    "cam_gather_sum": 1}
    program = X.export(module, inputs)
    assert X.emp_op_counts(program) == live
    path = str(tmp_path / "occ.pt2")
    torch.export.save(program, path)
    loaded = X.load_artifact(path).module()
    K.reset_launches()
    got = X.run(loaded, inputs)
    assert {k: n for k, n in K.LAUNCHES.items() if n} == live
    assert got.dtype == torch.int8 and torch.equal(got, want)
