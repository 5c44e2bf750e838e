"""The port's CUDA kernels against their plain twins, on the card.

Skipped without an NVIDIA GPU: a CUDA kernel has no CPU mode.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

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

    for C, M in ((96, 100), (192, 64), (384, 40), (768, 48)):
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
def test_int8_kernels_match_twins_on_card(cuda_device):
    """The int8 probe is exact, and B10 equals its twin bit for bit at a
    ragged row count and at the widest width (it rounds where the twin
    does); a dtype the kernel does not take raises."""
    x8, w8 = probe_operands(cuda_device)
    want = x8.cpu().long() @ w8.cpu().long().t()
    K.reset_launches()
    got = K.int8_dot(x8, w8)
    torch.cuda.synchronize()
    assert K.LAUNCHES["int8_dot"] == 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), want)

    g = torch.Generator(device=cuda_device).manual_seed(3)
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


@pytest.mark.cuda
def test_cam_gather_matches_twins_on_card(cuda_device):
    """B8 forward and backward against their twins on the card: at B=1
    and B=2, with many points on one feature row and indices outside
    ``[0, K)`` (relative Frobenius error <= 1e-2; the backward adds with
    f32 atomics in no fixed order); the wrappers refuse what the kernels
    do not take."""
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    for B, N, Kr, C, P in ((1, 6, 32, 16, 700), (2, 3, 8, 192, 300)):
        feats = torch.randn(B, N, Kr, C, generator=g, device=cuda_device).to(
            torch.bfloat16)
        idx = torch.randint(-1, Kr + 1, (B, N, P), generator=g,
                            device=cuda_device, dtype=torch.int32)
        valid = (torch.rand(B, N, P, generator=g, device=cuda_device)
                 > 0.3).to(torch.uint8)
        gr = torch.randn(B, P, C, generator=g, device=cuda_device)
        assert rel(K.cam_gather_sum(feats, idx, valid),
                   K.cam_gather_sum_plain(feats, idx, valid)) < 1e-2
        assert rel(K.cam_gather_sum_bwd(gr, idx, valid, Kr),
                   K.cam_gather_sum_bwd_plain(gr, idx, valid, Kr)) < 1e-2
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
