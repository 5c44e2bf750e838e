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
    is on its path, the other gates stay closed at tiny widths, and the
    result agrees with the all-plain run."""
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
    assert launches == {k: 2 if k == "attention" else 0 for k in K.LAUNCHES}
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
    8) and sampler kernels are on the path, forward and backward, and
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
               "triplane_sample_bwd": 1}
    assert launches == {k: on_path.get(k, 0) for k in K.LAUNCHES}
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-2 * abs(float(lp[k]))
    a = torch.cat([x.float().flatten() for x in gk])
    b = torch.cat([x.float().flatten() for x in gp])
    assert bool(torch.isfinite(a).all())
    assert float((a - b).norm() / b.norm()) < 5e-2
    logs = trainer.train_step(batch)
    assert all(torch.isfinite(torch.as_tensor(v)) for v in logs.values())
