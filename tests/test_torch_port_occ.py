"""The port's ``triplane_occ`` path against the JAX package, on the CPU.

Inputs and weights are made with numpy seeds and handed to both
packages.  JAX runs under full matmul precision (this build's default is
bf16 even on the CPU).  Every JAX leaf is perturbed from a seed so that
layer-scale ``gamma`` is far from its 1e-6 init and every ConvNeXt MLP
branch reaches the output; the perturbed tree goes to the port through
``weights.load_jax_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import TINY_ARCH, tiny_occ
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.convnext import (
    MaskConvNeXt as JMaskConvNeXt,
)
from efficient_multimodal_perception_tpu.models.joint_encoder import (
    JointEncoder as JJointEncoder,
)
from efficient_multimodal_perception_tpu.models.mit import MiTBlock as JMiTBlock
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.core.geometry import CameraAug
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.convnext import MaskConvNeXt
from efficient_multimodal_perception_tpu_torch.models.joint_encoder import (
    JointEncoder,
)
from efficient_multimodal_perception_tpu_torch.models.mit import MiTBlock
from efficient_multimodal_perception_tpu_torch.weights import load_jax_params
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

ATOL = RTOL = 1e-4  # tests/test_full_parity.py's occ-logit tolerance


def perturbed(params, seed):
    """Flat ``{path: array}`` of every leaf, perturbed from ``seed``."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    return {
        k: (np.asarray(v) * (1 + 0.1 * rng.standard_normal(v.shape))
            + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flat.items()
    }


def unflatten(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def jax_batch(arrs):
    return JBatch(
        img=jnp.asarray(arrs["img"]),
        range_image=jnp.asarray(arrs["range_image"]),
        range_points=jnp.asarray(arrs["range_points"]),
        lidar2img=jnp.asarray(arrs["lidar2img"]),
        cam_aug=JAug(jnp.asarray(arrs["cam_resize"]),
                     jnp.asarray(arrs["cam_crop"]),
                     jnp.asarray(arrs["cam_flip"])),
        occupancy=jnp.asarray(arrs["occupancy"]),
    )


@pytest.fixture(scope="module")
def occ_case():
    """tiny_occ at B=1, f32: the JAX logits and the perturbed params."""
    arrs = synthetic_arrays(1, point_budget=2048, with_occ=True, seed=3)
    jb = jax_batch(arrs)
    model = jax_build_model(tiny_occ())
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True))(jb)
    flat = perturbed(variables["params"], seed=0)
    with jax.default_matmul_precision("highest"):
        logits, _, losses = jax.jit(lambda p, b: model.apply(
            {"params": p}, b, deterministic=True))(unflatten(flat), jb)
    return dict(arrs=arrs, flat=flat, logits=np.asarray(logits),
                loss=float(losses["loss"]))


@pytest.fixture(scope="module")
def port_occ(occ_case):
    model = build_model(get_config("tiny_occ")["model"], device="cpu")
    model.load_state_dict(load_jax_params(occ_case["flat"], model))
    return model


def test_tiny_occ_logits_match_jax(occ_case, port_occ):
    with torch.no_grad():
        logits, occ, losses = port_occ(arrays_to_batch(occ_case["arrs"]))
    assert logits.shape == (1, 99, 99, 16, 5)
    assert occ.shape == (1, 99, 99, 16)
    np.testing.assert_allclose(logits.numpy(), occ_case["logits"],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(losses["loss"]), occ_case["loss"],
                               rtol=1e-5)


def test_tiny_occ_comparison_is_sensitive(occ_case, port_occ):
    """1% on one ConvNeXt block's pwconv1 moves the logits past the
    tolerance, so the comparison above sees the encoders' MLP branches."""
    w = port_occ.encoder.camera_encoder.stages[0][0].pwconv1.weight
    saved = w.detach().clone()
    try:
        with torch.no_grad():
            w.mul_(1.01)
            logits, _, _ = port_occ(arrays_to_batch(occ_case["arrs"]))
    finally:
        with torch.no_grad():
            w.copy_(saved)
    assert not np.allclose(logits.numpy(), occ_case["logits"],
                           atol=ATOL, rtol=RTOL)


def test_load_jax_params_fails_loudly(occ_case, port_occ):
    flat = dict(occ_case["flat"])
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_params({**flat, "neck/block0/attn/extra_scale":
                         np.zeros((2,), np.float32)}, port_occ)
    with pytest.raises(KeyError, match="attn.extra.weight"):
        load_jax_params({**flat, "neck/block0/attn/extra/kernel":
                         np.zeros((2, 2), np.float32)}, port_occ)
    flat.pop("decoder/conv3/kernel")
    with pytest.raises(KeyError, match="decoder.conv3.0.weight"):
        load_jax_params(flat, port_occ)


def test_convnext_forward1_forward2_match_jax():
    arch = {"depths": (1, 2, 1, 1), "channels": (8, 16, 32, 64)}
    kw = dict(arch=arch, in_channels=3, stem_patch_size=(2, 2),
              out_indices=1, norm_out=True)
    x = np.random.default_rng(1).standard_normal((2, 32, 64, 3)).astype(
        np.float32)
    jm = JMaskConvNeXt(**kw)
    init = jax.jit(lambda a: jm.init(jax.random.key(0), a))
    flat = perturbed(init(jnp.asarray(x))["params"], 2)
    with jax.default_matmul_precision("highest"):
        mid, out = jax.jit(lambda p, a: (
            jm.apply(p, a, method="forward1"),
            jm.apply(p, jm.apply(p, a, method="forward1"),
                     method="forward2"),
        ))({"params": unflatten(flat)}, jnp.asarray(x))
    pm = MaskConvNeXt(**kw)
    pm.load_state_dict(load_jax_params(flat, pm))
    with torch.no_grad():
        pmid = pm.forward1(torch.from_numpy(x))
        pout = pm.forward2(pmid)
    assert pmid.shape == (2, 8, 16, 16) and pout.shape == (2, 2, 4, 64)
    np.testing.assert_allclose(pmid.numpy(), np.asarray(mid),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pout.numpy(), np.asarray(out),
                               atol=ATOL, rtol=RTOL)


def test_mit_block_fused_route_matches_jax():
    """The fused LN->q|kv / LN->fc1 / GELU->fc2 route: JAX runs its
    Pallas prologues in interpret mode, the port its kernels' twins."""
    B, H, W, C = 1, 16, 16, 128
    x = np.random.default_rng(2).standard_normal((B, H * W, C)).astype(
        np.float32)
    jm = JMiTBlock(C, num_heads=4, mlp_ratio=2, fuse_prologue=True)
    flat = perturbed(jax.jit(lambda a: jm.init(
        jax.random.key(0), a, (H, W)))(jnp.asarray(x))["params"], 3)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, a: jm.apply(p, a, (H, W)))(
            {"params": unflatten(flat)}, jnp.asarray(x))
    pm = MiTBlock(C, 4, 2, fuse_prologue=True)
    pm.load_state_dict(load_jax_params(flat, pm))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), (H, W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_attention_kernel_gets_contiguous_inputs_at_batch_1(monkeypatch):
    """At B=1 reshaping q/k/v to flattened heads can return a strided
    view; the kernel takes contiguous rows only, so the block must hand
    it copies (the twin alone would not notice)."""
    from efficient_multimodal_perception_tpu_torch.models import mit
    from efficient_multimodal_perception_tpu_torch.ops import kernels as K

    seen = []

    def checked(q, k, v, scale):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return K.attention_plain(q, k, v, scale)[0]

    monkeypatch.setattr(mit, "attention_op", checked)
    blk = MiTBlock(64, 4, 2, fuse_prologue=False)
    blk.attn.fuse_attention = True
    with torch.no_grad():
        blk(torch.randn(1, 64, 64), (8, 8))
    assert seen == [[True, True, True]]


def test_interact_matches_jax_with_collisions():
    """Gather-sum and last-write PE scatter on a 4 x 8 feature map that
    hundreds of range pixels project into, so pixels are written many
    times and the last writer must win."""
    rng = np.random.default_rng(0)
    B, N, IH, IW, RH, RW = 2, 2, 64, 128, 16, 64
    h1, w1, C = 4, 8, 8
    enc_cfg = dict(arch=TINY_ARCH, out_indices=1, stem_patch_size=(2, 2))
    lid_cfg = dict(arch=TINY_ARCH, in_channels=1 + C,
                   stem_patch_size=(1, 4), downsample_height=False)
    feats = rng.standard_normal((B, N, h1, w1, C)).astype(np.float32)
    range_image = rng.uniform(0, 40, (B, RH, RW, 1)).astype(np.float32)
    empty = rng.random((B, RH, RW)) < 0.3
    range_points = rng.uniform(-20, 20, (B, RH, RW, 3)).astype(np.float32)
    range_points[empty] = 0.0
    range_image[empty] = 0.0
    range_image[(rng.random((B, RH, RW)) < 0.1) & ~empty] = 0.0
    l2i = np.zeros((B, N, 4, 4), np.float32)
    for c in range(N):
        K = np.array([[80.0, 0, IW / 2, 0], [0, 80.0, IH / 2, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        a = np.pi * c
        R = np.array([[np.cos(a), -np.sin(a), 0, 0], [0, 0, -1, 1.0],
                      [np.sin(a), np.cos(a), 0, 0], [0, 0, 0, 1]],
                     np.float32)
        l2i[:, c] = K @ R
    resize = np.full((B, N), 0.8, np.float32)
    crop = rng.uniform(0, 5, (B, N, 2)).astype(np.float32)
    flip = np.array([[False, True]] * B)

    jenc = JJointEncoder(lidar_encoder=lid_cfg, camera_encoder=enc_cfg,
                         embed_dims=C, image_hw=(IH, IW))
    jargs = (jnp.asarray(feats), jnp.asarray(range_image),
             jnp.asarray(range_points), jnp.asarray(l2i),
             JAug(jnp.asarray(resize), jnp.asarray(crop), jnp.asarray(flip)))
    flat = perturbed(jax.jit(lambda *a: jenc.init(
        jax.random.key(0), *a, method="interact"))(*jargs)["params"], 4)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, *a: jenc.apply(p, *a, method="interact"))(
            {"params": unflatten(flat)}, *jargs)

    penc = JointEncoder(lid_cfg, enc_cfg, embed_dims=C, image_hw=(IH, IW))
    sd = load_jax_params(flat)
    assert set(sd) == {"position_encoder.0.weight", "position_encoder.0.bias",
                       "position_encoder.2.weight", "position_encoder.2.bias"}
    penc.load_state_dict(sd, strict=False)
    with torch.no_grad():
        out = penc.interact(
            torch.from_numpy(feats), torch.from_numpy(range_image),
            torch.from_numpy(range_points), torch.from_numpy(l2i),
            CameraAug(torch.from_numpy(resize), torch.from_numpy(crop),
                      torch.from_numpy(flip)))
    # collisions: active points outnumber the feature pixels they hit
    rc = out[2].numpy()
    active = out[3].numpy() & (range_image[..., 0] > 0)[:, None]
    pix = (np.floor(rc[..., 0] * h1 / IH) * w1
           + np.floor(rc[..., 1] * w1 / IW))
    group = np.arange(B * N).reshape(B, N, 1, 1) * h1 * w1
    hit = np.unique((pix + group)[active])
    assert active.sum() >= len(hit) + 50
    for got, want in zip(out, ref):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   atol=ATOL, rtol=RTOL)
