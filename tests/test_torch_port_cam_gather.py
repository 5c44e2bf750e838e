"""B8 (``cam_gather_sum``) in the port against the JAX package, on the CPU.

- The twins and ``_CamGatherFn`` (forward, and the gradient of
  ``sum(sin(out))``) against the Pallas kernel in interpret mode and its
  ``jax.grad``, at atol 1e-5 in float32: at the shape of
  ``tests/test_pallas_kernels.py::test_cam_gather_sum_matches_xla`` in
  float32, and with bf16 features, many points per feature row and
  indices outside ``[0, K)`` (which contribute 0, as a one-hot row with
  no match does).
- The interact on the CPU never launches B8, ``set_kernels`` switches its
  site, and at batch 1 the interact hands the wrapper contiguous int32 /
  uint8 inputs whose result equals the plain gather-sum.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``).  JAX runs under full matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    cam_gather_sum as jax_cam_gather_sum,
)
from efficient_multimodal_perception_tpu_torch.configs.tiny import TINY_ARCH
from efficient_multimodal_perception_tpu_torch.core.geometry import CameraAug
from efficient_multimodal_perception_tpu_torch.models import joint_encoder
from efficient_multimodal_perception_tpu_torch.models.builder import (
    set_kernels,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

ATOL = 1e-5


def _case(name):
    """(feats, idx, valid) in numpy: ``f32`` at the JAX test's shape,
    ``bf16`` with collisions and out-of-range indices."""
    if name == "f32":
        rng = np.random.default_rng(11)
        B, N, Kr, C, P = 2, 3, 64, 8, 300
        feats = rng.standard_normal((B, N, Kr, C)).astype(np.float32)
        idx = rng.integers(0, Kr, (B, N, P)).astype(np.int32)
    else:
        rng = np.random.default_rng(12)
        B, N, Kr, C, P = 2, 3, 16, 16, 300
        feats = rng.standard_normal((B, N, Kr, C)).astype(np.float32)
        idx = rng.integers(-1, Kr + 1, (B, N, P)).astype(np.int32)
    valid = rng.random((B, N, P)) > 0.3
    return feats, idx, valid


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_cam_gather_matches_pallas(name):
    feats, idx, valid = _case(name)
    jdt, tdt = ((jnp.float32, torch.float32) if name == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jf, ji, jv = jnp.asarray(feats, jdt), jnp.asarray(idx), jnp.asarray(valid)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_cam_gather_sum(jf, ji, jv, True))
        want_grad = np.asarray(jax.grad(lambda f: jnp.sum(jnp.sin(
            jax_cam_gather_sum(f, ji, jv, True))))(jf), np.float32)

    if name == "bf16":  # many points per feature row
        hits = np.bincount(((np.arange(6).reshape(2, 3, 1) * 16 + idx)
                            [valid & (idx >= 0) & (idx < 16)]))
        assert hits.max() >= 15
        assert ((idx < 0) | (idx >= 16))[valid].sum() >= 20
    before = dict(K.LAUNCHES)
    tf = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    ti = torch.from_numpy(idx)
    tv = torch.from_numpy(valid.astype(np.uint8))
    plain = K.cam_gather_sum_plain(tf.detach(), ti, tv)
    out = K.cam_gather_sum_op(tf, ti, tv)
    assert out.dtype == torch.float32 and out.shape == want.shape
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)

    (grad,) = torch.autograd.grad(torch.sin(out).sum(), tf)
    assert grad.dtype == tdt
    np.testing.assert_allclose(grad.float().numpy(), want_grad, atol=ATOL)
    direct = K.cam_gather_sum_bwd_plain(torch.cos(out.detach()), ti, tv,
                                        feats.shape[2], tdt)
    assert torch.equal(direct, grad)
    assert K.LAUNCHES == before  # CPU tensors run the twins


def _interact_inputs(B, rng):
    """A tiny camera rig and range image whose points project into both
    cameras' 4 x 8 feature maps."""
    N, IH, IW, RH, RW = 2, 64, 128, 16, 64
    range_image = rng.uniform(0, 40, (B, RH, RW, 1)).astype(np.float32)
    empty = rng.random((B, RH, RW)) < 0.3
    range_points = rng.uniform(-20, 20, (B, RH, RW, 3)).astype(np.float32)
    range_points[empty] = 0.0
    range_image[empty] = 0.0
    l2i = np.zeros((B, N, 4, 4), np.float32)
    for c in range(N):
        cam = np.array([[80.0, 0, IW / 2, 0], [0, 80.0, IH / 2, 0],
                        [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        a = np.pi * c
        R = np.array([[np.cos(a), -np.sin(a), 0, 0], [0, 0, -1, 1.0],
                      [np.sin(a), np.cos(a), 0, 0], [0, 0, 0, 1]],
                     np.float32)
        l2i[:, c] = cam @ R
    aug = CameraAug(torch.full((B, N), 1.0), torch.zeros(B, N, 2),
                    torch.zeros(B, N, dtype=torch.bool))
    return (torch.from_numpy(range_image), torch.from_numpy(range_points),
            torch.from_numpy(l2i), aug), (IH, IW)


def _encoder(C, image_hw):
    enc_cfg = dict(arch=TINY_ARCH, out_indices=1, stem_patch_size=(2, 2))
    lid_cfg = dict(arch=TINY_ARCH, in_channels=1 + C,
                   stem_patch_size=(1, 4), downsample_height=False)
    return joint_encoder.JointEncoder(lid_cfg, enc_cfg, embed_dims=C,
                                      image_hw=image_hw)


def test_interact_never_launches_b8_on_cpu():
    rng = np.random.default_rng(5)
    args, hw = _interact_inputs(2, rng)
    enc = _encoder(16, hw)
    feats = torch.from_numpy(rng.standard_normal((2, 2, 4, 8, 16)).astype(
        np.float32)).to(torch.bfloat16)
    assert not joint_encoder.gather_kernel_active(feats)
    K.reset_launches()
    with torch.no_grad():
        fused = enc.interact(feats, *args)[0]
    assert K.LAUNCHES["cam_gather_sum"] == 0
    assert fused.shape == (2, 16, 64, 17) and fused.dtype == torch.float32
    assert fused[..., 1:].abs().sum() > 0  # the gather reached the image
    set_kernels(enc, False)
    assert not enc.fuse_gather
    set_kernels(enc, True)
    assert enc.fuse_gather


def test_interact_hands_b8_contiguous_inputs_at_batch_1(monkeypatch):
    """With the gate forced open on the CPU, the interact's kernel route
    at B=1 gives the wrapper contiguous int32 indices and uint8 validity,
    and its result equals the plain gather-sum route's."""
    rng = np.random.default_rng(6)
    args, hw = _interact_inputs(1, rng)
    enc = _encoder(16, hw)
    # a channels-last view, as a camera encoder's output may be
    feats = torch.from_numpy(rng.standard_normal((1, 2, 16, 4, 8)).astype(
        np.float32)).permute(0, 1, 3, 4, 2)
    assert not feats.is_contiguous()
    seen = []
    wrapper = K.cam_gather_sum

    def checked(f, idx, valid):
        seen.append((f.is_contiguous(), idx.is_contiguous(), idx.dtype,
                     valid.is_contiguous(), valid.dtype, tuple(idx.shape)))
        return wrapper(f, idx, valid)

    monkeypatch.setattr(K, "cam_gather_sum", checked)
    monkeypatch.setattr(joint_encoder, "gather_kernel_active", lambda f: True)
    with torch.no_grad():
        got = enc.interact(feats, *args)[0]
        enc.fuse_gather = False
        want = enc.interact(feats, *args)[0]
    assert seen == [(True, True, torch.int32, True, torch.uint8,
                     (1, 2, 16 * 64))]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
