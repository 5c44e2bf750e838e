"""Config fragments this port needs (copy of the JAX package's
``configs/_base.py`` encoder, neck, schedule and runtime blocks)."""

from __future__ import annotations


def schedule_cosine(
    lr: float = 2.5e-4,
    warmup_iters: int = 20,
    warmup_ratio: float = 0.1,
    min_lr_ratio: float = 0.1,
    epochs: int = 50,
):
    """AdamW(betas (0.95, 0.99), wd 1e-3), linear warmup + cosine to
    ``min_lr_ratio``, global-norm clip 35."""
    return dict(
        optimizer=dict(
            type="AdamW", lr=lr, betas=(0.95, 0.99), weight_decay=0.001
        ),
        grad_clip=35.0,
        lr_config=dict(
            policy="cosine",
            warmup="linear",
            warmup_iters=warmup_iters,
            warmup_ratio=warmup_ratio,
            min_lr_ratio=min_lr_ratio,
        ),
        epochs=epochs,
    )


def runtime():
    """bf16 compute with float32 parameters, no loss scaling."""
    return dict(
        checkpoint=dict(interval=5, max_keep=1000),
        log_interval=50,
        compute_dtype="bfloat16",
        seed=0,
    )


def convnext_lidar(arch: str):
    """Range-image encoder over the fused 193-channel input."""
    return dict(
        arch=arch,
        drop_path_rate=0.2,
        out_indices=3,
        norm_out=True,
        frozen_stages=1,
        in_channels=193,
        stem_patch_size=(1, 4),
        downsample_height=False,
    )


def convnext_camera(arch: str):
    """Split-forward camera encoder (``forward1`` ends after stage 1)."""
    return dict(
        arch=arch,
        drop_path_rate=0.2,
        out_indices=1,
        norm_out=True,
        frozen_stages=1,
        stem_patch_size=(2, 2),
    )


def mit_neck():
    return dict(
        type="MixVisionTransformer",
        img_size=(128, 32),
        patch_size=1,
        embed_dim=1024,
    )
