"""Config fragments this port needs (copy of the JAX package's
``configs/_base.py``: the nuScenes data block, the encoder, neck,
schedule and runtime blocks)."""

from __future__ import annotations


def data_nuscenes(
    load_points: bool = False,
    load_occ: bool = False,
    load_elev: bool = False,
    samples_per_device: int = 1,
    sweeps_num: int = 0,
):
    """The nuScenes loader's settings (``data/nuscenes.NuScenesDataset``).

    A keyframe holds ~34k points and each aggregated sweep adds up to as
    many, so the static point budget scales with ``1 + sweeps_num``; an
    aggregate over the budget is subsampled uniformly, never cut in file
    order."""
    return dict(
        type="NuScenesDataset",
        data_root="data/nuscenes",
        ann_train="nuscenes_infos_train.pkl",
        ann_val="nuscenes_infos_val.pkl",
        num_cams=6,
        image_size=(256, 512),  # ImageAug3D final_dim
        resize_lim=(0.44, 0.61),
        rand_flip=True,
        img_mean=(0.485, 0.456, 0.406),
        img_std=(0.229, 0.224, 0.225),
        load_points=load_points,
        point_dim=11,
        sweeps_num=sweeps_num,
        point_budget=36864 * (1 + sweeps_num),
        load_occ=load_occ,
        load_elev=load_elev,
        samples_per_device=samples_per_device,
        workers=4,
    )


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
