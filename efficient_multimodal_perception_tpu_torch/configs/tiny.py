"""Tiny configs for fast CPU tests: the shipped topology and spatial
shapes (the neck needs the (32 + 6*16, 32) strip) with ~100x fewer
channels.  ``tiny_occ``, ``tiny_point_occ`` (the JAX package's
``tiny_point(occ=True)``) and ``tiny_range_cam`` (its
``tiny_mae(contrastive=False, surface=False)``)."""

from ._base import runtime, schedule_cosine

TINY_ARCH = {"depths": (1, 1, 1, 1), "channels": (8, 16, 32, 64)}


def tiny_encoder():
    return dict(
        type="JointEncoder",
        lidar_encoder=dict(
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            in_channels=17,  # 1 + camera stage-1 channels
            stem_patch_size=(1, 4),
            downsample_height=False,
            drop_path_rate=0.1,
        ),
        camera_encoder=dict(
            arch=TINY_ARCH,
            out_indices=1,
            norm_out=True,
            stem_patch_size=(2, 2),
            drop_path_rate=0.1,
        ),
        embed_dims=16,
        lidar_mask_ratio=0.0,
        camera_mask_ratio=0.0,
    )


def tiny_neck():
    return dict(
        type="MixVisionTransformer",
        img_size=(128, 32),
        patch_size=1,
        in_chans=64,
        embed_dim=64,
    )


def tiny_occ():
    return dict(
        type="TriplaneOcc",
        encoder=tiny_encoder(),
        neck=tiny_neck(),
        decoder=dict(type="Mlp", input_dim=32, num_classes=5),
        voxel_size=(0.5, 0.5, 0.5),
        occ_range=(-25, -25, -5, 25, 25, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        triplane_voxel_size=(0.4, 0.4, 0.1),
        embed_dim=64,
    )


def tiny_mae():
    return dict(
        type="TriplaneMAE",
        encoder=tiny_encoder(),
        neck=tiny_neck(),
        contrastive=False,
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters=64,
        embed_dim=64,
        camera_decoder=dict(
            type="MixVisionTransformerHead",
            patch_size=(7, 7),
            stride=(4, 4),
            in_chans=32,
            embed_dim=32,
            actual_patch_size=(4, 4),
            img_in_chans=3,
        ),
        lidar_decoder=dict(
            type="MixVisionTransformerHead",
            patch_size=(1, 7),
            stride=(1, 4),
            in_chans=32,
            embed_dim=32,
            actual_patch_size=(1, 4),
            img_in_chans=1,
        ),
    )


def tiny_point_occ():
    """The JAX package's ``tiny_point(occ=True)``: a 32 x 32 x 16 grid,
    16-channel projector, tiny encoders and a 24-channel FPN."""
    return dict(
        type="PointTriplaneOcc",
        point_triplane_projector=dict(
            type="PointTriplaneProjector",
            grid_size=(32, 32, 16),
            base_channels=16,
            split=(8, 8, 4),
            in_channels=5,
            out_channels=16,
        ),
        camera_encoder=dict(
            type="MaskConvNeXt",
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            stem_patch_size=(2, 2),
        ),
        triplane_encoder=dict(
            type="MaskConvNeXt",
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            stem_patch_size=(1, 1),
            out_all_scale=True,
            in_channels=16,
        ),
        fpn=dict(
            type="GeneralizedLSSFPN",
            in_channels=(8, 16, 32, 64),
            out_channels=24,
        ),
        decoder=dict(type="Mlp", input_dim=24, num_classes=5),
        voxel_size=(0.5, 0.5, 0.5),
        occ_range=(-25, -25, -5, 25, 25, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        triplane_voxel_size=(50 / 32, 50 / 32, 8 / 16),
    )


def get_config():
    return dict(name="tiny_occ", model=tiny_occ(),
                model_init=dict(ckpt_path=None, freeze=("encoder", "neck")),
                data=dict(num_cams=6, image_size=(256, 512),
                          point_budget=4096, samples_per_device=1,
                          load_occ=True),
                **schedule_cosine(warmup_ratio=0.5), **runtime())


def get_point_occ_config():
    return dict(name="tiny_point_occ", model=tiny_point_occ(),
                data=dict(num_cams=6, image_size=(256, 512),
                          point_budget=4096))


def get_range_cam_config():
    return dict(name="tiny_range_cam", model=tiny_mae(),
                model_init=dict(ckpt_path=None, freeze=()),
                data=dict(num_cams=6, image_size=(256, 512),
                          point_budget=4096, samples_per_device=1),
                **schedule_cosine(), **runtime())
