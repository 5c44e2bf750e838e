"""nuscenes_range: range-image MAE with the LiDAR decoder only
(ConvNeXt-tiny encoders, MiT neck with embed 1024, masking off): the
JAX package pairs its data block with this lidar-decoder-only
``TriplaneMAE``, the smallest pretraining rung."""

from ._base import (
    data_nuscenes,
    convnext_camera,
    convnext_lidar,
    mit_neck,
    runtime,
    schedule_cosine,
)


def get_config():
    return dict(
        name="nuscenes_range",
        model=dict(
            type="TriplaneMAE",
            encoder=dict(
                type="JointEncoder",
                lidar_encoder=convnext_lidar("tiny"),
                camera_encoder=convnext_camera("tiny"),
                lidar_mask_ratio=0.0,
                camera_mask_ratio=0.0,
            ),
            neck=mit_neck(),
            lidar_decoder=dict(
                type="MixVisionTransformerHead",
                patch_size=(1, 7),
                stride=(1, 4),
                in_chans=32,
                embed_dim=96,
                norm_pix_loss=False,
                actual_patch_size=(1, 4),
                img_in_chans=1,
            ),
            contrastive=False,
            voxel_size=(0.4, 0.4, 0.1),
            pc_range=(-25, -25, -5, 25, 25, 3),
        ),
        model_init=dict(ckpt_path=None, freeze=()),
        data=data_nuscenes(),
        **schedule_cosine(),
        **runtime(),
    )
