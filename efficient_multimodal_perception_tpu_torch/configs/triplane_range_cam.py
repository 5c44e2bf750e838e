"""triplane_range_cam: camera + range MAE pretraining (ConvNeXt-tiny
encoders, MiT neck with embed 1024, camera and LiDAR reconstruction
decoders; masking, surface and contrastive losses off)."""

from ._base import (
    convnext_camera,
    convnext_lidar,
    mit_neck,
    runtime,
    schedule_cosine,
)


def get_config():
    return dict(
        name="triplane_range_cam",
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
            camera_decoder=dict(
                type="MixVisionTransformerHead",
                patch_size=(7, 7),
                stride=(4, 4),
                in_chans=32,
                embed_dim=96,
                norm_pix_loss=False,
                actual_patch_size=(4, 4),
                img_in_chans=3,
            ),
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
        data=dict(num_cams=6, image_size=(256, 512), point_budget=36864,
                  samples_per_device=1),
        **schedule_cosine(),
        **runtime(),
    )
