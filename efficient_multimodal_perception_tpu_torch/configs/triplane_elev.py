"""triplane_elev: BEV elevation fine-tune (ConvNeXt-tiny encoders, MiT
neck with embed 1024, the resnet34 U-Net head over the (100, 100, 80)
voxel readout; the encoder and neck come frozen from the pretrain
checkpoint)."""

from ._base import (
    data_nuscenes,
    convnext_camera,
    convnext_lidar,
    mit_neck,
    runtime,
    schedule_cosine,
)


def get_config():
    volume = (100, 100, 80)
    return dict(
        name="triplane_elev",
        model=dict(
            type="TriplaneElev",
            encoder=dict(
                type="JointEncoder",
                lidar_encoder=convnext_lidar("tiny"),
                camera_encoder=convnext_camera("tiny"),
                lidar_mask_ratio=0.0,
                camera_mask_ratio=0.0,
            ),
            neck=mit_neck(),
            decoder=dict(
                type="Unet", input_dim=32, height_dim=volume[2], pad=14
            ),
            volume=volume,
            voxel_size=(0.4, 0.4, 0.1),
            pc_range=(-20, -20, -5, 20, 20, 3),
            triplane_range=(-25, -25, -5, 25, 25, 3),
        ),
        model_init=dict(
            ckpt_path=None,  # the pretrain checkpoint (train.cli --ckpt-path)
            freeze=("encoder", "neck"),
        ),
        data=data_nuscenes(load_elev=True),
        **schedule_cosine(warmup_iters=1000, min_lr_ratio=1e-7 / 2.5e-4),
        **runtime(),
    )
